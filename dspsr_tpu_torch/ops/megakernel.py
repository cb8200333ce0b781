"""The fused fold step: unpack -> filterbank(+chirp) -> detect -> fold.

Counterpart of ``dspsr_tpu/ops/megakernel.py``.  One call folds a whole
block of raw bytes into carried ``profiles [nchan_in, nplane, nsub, nbin]``
and ``hits [nchan_in, nbin]``:

1. unpack the 8-bit codes (``code * scale + offset``);
2. forward FFT of each overlap-save window of ``2N`` real samples, keeping
   bins ``0..N-1`` (Nyquist dropped), ``N = nsub * freq_res``;
3. multiply the input channel's dedispersion chirp (natural bin order);
4. inverse FFT of each subband's ``freq_res`` bins, scaled by
   ``1/freq_res``, keeping ``nfilt_pos <= t < nfilt_pos + nkeep``;
5. detect (Intensity, PPQQ, PP, QQ, Coherence or Stokes, optionally with the
   10 fourth-moment products);
6. fold with the float32 phase ``phi0[w] + dphi[w] * (t - nfilt_pos)``
   (each operation rounded separately), inside the sample-exact bounds.

Here live the host-side plan (``MegaPlan``, ``unpack_affine``,
``window_weight_spans``: numpy copies of the JAX package's, with the same
fields and results), the constants the step reads (``MegaConstants``), the
plain PyTorch version of the step (``megastep_plain``) and
``build_megastep``, which returns the step.  On CUDA tensors the step
launches the hand-written kernel (``kernels.megastep``); on CPU tensors it
runs ``megastep_plain``.

The search front end (``megafil_plain``, ``build_megafil``) runs steps 1-5
and returns the detected samples in time order instead of folding them,
optionally with the pre-chirp passband and with the chirp handed in per
call (the hybrid fold engine's front end); its kernel is
``kernels.megafil``.  Both plain versions share one front end
(``_front_plain``).

The TPU kernel's dense DFT, twiddle and row-select matrices are not ported:
they existed for the TPU's matrix unit, and the Hopper kernels run
register-resident FFTs with twiddle tables built by their wrapper instead.
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass
from typing import Optional, Tuple

import numpy as np
import torch

from .fold import compute_bins

_KERNEL_ITEM = "ROADMAP.md Queue 1 item 7 and Queue 2 item 1"
_NEXT_SLICE = ("ROADMAP.md Queue 1 item 6 (what is left of the hybrid fold "
               "engine)")


def _pow2(n: int) -> bool:
    return n > 0 and (n & (n - 1)) == 0


@dataclass(frozen=True)
class MegaPlan:
    """Static geometry of the fused block step (fields and formulas of
    ``dspsr_tpu.ops.megakernel.MegaPlan``).

    Built from a FilterbankPlan with the overlap rounded up so every window
    starts on a whole-row boundary of the ``[totrows, row_len]`` input view;
    the pipeline adopts the rounded overlap, so the port's block geometry is
    the reference's.
    """

    nsub: int          # output channels per input channel (nchan_subband)
    freq_res: int      # complex samples per subband per window
    R1: int            # first-stage radix (= rows of the spectrum layout)
    nfilt_pos: int     # complex samples dropped per window head (per subband)
    nfilt_neg: int     # rounded-up tail discard
    nbin: int          # fold phase bins
    npol: int          # input polarizations
    npol_out: int = 1  # 1 = Intensity, 2 = PPQQ, 4 = Stokes
    nbit: int = 8      # input bits per sample (2, 4, 8 or 32)
    real_input: bool = True  # Nyquist (real) vs analytic (complex) input
    nchan_in: int = 1  # input channels, each its own convolving filterbank
    #: samples per JA98 correction/excision block (> 0: dynamic 2-bit)
    npw: int = 0
    #: "auto" maps npol_out 1/2/4 -> Intensity/PPQQ/Stokes; "pp"/"qq" fold
    #: one polarization's power; "coherence" folds PP, QQ, Re[p*q], Im[p*q]
    detection: str = "auto"
    #: fold the 10 unique second-order Stokes products too (14 planes)
    fourth_moment: bool = False
    #: 8-bit two's-complement codes (an affine map of the signed byte)
    twos_complement: bool = False
    #: raw byte layout: "tfp" or "caspsr"
    interleave: str = "tfp"

    @property
    def n_fft(self) -> int:
        return self.nsub * self.freq_res

    @property
    def R2(self) -> int:
        return self.n_fft // self.R1

    @property
    def q(self) -> int:
        return self.freq_res // self.R1

    @property
    def nfilt_tot(self) -> int:
        return self.nfilt_pos + self.nfilt_neg

    @property
    def nkeep(self) -> int:
        return self.freq_res - self.nfilt_tot

    @property
    def mult(self) -> int:
        """Time samples per complex point (2 for real Nyquist input)."""
        return 2 if self.real_input else 1

    @property
    def ndim(self) -> int:
        return 1 if self.real_input else 2

    @property
    def nsamp_fft(self) -> int:
        return self.mult * self.n_fft

    @property
    def row_len(self) -> int:
        """Samples per row of the [totrows, row_len] input view."""
        return self.mult * self.R2

    @property
    def nsamp_step(self) -> int:
        return self.nsamp_fft - self.mult * self.nsub * self.nfilt_tot

    @property
    def step_rows(self) -> int:
        return self.nsamp_step // self.row_len

    @property
    def nplane(self) -> int:
        """Folded planes per subband (npol_out, or 14 with fourth moments)."""
        return 14 if self.fourth_moment else self.npol_out

    def block_ndat(self, npart: int) -> int:
        """Input time samples per block PER INPUT CHANNEL."""
        return (npart * self.nsamp_step
                + self.mult * self.nsub * self.nfilt_tot)

    def validate(self):
        if not (_pow2(self.n_fft) and _pow2(self.R1) and _pow2(self.freq_res)):
            raise ValueError("sizes must be powers of two")
        if self.freq_res % self.R1:
            raise ValueError("freq_res must be a multiple of R1")
        if self.nsamp_step % self.row_len:
            raise ValueError("step not a multiple of row_len (round nfilt up)")
        if self.step_rows % 8:
            raise ValueError("step_rows must be 8-aligned (round nfilt to 8q)")
        if self.nkeep <= 0:
            raise ValueError("nothing kept per window")
        if self.npol_out not in (1, 2, 4):
            raise ValueError("npol_out must be 1, 2 or 4")
        if self.npol_out > 1 and self.npol != 2:
            raise ValueError("PPQQ/Stokes need npol == 2")
        if self.detection not in ("auto", "pp", "qq", "coherence"):
            raise ValueError(f"unknown detection: {self.detection}")
        if self.detection in ("pp", "qq") and (
                self.npol_out != 1 or self.npol != 2):
            raise ValueError("pp/qq detection needs npol == 2, npol_out == 1")
        if self.detection == "coherence" and self.npol_out != 4:
            raise ValueError("coherence detection needs npol_out == 4")
        if self.fourth_moment and (
                self.npol_out != 4 or self.detection != "auto"):
            raise ValueError("fourth moments need Stokes (npol_out=4, auto)")
        if self.nbit not in (1, 2, 4, 8, 32):
            raise ValueError("nbit must be 1, 2, 4, 8 or 32")
        if self.npw:
            if self.nbit != 2:
                raise ValueError("dynamic-level unpack (npw > 0) needs nbit=2")
            if self.row_len % self.npw:
                raise ValueError("npw must divide row_len")
            if self.twos_complement:
                raise ValueError(
                    "JA98 dynamic levels use offset-binary state codes")
        if self.nchan_in < 1:
            raise ValueError("nchan_in must be >= 1")
        if self.twos_complement and self.nbit not in (2, 4, 8):
            raise ValueError("two's complement is 2/4/8-bit")
        if self.interleave not in ("tfp", "caspsr"):
            raise ValueError(f"unknown interleave: {self.interleave}")
        if self.interleave == "caspsr" and (
                self.nbit != 8 or self.nchan_in != 1 or self.ndim != 1):
            raise ValueError("CASPSR layout is 8-bit real single-channel")

    @staticmethod
    def choose_r1(n_fft: int, freq_res: int) -> Optional[int]:
        """Balanced first-stage radix: R1 ~ sqrt(N), dividing freq_res,
        capped at 1024 (and R2 at 8192)."""
        if not (_pow2(n_fft) and _pow2(freq_res)):
            return None
        r1 = 1 << (n_fft.bit_length() // 2)
        r1 = min(r1, freq_res, 1024)
        while n_fft // r1 > 4096 and r1 * 2 <= min(freq_res, 1024):
            r1 *= 2
        if n_fft // r1 > 8192 or r1 < 8:
            return None
        return r1

    @classmethod
    def from_filterbank(cls, fb_plan, nbin: int, npol: int,
                        npol_out: int = 1, nbit: int = 8,
                        nchan_in: int = 1,
                        ndat_per_weight: int = 0,
                        detection: str = "auto",
                        fourth_moment: bool = False,
                        twos_complement: bool = False,
                        interleave: str = "tfp") -> Optional["MegaPlan"]:
        """Build from an ``ops.filterbank.FilterbankPlan``; None if
        ineligible."""
        nsub, freq_res = fb_plan.nchan_subband, fb_plan.freq_res
        r1 = cls.choose_r1(nsub * freq_res, freq_res)
        if r1 is None:
            return None
        q = freq_res // r1
        # round the tail discard up to a multiple of 8q: every window then
        # starts on a whole 8-row boundary of the [totrows, row_len] view
        # (the reference's block geometry on its fused path)
        nfilt_tot = fb_plan.nfilt_pos + fb_plan.nfilt_neg
        rounded = -(-nfilt_tot // (8 * q)) * (8 * q)
        nfilt_neg = fb_plan.nfilt_neg + (rounded - nfilt_tot)
        npw = ndat_per_weight if nbit == 2 else 0
        plan = cls(nsub=nsub, freq_res=freq_res, R1=r1,
                   nfilt_pos=fb_plan.nfilt_pos, nfilt_neg=nfilt_neg,
                   nbin=nbin, npol=npol, npol_out=npol_out, nbit=nbit,
                   real_input=fb_plan.real_input, nchan_in=nchan_in,
                   npw=npw, detection=detection, fourth_moment=fourth_moment,
                   twos_complement=twos_complement, interleave=interleave)
        if plan.nkeep <= 0:
            return None
        if npw > 0 and plan.row_len % npw:
            return None
        plan.validate()
        return plan


def check_supported(plan: MegaPlan) -> None:
    """Raise ``NotImplementedError`` for a plan outside this slice: the
    port's step covers real-sampled 8-bit TFP input only."""
    if plan.nbit != 8 or plan.npw:
        raise NotImplementedError(
            f"nbit={plan.nbit}, npw={plan.npw}: the fused step is ported for "
            "8-bit input only; see " + _KERNEL_ITEM)
    if not plan.real_input:
        raise NotImplementedError(
            "analytic (complex) input on the fused step; see " + _KERNEL_ITEM)
    if plan.interleave != "tfp":
        raise NotImplementedError(
            f"{plan.interleave} byte layout on the fused step; see "
            + _KERNEL_ITEM)


def unpack_affine(nbit: int, twos_complement: bool = False) -> Tuple[float, float]:
    """(scale, offset) such that value = code * scale + offset reproduces
    the BitTable uniform level map.  Offset binary: the code is the unsigned
    field value; two's complement: the SIGNED field value."""
    from ..unpack.bittable import BitTable, CodeType

    if nbit == 32:
        return 1.0, 0.0
    n = 1 << nbit
    table = BitTable(nbit, CodeType.TWOS_COMPLEMENT if twos_complement
                     else CodeType.OFFSET_BINARY)
    asc = np.sort(table.values.astype(np.float64))
    step = float((asc[-1] - asc[0]) / (n - 1)) if n > 1 else 2.0
    if twos_complement:
        if nbit not in (2, 4, 8):
            raise NotImplementedError(
                "two's-complement codes are 2/4/8-bit")
        return step, float(asc[0]) + (n // 2) * step
    return step, float(asc[0])


def window_weight_spans(plan: MegaPlan, npart: int):
    """[(a, b)] weight-block index span covered by each window (the
    conservative convolve_weights rule: any bad block zeroes the window)."""
    spans = []
    for w in range(npart):
        a = (w * plan.nsamp_step) // plan.npw
        b = (w * plan.nsamp_step + plan.nsamp_fft) // plan.npw
        spans.append((a, b))
    return spans


@dataclass(frozen=True)
class MegaConstants:
    """What the fused step reads besides the data: the per-input-channel
    chirp and the unpack map.

    ``gr``/``gi`` are float32 ``[nchan_in, n_fft]`` in natural bin order;
    they equal the JAX package's ``MegaConstants.gr/gi`` bitwise after
    undoing its ``[k1, k2]`` permutation (``convert.constants_from_numpy``).
    Built by :meth:`build` as numpy arrays; :meth:`to` gives tensors.
    """

    gr: object
    gi: object
    unpack_scale: float = 1.0
    unpack_offset: float = 0.0

    @classmethod
    def build(cls, plan: MegaPlan, response_natural: Optional[np.ndarray],
              unpack_scale: float = 1.0, unpack_offset: float = 0.0,
              twobit=None, window: Optional[np.ndarray] = None,
              jones: Optional[np.ndarray] = None) -> "MegaConstants":
        """The JAX package's float64 formulas for the arrays this slice
        reads.  ``jones``, ``window`` and ``twobit`` raise."""
        if jones is not None:
            raise NotImplementedError(
                "Jones response on the fused step; see " + _NEXT_SLICE)
        if window is not None:
            raise NotImplementedError(
                "apodization on the fused step; see " + _KERNEL_ITEM)
        if twobit is not None or plan.npw:
            raise NotImplementedError(
                "JA98 2-bit levels on the fused step; see " + _KERNEL_ITEM)
        check_supported(plan)
        N = plan.n_fft
        if response_natural is not None:
            flat = np.asarray(response_natural).reshape(
                plan.nchan_in, N).astype(np.complex128)
        else:
            flat = np.ones((plan.nchan_in, N), np.complex128)
        return cls(gr=np.ascontiguousarray(flat.real).astype(np.float32),
                   gi=np.ascontiguousarray(flat.imag).astype(np.float32),
                   unpack_scale=float(unpack_scale),
                   unpack_offset=float(unpack_offset))

    def to(self, device) -> "MegaConstants":
        """A copy whose arrays are float32 tensors on ``device``."""
        return dataclasses.replace(
            self,
            gr=torch.as_tensor(self.gr, dtype=torch.float32).to(device),
            gi=torch.as_tensor(self.gi, dtype=torch.float32).to(device))


# --------------------------------------------------------------------------
# the step
# --------------------------------------------------------------------------

#: detection codes shared with csrc/megastep.cu (enum Det)
DET_ONE, DET_SUM, DET_PPQQ, DET_COH, DET_STOKES = range(5)


def fold_pols(plan: MegaPlan) -> Tuple[int, ...]:
    """Input pols the step transforms: PP/QQ fold one pol's power only."""
    return {"pp": (0,), "qq": (1,)}.get(plan.detection,
                                        tuple(range(plan.npol)))


def detection_code(plan: MegaPlan) -> int:
    if len(fold_pols(plan)) == 1:
        return DET_ONE
    if plan.npol_out == 1:
        return DET_SUM
    if plan.npol_out == 2:
        return DET_PPQQ
    return DET_COH if plan.detection == "coherence" else DET_STOKES


def bounds_pair(bounds) -> Tuple[int, int]:
    """``[lo, hi)`` block output-sample span as host ints; ``None`` means
    the whole block."""
    if bounds is None:
        return 0, (1 << 31) - 1
    lo, hi = (int(b) for b in bounds)
    return lo, hi


def _detect_plain(v: torch.Tensor, plan: MegaPlan) -> torch.Tensor:
    """[nchan, npolf, ...] complex voltages -> [nchan, nplane, ...]."""
    det = detection_code(plan)
    a = v[:, 0]
    pp = a.real * a.real + a.imag * a.imag
    if det == DET_ONE:
        planes = [pp]
    else:
        b = v[:, 1]
        qq = b.real * b.real + b.imag * b.imag
        if det == DET_SUM:
            planes = [pp + qq]
        elif det == DET_PPQQ:
            planes = [pp, qq]
        else:
            re = a.real * b.real + a.imag * b.imag
            im = a.real * b.imag - a.imag * b.real
            if det == DET_COH:
                planes = [pp, qq, re, im]
            else:
                planes = [pp + qq, pp - qq, 2 * re, 2 * im]
            if plan.fourth_moment:
                planes = planes + [planes[i] * planes[j]
                                   for i in range(4) for j in range(i, 4)]
    return torch.stack(planes, dim=1)


def fold_bins(plan: MegaPlan, phi0: torch.Tensor,
              dphi: torch.Tensor) -> torch.Tensor:
    """Phase bin of every kept sample, int64 ``[npart, nkeep]``, in float32
    exactly as the reference computes it (one op per rounding)."""
    return compute_bins(phi0, dphi, plan.nkeep, plan.nbin).reshape(
        phi0.shape[0], plan.nkeep)


def _front_plain(plan: MegaPlan, cst: MegaConstants, raw: torch.Tensor,
                 npart: int, dtype, passband: bool = False, gr=None,
                 gi=None):
    """The front end both plain steps share: unpack, ``rfft`` of each
    window (Nyquist dropped), chirp (``gr``/``gi``, default the
    constants'), per-subband ``ifft`` (kept samples only) and detection, in
    ``dtype``.  Returns ``[nchan_in, nplane, npart, nsub, nkeep]`` and the
    passband (``None`` unless asked for): ``[nchan_in, npol, n_fft]``, the
    sum over windows of every input pol's ``|X|^2`` before the chirp."""
    p = plan
    check_supported(p)
    cdtype = torch.complex128 if dtype == torch.float64 else torch.complex64
    nchan, M = p.nchan_in, p.freq_res
    codes = raw.view(torch.int8) if p.twos_complement else raw
    x = codes.to(dtype) * cst.unpack_scale + cst.unpack_offset
    x = x.reshape(p.block_ndat(npart), nchan, p.npol).permute(1, 2, 0)
    pols = list(fold_pols(p))
    if not passband:
        x = x[:, pols]
    win = x.unfold(-1, p.nsamp_fft, p.nsamp_step)  # [nchan, npolf, npart, 2N]
    spec = torch.fft.rfft(win, dim=-1)[..., :p.n_fft]
    pb = None
    if passband:
        pb = torch.sum(spec.real * spec.real + spec.imag * spec.imag, dim=2)
        spec = spec[:, pols]
    gr = cst.gr if gr is None else gr
    gi = cst.gi if gi is None else gi
    spec = spec * torch.complex(gr, gi).to(cdtype)[:, None, None, :]
    sub = spec.reshape(nchan, -1, npart, p.nsub, M)
    v = torch.fft.ifft(sub, dim=-1)[..., p.nfilt_pos:p.nfilt_pos + p.nkeep]
    return _detect_plain(v, p), pb


def megastep_plain(plan: MegaPlan, cst: MegaConstants, profiles: torch.Tensor,
                   hits: torch.Tensor, raw: torch.Tensor, phi0: torch.Tensor,
                   dphi: torch.Tensor, bounds=None):
    """Plain PyTorch version of the fused step (``torch.fft`` and
    ``index_add_``), in the dtype of ``profiles`` (float32 or float64); the
    phase is float32 whatever that dtype.

    profiles ``[nchan_in, nplane, nsub, nbin]``, hits ``[nchan_in, nbin]``,
    raw uint8 flat TFP bytes of one block, phi0/dphi ``[npart]`` per-window
    anchors, bounds ``None`` or ``(lo, hi)``.  Returns new
    ``(profiles, hits)``.
    """
    p = plan
    npart = phi0.shape[0]
    dtype = profiles.dtype
    nchan = p.nchan_in
    planes, _ = _front_plain(p, cst, raw, npart, dtype)

    lo, hi = bounds_pair(bounds)
    g = torch.arange(npart * p.nkeep, device=raw.device)
    keep = ((g >= lo) & (g < hi)).to(dtype)
    idx = fold_bins(p, phi0, dphi).reshape(-1)
    data = planes.permute(0, 1, 3, 2, 4).reshape(
        nchan, p.nplane, p.nsub, npart * p.nkeep) * keep
    blk = torch.zeros(nchan, p.nplane, p.nsub, p.nbin, dtype=dtype,
                      device=raw.device)
    blk.index_add_(3, idx, data)
    hblk = torch.zeros(p.nbin, dtype=hits.dtype, device=raw.device)
    hblk.index_add_(0, idx, keep.to(hits.dtype))
    return profiles + blk, hits + hblk[None, :]


def build_megastep(plan: MegaPlan, cst: MegaConstants, npart: int):
    """The fused fold step for ``npart`` windows a block:
    ``step(profiles, hits, raw, phi0, dphi, bounds=None) -> (profiles,
    hits)``.  On CUDA tensors it launches the hand-written kernel
    (``kernels.megastep.megastep_cuda``); on CPU tensors it runs
    :func:`megastep_plain`.  ``cst`` holds tensors on the step's device."""
    plan.validate()
    check_supported(plan)

    def step(profiles, hits, raw, phi0, dphi, bounds=None):
        if phi0.shape != (npart,):
            raise ValueError(f"phi0 shape {tuple(phi0.shape)} != ({npart},)")
        if raw.is_cuda:
            from ..kernels.megastep import megastep_cuda

            return megastep_cuda(plan, cst, profiles, hits, raw, phi0, dphi,
                                 bounds)
        return megastep_plain(plan, cst, profiles, hits, raw, phi0, dphi,
                              bounds)

    return step


# --------------------------------------------------------------------------
# the search front end (detected filterbank, no fold)
# --------------------------------------------------------------------------

def passband_layout(plan: MegaPlan, pb: torch.Tensor) -> torch.Tensor:
    """Passband ``[nchan_in, npol, n_fft]`` in natural bin order ->
    ``[nchan_in*nsub, npol, freq_res]`` by output channel (the JAX
    package's ``_depermute_pb`` for real input)."""
    p = plan
    npol = pb.shape[1]
    return pb.reshape(p.nchan_in, npol, p.nsub, p.freq_res).permute(
        0, 2, 1, 3).reshape(p.nchan_in * p.nsub, npol, p.freq_res)


def megafil_plain(plan: MegaPlan, cst: MegaConstants, raw: torch.Tensor,
                  npart: int, dtype=torch.float32, passband: bool = False,
                  gr=None, gi=None):
    """Plain PyTorch version of the fused search front end (``torch.fft``),
    in ``dtype`` (float32 or float64): raw uint8 flat TFP bytes of one block
    -> detected, time-ordered ``[nchan_in*nsub, nplane, npart*nkeep]``
    (output channel ``c*nsub + s``); with ``passband`` also the pre-chirp
    passband ``[nchan_in*nsub, npol, freq_res]`` of every input pol, summed
    over the block's windows.  ``gr``/``gi`` replace the constants' chirp
    (float ``[nchan_in, n_fft]``, natural bin order)."""
    p = plan
    planes, pb = _front_plain(p, cst, raw, npart, dtype, passband, gr, gi)
    # [nchan, nplane, npart, nsub, nkeep] -> [nchan, nsub, nplane, npart,
    # nkeep]: time order within each output channel
    data = planes.permute(0, 3, 1, 2, 4).reshape(
        p.nchan_in * p.nsub, p.nplane, npart * p.nkeep)
    if not passband:
        return data
    return data, passband_layout(p, pb)


def build_megafil(plan: MegaPlan, cst: MegaConstants, npart: int,
                  output: str = "detected", passband: bool = False,
                  return_weights: bool = False,
                  response_as_args: bool = False,
                  jones_as_args: bool = False):
    """The fused search front end for ``npart`` windows a block (the JAX
    package's ``build_megafil``, detected output).  ``step(raw)``, or
    ``step(raw, gr, gi)`` with ``response_as_args``, returns
    ``data[, wgt][, pb]``:

    - ``data``: float32 ``[nchan_in*nsub, nplane, npart*nkeep]`` detected,
      time-ordered filterbank samples;
    - ``wgt`` (``return_weights``): per-window excision weights ``[nchan_in,
      npart]``, all ones (8-bit input has no JA98 excision);
    - ``pb`` (``passband``): the pre-chirp passband ``[nchan_in*nsub, npol,
      freq_res]`` of every input pol, summed over the block's windows.

    ``gr``/``gi`` are the chirp (times, say, an RFI zap mask) float32
    ``[nchan_in, n_fft]`` in natural bin order.  The JAX package keeps its
    response in the permuted ``[k1, k2]`` layout of its TPU kernel and
    permutes every traced mask to match (``permute_response``); here the
    chirp and the passband are both in natural order, so a mask multiplies
    the chirp as it is and no permutation exists.

    On CUDA tensors the step launches the hand-written kernel
    (``kernels.megafil.megafil_cuda``); on CPU tensors it runs
    :func:`megafil_plain`.  ``cst`` holds tensors on the step's device.
    The voltage output and the traced Jones planes raise
    ``NotImplementedError``, as do fourth moments (the JAX kernel refuses
    them too)."""
    if output not in ("detected", "voltage"):
        raise ValueError(f"unknown output mode: {output}")
    uncovered = (
        (output == "voltage", "output='voltage'", _NEXT_SLICE),
        (jones_as_args, "jones_as_args=True", _NEXT_SLICE),
        (plan.fourth_moment, "fourth moments (applied after the front end)",
         "ROADMAP.md Queue 1 item 6 (the hybrid tail applies them)"),
    )
    for bad, what, item in uncovered:
        if bad:
            raise NotImplementedError(
                f"{what} on the fused search front end; see {item}")
    plan.validate()
    check_supported(plan)

    def step(raw, *resp):
        if len(resp) != (2 if response_as_args else 0):
            raise TypeError("step(raw, gr, gi) with response_as_args, else "
                            "step(raw)")
        gr, gi = resp if resp else (None, None)
        if raw.is_cuda:
            from ..kernels.megafil import megafil_cuda

            res = megafil_cuda(plan, cst, raw, npart, passband, gr, gi)
        else:
            res = megafil_plain(plan, cst, raw, npart, passband=passband,
                                gr=gr, gi=gi)
        if not (passband or return_weights):
            return res
        data, pb = res if passband else (res, None)
        out = [data]
        if return_weights:
            out.append(torch.ones((plan.nchan_in, npart), dtype=torch.float32,
                                  device=raw.device))
        if passband:
            out.append(pb)
        return tuple(out)

    return step
