"""The fused fold step: unpack -> filterbank(+chirp) -> detect -> fold.

Counterpart of ``dspsr_tpu/ops/megakernel.py``.  One call folds a whole
block of raw bytes into carried ``profiles [nchan_in, nplane, nsub, nbin]``
and ``hits [nchan_in, nbin]``:

1. unpack: 8-bit codes (TFP order or the CASPSR layout,
   ``unpack.unpackers.reorder_bytes_tfp``) and fixed-level 1/2/4-bit fields
   (two's-complement fields wrap to signed first) as ``code * scale +
   offset``; float32 samples as they are; 2-bit codes with JA98 dynamic
   levels (``plan.npw > 0``) as ``sign * (lo or hi)[nlow]`` of their
   ``npw``-sample block, whose excision weights give each window a weight
   of 0 or 1 (``window_weights``) that multiplies its folded samples and
   hits;
2. forward FFT of each overlap-save window, times the apodization window
   when there is one: real input, ``2N`` samples,
   bins ``0..N-1`` kept (Nyquist dropped); complex (analytic) input, ``N``
   complex samples ``re + i im``, all bins kept, ``fftshift``-ed so that
   natural bin ``j`` is FFT bin ``(j + N/2) mod N`` (the JAX package's
   order).  ``N = nsub * freq_res``;
3. multiply the input channel's dedispersion chirp (natural bin order);
   on the search front end, optionally mix the two input pols' spectra
   with a Jones response first (matrix convolution);
4. inverse FFT of each subband's ``freq_res`` bins, scaled by
   ``1/freq_res``, keeping ``nfilt_pos <= t < nfilt_pos + nkeep``
   (``nsub == 1``: the overlap-save convolution, one inverse of ``n_fft``
   points);
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
and returns the detected samples in time order instead of folding them, or
steps 1-4 and the undetected voltage (the cyclic fold's input), optionally
with the pre-chirp passband and with the chirp handed in per call (the
hybrid fold engine's front end); its kernel is ``kernels.megafil``.  Both
plain versions share one front end (``_front_plain``).
``inverse_subbands_twopass`` is the plain twin of the kernels' multi-pass
inverse (the two-pass split they run past one CTA), for the tests.

The TPU kernel's dense DFT, twiddle and row-select matrices are not ported:
they existed for the TPU's matrix unit, and the Hopper kernels run
register-resident FFTs with twiddle tables built by their wrapper instead.
The JAX package also folds the complex input's ``fftshift`` into its chirp
(a ``-N/2`` roll) and its inverse matrix; here the chirp, the passband and
the spectra between the kernels' passes are all in natural (centred) bin
order, so no roll exists outside ``convert``.
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass
from typing import Optional, Tuple

import numpy as np
import torch

from ..device import count_bytes
from ..unpack.unpackers import (
    bytes_to_codes, reorder_bytes_tfp, twobit_levels, twobit_nlow)
from .fold import compute_bins

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
    nbit: int = 8      # input bits per sample (1, 2, 4, 8 or 32)
    real_input: bool = True  # Nyquist (real) vs analytic (complex) input
    nchan_in: int = 1  # input channels, each its own convolving filterbank
    #: samples per JA98 correction/excision block (> 0: dynamic 2-bit)
    npw: int = 0
    #: "auto" maps npol_out 1/2/4 -> Intensity/PPQQ/Stokes; "pp"/"qq" fold
    #: one polarization's power; "coherence" folds PP, QQ, Re[p*q], Im[p*q]
    detection: str = "auto"
    #: fold the 10 unique second-order Stokes products too (14 planes)
    fourth_moment: bool = False
    #: two's-complement codes, 2/4/8-bit (an affine map of the signed field)
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


def window_weights(plan: MegaPlan, w_chan: torch.Tensor,
                   npart: int) -> torch.Tensor:
    """Each window's weight ``[nchan_in, npart]`` from the blocks' weights
    ``w_chan [nchan_in, nweights]``: the least over the window's span of
    :func:`window_weight_spans` (npw divides both the step and the
    window, so the spans are one sliding window of blocks)."""
    p = plan
    spans = w_chan.unfold(-1, p.nsamp_fft // p.npw, p.nsamp_step // p.npw)
    return spans[:, :npart].amin(dim=-1)


def twobit_plain(plan: MegaPlan, cst: "MegaConstants", codes: torch.Tensor,
                 npart: int):
    """The JA98 pre-pass of the fused kernels (``mega_ja98``), plain: 2-bit
    ``codes [nchan_in, npol, ndim, T]`` -> the low-state counts ``nlow``
    int64 ``[nchan_in, npol, ndim, T // npw]`` and the window weights
    float32 ``[nchan_in, npart]``."""
    p = plan
    nlow = twobit_nlow(codes, p.npw)
    w_dig = cst.twobit[2][nlow]
    w_chan = w_dig.reshape(p.nchan_in, p.npol * p.ndim, -1).amin(dim=1)
    return nlow, window_weights(p, w_chan, npart)


@dataclass(frozen=True)
class MegaConstants:
    """What the fused step reads besides the data: the per-input-channel
    chirp, the optional Jones response, the unpack map, the JA98 tables and
    the apodization window.

    ``gr``/``gi`` are float32 ``[nchan_in, n_fft]`` in natural bin order
    (for complex input the centred order of ``fftshift``); they equal the
    JAX package's ``MegaConstants.gr/gi`` bitwise after undoing its ``[k1,
    k2]`` permutation and, for complex input, its ``-N/2`` roll
    (``convert.constants_from_numpy``).  ``jones`` (search front end only)
    is ``None`` or float32 ``[nchan_in, 4, n_fft, 2]``: the complex 2x2
    response ``J[a, b]`` of each bin as plane ``2a + b``, (re, im) last, in
    the same bin order (``convert.jones_from_numpy`` from the JAX package's
    ``jxr/jxi``).  With it the output pol ``p`` is ``J[p, 0] X_0 + J[p, 1]
    X_1``, and the scalar chirp multiplies after the mix (reference
    ``ResponseProduct``; ones when the Jones response carries the chirp).
    ``twobit`` (JA98 plans, ``npw > 0``) is float32 ``[3, npw + 1]``: the
    low and high output levels and the excision weight of each low-state
    count nlow (``unpack.twobit.TwoBitCorrection``, the JAX package's
    tables bit for bit).  ``window`` is ``None`` or the apodization taper,
    float32 ``[nsamp_fft]`` in sample order (the JAX package keeps the same
    values as ``apod [R1, row_len]``).  Built by :meth:`build` as numpy
    arrays; :meth:`to` gives tensors.
    """

    gr: object
    gi: object
    unpack_scale: float = 1.0
    unpack_offset: float = 0.0
    jones: object = None
    twobit: object = None
    window: object = None

    @classmethod
    def build(cls, plan: MegaPlan, response_natural: Optional[np.ndarray],
              unpack_scale: float = 1.0, unpack_offset: float = 0.0,
              twobit=None, window: Optional[np.ndarray] = None,
              jones: Optional[np.ndarray] = None) -> "MegaConstants":
        """The JAX package's float64 formulas for the arrays the step
        reads.  ``jones`` is the natural-order complex ``[nchan_in, n_fft,
        2, 2]`` Jones response (``ops.polncal``), or None; ``twobit`` a
        ``TwoBitCorrection`` for a JA98 plan (default: one of ``plan.npw``
        samples a block; ignored when the plan has none); ``window`` the
        ``nsamp_fft``-sample taper (``ops.apodization.build_window``)."""
        N = plan.n_fft
        if response_natural is not None:
            flat = np.asarray(response_natural).reshape(
                plan.nchan_in, N).astype(np.complex128)
        else:
            flat = np.ones((plan.nchan_in, N), np.complex128)
        jn = None
        if jones is not None:
            if plan.npol != 2:
                raise ValueError("Jones response needs npol == 2")
            jn = np.asarray(jones).astype(np.complex128)
            if jn.shape != (plan.nchan_in, N, 2, 2):
                raise ValueError(f"jones shape {jn.shape} != "
                                 f"({plan.nchan_in}, {N}, 2, 2)")
            jn = jones_planes(jn)
        tables = None
        if plan.npw:
            if twobit is None:
                from ..unpack.twobit import TwoBitCorrection

                twobit = TwoBitCorrection(ndat_per_weight=plan.npw)
            if twobit.ndat_per_weight != plan.npw:
                raise ValueError("twobit.ndat_per_weight != plan.npw")
            tables = np.stack([*twobit.level_tables, twobit.weight_table])
        win = None
        if window is not None:
            win = np.asarray(window, np.float64).reshape(-1).astype(np.float32)
            if win.size != plan.nsamp_fft:
                raise ValueError("window length != nsamp_fft")
        return cls(gr=np.ascontiguousarray(flat.real).astype(np.float32),
                   gi=np.ascontiguousarray(flat.imag).astype(np.float32),
                   unpack_scale=float(unpack_scale),
                   unpack_offset=float(unpack_offset), jones=jn,
                   twobit=tables, window=win)

    def to(self, device) -> "MegaConstants":
        """A copy whose arrays are float32 tensors on ``device``."""
        def f32(a):
            return (None if a is None
                    else torch.as_tensor(a, dtype=torch.float32).to(device))

        return dataclasses.replace(
            self, gr=f32(self.gr), gi=f32(self.gi), jones=f32(self.jones),
            twobit=f32(self.twobit), window=f32(self.window))


def jones_planes(jones: np.ndarray) -> np.ndarray:
    """Complex ``[nchan, n, 2, 2]`` Jones matrices -> float32 ``[nchan, 4,
    n, 2]`` (plane ``2a + b``, then re, im): the layout of
    ``MegaConstants.jones``."""
    jn = np.asarray(jones)
    planes = jn.reshape(jn.shape[0], jn.shape[1], 4).transpose(0, 2, 1)
    return np.ascontiguousarray(
        np.stack([planes.real, planes.imag], axis=-1)).astype(np.float32)


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


def voltage_sign_flips(plan: MegaPlan) -> bool:
    """Whether the voltage output owes the ``(-1)^t`` factor of the
    reference's per-chunk ``ifftshift`` (``t`` the sample's index in its
    freq_res chunk): with several subbands or complex input, as the JAX
    package restores it (``dspsr_tpu/ops/megakernel.py:1456-1464``).  One
    subband of real input follows the convolution's convention: no shift."""
    return plan.nsub > 1 or not plan.real_input


def raw_nbytes(plan: MegaPlan, npart: int) -> int:
    """Bytes of one block of raw input: ``block_ndat * nchan_in * npol *
    ndim`` samples of ``nbit`` bits (float32 samples: 4 bytes each)."""
    p = plan
    nbits = p.block_ndat(npart) * p.nchan_in * p.npol * p.ndim * p.nbit
    if nbits % 8:
        raise ValueError(f"a block of {nbits} bits is not whole bytes")
    return nbits // 8


def ftp_traffic(plan: MegaPlan, npart: int) -> int:
    """Bytes the fold step's channel-transposing pre-pass moves over one
    block (``mega_ftp`` in ``csrc/mega_common.cuh``): the block's codes
    read once and the copy's samples written once (its padding is not
    written; sub-byte units are written a byte a code).  0 where the step
    runs no pre-pass of its own: one input channel, and JA98 codes, whose
    copy ``mega_ja98`` makes as it counts."""
    p = plan
    if p.nchan_in == 1 or p.npw:
        return 0
    npd = p.npol * p.ndim
    bits = npd * p.nbit
    unit = npd if bits < 8 else bits // 8
    return raw_nbytes(p, npart) + p.nchan_in * p.block_ndat(npart) * unit


def _channel_major(plan: MegaPlan, x: torch.Tensor, npart: int, span):
    """TFP samples or codes ``x`` as ``[nchan_in, npol, ndim,
    block_ndat]``; where the fold step's pre-pass would run
    (:func:`ftp_traffic`) and ``span`` is given, made contiguous inside
    ``span("ftp")``: the plain step's channel transpose, timed."""
    p = plan
    x = x.reshape(p.block_ndat(npart), p.nchan_in, p.npol, p.ndim).permute(
        1, 2, 3, 0)
    if span is None or not ftp_traffic(p, npart):
        return x
    with span("ftp"):
        return x.contiguous()


def _unpack_plain(plan: MegaPlan, cst: MegaConstants, raw: torch.Tensor,
                  npart: int, dtype, span=None):
    """The plain unpack of one block of raw bytes: the samples
    ``[nchan_in, npol, ndim, block_ndat]`` in ``dtype`` and, for a JA98
    plan, the window weights ``[nchan_in, npart]`` (else None).  ``span``
    as :func:`_channel_major`."""
    p = plan
    if p.nbit == 32:
        return _channel_major(p, raw.view(torch.float32), npart, span).to(
            dtype), None
    raw = reorder_bytes_tfp(raw, p.interleave, p.npol)
    if p.nbit == 8 and p.twos_complement:
        codes = raw.view(torch.int8)
    else:
        codes = bytes_to_codes(raw, p.nbit)
    codes = _channel_major(p, codes, npart, span)
    if p.npw:
        nlow, wgt = twobit_plain(p, cst, codes, npart)
        lo, hi = cst.twobit[0].to(dtype), cst.twobit[1].to(dtype)
        return twobit_levels(codes, nlow, lo, hi, p.npw), wgt
    x = codes.to(dtype)
    if p.twos_complement and p.nbit < 8:
        # sub-byte two's-complement fields wrap to the signed value
        half = 1 << (p.nbit - 1)
        x = torch.where(x >= half, x - 2 * half, x)
    return x * cst.unpack_scale + cst.unpack_offset, None


def inverse_subbands_twopass(spec: torch.Tensor,
                             plan: MegaPlan) -> torch.Tensor:
    """Each subband's inverse FFT, split into the two passes of the
    kernels' multi-pass inverse (``mega_inva`` and pass B in
    ``csrc/mega_common.cuh``), indexed as they index it: plain PyTorch, the
    twin of the kernels, which the tests hold against the plain inverse
    (``torch.fft.ifft`` of each subband) and ``mega_reference``; no step
    runs it on the card.

    ``spec [..., n_fft]`` is each window's chirped spectrum in the forward
    FFT's bin order (real input: bins 0..N-1; complex input: unshifted).
    Viewed as ``[k2, k1]`` (bin k = k2*R1 + k1), row k2 lands at the
    kernels' stored row ``js = (k2 + R2/2) mod R2`` for complex input (the
    ``fftshift`` that ``mega_fwd2c`` makes as it stores, the column shift of
    the JAX package's block-diagonal matrix), at ``k2`` for real input;
    subband ``s`` is stored rows ``s*q .. s*q + q - 1``.  Pass A: the
    length-q inverse over ``k2l`` of each ``(s, k1)``, times ``exp(+2 pi i
    k1 n2 / M)``; pass B: the length-R1 inverse over ``k1`` of each row
    ``(s, n2)``, times ``1/M``; sample ``t = n2 + q*n1``.  Returns ``[...,
    nsub, freq_res]`` complex samples in time order."""
    p = plan
    R1, R2, q, M = p.R1, p.R2, p.q, p.freq_res
    lead = spec.shape[:-1]
    y = spec.reshape(*lead, R2, R1)
    if not p.real_input:
        # stored row js holds FFT row k2 = (js + R2/2) mod R2
        y = y[..., (torch.arange(R2, device=spec.device) + R2 // 2) % R2, :]
    y = y.reshape(*lead, p.nsub, q, R1)  # [s, k2l, k1]
    a = torch.fft.ifft(y, dim=-2) * q  # [s, n2, k1], unscaled
    rdt = spec.real.dtype
    n2 = torch.arange(q, dtype=rdt, device=spec.device)
    k1 = torch.arange(R1, dtype=rdt, device=spec.device)
    a = a * torch.exp(2j * torch.pi * torch.outer(n2, k1) / M)
    x = torch.fft.ifft(a, dim=-1) * (R1 / M)  # [s, n2, n1]
    return x.transpose(-1, -2).reshape(*lead, p.nsub, M)


def _front_plain(plan: MegaPlan, cst: MegaConstants, raw: torch.Tensor,
                 npart: int, dtype, passband: bool = False, gr=None,
                 gi=None, voltage: bool = False, jones=None,
                 twopass: bool = False, span=None):
    """The front end both plain steps share: unpack (:func:`_unpack_plain`),
    the spectrum of each window times the apodization window when there is
    one (real input: ``rfft``, Nyquist dropped; complex input: ``fft`` then
    ``fftshift``, natural centred order), chirp (``gr``/``gi``, default the
    constants'), per-subband ``ifft`` (kept samples only) and detection, in
    ``dtype``.  Returns ``[nchan_in, nplane, npart, nsub, nkeep]``, the
    passband (``None`` unless asked for): ``[nchan_in, npol, n_fft]``, the
    sum over windows of every input pol's ``|X|^2`` before the chirp, and
    the JA98 window weights ``[nchan_in, npart]`` (``None`` without JA98).
    With ``voltage`` the first is the undetected complex ``[nchan_in, npol,
    npart, nsub, nkeep]`` of every input pol instead, with the sign of
    :func:`voltage_sign_flips`.  With a Jones response (``jones``, default
    ``cst.jones``) both input pols are transformed, and output pol ``p`` is
    the mix ``J[p, 0] X_0 + J[p, 1] X_1`` before the scalar chirp slot.
    ``twopass`` runs the inverse as :func:`inverse_subbands_twopass` (for
    the tests) in place of ``torch.fft.ifft``; ``span`` times the channel
    transpose (:func:`_channel_major`)."""
    p = plan
    cdtype = torch.complex128 if dtype == torch.float64 else torch.complex64
    nchan, M = p.nchan_in, p.freq_res
    x, wgt = _unpack_plain(p, cst, raw, npart, dtype, span)
    x = x[:, :, 0] if p.real_input else torch.complex(x[:, :, 0], x[:, :, 1])
    pols = list(range(p.npol)) if voltage else list(fold_pols(p))
    jones = cst.jones if jones is None else jones
    if not passband and jones is None:
        x = x[:, pols]
    win = x.unfold(-1, p.nsamp_fft, p.nsamp_step)  # [nchan, npolf, npart, L]
    if cst.window is not None:
        win = win * cst.window.to(dtype)
    if p.real_input:
        spec = torch.fft.rfft(win, dim=-1)[..., :p.n_fft]
    else:
        spec = torch.fft.fftshift(torch.fft.fft(win, dim=-1), dim=-1)
    pb = None
    if passband:
        pb = torch.sum(spec.real * spec.real + spec.imag * spec.imag, dim=2)
    if jones is not None:
        # matrix convolution (Convolution.C:425-436): [nchan, 4, n_fft]
        J = torch.view_as_complex(jones.to(dtype))[:, :, None, :]
        spec = torch.stack([J[:, 2 * q] * spec[:, 0] + J[:, 2 * q + 1]
                            * spec[:, 1] for q in pols], dim=1)
    elif passband:
        spec = spec[:, pols]
    gr = cst.gr if gr is None else gr
    gi = cst.gi if gi is None else gi
    spec = spec * torch.complex(gr, gi).to(cdtype)[:, None, None, :]
    if twopass:
        fft_order = spec if p.real_input else torch.fft.ifftshift(spec,
                                                                 dim=-1)
        v = inverse_subbands_twopass(fft_order, p)
    else:
        v = torch.fft.ifft(spec.reshape(nchan, -1, npart, p.nsub, M),
                           dim=-1)
    v = v[..., p.nfilt_pos:p.nfilt_pos + p.nkeep]
    if not voltage:
        return _detect_plain(v, p), pb, wgt
    if voltage_sign_flips(p):
        t = torch.arange(p.nfilt_pos, p.nfilt_pos + p.nkeep, device=v.device)
        v = v * (1 - 2 * (t % 2)).to(dtype)
    return v, pb, wgt


def megastep_plain(plan: MegaPlan, cst: MegaConstants, profiles: torch.Tensor,
                   hits: torch.Tensor, raw: torch.Tensor, phi0: torch.Tensor,
                   dphi: torch.Tensor, bounds=None, gr=None, gi=None,
                   weights=None, twopass: bool = False, span=None):
    """Plain PyTorch version of the fused step (``torch.fft`` and
    ``index_add_``), in the dtype of ``profiles`` (float32 or float64); the
    phase is float32 whatever that dtype.

    profiles ``[nchan_in, nplane, nsub, nbin]``, hits ``[nchan_in, nbin]``,
    raw uint8 flat bytes of one block in the plan's layout, phi0/dphi
    ``[npart]`` per-window anchors, bounds ``None`` or ``(lo, hi)``,
    ``gr``/``gi`` the chirp (default the constants', float ``[nchan_in,
    n_fft]``, natural bin order), ``weights`` ``None`` or float
    ``[nchan_in, npart]`` external window weights (the JAX package's
    ``external_weights``: SK or RFI masks computed outside the step).
    Returns new ``(profiles, hits)``.  A JA98 plan's window weights, times
    the external ones, multiply each window's samples and hits (the
    reference's weight in the fold's one-hot, ``mega_reference``).
    ``twopass`` runs the inverse as :func:`inverse_subbands_twopass`.
    ``span(name)``, when given, is a context (a ``RunReport``'s
    ``device``) around the channel transpose of multi-channel input, named
    ``"ftp"``, as ``megastep_cuda`` puts it around its pre-pass.
    """
    p = plan
    npart = phi0.shape[0]
    dtype = profiles.dtype
    nchan = p.nchan_in
    planes, _, wgt = _front_plain(p, cst, raw, npart, dtype, gr=gr, gi=gi,
                                  twopass=twopass, span=span)
    if weights is not None:
        weights = weights.to(dtype)
        wgt = weights if wgt is None else wgt.to(dtype) * weights

    lo, hi = bounds_pair(bounds)
    g = torch.arange(npart * p.nkeep, device=raw.device)
    keep = ((g >= lo) & (g < hi)).to(dtype)[None, :]
    if wgt is not None:
        # [nchan, npart * nkeep]: each sample's window weight
        keep = keep * wgt.to(dtype).repeat_interleave(p.nkeep, dim=1)
    idx = fold_bins(p, phi0, dphi).reshape(-1)
    data = planes.permute(0, 1, 3, 2, 4).reshape(
        nchan, p.nplane, p.nsub, npart * p.nkeep) * keep[:, None, None, :]
    blk = torch.zeros(nchan, p.nplane, p.nsub, p.nbin, dtype=dtype,
                      device=raw.device)
    blk.index_add_(3, idx, data)
    hblk = torch.zeros(nchan, p.nbin, dtype=hits.dtype, device=raw.device)
    hblk.index_add_(1, idx, keep.to(hits.dtype).expand(nchan, -1))
    return profiles + blk, hits + hblk


def build_megastep(plan: MegaPlan, cst: MegaConstants, npart: int,
                   response_as_args: bool = False,
                   external_weights: bool = False, inverse: str = "auto",
                   report=None):
    """The fused fold step for ``npart`` windows a block:
    ``step(profiles, hits, raw, phi0, dphi[, weights | gr, gi],
    bounds=None) -> (profiles, hits)`` (the JAX package's signature).
    With ``external_weights`` it takes ``weights``, float32 ``[nchan_in,
    npart]`` window weights that multiply each window's samples and hits
    (SK or RFI masks computed outside the step; times the JA98 weights of a
    JA98 plan).  With ``response_as_args`` it takes the chirp on each call,
    float32 ``[nchan_in, n_fft]`` in natural bin order (the channel-sharded
    step passes its channel group's rows of the full-band chirp; the JAX
    package passes its permuted ``[nchan_in, R1, R2]`` layout instead).  On
    CUDA tensors it launches the hand-written kernel
    (``kernels.megastep.megastep_cuda``; ``inverse="multipass"`` forces
    its multi-pass inverse where one CTA would do, for checks); on CPU
    tensors it runs :func:`megastep_plain`.  ``cst`` holds tensors on the step's
    device.  ``report``, when given, is called at each step for the run's
    ``RunReport``, whose ``device("ftp")`` span the step puts around its
    channel transpose of multi-channel input.  A Jones response raises: it runs on the hybrid engine's front
    end, as in the JAX package (``load_to_fold.py:1127-1144``)."""
    plan.validate()
    if cst is not None and cst.jones is not None:
        raise NotImplementedError(
            "a Jones response on the fused fold step; the pipeline runs it "
            "on the hybrid engine (build_megafil), as the JAX package does; "
            "see ROADMAP.md Queue 2 item 1")
    if inverse not in ("auto", "multipass"):
        raise ValueError(f"unknown inverse: {inverse}")
    if external_weights and response_as_args:
        raise ValueError("external_weights or response_as_args, not both "
                         "(the JAX package's step takes one or the other)")

    def run(profiles, hits, raw, phi0, dphi, weights, gr, gi, bounds):
        if phi0.shape != (npart,):
            raise ValueError(f"phi0 shape {tuple(phi0.shape)} != ({npart},)")
        span = None if report is None else report().device
        if raw.is_cuda:
            from ..kernels.megastep import megastep_cuda

            return megastep_cuda(plan, cst, profiles, hits, raw, phi0, dphi,
                                 bounds, gr, gi, weights, inverse,
                                 span=span)
        # the plain step's transpose stands for the pre-pass's bytes
        count_bytes("ftp_bytes", ftp_traffic(plan, npart))
        return megastep_plain(plan, cst, profiles, hits, raw, phi0, dphi,
                              bounds, gr, gi, weights, span=span)

    if external_weights:
        def step(profiles, hits, raw, phi0, dphi, weights, bounds=None):
            return run(profiles, hits, raw, phi0, dphi, weights, None, None,
                       bounds)
    elif response_as_args:
        def step(profiles, hits, raw, phi0, dphi, gr, gi, bounds=None):
            return run(profiles, hits, raw, phi0, dphi, None, gr, gi, bounds)
    else:
        def step(profiles, hits, raw, phi0, dphi, bounds=None):
            return run(profiles, hits, raw, phi0, dphi, None, None, None,
                       bounds)

    return step


# --------------------------------------------------------------------------
# the search front end (detected filterbank, no fold)
# --------------------------------------------------------------------------

def passband_layout(plan: MegaPlan, pb: torch.Tensor) -> torch.Tensor:
    """Passband ``[nchan_in, npol, n_fft]`` in natural bin order (centred
    for complex input) -> ``[nchan_in*nsub, npol, freq_res]`` by output
    channel (the JAX package's ``_depermute_pb``)."""
    p = plan
    npol = pb.shape[1]
    return pb.reshape(p.nchan_in, npol, p.nsub, p.freq_res).permute(
        0, 2, 1, 3).reshape(p.nchan_in * p.nsub, npol, p.freq_res)


def megafil_plain(plan: MegaPlan, cst: MegaConstants, raw: torch.Tensor,
                  npart: int, dtype=torch.float32, passband: bool = False,
                  gr=None, gi=None, output: str = "detected",
                  return_weights: bool = False, jones=None,
                  twopass: bool = False):
    """Plain PyTorch version of the fused search front end (``torch.fft``),
    in ``dtype`` (float32 or float64): raw uint8 flat bytes of one block
    -> detected, time-ordered ``[nchan_in*nsub, nplane, npart*nkeep]``
    (output channel ``c*nsub + s``), or with ``output="voltage"`` the
    undetected complex (complex64 or complex128) ``[nchan_in*nsub, npol,
    npart*nkeep]`` of every input pol, signed as the JAX package restores
    it (:func:`voltage_sign_flips`); with ``return_weights`` then the
    window weights float32 ``[nchan_in, npart]`` (JA98 excision, else
    ones); with ``passband`` last the pre-chirp passband ``[nchan_in*nsub,
    npol, freq_res]`` of every input pol, summed over the block's windows.
    ``gr``/``gi`` replace the constants' chirp (float ``[nchan_in, n_fft]``,
    natural bin order), ``jones`` their Jones response (float ``[nchan_in,
    4, n_fft, 2]``, the layout of ``MegaConstants.jones``).  The data are
    not weighted, as in the JAX package.  ``twopass`` runs the inverse as
    :func:`inverse_subbands_twopass`."""
    p = plan
    voltage = output == "voltage"
    planes, pb, wgt = _front_plain(p, cst, raw, npart, dtype, passband, gr,
                                   gi, voltage, jones, twopass)
    # [nchan, nplane, npart, nsub, nkeep] -> [nchan, nsub, nplane, npart,
    # nkeep]: time order within each output channel
    data = planes.permute(0, 3, 1, 2, 4).reshape(
        p.nchan_in * p.nsub, planes.shape[1], npart * p.nkeep)
    out = [data]
    if return_weights:
        out.append(wgt if wgt is not None else torch.ones(
            (p.nchan_in, npart), dtype=torch.float32, device=raw.device))
    if passband:
        out.append(passband_layout(p, pb))
    return out[0] if len(out) == 1 else tuple(out)


def build_megafil(plan: MegaPlan, cst: MegaConstants, npart: int,
                  output: str = "detected", passband: bool = False,
                  return_weights: bool = False,
                  response_as_args: bool = False,
                  jones_as_args: bool = False, inverse: str = "auto"):
    """The fused search front end for ``npart`` windows a block (the JAX
    package's ``build_megafil``).  ``step(raw)``, ``step(raw, gr, gi)``
    with ``response_as_args``, ``step(raw, jones)`` with ``jones_as_args``
    and ``step(raw, gr, gi, jones)`` with both, returns ``data[, wgt][,
    pb]``:

    - ``data``: float32 ``[nchan_in*nsub, nplane, npart*nkeep]`` detected,
      time-ordered filterbank samples; with ``output="voltage"`` the
      undetected complex64 ``[nchan_in*nsub, npol, npart*nkeep]`` of every
      input pol (the JAX package returns the same as a split pair), signed
      by the rule of :func:`voltage_sign_flips` (the cyclic fold's input);
    - ``wgt`` (``return_weights``): per-window excision weights ``[nchan_in,
      npart]``: the JA98 window weights (0 or 1) of a plan with ``npw``,
      else all ones;
    - ``pb`` (``passband``): the pre-chirp passband ``[nchan_in*nsub, npol,
      freq_res]`` of every input pol, summed over the block's windows.

    ``gr``/``gi`` are the chirp (times, say, an RFI zap mask) float32
    ``[nchan_in, n_fft]`` in natural bin order.  The JAX package keeps its
    response in the permuted ``[k1, k2]`` layout of its TPU kernel and
    permutes every traced mask to match (``permute_response``); here the
    chirp and the passband are both in natural order, so a mask multiplies
    the chirp as it is and no permutation exists.  A Jones response mixes
    the two input pols before that chirp (every input pol is then
    transformed): ``cst.jones``, or with ``jones_as_args`` the ``jones``
    handed in on each call, float32 ``[nchan_in, 4, n_fft, 2]`` in the
    layout of ``MegaConstants.jones`` (the channel-sharded step passes its
    channel group's rows of the full-band response; the JAX package passes
    a permuted ``(jxr, jxi)`` pair ``[nchan_in, 4, R1, R2]`` instead).

    On CUDA tensors the step launches the hand-written kernel
    (``kernels.megafil.megafil_cuda``; ``inverse="multipass"`` forces its
    multi-pass inverse where the one-CTA inverse would fit, for checks); on
    CPU tensors it runs :func:`megafil_plain`.  ``cst`` holds tensors on the
    step's device.  Fourth moments raise ``NotImplementedError`` (the JAX
    kernel refuses them too)."""
    if output not in ("detected", "voltage"):
        raise ValueError(f"unknown output mode: {output}")
    if inverse not in ("auto", "multipass"):
        raise ValueError(f"unknown inverse: {inverse}")
    if plan.fourth_moment:
        raise NotImplementedError(
            "fourth moments (applied after the front end) on the fused "
            "search front end; see ROADMAP.md Queue 1 item 6 (the hybrid "
            "tail applies them)")
    if jones_as_args and plan.npol != 2:
        raise ValueError("a Jones response needs npol == 2")
    plan.validate()
    nargs = 2 * response_as_args + jones_as_args

    def step(raw, *args):
        if len(args) != nargs:
            raise TypeError(
                "step(raw[, gr, gi][, jones]): gr, gi with "
                "response_as_args, jones with jones_as_args")
        gr, gi = args[:2] if response_as_args else (None, None)
        jones = args[-1] if jones_as_args else None
        if raw.is_cuda:
            from ..kernels.megafil import megafil_cuda

            return megafil_cuda(plan, cst, raw, npart, passband, gr, gi,
                                output, inverse, return_weights, jones)
        return megafil_plain(plan, cst, raw, npart, passband=passband,
                             gr=gr, gi=gi, output=output,
                             return_weights=return_weights, jones=jones)

    return step
