"""Phase-locked filterbank: phase-resolved spectra for very slow pulsars.

Counterpart of ``dspsr_tpu/ops/phase_locked.py`` (reference
``dsp::PhaseLockedFilterbank``, ``Signal/Pulsar/PhaseLockedFilterbank.C:
17-260``): instead of channelising then folding (which loses spectral
resolution to the detection window), one short FFT of ``ndat_fft`` samples
is taken at every pulse-phase-bin boundary the predictor gives, and the
detected spectrum is added to that phase bin, giving ``nbin``
phase-resolved spectra of ``nchan`` channels per input channel.  The
reference divides time with ``TimeDivide`` set to ``1/nbin`` turns
(``:38-39``) and takes the first ``ndat_fft`` samples of each division
(``ndat_fft = 2*nchan`` for Nyquist input, ``nchan`` for analytic,
``:100-110``; the division of phase bin ``b`` adds its spectrum and
``hits[b]++``, ``:233-237``).

The phase-boundary walk (data-dependent, float64) runs on the host against
the predictor (``window_plan``) and gives each block's window starts and
phase bins; the device gathers the windows from the unpacked block
(``extract_windows``), transforms them (``ops.fft``), detects, and adds each
window's spectrum to its bin with one ``index_add_`` over the window axis
(``plf_fold_block``), in float32.  This is plain PyTorch: the JAX package
has no Pallas kernel here.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional, Tuple

import numpy as np
import torch

from ..device import host_to_device, resolve_device
from ..timing.mjd import MJD
from . import fft


@dataclass(frozen=True)
class PLFPlan:
    """Static geometry of the phase-locked filterbank.

    nchan: output channels per input channel (FFT length in complex bins).
    nbin: pulse-phase bins (the TimeDivide granularity, 1/nbin turns).
    npol_out: 1 (Intensity), 2 (PPQQ) or 4 (Coherence) — the reference's
      ``set_npol`` check (``PhaseLockedFilterbank.C:41-47``).
    real_input: Nyquist-sampled input (ndat_fft = 2*nchan,
      ``PhaseLockedFilterbank.C:100-104``) or analytic (ndat_fft = nchan).
    """

    nchan: int
    nbin: int
    npol_out: int = 1
    real_input: bool = True

    def __post_init__(self):
        if self.npol_out not in (1, 2, 4):
            raise ValueError(f"npol_out must be 1|2|4, got {self.npol_out}")
        if self.nchan < 2 or self.nbin < 2:
            raise ValueError("need nchan >= 2 and nbin >= 2")

    @property
    def ndat_fft(self) -> int:
        return 2 * self.nchan if self.real_input else self.nchan


def suggest_nchan(period: float, rate: float, nbin: int) -> int:
    """Reference heuristic (``PhaseLockedFilterbank.C:66-76``): the largest
    power of two <= samples available per phase bin."""
    samples_per_bin = period * rate / nbin
    if samples_per_bin < 2:
        raise ValueError("phase bin shorter than 2 samples")
    return 2 ** int(np.floor(np.log2(samples_per_bin)))


def window_plan(
    predictor,
    start_time: MJD,
    rate: float,
    ndat: int,
    plan: PLFPlan,
) -> Tuple[np.ndarray, np.ndarray]:
    """Walk the pulse-phase-bin boundaries across one block (host, float64).

    The reference's TimeDivide loop with ``turns = 1/nbin``
    (``PhaseLockedFilterbank.C:209-240``): each division starts at the next
    multiple of 1/nbin turns; the window is its first ``ndat_fft`` samples;
    the division's phase bin indexes the accumulator.

    Returns (starts int64[nwin] sample offsets into the block,
    bins int32[nwin] phase-bin ids).  Windows that would overrun the block
    are dropped (``phase_locked_fold`` reads the blocks with an overlap, so
    no boundary is lost).
    """
    tsamp = 1.0 / rate
    nbin = plan.nbin
    starts, bins = [], []
    idat = 0
    while True:
        t = start_time + idat * tsamp
        frac = predictor.fracturns(t)
        # next boundary k/nbin at or after frac (within half-sample slop)
        f = predictor.frequency(t)
        slop = 0.5 * tsamp * f * nbin  # half a sample, in bin units
        k = np.ceil(frac * nbin - slop)
        delta_turns = k / nbin - frac
        if delta_turns < 0:
            delta_turns = 0.0
        # Newton refinement of the boundary time (phase is smooth; one
        # correction pass reaches << 1 sample for polyco spans)
        t_b = t + delta_turns / f
        for _ in range(2):
            frac_b = predictor.fracturns(t_b)
            err = frac_b * nbin - k
            err -= np.round(err / nbin) * nbin  # wrap to nearest turn
            t_b = t_b - (err / nbin) / predictor.frequency(t_b)
        off = int(np.ceil((t_b - start_time) * rate - 1e-9))
        if off < idat:
            off = idat
        if off + plan.ndat_fft > ndat:
            break
        starts.append(off)
        bins.append(int(k) % nbin)
        idat = off + 1  # advance past this boundary
        # jump close to the next boundary to keep the walk O(nwin)
        idat = max(idat, off + int(0.9 / (predictor.frequency(t_b) * nbin
                                          * tsamp)))
    return (np.asarray(starts, dtype=np.int64),
            np.asarray(bins, dtype=np.int32))


def extract_windows(x: torch.Tensor, starts: torch.Tensor,
                    ndat_fft: int) -> torch.Tensor:
    """Window gather on ``x``'s device: ``x [..., ndat]`` (float32 or
    complex64) -> ``[nwin, ..., ndat_fft]``, window ``w`` being samples
    ``starts[w]`` to ``starts[w] + ndat_fft - 1``."""
    idx = starts.to(x.device, torch.int64)[:, None] + torch.arange(
        ndat_fft, device=x.device)
    return torch.movedim(x[..., idx], -2, 0)


def _detect_windows(spec: torch.Tensor, npol_out: int) -> torch.Tensor:
    """Complex spectra ``[nwin, nchan_in, npol_in, nchan]`` -> detected
    planes ``[nwin, nchan_in, npol_out, nchan]``."""
    npol_in = spec.shape[2]
    p = spec[:, :, 0]
    pp = p.real ** 2 + p.imag ** 2
    if npol_in == 1:
        if npol_out != 1:
            raise ValueError("npol_out > 1 needs 2 input polarizations")
        return pp[:, :, None]
    q = spec[:, :, 1]
    qq = q.real ** 2 + q.imag ** 2
    if npol_out == 1:
        return (pp + qq)[:, :, None]
    if npol_out == 2:
        return torch.stack([pp, qq], dim=2)
    # Coherence: PP, QQ, Re(P conj(Q)), Im(P conj(Q)) (the JAX package's
    # sign here; ops.detection's coherence takes Im(conj(P) Q))
    repq = p.real * q.real + p.imag * q.imag
    impq = p.imag * q.real - p.real * q.imag
    return torch.stack([pp, qq, repq, impq], dim=2)


def plf_fold_block(
    spectra: torch.Tensor,
    hits: torch.Tensor,
    windows: torch.Tensor,
    bins: torch.Tensor,
    plan: PLFPlan,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Add one block of phase-locked windows.

    Args:
      spectra: float32 ``[nchan_out, npol_out, nbin]``, ``nchan_out =
        nchan_in * plan.nchan`` (input channel major).
      hits: float32 ``[nbin]``: one hit count a bin for every channel, as
        the reference keeps (``PhaseLockedFilterbank.C:233``).
      windows: float32 ``[nwin, nchan_in, npol_in, ndat_fft]`` when
        ``plan.real_input``, else complex64 ``[nwin, nchan_in, npol_in,
        nchan]``.
      bins: ``[nwin]`` phase-bin ids from ``window_plan``.

    Returns the new ``(spectra, hits)``.
    """
    if plan.real_input:
        spec = fft.rfft(windows)  # natural ascending offsets
    else:
        # natural order (the reference band-swaps and records nsub_swap;
        # this emits natural order, as ops.filterbank does)
        spec = fft.fftshift(fft.fft(windows))
    nwin, nchan_in = spec.shape[:2]
    det = _detect_windows(spec, plan.npol_out)
    # [nwin, nchan_in, npol_out, nchan] -> [nwin, nchan_in*nchan*npol_out]
    flat = det.movedim(3, 2).reshape(nwin, -1)
    bins = bins.to(spectra.device, torch.int64)
    acc = torch.zeros((plan.nbin, flat.shape[1]), dtype=spectra.dtype,
                      device=spectra.device).index_add_(0, bins, flat)
    spectra = spectra + acc.T.reshape(nchan_in * plan.nchan, plan.npol_out,
                                      plan.nbin)
    hits = hits + torch.bincount(bins, minlength=plan.nbin).to(hits.dtype)
    return spectra, hits


def plf_fold_numpy(spectra, hits, windows, bins, plan: PLFPlan):
    """Numpy mirror of ``plf_fold_block`` with numpy FFTs, for tests:
    ``windows`` real for real input, complex for analytic."""
    spectra = spectra.copy()
    hits = hits.copy()
    if plan.real_input:
        spec = np.fft.rfft(windows, axis=-1)[..., : plan.nchan]
    else:
        spec = np.fft.fftshift(np.fft.fft(windows, axis=-1), axes=-1)
    npol_in = spec.shape[2]
    pp = np.abs(spec[:, :, 0]) ** 2
    if plan.npol_out == 1:
        det = (pp[:, :, None] if npol_in == 1
               else (pp + np.abs(spec[:, :, 1]) ** 2)[:, :, None])
    elif plan.npol_out == 2:
        det = np.stack([pp, np.abs(spec[:, :, 1]) ** 2], axis=2)
    else:
        pq = spec[:, :, 0] * np.conj(spec[:, :, 1])
        det = np.stack([pp, np.abs(spec[:, :, 1]) ** 2, pq.real, pq.imag],
                       axis=2)
    det = np.moveaxis(det, 3, 2)  # [nwin, nchan_in, nchan, npol_out]
    nwin = det.shape[0]
    flat = det.reshape(nwin, -1, plan.npol_out)
    for w_i in range(nwin):
        spectra[:, :, bins[w_i]] += flat[w_i]
        hits[bins[w_i]] += 1
    return spectra, hits


@dataclass
class PLFResult:
    """Phase-resolved spectra: [nchan_out, npol_out, nbin] + hits[nbin]."""

    spectra: np.ndarray
    hits: np.ndarray
    plan: PLFPlan

    def normalized(self) -> np.ndarray:
        h = np.maximum(self.hits, 1.0)
        return self.spectra / h[None, None, :]


def phase_locked_fold(
    source,
    predictor,
    plan: Optional[PLFPlan] = None,
    *,
    nchan: int = 0,
    nbin: int = 16,
    npol_out: int = 1,
    block_samples: int = 1 << 20,
    max_blocks: Optional[int] = None,
    device="cuda",
) -> PLFResult:
    """The phase-locked filterbank over a Source, on ``device`` (``"cuda"``
    by default; the CPU must be asked for by name).

    Host loop: read a block, copy it to the device, unpack it there, plan
    its windows against the predictor, gather, transform and fold them on
    the device.  Blocks overlap by ``ndat_fft`` samples so that no
    boundary window is lost (InputBuffering's tail carry).
    """
    from ..observation import Signal
    from ..unpack.unpackers import UnpackPlan

    dev = resolve_device(device)
    obs = source.obs
    real_input = obs.state == Signal.NYQUIST
    if plan is None:
        if not nchan:
            period = 1.0 / predictor.frequency(obs.start_time)
            nchan = suggest_nchan(period, obs.rate, nbin)
        plan = PLFPlan(nchan=nchan, nbin=nbin, npol_out=npol_out,
                       real_input=real_input)
    unpack = UnpackPlan(obs)

    nchan_out = obs.nchan * plan.nchan
    spectra = torch.zeros((nchan_out, plan.npol_out, plan.nbin),
                          dtype=torch.float32, device=dev)
    hits = torch.zeros((plan.nbin,), dtype=torch.float32, device=dev)

    total = source.total_samples
    stride = block_samples - plan.ndat_fft  # overlap = ndat_fft
    start = 0
    iblock = 0
    while start + plan.ndat_fft <= total:
        if max_blocks is not None and iblock >= max_blocks:
            break
        n = min(block_samples, total - start)
        raw = host_to_device(np.ascontiguousarray(
            source.read_samples(start, n)), dev)
        x, _w = unpack.unpack(raw)
        t0 = obs.start_time + start / obs.rate
        starts, bins = window_plan(predictor, t0, obs.rate, x.shape[-1],
                                   plan)
        if start + block_samples < total:
            # windows at offset >= stride belong to the next (overlapping)
            # block: keep each boundary exactly once
            keep = starts < stride
            starts, bins = starts[keep], bins[keep]
        if len(starts):
            windows = extract_windows(x, torch.from_numpy(starts),
                                      plan.ndat_fft)
            spectra, hits = plf_fold_block(spectra, hits, windows,
                                           torch.from_numpy(bins), plan)
        start += stride
        iblock += 1
    return PLFResult(spectra.cpu().numpy(), hits.cpu().numpy(), plan)
