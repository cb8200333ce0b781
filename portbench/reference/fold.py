"""Phase and fold of the detected stream at a fixed period (dspsr ``Fold``).

The phase of each window's first kept sample is worked out in float64 as
seconds of the day since the observation's start (an MJD held as whole
days and float64 seconds, as dspsr's ``MJD`` holds it), taken modulo the
period; each window then carries ``(phi0, dphi)`` in float32 and the bin
of its ``i``-th kept sample is ``floor(frac(phi0 + dphi * i) * nbin)``,
each operation rounded to float32 (``Fold.C:766-770``).  That is the
configuration's stated precision for the phase: the reference folds in
float64 what it bins in float32.

The stream is folded into sub-integrations of ``L`` seconds (dspsr
``-L``; ``TimeDivide.C:48-81`` and ``:503-522``): for a whole number of
seconds the divisions start at the multiples of ``L`` within the UTC day,
else at the first output sample; each boundary falls on the output sample
nearest to it, so a block that spans one is folded into both.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from .geometry import Geometry


def anchors(g: Geometry, block: int, start_secs: float,
            period: float) -> tuple:
    """``(phi0, dphi)`` float64 numpy ``[npart]`` of block ``block``:
    the fractional turn at each window's first kept output sample, and the
    turns a sample.  ``start_secs`` is the observation's start in seconds of
    its day."""
    tsamp = 1.0 / g.out_rate
    # the block's first input sample, then the head discard of the filter
    secs = start_secs + (block * g.stride_ndat) / g.rate
    secs = secs + g.nfilt_pos / g.out_rate
    phi0 = np.empty(g.npart)
    for w in range(g.npart):
        t = (secs + float(w * g.nkeep) * tsamp) - start_secs
        ph = math.fmod(t, period) / period
        phi0[w] = ph - math.floor(ph)
    dphi = np.full(g.npart, tsamp * (1.0 / period))
    return phi0, dphi


class Divisions:
    """Sub-integrations of ``seconds`` over the output samples of a stream
    whose output sample 0 is ``start_secs`` seconds into its UTC day."""

    def __init__(self, g: Geometry, start_secs: float, seconds: float):
        self.rate = g.out_rate
        self.start = start_secs + g.nfilt_pos / g.out_rate
        self.seconds = float(seconds)
        if seconds == int(seconds):
            self.ref = math.floor(self.start / seconds) * seconds
        else:
            self.ref = self.start

    def boundary(self, k: int) -> int:
        """Output sample at which division ``k`` starts (negative where it
        starts before the stream)."""
        return int(round((self.ref + k * self.seconds - self.start)
                         * self.rate))

    def of(self, sample: int) -> int:
        """The division that holds output sample ``sample``."""
        k = math.floor((self.start + sample / self.rate - self.ref)
                       / self.seconds)
        while self.boundary(k) > sample:
            k -= 1
        while self.boundary(k + 1) <= sample:
            k += 1
        return k


def bins(phi0: np.ndarray, dphi: np.ndarray, nkeep: int, nbin: int,
         device) -> torch.Tensor:
    """Bin of every kept sample of a block, int64 ``[npart * nkeep]``, in
    float32 one rounding an operation."""
    p0 = torch.from_numpy(phi0.astype(np.float32)).to(device)
    # float32 anchors of 1.0 wrap to 0 (the turn count is dropped)
    p0 = torch.where(p0 >= 1.0, p0 - 1.0, p0)
    dp = torch.from_numpy(dphi.astype(np.float32)).to(device)
    i = torch.arange(nkeep, device=device, dtype=torch.float32)
    step = dp[:, None] * i[None, :]
    phase = p0[:, None] + step
    frac = phase - torch.floor(phase)
    b = torch.floor(frac * float(nbin)).long()
    return b.clamp_(0, nbin - 1).reshape(-1)


def fold(profile: torch.Tensor, hits: torch.Tensor, data: torch.Tensor,
         idx: torch.Tensor) -> None:
    """Add ``data [nsub, n]`` into ``profile [nsub, nbin]`` at bins ``idx
    [n]``, and one a sample into ``hits [nbin]``, in place (in their
    dtype, float64 in the reference and the control alike)."""
    profile.index_add_(1, idx, data.to(profile.dtype))
    hits.index_add_(0, idx, torch.ones_like(idx, dtype=hits.dtype))
