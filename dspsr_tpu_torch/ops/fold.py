"""Pulse-phase folding: geometry, phase anchors and the fold of a detected
block.

Counterpart of ``dspsr_tpu/ops/fold.py``.  The predictor is evaluated on the
host in float64 at the start of each phase-anchor segment (one overlap-save
window on the fused paths); the device adds ``i * dphi`` in float32 within
the segment, one operation per rounding as the reference does, so the
anchors and the phase bins are identical to the reference's.

``fold_block`` (the hybrid engine's fold) is the reference's one-hot matmul
written as ``index_add_`` over the bins: the one-hot operand would be
``ndat * nbin * 4`` bytes (1.08 GB a flagship block).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Tuple

import numpy as np
import torch

from ..timing.mjd import MJD


@dataclass(frozen=True)
class FoldPlan:
    """Static fold geometry."""

    nbin: int
    seg_len: int  # output samples per phase-anchor segment


def choose_nbin(period: float, tsamp: float, requested: int = 0,
                maximum: int = 1024) -> int:
    """Reference ``Fold::choose_nbin`` (``Fold.C:275-382``): the largest
    power of two <= period/(1.2*tsamp), capped at ``maximum``, unless
    ``requested``."""
    if requested:
        return requested
    limit = period / (1.2 * tsamp)
    nbin = 1
    while nbin * 2 <= limit and nbin * 2 <= maximum:
        nbin *= 2
    return max(nbin, 2)


def compute_anchors(predictor, start_time: MJD, tsamp: float, ndat: int,
                    seg_len: int) -> Tuple[np.ndarray, np.ndarray]:
    """Float64 phase anchors for one block: (phi0[nseg] fractional turns at
    segment starts, dphi[nseg] phase per sample), both float32."""
    nseg = ndat // seg_len
    offsets = np.arange(nseg, dtype=np.int64) * seg_len
    phi0 = predictor.phase_anchors(start_time, tsamp, offsets)
    dphi = np.empty(nseg, dtype=np.float64)
    for i, off in enumerate(offsets):
        t = start_time + float(off) * tsamp
        dphi[i] = tsamp * predictor.frequency(t)
    return phi0.astype(np.float32), dphi.astype(np.float32)


def compute_bins(phi0: torch.Tensor, dphi: torch.Tensor, seg_len: int,
                 nbin: int) -> torch.Tensor:
    """Phase bin of every sample, int64 ``[nseg * seg_len]``, from float32
    segment anchors ``phi0``/``dphi [nseg]`` (``Fold.C:766-770``)."""
    i = torch.arange(seg_len, dtype=torch.float32, device=phi0.device)
    phase = phi0.float()[:, None] + dphi.float()[:, None] * i[None, :]
    frac = phase - torch.floor(phase)
    bins = torch.floor(frac * float(nbin)).long()
    return bins.clamp_(0, nbin - 1).reshape(-1)


def fold_block(profiles: torch.Tensor, hits: torch.Tensor, x: torch.Tensor,
               weights: torch.Tensor, phi0: torch.Tensor, dphi: torch.Tensor,
               plan: FoldPlan) -> Tuple[torch.Tensor, torch.Tensor]:
    """Fold one block into carried accumulators; returns new
    ``(profiles, hits)``.

    ``profiles [nchan, npol, nbin]``, ``hits [nchan, nbin]``, detected ``x
    [nchan, npol, ndat]``, ``weights [nchan, ndat]`` (0 drops a sample,
    ``Fold.C:782-788``), anchors ``phi0``/``dphi [nseg]``.  Samples past
    ``nseg * seg_len`` are not folded.
    """
    nchan, npol, ndat = x.shape
    n = (ndat // plan.seg_len) * plan.seg_len
    bins = compute_bins(phi0, dphi, plan.seg_len, plan.nbin)[:n]
    w = weights[:, :n].to(profiles.dtype)
    prof = torch.zeros_like(profiles).index_add_(
        2, bins, x[:, :, :n].to(profiles.dtype) * w[:, None, :])
    h = torch.zeros_like(hits).index_add_(1, bins, w.to(hits.dtype))
    return profiles + prof, hits + h
