"""Fold geometry and phase anchors (host side).

Counterpart of ``dspsr_tpu/ops/fold.py:42-92``.  The predictor is evaluated
on the host in float64 at the start of each phase-anchor segment (one
overlap-save window on the fused path); the device adds ``i * dphi`` in
float32 within the segment.  The arithmetic and its order are the
reference's, so the float32 anchors are identical.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Tuple

import numpy as np

from dspsr_tpu.timing.mjd import MJD


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
