"""Spectral-kurtosis RFI excision.

Counterpart of ``dspsr_tpu/ops/spectral_kurtosis.py`` (reference
``dsp::SpectralKurtosis`` with SKComputer/SKDetector/SKMasker; estimator
after Nita & Gary 2010): for every channel and cell of M power samples::

    S1 = sum p_i,  S2 = sum p_i^2
    SK = (M+1)/(M-1) * (M * S2 / S1^2 - 1)

A cell whose SK lies outside the Pearson-IV +/- n-sigma thresholds
(``utils.stats.sk_limits``) is zapped.  Three rounds, as in the reference:
per (channel, cell), time-scrunched (one cell per channel over the block)
and frequency-scrunched (S1 and S2 pooled over the channels).  Plain PyTorch
reductions; thresholds are compared in float32, as the JAX package does.

Over channel shards the frequency-scrunched round pools the whole band, as
the JAX package's ``psum`` over its mesh axis does: each shard's
:func:`sk_fscr_sums` are added across the shards, and :func:`sk_mask` reads
the pooled sums with the band's channel count.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Tuple

import numpy as np
import torch

from ..utils.stats import sk_limits

@dataclass(frozen=True)
class SKPlan:
    """Static SK geometry and thresholds (host side)."""

    M: int  # samples per SK cell (reference -skm)
    std_devs: int = 3
    detect_cell: bool = True
    detect_tscr: bool = True
    detect_fscr: bool = True
    #: restrict excision to output channels [chan_start, chan_end)
    #: (--skz_start/--skz_end; 0, 0 = the whole band)
    chan_start: int = 0
    chan_end: int = 0

    def thresholds(self, m: int | None = None) -> Tuple[float, float]:
        t = sk_limits(m or self.M, self.std_devs)
        return t.lower, t.upper


def _f32(x: float) -> float:
    """A threshold rounded to float32, as the JAX package compares it."""
    return float(np.float32(x))


def sk_estimate(p: torch.Tensor, M: int) -> torch.Tensor:
    """SK per cell: ``p [..., nblk, M]`` detected power -> ``[..., nblk]``."""
    s1 = torch.sum(p, dim=-1)
    s2 = torch.sum(p * p, dim=-1)
    Mf = float(M)
    return ((Mf + 1.0) / (Mf - 1.0)) * (
        Mf * s2 / torch.clamp(s1 * s1, min=1e-30) - 1.0)


def _inside(sk: torch.Tensor, lo: float, hi: float) -> torch.Tensor:
    return ((sk > _f32(lo)) & (sk < _f32(hi))).to(torch.float32)


def _cells(power: torch.Tensor, M: int, nblk: int) -> torch.Tensor:
    nchan, npol = power.shape[0], power.shape[1]
    return power[:, :, :nblk * M].reshape(nchan, npol, nblk, M)


def sk_fscr_sums(power: torch.Tensor, plan: SKPlan,
                 nblk: int) -> torch.Tensor:
    """One channel group's share of the frequency-scrunched round: S1 and
    S2 of every (pol, cell) summed over the group's channels, float32
    ``[2, npol, nblk]``.  Added over the channel shards of a block, they
    are :func:`sk_mask`'s ``pooled``."""
    cells = _cells(power, plan.M, nblk)
    return torch.stack([torch.sum(torch.sum(cells, dim=-1), dim=0),
                        torch.sum(torch.sum(cells * cells, dim=-1), dim=0)])


def sk_mask(power: torch.Tensor, plan: SKPlan, nblk: int,
            pooled: torch.Tensor = None, nchan_total: int = 0,
            chan_offset: int = 0) -> torch.Tensor:
    """The SK excision mask of one block: ``power [nchan, npol, ndat]``
    per-pol power ``|x|^2`` (``ndat >= nblk * plan.M``) -> weights
    ``float32 [nchan, nblk]``, 1 keep, 0 zap; a cell is zapped when any pol
    trips.  On a channel shard, ``pooled`` is the band's
    :func:`sk_fscr_sums` (every shard's added), whose thresholds take
    ``Nd = nchan_total``, and ``power``'s first channel is channel
    ``chan_offset`` of the band, for ``--skz_start/--skz_end`` (the JAX
    package's ``axis_name`` form)."""
    nchan, npol = power.shape[0], power.shape[1]
    M = plan.M
    cells = _cells(power, M, nblk)
    w = torch.ones((nchan, nblk), dtype=torch.float32, device=power.device)

    if plan.detect_cell:
        lo, hi = plan.thresholds()
        sk = sk_estimate(cells, M)  # [nchan, npol, nblk]
        w = w * torch.amin(_inside(sk, lo, hi), dim=1)

    if plan.detect_tscr and nblk > 1:
        # one cell of M*nblk samples per (chan, pol): a bad channel zaps
        # all its cells
        lo_t, hi_t = plan.thresholds(M * nblk)
        sk_t = sk_estimate(cells.reshape(nchan, npol, 1, nblk * M),
                           M * nblk)[:, :, 0]
        w = w * torch.amin(_inside(sk_t, lo_t, hi_t), dim=1)[:, None]

    if plan.detect_fscr and (nchan > 1 or pooled is not None):
        # S1/S2 pooled over the channels per (pol, cell): the generalized
        # estimator with Nd = nchan (the band's, when sharded)
        s1f, s2f = (sk_fscr_sums(power, plan, nblk) if pooled is None
                    else pooled)
        Mf = float(M)
        nd = float(nchan if pooled is None else nchan_total)
        sk_f = ((Mf * nd + 1.0) / (Mf * nd - 1.0)) * (
            Mf * nd * s2f / torch.clamp(s1f * s1f, min=1e-30) - 1.0)
        one_std = np.sqrt(4.0 / (M * nd))
        lo_g = 1.0 - plan.std_devs * one_std
        hi_g = 1.0 + plan.std_devs * one_std
        w = w * torch.amin(_inside(sk_f, lo_g, hi_g), dim=0)[None, :]

    if plan.chan_start or plan.chan_end:
        end = plan.chan_end or (nchan if pooled is None else nchan_total)
        ix = torch.arange(nchan, device=power.device) + chan_offset
        in_range = (ix >= plan.chan_start) & (ix < end)
        w = torch.where(in_range[:, None], w, torch.ones_like(w))

    return w


def expand_mask(w: torch.Tensor, M: int) -> torch.Tensor:
    """[nchan, nblk] cell weights -> [nchan, nblk*M] per-sample weights."""
    nchan, nblk = w.shape
    return w[:, :, None].expand(nchan, nblk, M).reshape(nchan, nblk * M)
