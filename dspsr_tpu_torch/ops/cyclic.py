"""Cyclic spectroscopy: folding lag products by pulse phase.

Counterpart of ``dspsr_tpu/ops/cyclic.py`` (reference ``dsp::CyclicFold``
and ``CyclicFoldEngine``, ``Signal/Pulsar/CyclicFold.C``; Demorest 2011,
MNRAS 416, 2821): instead of detected power, the complex lag products::

    c_l[t] = x[t + l] * conj(x[t])      l = 0 .. nlag-1

are folded by pulse phase, and the Fourier transform over lag of the folded
(Hermitian) lag function gives the phase-resolved cyclic spectrum, with
structure inside each filterbank channel resolved.  ``nlag = mover *
nchan_cyclic / 2 + 1`` (``CyclicFold.h``).

Plain PyTorch: the JAX package builds the products as XLA ops, not in a
Pallas kernel.  ``fold_lag_products`` folds them a few lags at a time, so a
block never holds all ``2 * npol * nlag`` planes at once (4.5 GB at the
``hybrid_cyclic`` width).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Tuple

import numpy as np
import torch

from .fold import FoldPlan, fold_bins_for

#: bytes of lag products (complex64) one pass of ``fold_lag_products``
#: builds
LAG_PASS_BYTES = 1 << 30


@dataclass(frozen=True)
class CyclicPlan:
    """Static cyclic-fold geometry (reference ``CyclicFold::set_nlag``)."""

    nchan_cyclic: int  # output cyclic channels per input channel
    mover: int = 1  # oversampling factor (channel isolation)

    @property
    def nlag(self) -> int:
        return self.mover * self.nchan_cyclic // 2 + 1


def lag_products(x: torch.Tensor, nlag: int) -> torch.Tensor:
    """Complex lag products of complex voltages ``x [nchan, npol, ndat]``:
    ``[nchan, npol, nlag, ndat - nlag + 1]`` with ``out[..., l, t] = x[...,
    t + l] * conj(x[..., t])`` (every lag over the same valid range)."""
    n = x.shape[-1] - nlag + 1
    return x.unfold(-1, n, 1) * x[..., None, :n].conj()


def lag_planes(x: torch.Tensor, nlag: int) -> torch.Tensor:
    """Lag products as real fold planes: ``[nchan, npol, ndat]`` complex ->
    ``[nchan, npol*nlag*2, ndat-nlag+1]`` real, plane ``(ipol*nlag + l)*2 +
    is_imag``."""
    c = lag_products(x, nlag)
    nchan, npol, _, n = c.shape
    return torch.stack([c.real, c.imag], dim=3).reshape(
        nchan, npol * nlag * 2, n)


def fold_lag_products(profiles: torch.Tensor, hits: torch.Tensor,
                      x: torch.Tensor, nlag: int, weights: torch.Tensor,
                      phi0: torch.Tensor, dphi: torch.Tensor,
                      plan: FoldPlan) -> Tuple[torch.Tensor, torch.Tensor]:
    """``ops.fold.fold_block`` of ``lag_planes(x, nlag)``, built and folded
    a few lags at a time: ``profiles [nchan, npol*nlag*2, nbin]``, ``hits
    [nchan, nbin]``, complex voltages ``x [nchan, npol, ndat]``, ``weights
    [nchan, ndat - nlag + 1]``, anchors ``phi0``/``dphi [nseg]``.  Returns
    new ``(profiles, hits)``."""
    nchan, npol, ndat = x.shape
    nbin = plan.nbin
    n = ndat - nlag + 1
    bins, n = fold_bins_for(phi0, dphi, plan, n)
    w = weights[:, :n].to(profiles.dtype)
    base = x[..., :n].conj()
    lags = x.unfold(-1, n, 1)  # [nchan, npol, nlag, n], a view
    per_lag = nchan * npol * n * x.element_size()
    step = max(1, min(nlag, LAG_PASS_BYTES // max(per_lag, 1)))
    # [nchan, npol, nlag, nbin, (re, im)]: the products' own layout
    acc = torch.zeros((nchan, npol, nlag, nbin, 2), dtype=profiles.dtype,
                      device=profiles.device)
    wv = w[:, None, None, :, None]
    for l0 in range(0, nlag, step):
        l1 = min(nlag, l0 + step)
        prod = torch.view_as_real(lags[:, :, l0:l1] * base[:, :, None])
        acc[:, :, l0:l1].index_add_(3, bins, prod.to(profiles.dtype) * wv)
    prof = acc.permute(0, 1, 2, 4, 3).reshape(nchan, npol * nlag * 2, nbin)
    h = torch.zeros_like(hits).index_add_(1, bins, w.to(hits.dtype))
    return profiles + prof, hits + h


def cyclic_spectra(folded_planes: np.ndarray, nlag: int, mover: int,
                   npol: int = 1) -> np.ndarray:
    """Phase-resolved cyclic spectra from folded lag planes
    (``float64[nchan, npol*nlag*2, nbin]``, hit-normalized): returns
    ``float64[nchan, npol, nbin, nchan_cyclic]``, ``nchan_cyclic =
    2*(nlag-1)//mover``.  The folded lag function is Hermitian in lag, so
    the transform of its extension over ``2*(nlag-1)`` lags is real
    (reference ``CyclicFoldEngine::synch``); ``fftshift``-ed, and with
    ``mover > 1`` averaged down to ``nchan_cyclic`` channels."""
    nchan = folded_planes.shape[0]
    nbin = folded_planes.shape[-1]
    planes = folded_planes.reshape(nchan, npol, nlag, 2, nbin)
    c = planes[:, :, :, 0] + 1j * planes[:, :, :, 1]
    c = np.moveaxis(c, 2, 3)  # [nchan, npol, nbin, nlag]
    nfull = 2 * (nlag - 1)
    full = np.zeros((*c.shape[:-1], nfull), np.complex128)
    full[..., :nlag] = c
    full[..., nlag:] = np.conj(c[..., -2:0:-1])
    spec = np.fft.fftshift(np.fft.fft(full, axis=-1), axes=-1).real
    if mover > 1:
        spec = spec.reshape(*spec.shape[:-1], nfull // mover, mover).mean(-1)
    return spec
