"""Time, frequency and polarization scrunch of detected data.

Counterpart of ``dspsr_tpu/ops/scrunch.py:19-72`` (reference
``TScrunch.C``, ``FScrunch.C``, ``PScrunch.C``): sums over groups of
samples, channels or polarizations of ``float32[nchan, npol, ndat]``, and
the matching metadata transitions.
"""

from __future__ import annotations

import torch

from ..observation import Observation, Signal


def tscrunch(x: torch.Tensor, factor: int) -> torch.Tensor:
    """Sum groups of ``factor`` consecutive time samples (dspsr sums rather
    than averages); a ragged tail is dropped."""
    if factor <= 1:
        return x
    nchan, npol, ndat = x.shape
    n = (ndat // factor) * factor
    return x[..., :n].reshape(nchan, npol, n // factor, factor).sum(-1)


def fscrunch(x: torch.Tensor, factor: int) -> torch.Tensor:
    """Sum groups of ``factor`` adjacent channels."""
    if factor <= 1:
        return x
    nchan, npol, ndat = x.shape
    n = (nchan // factor) * factor
    return x[:n].reshape(n // factor, factor, npol, ndat).sum(1)


def pscrunch(x: torch.Tensor) -> torch.Tensor:
    """Sum polarizations to total intensity."""
    return x.sum(1, keepdim=True)


def pscrunch_state(x: torch.Tensor, state: Signal) -> torch.Tensor:
    """Total intensity of ``state`` data: Stokes keeps I, others sum."""
    if state == Signal.STOKES:
        return x[:, 0:1]
    return pscrunch(x)


def update_observation_tscrunch(obs: Observation, factor: int) -> Observation:
    return obs.replace(rate=obs.rate / factor)


def update_observation_fscrunch(obs: Observation, factor: int) -> Observation:
    return obs.replace(nchan=obs.nchan // factor)
