"""Decimation and reshaping: time, frequency and polarization scrunch,
pol select, frequency zoom and pol reshape.

Counterpart of ``dspsr_tpu/ops/scrunch.py`` (reference ``TScrunch.C``,
``FScrunch.C``, ``PScrunch.C``, ``PolnSelect.C``, ``FZoom.C``,
``PolnReshape.C``): sums over groups of samples, channels or
polarizations of ``float32[nchan, npol, ndat]`` (pol select also of
complex voltages), and the matching metadata transitions.
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


def poln_select(x: torch.Tensor, ipol: int) -> torch.Tensor:
    """Keep one polarization (reference ``PolnSelect``)."""
    return x[:, ipol:ipol + 1]


def fzoom(x: torch.Tensor, chan_lo: int, nkeep: int) -> torch.Tensor:
    """Keep ``nkeep`` channels from ``chan_lo`` on (reference ``FZoom``)."""
    return x[chan_lo:chan_lo + nkeep]


def update_observation_fzoom(obs: Observation, chan_lo: int,
                             nkeep: int) -> Observation:
    f_lo = obs.centre_frequency_of(chan_lo)
    f_hi = obs.centre_frequency_of(chan_lo + nkeep - 1)
    return obs.replace(nchan=nkeep, centre_frequency=0.5 * (f_lo + f_hi),
                       bandwidth=obs.chan_bandwidth * nkeep)


def poln_reshape(x: torch.Tensor, from_state: Signal,
                 to_state: Signal) -> torch.Tensor:
    """Convert detected products between layouts (reference
    ``dsp::PolnReshape``): Coherence (AA, BB, Re, Im) <-> Stokes (I, Q, U,
    V), or Coherence, PPQQ or Stokes -> Intensity.  ``x [nchan, npol,
    ndat]``."""
    if from_state == to_state:
        return x
    if to_state == Signal.INTENSITY:
        if from_state == Signal.STOKES:
            return x[:, 0:1]
        return x[:, 0:1] + x[:, 1:2]
    if from_state == Signal.COHERENCE and to_state == Signal.STOKES:
        aa, bb, re, im = x[:, 0], x[:, 1], x[:, 2], x[:, 3]
        return torch.stack([aa + bb, aa - bb, 2 * re, 2 * im], dim=1)
    if from_state == Signal.STOKES and to_state == Signal.COHERENCE:
        i, q, u, v = x[:, 0], x[:, 1], x[:, 2], x[:, 3]
        return torch.stack([(i + q) / 2, (i - q) / 2, u / 2, v / 2], dim=1)
    raise ValueError(f"unsupported reshape {from_state} -> {to_state}")
