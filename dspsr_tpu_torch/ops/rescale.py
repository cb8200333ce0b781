"""Running mean and scale removal for search-mode output levelling.

Counterpart of ``dspsr_tpu/ops/rescale.py:23-90`` (reference
``Signal/General/Rescale.C``): subtract a per-(chan, pol) mean and multiply
by 1/std, with the statistics carried by the caller as ``(count, total,
sumsq)``.  The state is float32, the count included, as in the JAX package.
"""

from __future__ import annotations

from typing import NamedTuple, Tuple

import torch


class RescaleState(NamedTuple):
    count: torch.Tensor  # [nchan, npol] float32 sample count
    total: torch.Tensor  # [nchan, npol] running sum
    sumsq: torch.Tensor  # [nchan, npol] running sum of squares

    @classmethod
    def zeros(cls, nchan: int, npol: int, device="cpu") -> "RescaleState":
        return cls(*(torch.zeros((nchan, npol), dtype=torch.float32,
                                 device=device) for _ in range(3)))


def state_mean_scale(state: RescaleState
                     ) -> Tuple[torch.Tensor, torch.Tensor]:
    n = torch.clamp(state.count, min=1.0)
    mean = state.total / n
    var = torch.clamp(state.sumsq / n - mean * mean, min=1e-30)
    return mean, torch.rsqrt(var)


def accumulate(state: RescaleState, x: torch.Tensor,
               weights=None) -> RescaleState:
    """Add ``x [nchan, npol, ndat]`` to the statistics; ``weights [nchan,
    ndat]`` (0/1) leave bad samples out."""
    if weights is None:
        return RescaleState(
            count=state.count + x.shape[-1],
            total=state.total + x.sum(-1),
            sumsq=state.sumsq + (x * x).sum(-1),
        )
    w = weights[:, None, :]
    return RescaleState(
        count=state.count + w.sum(-1),
        total=state.total + (x * w).sum(-1),
        sumsq=state.sumsq + (x * x * w).sum(-1),
    )


def apply_scales(x: torch.Tensor, mean: torch.Tensor, inv: torch.Tensor,
                 weights=None) -> torch.Tensor:
    y = (x - mean[:, :, None]) * inv[:, :, None]
    if weights is not None:
        y = y * weights[:, None, :]
    return y


def rescale_block(state: RescaleState, x: torch.Tensor, freeze: bool = False,
                  weights=None) -> Tuple[RescaleState, torch.Tensor]:
    """Apply ``(x - mean) * inv_std`` with statistics that include this
    block (unless ``freeze``), and return the updated state."""
    state = accumulate(state, x, weights) if not freeze else state
    mean, inv = state_mean_scale(state)
    return state, apply_scales(x, mean, inv, weights)


def bandpass_from_state(state: RescaleState) -> torch.Tensor:
    """Mean bandpass per chan/pol (the reference BandpassMonitor output)."""
    return state_mean_scale(state)[0]
