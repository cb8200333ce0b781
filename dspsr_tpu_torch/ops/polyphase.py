"""Polyphase filterbank (critically sampled weighted overlap-add
channelizer).

Counterpart of ``dspsr_tpu/ops/polyphase.py`` (reference
``dsp::PolyPhaseFilterbank``, ``Signal/General/PolyPhaseFilterbank.C``):
better channel isolation than the plain FFT filterbank, at the cost of a
prototype FIR filter of ``ntaps`` taps a channel.  For ``nc`` channels
output sample ``t`` of channel ``c`` is the DFT across ``c'`` of

    s[c', t] = sum_j h[j*nc + c'] x[t*nc + j*nc + c']   (j = 0..ntaps-1)

after the input is shifted down half a channel (``exp(-i pi n / nc)``), so
that channel centres follow the non-dc-centred convention.  The stream is
torch ``complex64`` from the shift on (``ops.fft``).
"""

from __future__ import annotations

import math
from dataclasses import dataclass

import numpy as np
import torch

from . import fft
from .convolution import frame


def prototype_lowpass(nchan: int, ntaps: int, beta: float = 1.0) -> np.ndarray:
    """Windowed-sinc prototype filter with its cutoff at the channel width:
    float32 ``[ntaps * nchan]``, unit gain for a tone at a channel
    centre."""
    n = ntaps * nchan
    t = np.arange(n, dtype=np.float64) - (n - 1) / 2.0
    h = np.sinc(t / nchan * beta)
    h *= np.hamming(n)
    h /= h.sum()
    return h.astype(np.float32)


@dataclass(frozen=True)
class PolyphasePlan:
    real_input: bool
    nchan_subband: int
    ntaps: int = 8

    @property
    def window_samples(self) -> int:
        return self.ntaps * self.nchan_subband

    @property
    def step(self) -> int:
        return self.nchan_subband  # critically sampled

    def npart(self, ndat: int) -> int:
        if ndat < self.window_samples:
            return 0
        return (ndat - self.window_samples) // self.step + 1

    def block_ndat(self, npart: int) -> int:
        return (npart - 1) * self.step + self.window_samples


def polyphase_filterbank_block(x: torch.Tensor, h: torch.Tensor,
                               plan: PolyphasePlan,
                               npart: int) -> torch.Tensor:
    """Channelize ``x [nchan_in, npol, ndat]`` (real, or complex when
    ``plan.real_input`` is False) with the prototype filter ``h [ntaps *
    nchan_subband]``: complex ``[nchan_in * nchan_subband, npol, npart]``
    in natural channel order, one output sample a window."""
    nc = plan.nchan_subband
    hw = h.reshape(plan.ntaps, nc)
    # the half-channel shift, periodic in 2 nc samples: the float32 phase
    # of n mod 2 nc, as the JAX package computes it
    ndat = x.shape[-1]
    n_mod = torch.arange(ndat, device=x.device) % (2 * nc)
    ang = float(np.float32(math.pi / nc)) * n_mod.to(torch.float32)
    ramp = torch.complex(torch.cos(ang), -torch.sin(ang))
    w = frame(x * ramp, plan.window_samples, plan.step, npart)
    w = w.reshape(*w.shape[:-1], plan.ntaps, nc)
    spec = fft.fftshift(fft.fft((w * hw).sum(dim=-2)))
    nchan_in, npol = spec.shape[:2]
    return spec.movedim(3, 1).reshape(nchan_in * nc, npol, npart)
