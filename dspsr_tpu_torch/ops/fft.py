"""FFTs of the general chain, with the JAX package's conventions.

Counterpart of ``dspsr_tpu/ops/mxfft.py``.  That module builds its FFTs as
dense DFT matmuls because the TPU has no FFT primitive; here the same
transforms are ``torch.fft`` calls (cuFFT on the card, pocketfft on the
CPU) over torch ``complex64`` tensors, the form of every complex stream
of the general chain (the JAX package's split-complex ``(re, im)`` pairs
of ``ops/sc.py`` are not carried over).  The conventions are the JAX
package's:

- :func:`rfft` of ``2N`` real samples returns bins ``0..N-1``: the Nyquist
  bin is dropped (``mxfft.py:209-240``, reference ``frc1d``);
- :func:`fft` is unscaled and :func:`ifft` scaled by ``1/N``, numpy's
  convention (``mxfft.py:199-202``);
- :func:`fftshift` and :func:`ifftshift` move the second half of the last
  axis to the front; the lengths of this chain are even, where the two
  are one and the same (``mxfft.py:243-254``).

Each function looks ``torch.fft`` up when it is called, so a caller that
replaces ``torch.fft.rfft`` (``chip_smoke.py``'s guard on the fused
paths) sees every call.
"""

from __future__ import annotations

import torch


def rfft(x: torch.Tensor) -> torch.Tensor:
    """Spectrum of real ``x [..., 2N]``: complex ``[..., N]``, bins 0 to
    N-1 (the Nyquist bin dropped)."""
    n = x.shape[-1] // 2
    return torch.fft.rfft(x, dim=-1)[..., :n]


def fft(x: torch.Tensor) -> torch.Tensor:
    """Forward transform of complex ``x`` along the last axis, unscaled."""
    return torch.fft.fft(x, dim=-1)


def ifft(x: torch.Tensor) -> torch.Tensor:
    """Inverse transform of complex ``x`` along the last axis, scaled by
    ``1/N``."""
    return torch.fft.ifft(x, dim=-1)


def fftshift(x: torch.Tensor) -> torch.Tensor:
    """DC to the centre of the last axis (even length)."""
    return torch.fft.fftshift(x, dim=-1)


#: on even lengths the inverse shift is the same permutation
ifftshift = fftshift
