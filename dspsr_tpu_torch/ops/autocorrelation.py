"""Lag-domain spectrometry: autocorrelation spectra and the ACF filterbank.

Counterpart of ``dspsr_tpu/ops/autocorrelation.py`` (reference
``dsp::AutoCorrelation`` and ``dsp::ACFilterbank``,
``Signal/General/AutoCorrelation.C``, ``ACFilterbank.C``): estimate spectra
from time-averaged lag products instead of windowed FFTs, the classic lag
("XF") spectrometer, useful where channel shapes must be controlled in the
lag domain.

Plain PyTorch on ``complex64`` voltages, on the device they lie on: the lag
products are ``ops.cyclic.lag_products`` (the shifted multiply the cyclic
fold uses), the transforms ``ops.fft``.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from . import fft
from .cyclic import lag_products


def autocorrelation(x: torch.Tensor, nlag: int) -> torch.Tensor:
    """Time-averaged complex autocorrelation function of complex ``x
    [nchan, npol, ndat]``: ``[nchan, npol, nlag]``, ``<x[t+l]
    conj(x[t])>_t``."""
    return lag_products(x, nlag).mean(-1)


def acf_spectra(acf) -> np.ndarray:
    """Power spectra from the one-sided ACF (a complex tensor or array
    ``[*, nlag]``) via Hermitian extension, on the host: real ``[*,
    2*(nlag-1)]``, natural channel order."""
    if isinstance(acf, torch.Tensor):
        acf = acf.cpu().numpy()
    c = np.asarray(acf, np.complex128)
    nlag = c.shape[-1]
    nfull = 2 * (nlag - 1)
    full = np.zeros((*c.shape[:-1], nfull), np.complex128)
    full[..., :nlag] = c
    full[..., nlag:] = np.conj(c[..., -2:0:-1])
    return np.fft.fftshift(np.fft.fft(full, axis=-1), axes=-1).real


def acf_filterbank(x: torch.Tensor, nlag: int, nblock: int) -> torch.Tensor:
    """ACFilterbank: time-resolved ACFs over ``nblock`` equal sub-spans of
    complex ``x [nchan, npol, ndat]``: ``[nchan, npol, nlag, nblock]``, the
    JAX package's layout (its docstring says ``[..., nblock, nlag]``, but
    its arrays, and so these, keep the lag axis before the block axis)."""
    c = lag_products(x, nlag)
    span = c.shape[-1] // nblock
    c = c[..., : nblock * span]
    return c.reshape(*c.shape[:-1], nblock, span).mean(-1)


def ac_filterbank(x: torch.Tensor, nchan: int, nlag: int = 0,
                  form_acf: bool = False,
                  window: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Zero-padded lag-domain filterbank (reference ``dsp::ACFilterbank``,
    ``Signal/General/ACFilterbank.C:40-293``).

    Frames each channel/pol of complex ``x`` into windows of ``ngood =
    nchan - nlag`` samples, zero-pads them to ``nchan``, transforms, and
    forms X * conj(X):

    - ``form_acf=False`` (mode 1): the power spectral density of each
      window, complex ``[nchan_in, npol, nwin, nchan]`` with zero imaginary
      part (the reference's layout, which stores the analytic PSD);
    - ``form_acf=True`` (mode 2): the inverse transform of the PSD, the
      non-cyclic autocorrelation function; its first ``nlag`` lags,
      complex ``[nchan_in, npol, nwin, nlag]``.

    Zero-padding each window by ``nlag`` keeps lags < nlag free of cyclic
    wrap (``dsp/ACFilterbank.h:29-35``).  ``window``: optional apodization
    of the ngood data samples.
    """
    if nlag <= 0:
        nlag = nchan // 2
    ngood = nchan - nlag
    nwin = x.shape[-1] // ngood
    a = x[..., : nwin * ngood].reshape(*x.shape[:-1], nwin, ngood)
    if window is not None:
        a = a * window
    spec = fft.fft(torch.nn.functional.pad(a, (0, nchan - ngood)))
    psd = spec.real * spec.real + spec.imag * spec.imag
    psd = torch.complex(psd, torch.zeros_like(psd))
    if not form_acf:
        return psd
    return fft.ifft(psd)[..., :nlag]
