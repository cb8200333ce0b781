"""Apodization (tapering) windows applied before the forward FFT.

Equivalent of the reference ``dsp::Apodization``
(``Signal/General/Apodization.C``; types hanning/welch/parzen/tukey/none,
``dsp/Apodization.h:23``).  Windows are built host-side in float64 and
multiplied into the framed overlap-save windows (one fused elementwise op).

The port's copy of ``dspsr_tpu/ops/apodization.py``; the fused kernels read
the window as float32 in sample order (``MegaConstants.window``).
"""

from __future__ import annotations

from enum import Enum

import numpy as np


class WindowType(Enum):
    NONE = "none"
    HANNING = "hanning"
    WELCH = "welch"
    PARZEN = "parzen"  # reference's name for the Bartlett/triangular window
    TUKEY = "tukey"
    TOP_HAT = "tophat"


def build_window(kind: WindowType, nsamp: int, transition: int = 0) -> np.ndarray:
    """float32[nsamp] window; ``transition`` is the taper width for Tukey /
    the passband edge for top-hat (reference ``Apodization::set_shape``)."""
    n = np.arange(nsamp, dtype=np.float64)
    if kind == WindowType.NONE:
        w = np.ones(nsamp)
    elif kind == WindowType.HANNING:
        w = 0.5 - 0.5 * np.cos(2 * np.pi * n / (nsamp - 1))
    elif kind == WindowType.WELCH:
        x = (n - 0.5 * (nsamp - 1)) / (0.5 * (nsamp + 1))
        w = 1.0 - x * x
    elif kind == WindowType.PARZEN:
        # triangular (the reference's "parzen" is the Bartlett window)
        w = 1.0 - np.abs((n - 0.5 * (nsamp - 1)) / (0.5 * (nsamp + 1)))
    elif kind == WindowType.TUKEY:
        t = transition or nsamp // 8
        w = np.ones(nsamp)
        ramp = 0.5 * (1 - np.cos(np.pi * np.arange(t) / t))
        w[:t] = ramp
        w[nsamp - t:] = ramp[::-1]
    elif kind == WindowType.TOP_HAT:
        t = transition or 0
        w = np.zeros(nsamp)
        w[t : nsamp - t] = 1.0
    else:
        raise ValueError(kind)
    return w.astype(np.float32)
