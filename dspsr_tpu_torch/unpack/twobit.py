"""Two-bit dynamic-level correction and impulsive-interference excision.

Equivalent of the reference ``dsp::TwoBitCorrection`` /
``dsp::ExcisionUnpacker`` (``Kernel/Classes/TwoBitCorrection.C``,
``ExcisionUnpacker.C``, ``TwoBitFour.C``) implementing Jenet & Anderson
(1998, PASP 110, 1467) dynamic output level setting:

Two-bit sampling quantizes voltage v with thresholds {-t, 0, +t} into four
states; the two inner states ("low") get output level ±lo, the outer ±hi.
When the true input power varies (scintillation, interference), fixed levels
mis-scale the signal; JA98 instead estimate the input sigma per short block
from the *observed fraction of low samples* f = nlow/ndat::

    f = erf( t / (sigma sqrt(2)) )        =>  sigma_hat = t / (sqrt(2) erfinv(f))

and set the output levels to the conditional means of the Gaussian segments
(JA98 eq. 44-45), normalized to unit output variance::

    lo = E[ v | 0 < v < t ]  = sigma_hat sqrt(2/pi) (1 - exp(-t^2/2 sigma_hat^2)) / f
    hi = E[ v | v > t ]      = sigma_hat sqrt(2/pi) exp(-t^2/2 sigma_hat^2) / (1 - f)

Impulsive-interference **excision** (reference ``ExcisionUnpacker``,
``Kernel/Classes/dsp/ExcisionUnpacker.h:23-115``): blocks whose nlow falls
outside ``cutoff_sigma`` standard deviations of the binomial expectation
``nlow ~ B(ndat, f_opt)`` get weight zero and are excluded from folding.

Everything is precomputed into lookup tables indexed by nlow (device gather).

The port's copy of ``dspsr_tpu/unpack/twobit.py``: the tables are equal to
the JAX package's bit for bit.
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from functools import cached_property

import numpy as np

#: JA98 optimal 2-bit threshold in units of sigma (their t/sigma ~ 0.9674
#: maximizing SNR for the *non-uniform* optimal output levels; reference
#: TwoBitTable uses JenetAnderson98::get_optimal_spacing).
JA98_THRESHOLD = 0.9674


def optimal_flow(threshold: float = JA98_THRESHOLD) -> float:
    """Expected fraction of low samples at nominal input power."""
    return math.erf(threshold / math.sqrt(2.0))


@dataclass
class TwoBitCorrection:
    """Dynamic-level two-bit unpack tables.

    Args:
      ndat_per_weight: samples per correction/excision block (reference
        ``ExcisionUnpacker::set_ndat_per_weight``; typically 512).
      cutoff_sigma: excision threshold in binomial sigmas (default 3.0 as in
        the reference ``ExcisionUnpacker.C``).
      threshold: sampler threshold in units of nominal sigma.
    """

    ndat_per_weight: int = 512
    cutoff_sigma: float = 3.0
    threshold: float = JA98_THRESHOLD

    @cached_property
    def nlow_range(self) -> tuple[int, int]:
        """[nlow_min, nlow_max] inclusive for a block to be kept
        (reference ``ExcisionUnpacker::set_cutoff_sigma``)."""
        n = self.ndat_per_weight
        f = optimal_flow(self.threshold)
        mean = n * f
        sigma = math.sqrt(n * f * (1.0 - f))
        lo = int(math.floor(mean - self.cutoff_sigma * sigma))
        hi = int(math.ceil(mean + self.cutoff_sigma * sigma))
        return max(lo, 1), min(hi, n - 1)

    @cached_property
    def level_tables(self) -> tuple[np.ndarray, np.ndarray]:
        """(lo[n+1], hi[n+1]) float32 output levels per possible nlow.

        JA98 dynamic levels normalized so the expected output variance is
        unity: E[y^2] = f lo^2 + (1-f) hi^2 = 1.
        """
        n = self.ndat_per_weight
        t = self.threshold
        lo = np.empty(n + 1, np.float64)
        hi = np.empty(n + 1, np.float64)
        for nlow in range(n + 1):
            f = min(max(nlow / n, 0.5 / n), 1.0 - 0.5 / n)
            # sigma_hat from f = erf(t / (sigma sqrt 2))
            from math import sqrt

            erfinv_f = _erfinv(f)
            sigma = t / (sqrt(2.0) * erfinv_f)
            g = math.exp(-0.5 * (t / sigma) ** 2)
            lo_v = sigma * math.sqrt(2.0 / math.pi) * (1.0 - g) / f
            hi_v = sigma * math.sqrt(2.0 / math.pi) * g / (1.0 - f)
            # normalize to unit output variance
            var = f * lo_v**2 + (1.0 - f) * hi_v**2
            s = 1.0 / math.sqrt(var)
            lo[nlow] = lo_v * s
            hi[nlow] = hi_v * s
        return lo.astype(np.float32), hi.astype(np.float32)

    @cached_property
    def weight_table(self) -> np.ndarray:
        """float32[n+1]: 1 if nlow in the keep range else 0."""
        n = self.ndat_per_weight
        lo, hi = self.nlow_range
        w = np.zeros(n + 1, np.float32)
        w[lo : hi + 1] = 1.0
        return w


def _erfinv(y: float) -> float:
    """Inverse error function via Newton on erf (float64, |y|<1)."""
    if not -1.0 < y < 1.0:
        raise ValueError("erfinv domain")
    # initial guess (Winitzki approximation)
    a = 0.147
    ln1my2 = math.log(1.0 - y * y)
    term = 2.0 / (math.pi * a) + ln1my2 / 2.0
    x = math.copysign(math.sqrt(math.sqrt(term**2 - ln1my2 / a) - term), y)
    for _ in range(50):
        err = math.erf(x) - y
        dx = err / (2.0 / math.sqrt(math.pi) * math.exp(-x * x))
        x -= dx
        if abs(dx) < 1e-15:
            break
    return x
