"""Statistical distributions for spectral-kurtosis RFI thresholds.

Equivalent of the reference ``Signal/Statistics/``: ``PearsonIV.C`` (the
Pearson type-IV approximation to the SK estimator distribution, after Nita &
Gary 2010, MNRAS 406, L60) and ``SKLimits.C`` (inverting its CF/CCF with
Newton-Raphson for the +/- n-sigma probability thresholds).

All formulas match the reference line for line (moments ``PearsonIV.C:28-84``,
normalization ``log_normal`` ``PearsonIV.C:117-140``, threshold search
``SKLimits.C:29-103``).
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from functools import lru_cache
from typing import Tuple

import numpy as np


class PearsonIV:
    """Pearson type-IV pdf fitted to the SK estimator's first four moments
    for M samples (reference ``PearsonIV.C``)."""

    def __init__(self, M: int):
        self.M = M
        Mf = float(M)
        self.mu1 = 1.0
        self.mu2 = (4 * Mf * Mf) / ((Mf - 1) * (Mf + 2) * (Mf + 3))
        beta1 = (4 * (Mf + 2) * (Mf + 3) * (5 * Mf - 7) ** 2) / (
            (Mf - 1) * (Mf + 4) ** 2 * (Mf + 5) ** 2)
        beta2 = (3 * (Mf + 2) * (Mf + 3)
                 * (Mf ** 3 + 98 * Mf ** 2 - 185 * Mf + 78)) / (
            (Mf - 1) * (Mf + 4) * (Mf + 5) * (Mf + 6) * (Mf + 7))
        self.beta1, self.beta2 = beta1, beta2
        r = (6 * (beta2 - beta1 - 1)) / (2 * beta2 - 3 * beta1 - 6)
        self.r = r
        self.m = (r + 2) / 2
        self.v = -(r * (r - 2) * math.sqrt(beta1)) / math.sqrt(
            16 * (r - 1) - beta1 * (r - 2) ** 2)
        self.a = 0.25 * math.sqrt(
            self.mu2 * (16 * (r - 1) - beta1 * (r - 2) ** 2))
        self.lamda = self.mu1 - 0.25 * (r - 2) * math.sqrt(self.mu2) * math.sqrt(beta1)
        self.logk = self._log_normal()

    def _log_normal(self) -> float:
        """log of the pdf normalization (reference ``log_normal``,
        ``PearsonIV.C:117-140``) via |Gamma(m+iv/2)/Gamma(m)|^2 recursion."""
        x = self.m
        y = 0.5 * self.v
        y2 = y * y
        xmin = max(2 * y2, 10.0)
        logr, s, p, f = 0.0, 1.0, 1.0, 0.0
        while x < xmin:
            t = y / x
            x += 1
            logr += math.log(1 + t * t)
        while p > s * np.finfo(float).eps:
            p *= y2 + f * f
            f += 1
            p /= x * f  # reference: p /= x++ * ++f
            x += 1
            s += p
        return (math.log(0.5 * (2.0 / math.sqrt(math.pi)) / self.a)
                - (logr + math.log(s))
                + math.lgamma(self.m) - math.lgamma(self.m - 0.5))

    def log_pdf(self, x: float) -> float:
        t = (x - self.lamda) / self.a
        return self.logk - self.m * math.log1p(t * t) - self.v * math.atan(t)

    def pdf(self, x):
        x = np.asarray(x, dtype=float)
        t = (x - self.lamda) / self.a
        return np.exp(self.logk - self.m * np.log1p(t * t) - self.v * np.arctan(t))

    def cf(self, x: float) -> float:
        """Cumulative distribution P(SK < x) (reference Romberg-integrates the
        pdf from (effectively) the lower support; here adaptive Simpson from
        far in the left tail)."""
        lo = self.lamda - 50.0 * math.sqrt(self.mu2)
        return self._integrate(lo, x)

    def ccf(self, x: float) -> float:
        """Complementary cumulative P(SK > x)."""
        hi = self.lamda + 80.0 * math.sqrt(self.mu2)
        return self._integrate(x, hi)

    def _integrate(self, a: float, b: float, n: int = 4001) -> float:
        if b <= a:
            return 0.0
        xs = np.linspace(a, b, n)
        ys = self.pdf(xs)
        return float(np.trapezoid(ys, xs))


@dataclass(frozen=True)
class SKThresholds:
    M: int
    std_devs: float
    lower: float
    upper: float


@lru_cache(maxsize=32)
def sk_limits(M: int, std_devs: int = 3) -> SKThresholds:
    """SK thresholds for M samples at +/- std_devs sigma (reference
    ``SKLimits::calc_limits``, ``SKLimits.C:29-103``): invert the Pearson IV
    CF/CCF to the two-sided tail probability; for M >= 32768 use the Gaussian
    limit 1 +/- std_devs*sqrt(4/M)."""
    if M <= 1 or std_devs <= 0:
        raise ValueError("invalid SK limit inputs")
    percent = math.erf(std_devs / math.sqrt(2.0))
    target = (1 - percent) / 2.0
    one_std = math.sqrt(4.0 / M)
    factor = one_std * std_devs
    if M >= 32768:
        return SKThresholds(M, std_devs, 1.0 - factor, 1.0 + factor)

    p4 = PearsonIV(M)

    def newton(fn, dfn, target_log, x0):
        x = x0
        for _ in range(100):
            fx = fn(x)
            if fx <= 0:
                x *= 1.01
                continue
            err = math.log(fx) - target_log
            d = dfn(x) / fx
            if d == 0:
                break
            step = err / d
            x_new = min(max(x - step, 1e-4), 10.0)
            if abs(x_new - x) < 1e-12:
                return x_new
            x = x_new
        return x

    lower = newton(p4.cf, p4.pdf, math.log(target), 1 - factor)
    upper = newton(lambda x: p4.ccf(x), lambda x: -p4.pdf(x),
                   math.log(target), 1 + factor)
    return SKThresholds(M, std_devs, lower, upper)
