"""The output level of each 8-bit offset-binary code (dspsr ``BitTable``).

Levels are uniformly spaced about zero and scaled so that Gaussian noise,
sampled with the threshold spacing that minimises a uniform quantizer's
distortion (Jenet & Anderson 1998, PASP 110, 1467), unpacks to unit
variance (``BitTable.C:165-218``).  Float64, from first principles.
"""

from __future__ import annotations

import functools
import math


def _cdf(x: float) -> float:
    return 0.5 * (1.0 + math.erf(x / math.sqrt(2.0)))


def _pdf(x: float) -> float:
    return math.exp(-0.5 * x * x) / math.sqrt(2.0 * math.pi)


def _cell(lo: float, hi: float) -> tuple:
    """Probability, first and second moments of a unit normal on [lo, hi)
    (``hi`` may be infinite)."""
    top = math.isinf(hi)
    p = (1.0 if top else _cdf(hi)) - _cdf(lo)
    m1 = _pdf(lo) - (0.0 if top else _pdf(hi))
    m2 = p + lo * _pdf(lo) - (0.0 if top else hi * _pdf(hi))
    return p, m1, m2


def _distortion(d: float, half: int) -> float:
    """Mean-square error of the mid-rise quantizer with thresholds ``k d``
    and levels ``(k + 1/2) d`` on a unit normal."""
    total = 0.0
    for k in range(half):
        hi = (k + 1) * d if k < half - 1 else math.inf
        p, m1, m2 = _cell(k * d, hi)
        level = (k + 0.5) * d
        total += m2 - 2 * level * m1 + level * level * p
    return 2.0 * total


@functools.lru_cache(maxsize=None)
def level_step(nbit: int = 8) -> float:
    """Spacing of adjacent output levels: value = (code - (2^nbit - 1)/2)
    times this, for offset-binary codes."""
    n = 1 << nbit
    half = n // 2
    # golden-section search for the optimal threshold spacing
    a, b = 1e-3, 4.0
    g = (math.sqrt(5) - 1) / 2
    c, e = b - g * (b - a), a + g * (b - a)
    for _ in range(200):
        if _distortion(c, half) < _distortion(e, half):
            b = e
        else:
            a = c
        c, e = b - g * (b - a), a + g * (b - a)
    d = 0.5 * (a + b)
    # variance of levels (i + 1/2)/n sampled at that spacing
    var = 0.0
    for k in range(half):
        hi = (k + 1) * d if k < half - 1 else math.inf
        p = _cell(k * d, hi)[0]
        var += ((k + 0.5) / n) ** 2 * p
    return (1.0 / n) / math.sqrt(2.0 * var)
