"""Quantization level tables for n-bit unpacking.

Host-side (numpy float64) equivalent of the reference ``dsp::BitTable``
(``Kernel/Classes/BitTable.C:121-233``): maps each n-bit sample code to a
float output level.  Output levels are uniformly spaced and scaled so that,
for Gaussian input sampled with the optimal uniform threshold spacing, the
unpacked data has unit variance (``BitTable::generate_unique_values``,
``BitTable.C:165-218``).

The optimal threshold spacing for a uniform quantizer of a unit normal
(PSRCHIVE ``JenetAnderson98::get_optimal_spacing``; Jenet & Anderson 1998,
PASP 110, 1467) is computed here by directly minimizing the mean-squared
quantization distortion — reproducing the classic Max (1960) / JA98 values
(2-bit: ~0.9957 for uniform output levels).
"""

from __future__ import annotations

import functools
import math
from dataclasses import dataclass, field
from enum import Enum

import numpy as np


def _phi(x: float) -> float:
    """Standard normal CDF."""
    return 0.5 * (1.0 + math.erf(x / math.sqrt(2.0)))


def _norm_pdf(x: float) -> float:
    return math.exp(-0.5 * x * x) / math.sqrt(2.0 * math.pi)


@functools.lru_cache(maxsize=None)
def optimal_spacing(nbit: int) -> float:
    """Optimal uniform threshold spacing (in sigma) for 2^nbit levels.

    Minimizes E[(x - q(x))^2] for x ~ N(0,1), q the uniform mid-rise
    quantizer with levels (k + 1/2)*d, k = -2^(nbit-1) .. 2^(nbit-1)-1 and
    thresholds k*d.  Golden-section search on the unimodal distortion.
    """
    n = 1 << nbit
    m = n // 2

    def distortion(d: float) -> float:
        # sum over positive-side cells, doubled (symmetry)
        total = 0.0
        for k in range(m):
            lo = k * d
            hi = (k + 1) * d if k < m - 1 else float("inf")
            level = (k + 0.5) * d
            # integral of (x-level)^2 phi(x) dx over [lo,hi)
            # = (1+level^2)(Phi(hi)-Phi(lo)) - 2*level*(pdf(lo)-pdf(hi))
            #   + [lo*pdf(lo) - hi*pdf(hi)]  (since int x^2 phi = Phi - x phi |)
            p_hi = _phi(hi) if hi != float("inf") else 1.0
            p_lo = _phi(lo)
            f_hi = _norm_pdf(hi) if hi != float("inf") else 0.0
            f_lo = _norm_pdf(lo)
            i0 = p_hi - p_lo
            i1 = f_lo - f_hi
            i2 = i0 + lo * f_lo - (hi * f_hi if hi != float("inf") else 0.0)
            total += i2 - 2 * level * i1 + level * level * i0
        return 2.0 * total

    a, b = 1e-3, 4.0
    gr = (math.sqrt(5) - 1) / 2
    c = b - gr * (b - a)
    dd = a + gr * (b - a)
    for _ in range(200):
        if distortion(c) < distortion(dd):
            b = dd
        else:
            a = c
        c = b - gr * (b - a)
        dd = a + gr * (b - a)
    return 0.5 * (a + b)


class CodeType(Enum):
    """Bit-pattern interpretation (reference ``BitTable::Type``)."""

    OFFSET_BINARY = "offset"  # 0 .. 2^n-1 maps low..high
    TWOS_COMPLEMENT = "twos"


@dataclass
class BitTable:
    """Level lookup for one n-bit code.

    Mirrors ``BitTable::generate_unique_values`` (``BitTable.C:165-218``):
    uniform output levels centred on zero, variance-normalized against the
    optimally-spaced Gaussian quantizer.
    """

    nbit: int
    type: CodeType = CodeType.OFFSET_BINARY

    def __post_init__(self):
        if self.nbit not in (1, 2, 4, 8):
            raise ValueError(f"unsupported nbit={self.nbit}")

    @functools.cached_property
    def values(self) -> np.ndarray:
        """float32[2^nbit]: output level for each code."""
        n = 1 << self.nbit
        middle = (n - 1) / 2.0
        spacing_out = 1.0 / n
        out = (np.arange(n) - middle) * spacing_out

        if self.nbit == 1:
            # 1-bit: +/-1 levels, unit variance by construction
            vals = np.where(np.arange(n) >= 1, 1.0, -1.0)
            return self._reorder(vals.astype(np.float64)).astype(np.float32)

        d = optimal_spacing(self.nbit)
        m = n // 2
        # variance of the quantized unit normal with thresholds k*d
        var = 0.0
        for i in range(m, n):  # positive-side codes
            k = i - m
            lo = k * d
            hi = (k + 1) * d if k < m - 1 else float("inf")
            p = (_phi(hi) if hi != float("inf") else 1.0) - _phi(lo)
            var += out[i] ** 2 * p
        var *= 2.0
        vals = out / math.sqrt(var)
        return self._reorder(vals).astype(np.float32)

    def _reorder(self, ascending_vals: np.ndarray) -> np.ndarray:
        """Map code index -> level according to the code type
        (``BitTable.C:180-190`` input_offset for twos complement)."""
        n = len(ascending_vals)
        if self.type == CodeType.TWOS_COMPLEMENT:
            # code 0 .. n/2-1 = levels n/2 .. n-1; code n/2 .. n-1 = 0 .. n/2-1
            return np.roll(ascending_vals, n // 2)
        return ascending_vals

    @functools.cached_property
    def scale(self) -> float:
        """Output units per input sigma-spacing (``BitTable.C:214-216``)."""
        n = 1 << self.nbit
        # values are uniformly spaced; scale = spacing of adjacent levels
        asc = np.sort(self.values)
        return float(asc[1] - asc[0]) if n > 1 else 1.0
