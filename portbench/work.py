"""The least time one step of the filterbank could take on the card.

The work is the filterbank's own, whatever kernels do it: per window the
forward FFT (real input: one packed transform of ``2 N`` points, ``N =
nsub * freq_res``, at ``5 L log2 L`` operations), the chirp (16 a bin for
each pol kept), each kept pol's ``nsub`` inverse FFTs of ``freq_res``
points, and the detection (4 a kept sample and plane).  The bytes are the
step's input, constants and output, each once: never the round trips that
the current kernels make between their passes, so a fused or re-split step
leaves the count as it is.  The peaks are the H100 SXM data sheet's, for a
card at its 700 W limit: device memory 3.35 TB/s, float32 outside the
tensor cores 67 TFLOP/s.  A step moved onto the tensor cores needs this
count re-based.
"""

from __future__ import annotations

import math

from .reference.geometry import Geometry

#: device-memory bytes a second and float32 operations a second (H100 SXM)
HBM_BYTES_S = 3.35e12
F32_OPS_S = 67e12


def front_ops(g: Geometry) -> float:
    """float32 operations of the filterbank over one block: both pols
    transformed, inverted and detected into one plane."""
    n, m = g.n_fft, g.freq_res
    fwd = 5 * 2 * n * math.log2(2 * n)
    per = (fwd + 16 * n * 2 + 2 * g.nsub * 5 * m * math.log2(m)
           + 4 * g.nsub * g.nkeep)
    return g.npart * per


def fold_bytes(g: Geometry) -> int:
    """Bytes of one fold step: the block's raw bytes, the chirp (float32 real
    and imaginary), the profiles and hits read and written, the anchors."""
    acc = g.nsub * g.nbin + g.nbin
    return g.block_bytes + 8 * g.n_fft + 8 * acc + 8 * g.npart


def bound_ms(nbytes: float, ops: float) -> tuple:
    """``(ms, by)``: the larger of the bytes at the memory rate and the
    operations at the float32 rate, and which of the two it is."""
    tb, to = nbytes / HBM_BYTES_S * 1e3, ops / F32_OPS_S * 1e3
    return (tb, "bytes") if tb >= to else (to, "operations")
