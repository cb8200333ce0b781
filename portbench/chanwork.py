"""The least work one fold step of channelised complex input needs
(``reference/channelised.py``), counted as ``portbench/work.py`` counts the
one real channel's, whose peaks and ``bound_ms`` it shares.

Per window and input channel: each pol's ``n_fft``-point complex forward
FFT (``5 L log2 L`` operations), the chirp (16 a bin for each pol), each
pol's ``nsub`` inverse FFTs of ``freq_res`` points, and the detection (4 a
kept sample and plane).  The bytes are the step's input, constants and
output, each once: the block's raw bytes, every channel's chirp (float32
real and imaginary), the profiles and hits read and written, the anchors.
Never the round trips between the kernels' passes, nor the channel
transpose's copy: a fused or re-split step leaves the count as it is.
"""

from __future__ import annotations

import math

from .reference.channelised import ChannelGeometry


def chan_front_ops(g: ChannelGeometry) -> float:
    """float32 operations of the filterbank over one block."""
    n, m = g.n_fft, g.freq_res
    per = g.npol * (5 * n * math.log2(n) + 16 * n
                    + g.nsub * 5 * m * math.log2(m)) + 4 * g.nsub * g.nkeep
    return g.nchan_in * g.npart * per


def chan_fold_bytes(g: ChannelGeometry) -> int:
    """Bytes of one fold step."""
    acc = g.nchan_in * (g.nsub * g.nbin + g.nbin)
    return g.block_bytes + 8 * g.nchan_in * g.n_fft + 8 * acc + 8 * g.npart
