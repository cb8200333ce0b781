"""The input: a page-locked host ring replayed as fast as the pipeline reads.

dspsr's CUDA path page-locks the psrdada ring it reads
(``dada_cuda_dbregister``), so each block's copy to the card runs from
pinned memory.  Here the ring holds ``K`` distinct blocks of 8-bit
offset-binary samples, Gaussian noise of ``rms`` levels made on the card
from the seed, and after them the first ``block - stride`` bytes again:
the stream is periodic with ``K`` strides, and every block-aligned read is
a view of the buffer, handed to the pipeline with no copy.
"""

from __future__ import annotations

import numpy as np
import torch

from dspsr_tpu_torch.io.sources import Source

#: samples made in one call of the generator
CHUNK = 1 << 26


def noise_bytes(n: int, rms: float, gen: torch.Generator,
                out: torch.Tensor) -> None:
    """``n`` offset-binary 8-bit codes of Gaussian noise at ``rms`` levels
    into ``out`` (uint8 on the generator's device): the nearest level
    ``code - 127.5`` to each sample, clipped to the codes."""
    for a in range(0, n, CHUNK):
        m = min(CHUNK, n - a)
        x = torch.randn(m, generator=gen, device=out.device)
        out[a:a + m] = torch.floor(x * rms + 128.0).clamp_(0, 255).to(
            torch.uint8)


class PinnedRing:
    """``nblocks`` strides of noise and the overlap, in pinned host memory.

    ``blocks()`` is the ring as a numpy array; ``view(offset, nbytes)`` a
    slice of it."""

    def __init__(self, nblocks: int, stride_bytes: int, block_bytes: int,
                 rms: float, seed: int, device: torch.device):
        if nblocks < 1 or block_bytes < stride_bytes:
            raise ValueError("a ring needs a block at least a stride long")
        self.nblocks = nblocks
        self.stride_bytes = stride_bytes
        self.block_bytes = block_bytes
        self.period = nblocks * stride_bytes
        total = self.period + block_bytes - stride_bytes
        pinned = device.type == "cuda"
        self.host = torch.empty(total, dtype=torch.uint8, pin_memory=pinned)
        gen = torch.Generator(device=device)
        gen.manual_seed(seed)
        stage = torch.empty(stride_bytes, dtype=torch.uint8, device=device)
        for k in range(nblocks):
            noise_bytes(stride_bytes, rms, gen, stage)
            self.host[k * stride_bytes:(k + 1) * stride_bytes].copy_(stage)
        del stage
        self.host[self.period:] = self.host[:total - self.period]
        self.array = self.host.numpy()

    def view(self, offset: int, nbytes: int) -> np.ndarray:
        """Bytes ``offset .. offset + nbytes`` of the periodic stream."""
        a = offset % self.period
        if a + nbytes > self.array.size:
            raise ValueError(f"a read of {nbytes} bytes at {offset} is not "
                             "block-aligned")
        return self.array[a:a + nbytes]

    def block(self, k: int) -> np.ndarray:
        """Ring block ``k`` (its overlap included)."""
        return self.view(k * self.stride_bytes, self.block_bytes)


class RingSource(Source):
    """The program's ``Source`` (``io/sources.py``) over a ``PinnedRing``,
    attached once the pipeline is built (``source.ring = ...``): the
    pipeline's geometry sizes the ring.  Reads are views."""

    def __init__(self, obs, bytes_per_sample: int):
        self.obs = obs
        self.bytes_per_sample = bytes_per_sample
        self.ring = None

    @property
    def total_samples(self) -> int:
        return self.obs.ndat

    def read_samples(self, start: int, nsamp: int) -> np.ndarray:
        with torch.profiler.record_function("portbench.read"):
            return self.ring.view(start * self.bytes_per_sample,
                                  nsamp * self.bytes_per_sample)
