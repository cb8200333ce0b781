"""Block data sources.

The readers (``DADAFile``, ``DummySource``, ``RawFileSource``,
``open_source``) are the JAX package's own, which are JAX-free and return
numpy bytes.  What is ported is the generator that makes the ``DummyFile``
benchmark bytes on the device, so no host-to-device copy sits in a measured
path.
"""

from __future__ import annotations

import torch

from dspsr_tpu.io.sources import (  # noqa: F401  (re-exported)
    DADAFile, DummySource, RawFileSource, Source, open_source)

_M32 = 0xFFFFFFFF


def _mul32(h: torch.Tensor, c: int) -> torch.Tensor:
    """(h * c) mod 2^32 for 0 <= h < 2^32, in int64 without overflow."""
    lo = h * (c & 0xFFFF)
    hi = ((h * (c >> 16)) & 0xFFFF) << 16
    return (lo + hi) & _M32


def device_noise_bytes(start_byte: int, nbytes: int, device) -> torch.Tensor:
    """Pseudo-noise ``uint8[nbytes]`` made on ``device``: the same bytes as
    ``dspsr_tpu.io.sources.device_noise_bytes`` (the 32-bit multiply-xorshift
    of the byte index, which wraps at 2^32), a different stream from
    ``DummySource.read_samples``."""
    i = (torch.arange(nbytes, dtype=torch.int64, device=device)
         + (int(start_byte) & _M32)) & _M32
    h = _mul32(i, 2654435761)
    h = h ^ (h >> 15)
    h = _mul32(h, 0x846CA68B)
    h = h ^ (h >> 13)
    return (h & 0xFF).to(torch.uint8)
