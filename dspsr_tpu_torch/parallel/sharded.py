"""Device-mesh construction for the sharded pipelines.

Counterpart of ``dspsr_tpu/parallel/sharded.py``.  The multi-device
dataflows live in :mod:`parallel.pipeline` (fold mode, the LoadToFoldN
equivalent) and :mod:`parallel.search` (search mode, LoadToFilN); this
module holds the mesh they share.

Mesh axes:

- ``time``: the thread pool's analogue: each shard runs the single-device
  op chain on a contiguous stripe of raw bytes (``MultiThread.C``);
- ``chan``: the MPITrans channel scatter (``Kernel/Classes/MPITrans.C``):
  each shard owns a group of channels.

One controller process drives every shard of the mesh with explicit
launches on the shard's ``torch.device``.  A device may appear more than
once (``devices=[torch.device("cuda:0")] * 4``): the shards on it then run
one after another, which checks the sharded dataflow on one card but
measures no speed-up.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional, Sequence

import numpy as np
import torch


@dataclass(frozen=True, eq=False)
class Mesh:
    """A 2-D ``(time, chan)`` object array of ``torch.device``; ``shape``
    maps each axis to its length, as ``jax.sharding.Mesh.shape``."""

    devices: np.ndarray

    axis_names = ("time", "chan")

    @property
    def shape(self) -> dict:
        return dict(zip(self.axis_names, self.devices.shape))

    def device(self, t: int, c: int = 0) -> torch.device:
        return self.devices[t, c]

    def unique_devices(self) -> list:
        """The mesh's distinct devices, in mesh order."""
        seen = []
        for d in self.devices.ravel():
            if d not in seen:
                seen.append(d)
        return seen


def make_mesh(n_devices: Optional[int] = None, nchan_shards: int = 1,
              devices: Optional[Sequence] = None) -> Mesh:
    """A ``(n_devices // nchan_shards, nchan_shards)`` mesh of the first
    ``n_devices`` of ``devices`` (default: every visible CUDA card,
    ``cuda:0`` to ``cuda:count-1``; raises when there is none, and never
    falls back to the CPU).  A device list repeats only when the caller
    passes one that repeats."""
    if devices is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "make_mesh: no CUDA device is visible; pass devices= "
                "(e.g. [torch.device('cpu')] * n) to run on the CPU")
        devices = [torch.device("cuda", i)
                   for i in range(torch.cuda.device_count())]
    devices = [torch.device(d) for d in devices]
    n = n_devices or len(devices)
    if n > len(devices):
        raise ValueError(f"n_devices={n} but only {len(devices)} devices")
    if nchan_shards < 1 or n % nchan_shards:
        raise ValueError(
            f"n_devices={n} not divisible by nchan_shards={nchan_shards}")
    arr = np.empty(n, dtype=object)
    arr[:] = devices[:n]
    return Mesh(arr.reshape(n // nchan_shards, nchan_shards))
