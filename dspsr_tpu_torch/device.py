"""Device selection and the device counters.

Every entry point of the port takes an explicit ``device``.  A request for
CUDA with no card present raises; nothing falls back to the CPU.

The counters are always on (a dict increment each) and count where the work
is enqueued, nowhere else:

- ``megastep``, ``megafil``: launches of each fused kernel's wrapper
  (``kernels/megastep.py``, ``kernels/megafil.py``); ``chip_smoke.py`` holds
  them against the blocks to prove a main path went through the kernels;
- ``mega_ja98``: launches of the JA98 pre-pass that both fused kernels run
  on dynamic 2-bit input; ``chip_smoke.py`` as above;
- ``kernels``: CUDA kernels the wrappers' C entry points enqueued, as each
  returns them; the run report's counters (``utils/report.py``), which
  ``portbench/metrics/kernels_per_block.py`` reads;
- ``h2d_copies``, ``h2d_bytes``: copies and bytes of ``host_to_device``
  and of ``BlockStaging``; the run report's counters;
- ``h2d_staged``: blocks whose copies went through ``BlockStaging``'s copy
  stream (the fold's blocks on a card); the run report's counter;
- ``ftp_bytes``: bytes the fused fold step's channel-transposing pre-pass
  read and wrote (``ops/megakernel.py::ftp_traffic``; on the CPU the plain
  step's transpose of the same bytes): 0 on one input channel; the run
  report's counter.
"""

from __future__ import annotations

import numpy as np
import torch

#: counter name -> its count since the last reset
_LAUNCHES: dict[str, int] = {"megastep": 0, "megafil": 0, "mega_ja98": 0,
                             "kernels": 0, "h2d_copies": 0, "h2d_bytes": 0,
                             "h2d_staged": 0, "ftp_bytes": 0}


def resolve_device(device) -> torch.device:
    """``device`` (a string or ``torch.device``) as a ``torch.device``;
    raises ``RuntimeError`` when CUDA is asked for and no card is present."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"device {device!r} requested but torch.cuda.is_available() is "
            "False; pass device='cpu' to run the plain PyTorch path")
    return dev


def count_launch(name: str, kernels: int = 0) -> None:
    """Record one launch of kernel ``name`` by its wrapper, which enqueued
    ``kernels`` CUDA kernels."""
    _LAUNCHES[name] += 1
    _LAUNCHES["kernels"] += kernels


def count_bytes(name: str, nbytes: int) -> None:
    """Add ``nbytes`` to the byte counter ``name``."""
    _LAUNCHES[name] += nbytes


def launch_counts() -> dict[str, int]:
    """A copy of the counters."""
    return dict(_LAUNCHES)


def reset_launch_counts() -> None:
    for name in _LAUNCHES:
        _LAUNCHES[name] = 0


def host_to_device(a: np.ndarray, device: torch.device) -> torch.Tensor:
    """A host array on ``device``: through pinned memory and without waiting
    for the device on CUDA, a plain copy on the CPU."""
    _LAUNCHES["h2d_copies"] += 1
    _LAUNCHES["h2d_bytes"] += a.nbytes
    t = torch.from_numpy(a)
    if device.type == "cuda":
        return t.pin_memory().to(device, non_blocking=True)
    return t.to(device)


class BlockStaging:
    """A block's host arrays to a CUDA card on a copy stream of the
    owner's, into two device slots that alternate from block to block, so
    that block n+1's copy runs while the current stream (the step's) works
    on block n.

    ``put`` copies one block into the next slot and makes the step's stream
    wait for the copies; ``release`` marks, on the step's stream, the end
    of the block's last use of its slot, which the slot's next copy waits
    for.  Events order the two streams: the host waits for neither.  Copy
    n thus starts once step n-2 has freed its slot, no later than on one
    stream, where it follows step n-1.  A slot's buffers are made at the
    first block and again only when the arrays' shapes or dtypes change."""

    def __init__(self, device: torch.device):
        self.device = device
        self.stream = torch.cuda.Stream(device=device)
        self._slots: list = [None, None]
        self._copied = [torch.cuda.Event(), torch.cuda.Event()]
        self._freed = [torch.cuda.Event(), torch.cuda.Event()]
        self._k = 1  # the slot of the last block

    def put(self, arrays, report) -> tuple:
        """``arrays`` (host arrays) in the next slot's device buffers, on
        the copy stream inside ``report``'s ``h2d`` span; the step's stream
        waits for them inside its ``h2d_wait`` span."""
        k = self._k = 1 - self._k
        hosts = [torch.from_numpy(a) for a in arrays]
        step = torch.cuda.current_stream(self.device)
        slot = self._slots[k]
        if slot is None or [(b.shape, b.dtype) for b in slot] \
                != [(h.shape, h.dtype) for h in hosts]:
            slot = self._slots[k] = tuple(
                torch.empty(h.shape, dtype=h.dtype, device=self.device)
                for h in hosts)
            # new buffers may reuse memory that work still queued on the
            # step's stream reads
            self.stream.wait_stream(step)
        self.stream.wait_event(self._freed[k])
        with torch.cuda.stream(self.stream), report.device("h2d"):
            for b, h in zip(slot, hosts):
                # pin_memory() is the tensor itself when it is pinned
                b.copy_(h.pin_memory(), non_blocking=True)
        self._copied[k].record(self.stream)
        with report.device("h2d_wait"):
            step.wait_event(self._copied[k])
        _LAUNCHES["h2d_copies"] += len(hosts)
        _LAUNCHES["h2d_bytes"] += sum(a.nbytes for a in arrays)
        _LAUNCHES["h2d_staged"] += 1
        return slot

    def release(self) -> None:
        """The last block's slot is free once the step's stream has done
        what is enqueued on it now."""
        self._freed[self._k].record(torch.cuda.current_stream(self.device))
