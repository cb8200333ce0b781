"""Device selection and kernel launch counters.

Every entry point of the port takes an explicit ``device``.  A request for
CUDA with no card present raises; nothing falls back to the CPU.

The launch counters let a run prove that its main path went through the
hand-written kernels: each kernel wrapper adds one to its own count where it
launches the kernel, and nowhere else (``mega_ja98`` counts the JA98
pre-pass that both fused kernels run on dynamic 2-bit input).
"""

from __future__ import annotations

import numpy as np
import torch

#: kernel name -> number of launches since the last reset
_LAUNCHES: dict[str, int] = {"megastep": 0, "megafil": 0, "mega_ja98": 0}


def resolve_device(device) -> torch.device:
    """``device`` (a string or ``torch.device``) as a ``torch.device``;
    raises ``RuntimeError`` when CUDA is asked for and no card is present."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"device {device!r} requested but torch.cuda.is_available() is "
            "False; pass device='cpu' to run the plain PyTorch path")
    return dev


def count_launch(name: str) -> None:
    """Record one launch of kernel ``name`` (called by its wrapper)."""
    _LAUNCHES[name] += 1


def launch_counts() -> dict[str, int]:
    """A copy of the per-kernel launch counts."""
    return dict(_LAUNCHES)


def reset_launch_counts() -> None:
    for name in _LAUNCHES:
        _LAUNCHES[name] = 0


def host_to_device(a: np.ndarray, device: torch.device) -> torch.Tensor:
    """A host array on ``device``: through pinned memory and without waiting
    for the device on CUDA, a plain copy on the CPU."""
    t = torch.from_numpy(a)
    if device.type == "cuda":
        return t.pin_memory().to(device, non_blocking=True)
    return t.to(device)
