"""dspsr_tpu_torch: the PyTorch and CUDA port of dspsr_tpu for NVIDIA Hopper.

The JAX package ``dspsr_tpu`` stays in the repository unchanged as the
reference this port is tested against.  The port imports ``torch`` and never
``jax``; it reuses only the JAX-free modules of ``dspsr_tpu`` (observation
metadata, timing, readers and writers, the chirp builder, bit tables).

Covered so far: the fold main path on the fused kernel (``mega_mode ==
"full"``) for real-sampled 8-bit input.  See ROADMAP.md for what follows.
"""

from .device import launch_counts, reset_launch_counts, resolve_device

__all__ = ["launch_counts", "reset_launch_counts", "resolve_device"]
