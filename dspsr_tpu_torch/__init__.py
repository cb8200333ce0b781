"""dspsr_tpu_torch: the PyTorch and CUDA port of dspsr_tpu for NVIDIA Hopper.

The JAX package ``dspsr_tpu`` stays in the repository unchanged as the
reference this port is tested against.  The port imports ``torch`` and never
``jax``; it reuses only the JAX-free modules of ``dspsr_tpu`` (observation
metadata, timing, readers and writers, the chirp builder, bit tables).

Covered so far, for real-sampled 8-bit input: the fold main path on the
fused fold kernel (``mega_mode == "full"``, ``models.load_to_fold``) and the
search path on the fused search front end (digifil: ``models.load_to_fil``,
``apps.digifil_app``).  See ROADMAP.md for what follows.
"""

from .device import launch_counts, reset_launch_counts, resolve_device

__all__ = ["launch_counts", "reset_launch_counts", "resolve_device"]
