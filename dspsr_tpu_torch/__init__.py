"""dspsr_tpu_torch: the PyTorch and CUDA port of dspsr_tpu for NVIDIA Hopper.

The JAX package ``dspsr_tpu`` stays in the repository unchanged as the
reference this port is tested against.  The port imports ``torch`` and
never ``jax``, nor anything of ``dspsr_tpu``: it keeps its own copies of the
JAX-free modules it needs (observation metadata, timing, readers and
writers, the dedispersion chirp, bit tables, SK limits, the run report).

Covered so far, for 8-bit input (real-sampled or complex, in TFP order or
the CASPSR layout): the fold main path on the fused fold kernel
(``mega_mode == "full"``, ``models.load_to_fold``), the hybrid fold engine
on the fused front end plus a plain PyTorch tail (``mega_mode ==
"hybrid"``: in-stream SK, the RFI filter, passband, pdmp, dump, several
pulsars, cyclic folding, the ``nsub == 1`` convolution and polarization
calibration) and the search path on the fused search front end (digifil:
``models.load_to_fil``, ``apps.digifil_app``).  The command-line tools
run as modules: ``apps.dspsr_app`` (dspsr, with ``-G``, the phase-locked
filterbank of ``ops.phase_locked``, and ``--fft-bench``, the measured FFT
lengths of ``utils.optimalfft``), ``apps.diagnostics``,
``apps.searchplot_app``, ``utils.fftbench`` and ``apps.decimator_app``
(the-decimator, a live ring to SIGPROC).  Every pipeline reads files or
live shared-memory rings (``io.hostio``: a POSIX ring and the psrdada-style
SysV hdu), and ``io.cfitsio`` reads its archives back through the system
cfitsio.  The port does everything the JAX package does; see ROADMAP.md
for what follows.
"""

from .device import launch_counts, reset_launch_counts, resolve_device

__all__ = ["launch_counts", "reset_launch_counts", "resolve_device"]
