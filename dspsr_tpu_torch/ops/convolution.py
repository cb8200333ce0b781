"""Overlap-save convolution geometry (host side).

Counterpart of ``OverlapSavePlan`` in ``dspsr_tpu/ops/convolution.py``
(reference ``Convolution::prepare``, ``Convolution.C:105-221``): the static
plan of the ``nsub == 1`` convolution, pure coherent dedispersion (and
optionally polarization calibration) of each input channel at its own
resolution.  The transforms run inside the fused front end
(``ops.megakernel.build_megafil``) as a one-subband geometry; the JAX
package's XLA ``overlap_save_*`` functions belong to the general chain
(ROADMAP.md Queue 1 item 8).
"""

from __future__ import annotations

from dataclasses import dataclass


@dataclass(frozen=True)
class OverlapSavePlan:
    """Static geometry of the overlap-save streaming convolution.  Counts
    are in input samples unless suffixed ``_c`` (complex samples at the
    analytic rate)."""

    real_input: bool  # Signal::Nyquist input (real), else analytic (complex)
    n_fft: int  # complex points per window after the forward FFT
    nfilt_pos: int  # complex samples dropped from each window head
    nfilt_neg: int  # complex samples dropped from each window tail

    @property
    def nfilt_tot(self) -> int:
        return self.nfilt_pos + self.nfilt_neg

    @property
    def nsamp_fft(self) -> int:
        """Input samples per forward FFT (``Convolution.C:170-189``)."""
        return 2 * self.n_fft if self.real_input else self.n_fft

    @property
    def nsamp_overlap(self) -> int:
        return 2 * self.nfilt_tot if self.real_input else self.nfilt_tot

    @property
    def nsamp_step(self) -> int:
        return self.nsamp_fft - self.nsamp_overlap

    @property
    def nkeep_c(self) -> int:
        """Complex output samples kept per window."""
        return self.n_fft - self.nfilt_tot

    def npart(self, ndat: int) -> int:
        """Windows that fit in ``ndat`` input samples."""
        if ndat <= self.nsamp_overlap:
            return 0
        return (ndat - self.nsamp_overlap) // self.nsamp_step

    def block_ndat(self, npart: int) -> int:
        """Input samples consumed by ``npart`` windows (with the trailing
        overlap)."""
        return npart * self.nsamp_step + self.nsamp_overlap

    def output_ndat(self, npart: int) -> int:
        """Complex output samples of ``npart`` windows."""
        return npart * self.nkeep_c

    def validate(self):
        if self.n_fft < 2:
            raise ValueError("FFT too small")
        if self.nkeep_c <= 0:
            raise ValueError(
                f"n_fft={self.n_fft} <= nfilt_tot={self.nfilt_tot}: "
                "FFT length must exceed the smearing")
