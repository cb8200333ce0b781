"""Overlap-save convolution: the plan, and the general chain's transforms.

Counterpart of ``dspsr_tpu/ops/convolution.py`` (reference
``Convolution::prepare``, ``Convolution.C:105-221``, and the convolution
loop, ``Convolution.C:389-461``): the static plan of the ``nsub == 1``
convolution, pure coherent dedispersion (and optionally polarization
calibration) of each input channel at its own resolution.  The fused front
end (``ops.megakernel.build_megafil``) runs it as a one-subband geometry;
the general chain runs :func:`overlap_save_convolve` and
:func:`overlap_save_convolve_jones` on torch ``complex64`` streams
(``ops.fft``).  Real (Nyquist) input gives ``n_fft`` positive-frequency
bins of an analytic signal at half the rate; the inverse is scaled by
``1/N``, so the output has the input's scale.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional, Sequence

import torch

from . import fft


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


def frame(x: torch.Tensor, nsamp_fft: int, nsamp_step: int,
          npart: int) -> torch.Tensor:
    """The overlap-save windows of the last axis: ``x [..., ndat]`` ->
    ``[..., npart, nsamp_fft]``, window ``p`` starting at ``p *
    nsamp_step`` (``Convolution.C:389-391``).  A view (``Tensor.unfold``)
    when ``x`` holds every window; otherwise ``x`` is zero-padded at the
    end first, as the JAX package's ``frame`` reads zeros past it."""
    need = (npart - 1) * nsamp_step + nsamp_fft
    if x.shape[-1] < need:
        x = torch.nn.functional.pad(x, (0, need - x.shape[-1]))
    return x[..., :need].unfold(-1, nsamp_fft, nsamp_step)


def forward_spectra(x: torch.Tensor, plan: OverlapSavePlan, npart: int,
                    apodization: Optional[torch.Tensor] = None
                    ) -> torch.Tensor:
    """Framed windows, tapered by ``apodization [nsamp_fft]`` when given
    (``Convolution.C:379-387``), and their spectra ``[..., npart, n_fft]``
    in FFT bin order: ``rfft`` of real input (Nyquist dropped), ``fft`` of
    complex."""
    w = frame(x, plan.nsamp_fft, plan.nsamp_step, npart)
    if apodization is not None:
        w = w * apodization
    return fft.rfft(w) if plan.real_input else fft.fft(w)


def _keep(t: torch.Tensor, plan: OverlapSavePlan) -> torch.Tensor:
    """Each window's kept samples, concatenated: ``[nchan, npol, npart,
    n_fft]`` -> ``[nchan, npol, npart * nkeep_c]``."""
    k = t[..., plan.nfilt_pos:plan.nfilt_pos + plan.nkeep_c]
    return k.reshape(*t.shape[:2], -1)


def overlap_save_convolve(x: torch.Tensor, response_fft_order: torch.Tensor,
                          plan: OverlapSavePlan, npart: int,
                          apodization: Optional[torch.Tensor] = None
                          ) -> torch.Tensor:
    """Convolve a block with a per-channel frequency response.

    ``x``: ``[nchan, npol, plan.block_ndat(npart)]``, real when
    ``plan.real_input``, else complex; ``response_fft_order``: complex
    ``[nchan, n_fft]`` in FFT bin order (``Response.fft_order``).  Returns
    the complex ``[nchan, npol, npart * nkeep_c]`` analytic voltages."""
    plan.validate()
    spec = forward_spectra(x, plan, npart, apodization)
    spec = spec * response_fft_order[:, None, None, :]
    return _keep(fft.ifft(spec), plan)


def overlap_save_convolve_jones(x: torch.Tensor,
                                response_fft_order: Sequence[torch.Tensor],
                                plan: OverlapSavePlan, npart: int,
                                apodization: Optional[torch.Tensor] = None
                                ) -> torch.Tensor:
    """Matrix (Jones) convolution of the two pols (``Convolution.C:425-436``):
    ``response_fft_order`` is ``(J00, J01, J10, J11)``, each complex
    ``[nchan, n_fft]`` in FFT bin order (``ops.polncal.jones_fft_order``),
    and output pol ``p`` is ``J[p, 0] X_0 + J[p, 1] X_1``.  ``x`` is
    ``[nchan, 2, block_ndat]``; returns complex ``[nchan, 2, npart *
    nkeep_c]``."""
    plan.validate()
    spec = forward_spectra(x, plan, npart, apodization)
    p, q = spec[:, 0], spec[:, 1]
    j00, j01, j10, j11 = (j[:, None, :] for j in response_fft_order)
    mixed = torch.stack([j00 * p + j01 * q, j10 * p + j11 * q], dim=1)
    return _keep(fft.ifft(mixed), plan)
