"""Convolving filterbank: the plan, and the general chain's transforms.

Counterpart of ``dspsr_tpu/ops/filterbank.py`` (reference
``dsp::Filterbank``, ``Filterbank.C``): the static plan
(``FilterbankPlan``, ``Filterbank::make_preparations``), the metadata
transition (``update_observation``) and, for the general chain, the
transforms on torch ``complex64`` streams (``ops.fft``).  Each window of
``nsamp_fft`` input samples is transformed into ``n_fft = nchan_subband *
freq_res`` bins in natural order (complex input is ``fftshift``ed), split
into ``nchan_subband`` chunks of ``freq_res`` bins, optionally multiplied
by a natural-order response, and each chunk is ``ifftshift``ed and
inverse-transformed, keeping ``nkeep`` samples from ``nfilt_pos`` on
(``Filterbank.C:477-670``); with ``freq_res == 1`` the bins are the output
samples.  Output channels are in natural order, ``c = ichan_in *
nchan_subband + isub``.  The fused kernels run the same transforms
(``ops.megakernel``).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional

import torch

from ..observation import Observation, Signal
from . import fft
from .convolution import frame


@dataclass(frozen=True)
class FilterbankPlan:
    """Static geometry (reference ``Filterbank::make_preparations``,
    ``Filterbank.C:55-263``)."""

    real_input: bool
    nchan_subband: int  # output channels per input channel
    freq_res: int  # complex points per subband per window
    nfilt_pos: int = 0
    nfilt_neg: int = 0

    @property
    def n_fft(self) -> int:
        return self.nchan_subband * self.freq_res

    @property
    def nfilt_tot(self) -> int:
        return self.nfilt_pos + self.nfilt_neg

    @property
    def nsamp_fft(self) -> int:
        return 2 * self.n_fft if self.real_input else self.n_fft

    @property
    def nsamp_overlap(self) -> int:
        """Input samples of window overlap (``Filterbank.C:141-152``)."""
        mult = 2 if self.real_input else 1
        return mult * self.nfilt_tot * self.nchan_subband

    @property
    def nsamp_step(self) -> int:
        return self.nsamp_fft - self.nsamp_overlap

    @property
    def nkeep(self) -> int:
        """Output samples kept per window per subband."""
        return self.freq_res - self.nfilt_tot

    def npart(self, ndat: int) -> int:
        if ndat <= self.nsamp_overlap:
            return 0
        return (ndat - self.nsamp_overlap) // self.nsamp_step

    def block_ndat(self, npart: int) -> int:
        return npart * self.nsamp_step + self.nsamp_overlap

    def validate(self):
        if self.freq_res <= self.nfilt_tot:
            raise ValueError(
                f"freq_res={self.freq_res} <= nfilt_tot={self.nfilt_tot}")
        if self.nchan_subband < 1:
            raise ValueError("nchan_subband must be >= 1")


def forward_spectra_chunked(x: torch.Tensor, plan: FilterbankPlan,
                            npart: int,
                            apodization: Optional[torch.Tensor] = None
                            ) -> torch.Tensor:
    """Frame, taper (``apodization [nsamp_fft]``, ``Convolution.C:379-387``),
    forward transform and chunk a block ``x [nchan_in, npol, ndat]`` (real
    when ``plan.real_input``, else complex): complex ``[nchan_in *
    nchan_subband, npol, npart, freq_res]`` in natural order.  The passband
    and the RFI zap read these spectra before the response."""
    plan.validate()
    nchan_in, npol = x.shape[:2]
    w = frame(x, plan.nsamp_fft, plan.nsamp_step, npart)
    if apodization is not None:
        w = w * apodization
    spec = fft.rfft(w) if plan.real_input else fft.fftshift(fft.fft(w))
    spec = spec.reshape(nchan_in, npol, npart, plan.nchan_subband,
                        plan.freq_res).movedim(3, 1)
    return spec.reshape(nchan_in * plan.nchan_subband, npol, npart,
                        plan.freq_res)


def apply_response_chunked(spec: torch.Tensor,
                           response_natural: Optional[torch.Tensor],
                           rfi_zap: Optional[tuple] = None,
                           nchan_sub_present: Optional[int] = None
                           ) -> torch.Tensor:
    """Multiply the natural-order response ``[nchan, freq_res]`` (complex)
    into chunked spectra ``[nchan, npol, npart, freq_res]`` ("convolve
    during"), then, with ``rfi_zap = (median_width, threshold)``, zero the
    bins the block's own bandpass flags (``ops.rfifilter``); the median runs
    across each input channel's ``nchan_sub_present`` subbands (default:
    all channels)."""
    if response_natural is not None:
        spec = spec * response_natural.reshape(
            spec.shape[0], 1, 1, spec.shape[-1])
    if rfi_zap is not None:
        from .rfifilter import rfi_bandpass_weights

        nchan, npol, npart, fr = spec.shape
        nsub = nchan_sub_present or nchan
        # [nchan_in, npol, npart, nsub, fr]: each input channel's band
        v = spec.reshape(nchan // nsub, nsub, npol, npart, fr).movedim(1, 3)
        v = v * rfi_bandpass_weights(v, *rfi_zap)
        spec = v.movedim(3, 1).reshape(nchan, npol, npart, fr)
    return spec


def invert_subbands(spec: torch.Tensor, plan: FilterbankPlan) -> torch.Tensor:
    """Each chunk's inverse transform and kept samples: ``[nchan, npol,
    npart, freq_res]`` -> complex ``[nchan, npol, npart * nkeep]``; with
    ``freq_res == 1`` the bins themselves."""
    nchan, npol = spec.shape[:2]
    if plan.freq_res == 1:
        return spec[..., 0]
    t = fft.ifft(fft.ifftshift(spec))
    k = t[..., plan.nfilt_pos:plan.nfilt_pos + plan.nkeep]
    return k.reshape(nchan, npol, -1)


def filterbank_block(x: torch.Tensor, plan: FilterbankPlan, npart: int,
                     response_natural: Optional[torch.Tensor] = None,
                     rfi_zap: Optional[tuple] = None,
                     apodization: Optional[torch.Tensor] = None
                     ) -> torch.Tensor:
    """Channelize a block ``x [nchan_in, npol, plan.block_ndat(npart)]``,
    optionally convolving the natural-order response ``[nchan_in *
    nchan_subband, freq_res]`` and zapping RFI: complex ``[nchan_in *
    nchan_subband, npol, npart * nkeep]``."""
    spec = forward_spectra_chunked(x, plan, npart, apodization)
    spec = apply_response_chunked(spec, response_natural, rfi_zap,
                                  nchan_sub_present=plan.nchan_subband)
    return invert_subbands(spec, plan)


def update_observation(obs: Observation, plan: FilterbankPlan) -> Observation:
    """Metadata transition applied by the filterbank
    (``Filterbank::prepare_output``, ``Filterbank.C:265-380``): subbands are
    complex baseband, dual-sideband, at ``rate * freq_res / nsamp_fft``."""
    ratechange = plan.freq_res / plan.nsamp_fft
    return obs.replace(
        nchan=obs.nchan * plan.nchan_subband,
        ndim=2,
        state=Signal.ANALYTIC,
        rate=obs.rate * ratechange,
        dc_centred=False,
        dual_sideband=plan.freq_res > 1,
    )
