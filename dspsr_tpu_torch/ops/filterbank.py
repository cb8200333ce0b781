"""Convolving-filterbank geometry (host side).

Counterpart of ``dspsr_tpu/ops/filterbank.py``: the static plan
(``FilterbankPlan``, reference ``Filterbank::make_preparations``) and the
metadata transition (``update_observation``).  The transforms themselves run
inside the fused kernel (``ops.megakernel``).
"""

from __future__ import annotations

from dataclasses import dataclass

from ..observation import Observation, Signal


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
