"""Coherent dedispersion chirp construction.

Equivalent of the reference ``dsp::Dedispersion``
(``Signal/General/Dedispersion.C``): builds the phase-coherent dedispersion
frequency response (chirp) for each channel, computes dispersion smearing
times and the number of overlap-save samples to discard.

The chirp phase at frequency offset ``f`` (MHz) from channel centre ``f0``
(MHz), for dispersion measure DM (pc cm^-3), is (``Dedispersion.C:534-545``)::

    phase(f) = -sign(bw) * 2*pi * (1e6 * DM / 2.41e-4) * f^2 / (f0^2 * (f0 + f))

with the dispersion constant ``dm_dispersion = 2.41e-4`` (``Dedispersion.C:28``).
The smearing time across a band [f1, f2] is ``D*(f1^-2 - f2^-2)`` seconds with
``D = DM/2.41e-4`` and f in MHz (``Dedispersion.C:348-356``).

All phase math is float64 on the host; phasors are cast to complex64 for the
device.  The DC phasor of the whole band is zapped (``Dedispersion.C:322-323``).
"""

from __future__ import annotations

import dataclasses
import math
from dataclasses import dataclass
from typing import Optional

import numpy as np

from .response import Response
from ..observation import Observation

#: MHz^2 pc^-1 cm^3 s — reference Dedispersion::dm_dispersion (Dedispersion.C:28)
DM_DISPERSION = 2.41e-4

#: fractional guard added to the smearing time (Dedispersion.C:30, smearing_buffer)
SMEARING_BUFFER = 0.1


def delay_time(dm: float, freq1: float, freq2: float) -> float:
    """Dispersion delay in seconds between two frequencies in MHz
    (``Dedispersion.C:348-356``)."""
    dispersion = dm / DM_DISPERSION
    return dispersion * (1.0 / freq1**2 - 1.0 / freq2**2)


def smearing_time(dm: float, cfreq: float, bw: float) -> float:
    """Smearing across a band centred on ``cfreq`` of width ``bw`` (MHz), in
    seconds (``Dedispersion.C:337-345``)."""
    return delay_time(dm, cfreq - abs(0.5 * bw), cfreq + abs(0.5 * bw))


def smearing_samples(dm: float, cfreq: float, bw: float, nchan: int,
                     buffer: float = SMEARING_BUFFER) -> int:
    """Smearing within the worst channel in complex samples, with guard
    (``Dedispersion.C:432-475``).

    The worst (most-smeared) channel is the lowest-frequency one; the
    per-channel complex sampling rate is |bw|/nchan MHz.
    """
    chanwidth = bw / nchan
    lowest_cfreq = cfreq - 0.5 * abs(bw) + 0.5 * abs(chanwidth)
    tsmear = smearing_time(dm, lowest_cfreq, chanwidth)
    sampling_rate = abs(chanwidth) * 1e6
    return int(math.ceil(tsmear * (1.0 + buffer) * sampling_rate))


@dataclass
class Dedispersion(Response):
    """The coherent-dedispersion chirp as a Response.

    Build with :meth:`build`; attributes beyond Response:
    """

    dispersion_measure: float = 0.0
    doppler_shift: float = 1.0
    centre_frequency: float = 0.0
    bandwidth: float = 0.0
    frequency_output: Optional[np.ndarray] = None  # MHz per channel
    bandwidth_output: Optional[np.ndarray] = None

    @classmethod
    def build(
        cls,
        dm: float,
        centre_frequency: float,
        bandwidth: float,
        nchan: int,
        ndat: int,
        doppler_shift: float = 1.0,
        dc_centred: bool = False,
        fractional_delay: bool = False,
        smear_buffer: float = SMEARING_BUFFER,
        zap_dc: bool = True,
    ) -> "Dedispersion":
        """Build the chirp, mirroring ``Dedispersion::build``
        (``Dedispersion.C:478-556``) in vectorized float64.

        Parameters match the reference: ``nchan`` channels across the signed
        ``bandwidth`` (MHz) about ``centre_frequency`` (MHz); ``ndat`` complex
        frequency points per channel.  Natural frequency ordering (see
        Response docstring).
        """
        centrefreq = centre_frequency / doppler_shift
        bw = bandwidth / doppler_shift
        sign = bw / abs(bw)
        chanwidth = bw / nchan
        binwidth = chanwidth / ndat

        lower_cfreq = centrefreq - 0.5 * bw
        if not dc_centred:
            lower_cfreq += 0.5 * chanwidth
        highest_freq = centrefreq + 0.5 * abs(bw - chanwidth)
        samp_int = 1.0 / chanwidth  # microseconds (quadrature sampling)

        dispersion_per_MHz = 1e6 * dm / DM_DISPERSION

        chan_cfreq = lower_cfreq + np.arange(nchan, dtype=np.float64) * chanwidth
        coeff = -sign * 2.0 * np.pi * dispersion_per_MHz / chan_cfreq**2

        # frequency offset of each bin from its channel centre
        freq = np.arange(ndat, dtype=np.float64) * binwidth - 0.5 * chanwidth

        phases = coeff[:, None] * freq[None, :] ** 2 / (chan_cfreq[:, None] + freq[None, :])

        if fractional_delay:
            delay = dispersion_per_MHz * (1.0 / chan_cfreq**2 - 1.0 / highest_freq**2)
            delay = -np.fmod(delay, samp_int)
            phases = phases + (-2.0 * np.pi) * freq[None, :] * delay[:, None]

        phasors = np.exp(1j * phases).astype(np.complex64)
        if zap_dc:
            # reference zaps the DC point of the whole response
            # (Dedispersion.C:322-323: phasors[0] = 0 in natural order)
            phasors[0, 0] = 0

        # overlap-save discard counts: the dispersive delay is negative
        # (earlier arrival) above the channel centre and positive below;
        # reference splits the smear into impulse_pos (high-frequency half)
        # and impulse_neg (Dedispersion::prepare via smearing_samples(half))
        nsmear_pos = cls._half_smearing_samples(dm, centrefreq, bw, nchan, +1, smear_buffer)
        nsmear_neg = cls._half_smearing_samples(dm, centrefreq, bw, nchan, -1, smear_buffer)

        return cls(
            phasors=phasors,
            impulse_pos=nsmear_pos,
            impulse_neg=nsmear_neg,
            dispersion_measure=dm,
            doppler_shift=doppler_shift,
            centre_frequency=centre_frequency,
            bandwidth=bandwidth,
            frequency_output=chan_cfreq,
            bandwidth_output=np.full(nchan, chanwidth),
        )

    @classmethod
    def build_interchannel_aligned(
        cls,
        dm: float,
        centre_frequency: float,
        bandwidth: float,
        nchan: int,
        ndat: int,
        **kw,
    ) -> "Dedispersion":
        """Chirp with inter-channel dispersion delays removed in the same
        response (the reference's ``SampleDelay``/-K op fused into the
        frequency response: a linear phase ramp exp(-2 pi i f dt_c) delays
        channel c by dt_c with sub-sample accuracy, costing zero extra ops).

        Channels align to the highest frequency in the band (reference
        ``DedispersionSampleDelay.C``).  The extra impulse_pos must cover the
        largest advance: an advanced output sample depends on input up to
        max(delay) samples in the future, so impulse_neg grows by that cover.
        """
        ded = cls.build(dm, centre_frequency, bandwidth, nchan, ndat, **kw)
        chan_cfreq = ded.frequency_output
        highest = max(
            centre_frequency + 0.5 * abs(bandwidth) - 0.5 * abs(bandwidth) / nchan,
            float(np.max(chan_cfreq)),
        )
        # delay of each channel centre relative to the highest frequency (s)
        delays = np.array([delay_time(dm, f, highest) for f in chan_cfreq])
        chan_rate = abs(bandwidth) / nchan * 1e6  # complex samples/s
        chanwidth = bandwidth / nchan
        binwidth = chanwidth / ndat
        # natural-order bin frequency offsets from the channel centre (MHz)
        freq = np.arange(ndat) * binwidth - 0.5 * chanwidth
        # remove the delay: multiply by exp(+2 pi i nu dt) with nu the
        # *baseband* frequency of the bin (dt in us).  For a negative
        # (lower-sideband) bandwidth the sky offset `freq` is the negated
        # baseband frequency, so the ramp carries the sideband sign — using
        # the sky offset directly would double the dispersion spread instead
        # of cancelling it.
        sideband = 1.0 if bandwidth > 0 else -1.0
        phase = sideband * 2.0 * np.pi * freq[None, :] * (delays[:, None] * 1e6)
        ded.phasors = (ded.phasors.astype(np.complex128)
                       * np.exp(1j * phase)).astype(np.complex64)
        extra = int(math.ceil(np.max(delays) * chan_rate)) + 1
        return dataclasses.replace(
            ded, impulse_neg=ded.impulse_neg + extra,
            phasors=ded.phasors)

    @staticmethod
    def _half_smearing_samples(dm: float, cfreq: float, bw: float, nchan: int,
                               half: int, buffer: float) -> int:
        """Smearing samples in the upper (+1) or lower (-1) half of the worst
        channel (reference ``Dedispersion::smearing_time(half)`` +
        ``smearing_samples``, ``Dedispersion.C:385-475``).

        Mirrors the reference exactly (``Dedispersion.C:385-430``): the band
        considered is centred at ``lowest_channel_centre + half*chanwidth/2``
        with width ``chanwidth/2`` — the reference's (slightly lopsided)
        convention — then scaled by the 10% guard and ceil'd
        (``smearing_samples``, ``Dedispersion.C:432-475``).  The upper half
        (+1) maps to impulse_pos, the lower (-1) to impulse_neg
        (``Dedispersion::prepare``, ``Dedispersion.C:216-247``).
        """
        ch_abs_bw = abs(bw) / nchan
        lowest_cfreq = cfreq - (abs(bw) - ch_abs_bw) / 2.0
        half_bw = ch_abs_bw / 2.0
        centre = lowest_cfreq + half * half_bw
        tsmear = smearing_time(dm, centre, half_bw)
        sampling_rate = ch_abs_bw * 1e6
        return int(math.ceil(abs(tsmear) * (1.0 + buffer) * sampling_rate))
