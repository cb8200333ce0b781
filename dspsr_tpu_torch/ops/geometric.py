"""Geometric (beamforming) delays: integer-sample + fractional/fringe phase.

The port's copy of ``dspsr_tpu/ops/geometric.py`` (numpy only).
Equivalent of the reference ``dsp::GeometricDelay``
(``Signal/General/GeometricDelay.C``, a ``SampleDelayFunction`` whose
reference implementation is an acknowledged skeleton — "HERE I would
compute the geometric delay..."): per-"telescope" (stored in the pol axis,
as the reference does) integer sample delays plus a complex frequency
response carrying the fractional delay and fringe rotation.  This version
actually computes the delay from an ITRF baseline and the source direction:

    tau(t) = (b . s_hat(t)) / c

with s_hat from the source hour angle/declination.  The integer part is an
integer-sample shift (the SampleDelay mechanism — here fused into the
frequency response as a full phase ramp, like the pipeline's -K alignment);
the fractional part and the fringe-stopping phase at the sky frequency ride
the per-channel response:

    R_p(f) = exp(-2 pi i (f_base + f) tau_p)

Applying R in the overlap-save convolution aligns both streams to the
phase center (sub-sample accurate), ready for coherent addition.
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Sequence, Tuple

import numpy as np

C_M_PER_S = 299792458.0
#: Earth rotation rate [rad/s of an sidereal day]
OMEGA_EARTH = 2.0 * math.pi / 86164.0905


def source_unit_vector(hour_angle_rad: float, dec_rad: float) -> np.ndarray:
    """Unit vector toward the source in the local (X toward meridian at
    equator, Y east, Z north celestial pole) frame used for baselines."""
    return np.array([
        math.cos(dec_rad) * math.cos(hour_angle_rad),
        -math.cos(dec_rad) * math.sin(hour_angle_rad),
        math.sin(dec_rad),
    ])


@dataclass
class GeometricDelay:
    """Per-stream geometric delays for a set of baselines.

    baselines_m: [nstream, 3] baseline vectors in metres (stream 0 is the
    reference antenna, typically the zero vector).  The streams live on the
    pol axis, matching the reference's two-telescope convention
    (``GeometricDelay.C`` npol=2 "representing two telescopes").
    """

    baselines_m: np.ndarray
    hour_angle_rad: float = 0.0
    dec_rad: float = 0.0

    def delays_seconds(self) -> np.ndarray:
        """tau per stream [s]: (b . s_hat)/c."""
        s = source_unit_vector(self.hour_angle_rad, self.dec_rad)
        return np.asarray(self.baselines_m, float) @ s / C_M_PER_S

    def delay_rate(self) -> np.ndarray:
        """d tau/dt per stream [s/s] from Earth rotation (fringe rate)."""
        h, d = self.hour_angle_rad, self.dec_rad
        dsdt = OMEGA_EARTH * np.array([
            -math.cos(d) * math.sin(h),
            -math.cos(d) * math.cos(h),
            0.0,
        ])
        return np.asarray(self.baselines_m, float) @ dsdt / C_M_PER_S

    def get_delay(self, ichan: int, ipol: int, rate: float) -> int:
        """Integer sample delay (reference ``GeometricDelay::get_delay``)."""
        return int(round(self.delays_seconds()[ipol] * rate))

    def response(self, nchan: int, nfft: int, centre_frequency: float,
                 bandwidth: float) -> Tuple[np.ndarray, np.ndarray]:
        """Split-complex phasors [nstream, nchan, nfft] in natural frequency
        order: exp(-2 pi i (f_sky) tau) over each channel's band.

        Multiplying a channel spectrum by this response applies the whole
        delay (integer + fractional) and stops the fringe at the sky
        frequency; frequencies in MHz, delays in seconds.
        """
        tau = self.delays_seconds()
        nstream = len(tau)
        chan_bw = bandwidth / nchan
        out_r = np.empty((nstream, nchan, nfft), np.float32)
        out_i = np.empty((nstream, nchan, nfft), np.float32)
        for c in range(nchan):
            f_lo = centre_frequency - bandwidth / 2.0 + c * chan_bw
            # intra-channel offsets in natural order, FFT-bin convention
            # (bin k at k*binwidth from the band edge, as ops/dedispersion)
            f = (f_lo + np.arange(nfft) * chan_bw / nfft) * 1e6  # Hz
            for p in range(nstream):
                ph = -2.0 * math.pi * f * tau[p]
                out_r[p, c] = np.cos(ph).astype(np.float32)
                out_i[p, c] = np.sin(ph).astype(np.float32)
        return out_r, out_i
