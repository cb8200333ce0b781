"""Observation metadata record.

TPU-native equivalent of the reference's ``dsp::Observation``
(``Kernel/Classes/dsp/Observation.h:29-392``): a plain-Python metadata record
describing a stream of sampled telescope voltages.  Unlike the reference it is
a frozen-ish dataclass passed by value between pipeline stages; all mutation
happens through :meth:`replace`.

Conventions (identical to the reference):

- ``bandwidth`` sign encodes sideband sense (negative = lower sideband).
- ``centre_frequency`` is the centre of the full band, in MHz.
- ``state`` describes what one sample is (see :class:`Signal`).
- ``rate`` is the sampling rate in Hz (samples per second per channel).
- ``dc_centred``: whether the centre frequency of each channel sits on the DC
  bin of that channel's spectrum.
"""

from __future__ import annotations

import dataclasses
import enum
from typing import Optional

from .timing.mjd import MJD


class Signal(enum.Enum):
    """Signal state of the data (reference ``Signal::State``)."""

    #: Real-sampled (Nyquist) voltages, ndim == 1.
    NYQUIST = "Nyquist"
    #: Complex (analytic) voltages, ndim == 2.
    ANALYTIC = "Analytic"
    #: Total intensity PP+QQ, ndim == 1, npol == 1.
    INTENSITY = "Intensity"
    #: Detected but unsummed polarizations, npol == 2.
    PPQQ = "PPQQ"
    #: Single polarization detected.
    PP = "PP"
    QQ = "QQ"
    #: Square-law total power to the nth power (n=2): (PP+QQ)^2
    #: (reference ``Signal::NthPower``, dspsr -d 3).
    NTHPOWER = "NthPower"
    #: PP, QQ, Re[P*Q], Im[P*Q] (reference ``cross_detect.ic``).
    COHERENCE = "Coherence"
    #: Stokes I,Q,U,V (reference ``stokes_detect.ic``).
    STOKES = "Stokes"
    #: Nth power / generic detected.
    NTH_POWER = "NthPower"
    #: Fourth-order moments.
    FOURTH_MOMENT = "FourthMoment"

    @property
    def detected(self) -> bool:
        return self not in (Signal.NYQUIST, Signal.ANALYTIC)

    @property
    def npol(self) -> int:
        """Number of output polarization products for a detected state."""
        return {
            Signal.INTENSITY: 1,
            Signal.PP: 1,
            Signal.QQ: 1,
            Signal.PPQQ: 2,
            Signal.COHERENCE: 4,
            Signal.STOKES: 4,
        }.get(self, 0)


class Basis(enum.Enum):
    LINEAR = "Linear"
    CIRCULAR = "Circular"
    ELLIPTICAL = "Elliptical"


@dataclasses.dataclass
class Observation:
    """Metadata describing a raw data stream.

    Mirrors the attribute surface of ``dsp::Observation``
    (``Kernel/Classes/dsp/Observation.h``), minus the C++ plumbing.
    """

    # dimensions
    nchan: int = 1
    npol: int = 1
    ndim: int = 1
    nbit: int = 8
    ndat: int = 0

    # band
    centre_frequency: float = 0.0  # MHz
    bandwidth: float = 0.0  # MHz, sign = sideband sense
    rate: float = 0.0  # Hz, per-channel sampling rate
    dc_centred: bool = False
    swap: bool = False  # halves of the band are swapped
    nsub_swap: int = 0  # band swapped within groups of nsub channels
    dual_sideband: bool = False

    # time
    start_time: MJD = dataclasses.field(default_factory=MJD)
    obs_offset: int = 0  # bytes offset of first sample from UTC_START

    # signal
    state: Signal = Signal.INTENSITY
    basis: Basis = Basis.LINEAR

    # astronomy
    source: str = ""
    coordinates: str = ""  # "hh:mm:ss dd:mm:ss"
    dispersion_measure: float = 0.0  # pc cm^-3
    rotation_measure: float = 0.0  # rad m^-2

    # provenance
    telescope: str = ""
    receiver: str = ""
    instrument: str = ""
    format: str = ""
    mode: str = ""  # PSR | CAL
    calfreq: float = 0.0  # Hz, for MODE=CAL square-wave

    # scale bookkeeping (reference Observation::scale)
    scale: float = 1.0

    def replace(self, **kw) -> "Observation":
        return dataclasses.replace(self, **kw)

    # ---- derived quantities (reference Observation.h accessors) ----

    @property
    def nbytes_per_sample(self) -> float:
        """Bytes per time sample over all chan/pol/dim."""
        return self.nchan * self.npol * self.ndim * self.nbit / 8.0

    def nbytes(self, ndat: Optional[int] = None) -> int:
        n = self.ndat if ndat is None else ndat
        total_bits = n * self.nchan * self.npol * self.ndim * self.nbit
        return total_bits // 8

    @property
    def chan_bandwidth(self) -> float:
        """Signed bandwidth of one channel in MHz."""
        return self.bandwidth / self.nchan

    def centre_frequency_of(self, ichan: int) -> float:
        """Centre frequency of channel ``ichan`` in MHz.

        Follows ``Observation::get_centre_frequency(ichan)`` conventions:
        channel 0 is at the lower edge of the band (plus half a channel when
        not dc_centred); the sign of ``bandwidth`` orders the channels.
        """
        bw = self.bandwidth
        chanwidth = bw / self.nchan
        lower = self.centre_frequency - 0.5 * bw
        if not self.dc_centred:
            lower += 0.5 * chanwidth
        return lower + ichan * chanwidth

    @property
    def end_time(self) -> MJD:
        if self.rate <= 0:
            return self.start_time
        return self.start_time + self.ndat / self.rate

    def samples_to_seconds(self, nsamp: int) -> float:
        return nsamp / self.rate

    def seconds_to_samples(self, sec: float) -> int:
        return int(round(sec * self.rate))

    # ---- state transitions ----

    def apply_detection(self, state: Signal, ndim: int = 1) -> "Observation":
        """Metadata change applied by Detection (reference Detection.C:160-204)."""
        if state in (Signal.STOKES, Signal.COHERENCE):
            npol = 4 // ndim
            out_ndim = ndim
        elif state == Signal.PPQQ:
            npol, out_ndim = 2, 1
        elif state in (Signal.INTENSITY, Signal.PP, Signal.QQ,
                       Signal.NTHPOWER):
            npol, out_ndim = 1, 1
        else:
            raise ValueError(f"not a detected state: {state}")
        return self.replace(state=state, npol=npol, ndim=out_ndim)

    def combinable_with(self, other: "Observation") -> bool:
        """Whether two streams can be combined (reference Observation::combinable)."""
        return (
            self.nchan == other.nchan
            and self.npol == other.npol
            and self.ndim == other.ndim
            and self.state == other.state
            and abs(self.centre_frequency - other.centre_frequency) < 1e-9
            and abs(self.bandwidth - other.bandwidth) < 1e-9
            and abs(self.rate - other.rate) < 1e-3
            and self.source == other.source
        )

    def contiguous_with(self, other: "Observation") -> bool:
        """Whether ``other`` begins where ``self`` ends (reference ``contiguous``)."""
        if not self.combinable_with(other):
            return False
        if self.rate <= 0:
            return False
        gap_samples = (other.start_time - self.end_time) * self.rate
        return abs(gap_samples) < 0.5
