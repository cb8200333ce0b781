"""High-precision two-part Modified Julian Date.

Equivalent of the reference's ``MJD`` class (PSRCHIVE ``Util/units/MJD.h``,
used throughout e.g. ``Signal/Pulsar/Fold.C:943-958``).  Stored as integer
days + float64 seconds-of-day, giving ~1e-12 s resolution — ample for pulse
phase prediction (the reference uses int days + int secs + double fracsec).

Arithmetic conventions:
- ``MJD - MJD`` -> float seconds (the reference writes
  ``(a - b).in_seconds()``; we fold that in).
- ``MJD +/- float`` -> MJD shifted by that many *seconds*.
"""

from __future__ import annotations

import math
import re
from dataclasses import dataclass


@dataclass(frozen=True)
class MJD:
    days: int = 0
    secs: float = 0.0  # seconds of day, in [0, 86400)

    def __post_init__(self):
        # normalize so 0 <= secs < 86400
        d, s = self.days, self.secs
        if s >= 86400.0 or s < 0.0:
            extra = math.floor(s / 86400.0)
            d += int(extra)
            s -= extra * 86400.0
        object.__setattr__(self, "days", int(d))
        object.__setattr__(self, "secs", float(s))

    # ---- constructors ----

    @classmethod
    def from_mjd(cls, mjd: float) -> "MJD":
        d = math.floor(mjd)
        return cls(int(d), (mjd - d) * 86400.0)

    @classmethod
    def from_utc(cls, utc: str) -> "MJD":
        """Parse ``YYYY-MM-DD-HH:MM:SS[.frac]`` (DADA UTC_START format)."""
        m = re.match(
            r"(\d{4})-(\d{2})-(\d{2})[-T](\d{2}):(\d{2}):(\d{2}(?:\.\d+)?)$",
            utc.strip(),
        )
        if not m:
            raise ValueError(f"unparseable UTC string: {utc!r}")
        y, mo, d = int(m.group(1)), int(m.group(2)), int(m.group(3))
        hh, mm = int(m.group(4)), int(m.group(5))
        ss = float(m.group(6))
        # Fliegel & Van Flandern Julian day number -> MJD = JD - 2400000.5
        a = (14 - mo) // 12
        y2 = y + 4800 - a
        m2 = mo + 12 * a - 3
        jdn = d + (153 * m2 + 2) // 5 + 365 * y2 + y2 // 4 - y2 // 100 + y2 // 400 - 32045
        mjd_day = jdn - 2400001  # JD at noon; MJD day starts at midnight
        return cls(mjd_day, hh * 3600.0 + mm * 60.0 + ss)

    # ---- accessors ----

    def in_days(self) -> float:
        return self.days + self.secs / 86400.0

    def in_seconds(self) -> float:
        return self.days * 86400.0 + self.secs

    def fracday(self) -> float:
        return self.secs / 86400.0

    # ---- arithmetic ----

    def __add__(self, seconds: float) -> "MJD":
        return MJD(self.days, self.secs + float(seconds))

    def __radd__(self, seconds: float) -> "MJD":
        return self.__add__(seconds)

    def __sub__(self, other):
        if isinstance(other, MJD):
            return (self.days - other.days) * 86400.0 + (self.secs - other.secs)
        return MJD(self.days, self.secs - float(other))

    def __lt__(self, other: "MJD") -> bool:
        return (self.days, self.secs) < (other.days, other.secs)

    def __le__(self, other: "MJD") -> bool:
        return (self.days, self.secs) <= (other.days, other.secs)

    def __gt__(self, other: "MJD") -> bool:
        return (self.days, self.secs) > (other.days, other.secs)

    def __ge__(self, other: "MJD") -> bool:
        return (self.days, self.secs) >= (other.days, other.secs)

    def __repr__(self) -> str:
        return f"MJD({self.days}+{self.secs:.9f}s)"

    def __str__(self) -> str:
        return f"{self.in_days():.12f}"
