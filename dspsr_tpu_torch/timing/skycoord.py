"""Sky coordinates: RA/Dec parsing and formatting.

Equivalent of the reference's PSRCHIVE ``sky_coord`` (used by Observation
for source coordinates and by SIGPROC's src_raj/src_dej fields).
"""

from __future__ import annotations

import math
import re
from dataclasses import dataclass


@dataclass(frozen=True)
class SkyCoord:
    ra_rad: float
    dec_rad: float

    @classmethod
    def parse(cls, ra: str, dec: str) -> "SkyCoord":
        """Parse 'hh:mm:ss.s' / 'dd:mm:ss.s' strings (par-file RAJ/DECJ)."""
        def sex(s, hours):
            m = re.match(r"([+-]?)(\d+):(\d+):(\d+(?:\.\d+)?)$", s.strip())
            if not m:
                raise ValueError(f"bad sexagesimal {s!r}")
            sign = -1.0 if m.group(1) == "-" else 1.0
            v = int(m.group(2)) + int(m.group(3)) / 60.0 + float(m.group(4)) / 3600.0
            scale = math.pi / 12.0 if hours else math.pi / 180.0
            return sign * v * scale

        return cls(sex(ra, True), sex(dec, False))

    def ra_hms(self) -> str:
        h = self.ra_rad * 12.0 / math.pi
        hh = int(h)
        mm = int((h - hh) * 60)
        ss = (h - hh - mm / 60.0) * 3600.0
        return f"{hh:02d}:{mm:02d}:{ss:07.4f}"

    def dec_dms(self) -> str:
        d = abs(self.dec_rad) * 180.0 / math.pi
        sign = "-" if self.dec_rad < 0 else "+"
        dd = int(d)
        mm = int((d - dd) * 60)
        ss = (d - dd - mm / 60.0) * 3600.0
        return f"{sign}{dd:02d}:{mm:02d}:{ss:06.3f}"

    def sigproc_raj(self) -> float:
        """SIGPROC packed format: hhmmss.s as a double."""
        h = self.ra_rad * 12.0 / math.pi
        hh = int(h)
        mm = int((h - hh) * 60)
        ss = (h - hh - mm / 60.0) * 3600.0
        return hh * 1e4 + mm * 1e2 + ss

    def sigproc_dej(self) -> float:
        d = abs(self.dec_rad) * 180.0 / math.pi
        dd = int(d)
        mm = int((d - dd) * 60)
        ss = (d - dd - mm / 60.0) * 3600.0
        v = dd * 1e4 + mm * 1e2 + ss
        return -v if self.dec_rad < 0 else v
