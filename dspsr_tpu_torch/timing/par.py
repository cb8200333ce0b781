"""Minimal TEMPO .par pulsar ephemeris reader.

Equivalent to the subset of PSRCHIVE ``Pulsar::Parameters`` that the reference
pipeline consumes: source name, DM, and a spin model good enough to generate a
predictor or pick nbin (``Signal/Pulsar/Fold.C:156-267``).  Full TEMPO2-grade
barycentric timing is out of scope — observatory polycos are the supported
high-precision path (as in the reference, which shells out to TEMPO).
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, Optional

from .mjd import MJD


def _parse_value(tok: str) -> float:
    return float(tok.replace("D", "E").replace("d", "e"))


@dataclass
class Ephemeris:
    params: Dict[str, str] = field(default_factory=dict)

    @classmethod
    def load(cls, path: str) -> "Ephemeris":
        with open(path) as f:
            return cls.parse(f.read())

    @classmethod
    def parse(cls, text: str) -> "Ephemeris":
        params: Dict[str, str] = {}
        for line in text.splitlines():
            toks = line.split()
            if not toks or toks[0].startswith("#"):
                continue
            params[toks[0].upper()] = toks[1] if len(toks) > 1 else ""
        return cls(params)

    def get(self, key: str, default: Optional[str] = None) -> Optional[str]:
        return self.params.get(key.upper(), default)

    @property
    def name(self) -> str:
        return self.get("PSRJ") or self.get("PSRB") or self.get("PSR") or ""

    @property
    def dm(self) -> float:
        v = self.get("DM")
        return _parse_value(v) if v else 0.0

    @property
    def f0(self) -> float:
        v = self.get("F0")
        if v:
            return _parse_value(v)
        p0 = self.get("P0")
        if p0:
            return 1.0 / _parse_value(p0)
        raise ValueError("ephemeris has neither F0 nor P0")

    @property
    def f1(self) -> float:
        v = self.get("F1")
        return _parse_value(v) if v else 0.0

    @property
    def pepoch(self) -> MJD:
        v = self.get("PEPOCH")
        return MJD.from_mjd(_parse_value(v)) if v else MJD(0, 0.0)

    def period_at(self, t: MJD) -> float:
        """Topocentric-ish spin period from the F0/F1 Taylor model."""
        dt = t - self.pepoch  # seconds
        f = self.f0 + self.f1 * dt
        return 1.0 / f
