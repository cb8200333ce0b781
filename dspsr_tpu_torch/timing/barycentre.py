"""Solar-system barycentric (Roemer) delay for .par-only folding.

The reference never computes this itself — it shells out to TEMPO/TEMPO2,
which evaluate JPL ephemerides, and folds with the returned polycos
(``Signal/Pulsar/Fold.C:229-267``).  When only a .par file is available in
an environment with no TEMPO, the direct spin model (``SpinPredictor``) is
topocentric: over long integrations the Earth's orbital Doppler
(v/c ~ 1e-4) smears the fold.  This module supplies the dominant
correction: the geometric (Roemer) light-travel delay of the observatory
relative to the solar-system barycentre projected on the pulsar direction,

    t_bary = t_topo + r_earth . n_psr / c

with the Earth position from the Meeus "Astronomical Algorithms" ch. 25
analytic solar theory (geometric solar longitude to ~0.01 deg, radius via
the equation of centre).  Accuracy budget, relative to a full TEMPO2
barycentring chain:

- Earth orbit model error ~0.01 deg      -> |delay| error  <~ 90 ms
- heliocentre vs true SSB (Jupiter etc.) -> |delay| error  <~ 5 s,
  but drifting only at the Sun's reflex velocity (~13 m/s)
- observatory site: diurnal term modelled from a built-in obsys table
  (spherical Earth; flattening -> <~ 70 us); unknown telescopes fall back
  to the geocentre (<~ 21 ms daily sinusoid)
- Einstein + Shapiro delays omitted      -> <~ 2 ms

What folding needs is the DERIVATIVE accuracy (apparent-frequency error):
the terms above contribute fractional frequency errors of ~2e-8 to ~7e-8
(measured residual vs TEMPO's Parkes vela.polyco: ~7e-8 fractional with
the site term, ~1e-6 without).  That converts a .par-only fold from
"wrong by many turns" to "sharp, with a slowly drifting absolute phase";
for timing-grade absolute phase, supply a polyco/T2 predictor (-P).
"""

from __future__ import annotations

import math

import numpy as np

from .mjd import MJD

#: light travel time for 1 AU, seconds (IAU 2012)
AU_LIGHT_S = 499.004783836


def sun_geometric(mjd_utc: float):
    """Geometric solar ecliptic longitude (rad) and distance (AU) at the
    given UTC MJD (Meeus ch. 25; TT-UTC neglected: ~70 s of orbital motion
    is ~2000 km, far below the model's own accuracy)."""
    T = (mjd_utc - 51544.5) / 36525.0
    L0 = math.radians((280.46646 + 36000.76983 * T + 0.0003032 * T * T)
                      % 360.0)
    M = math.radians((357.52911 + 35999.05029 * T - 0.0001537 * T * T)
                     % 360.0)
    e = 0.016708634 - 0.000042037 * T - 0.0000001267 * T * T
    C = (math.radians(1.914602 - 0.004817 * T - 0.000014 * T * T)
         * math.sin(M)
         + math.radians(0.019993 - 0.000101 * T) * math.sin(2 * M)
         + math.radians(0.000289) * math.sin(3 * M))
    lam = L0 + C
    nu = M + C
    R = 1.000001018 * (1 - e * e) / (1 + e * math.cos(nu))
    return lam, R


def earth_position_au(mjd_utc: float) -> np.ndarray:
    """Earth position relative to the Sun (~SSB), equatorial J2000-ish
    frame, in AU.  The Earth sits opposite the geometric Sun."""
    lam, R = sun_geometric(mjd_utc)
    T = (mjd_utc - 51544.5) / 36525.0
    eps = math.radians(23.439291 - 0.0130042 * T)
    # Sun geocentric equatorial (solar ecliptic latitude ~ 0)
    xs = R * math.cos(lam)
    ys = R * math.sin(lam) * math.cos(eps)
    zs = R * math.sin(lam) * math.sin(eps)
    return np.array([-xs, -ys, -zs])


#: geodetic observatory coordinates (lat deg, east lon deg, alt m) for the
#: telescope codes the Observation layer uses (the role of TEMPO's
#: obsys.dat); kilometre-level accuracy suffices (micro-second delay terms)
OBSERVATORIES = {
    "PKS": (-32.9984, 148.2635, 415.0),      # Parkes
    "PARKES": (-32.9984, 148.2635, 415.0),
    "GBT": (38.4330, -79.8398, 824.0),       # Green Bank
    "AO": (18.3442, -66.7528, 497.0),        # Arecibo
    "ARECIBO": (18.3442, -66.7528, 497.0),
    "JB": (53.2367, -2.3071, 86.0),          # Jodrell Bank
    "JODRELL": (53.2367, -2.3071, 86.0),
    "EFF": (50.5248, 6.8836, 369.0),         # Effelsberg
    "EFFELSBERG": (50.5248, 6.8836, 369.0),
    "VLA": (34.0790, -107.6184, 2124.0),
    "NANCAY": (47.3800, 2.1975, 150.0),
    "MEERKAT": (-30.7130, 21.4430, 1054.0),
    "GMRT": (19.0965, 74.0497, 650.0),
    "WSRT": (52.9146, 6.6033, 16.0),
}

_EARTH_R_AU = 6378.137e3 / 1.495978707e11  # equatorial radius in AU


def gmst_rad(mjd_utc: float) -> float:
    """Greenwich mean sidereal time (rad), IAU 1982-style linear form
    (UT1-UTC neglected: <0.9 s of rotation ~ <0.4 km of site motion)."""
    d = mjd_utc - 51544.5
    return math.radians((280.46061837 + 360.98564736629 * d) % 360.0)


def observatory_position_au(mjd_utc: float, lat_deg: float, lon_deg: float,
                            alt_m: float) -> np.ndarray:
    """Observatory position relative to the GEOCENTRE, equatorial frame,
    AU (spherical Earth: the ~21 km geodetic flattening term is ~70 us of
    delay, below the orbit model's error)."""
    lat = math.radians(lat_deg)
    theta = gmst_rad(mjd_utc) + math.radians(lon_deg)  # local sidereal
    r = _EARTH_R_AU + alt_m / 1.495978707e11
    return np.array([r * math.cos(lat) * math.cos(theta),
                     r * math.cos(lat) * math.sin(theta),
                     r * math.sin(lat)])


class SSBDelay:
    """Roemer delay callable for one sky direction.

    ``delay(t)`` returns seconds to ADD to a topocentric MJD to get the
    barycentric arrival time (positive when the Earth is displaced toward
    the pulsar, i.e. pulses arrive early).  With a known telescope the
    observatory's diurnal term rides on top of the orbital one (the
    site-velocity Doppler, ~1.5e-6 fractional, dominates the .par-fold
    residual otherwise).
    """

    def __init__(self, ra_rad: float, dec_rad: float,
                 telescope: str | None = None):
        self.n = np.array([
            math.cos(dec_rad) * math.cos(ra_rad),
            math.cos(dec_rad) * math.sin(ra_rad),
            math.sin(dec_rad),
        ])
        self.site = OBSERVATORIES.get((telescope or "").upper())

    @classmethod
    def from_strings(cls, raj: str, decj: str,
                     telescope: str | None = None) -> "SSBDelay":
        from .skycoord import SkyCoord

        c = SkyCoord.parse(raj, decj)
        return cls(c.ra_rad, c.dec_rad, telescope)

    def delay(self, t: MJD) -> float:
        mjd = t.days + t.fracday()
        r = earth_position_au(mjd)
        if self.site is not None:
            r = r + observatory_position_au(mjd, *self.site)
        return float(r @ self.n) * AU_LIGHT_S

    def delay_rate(self, t: MJD) -> float:
        """d(delay)/dt — the orbital Doppler factor v.n/c (dimensionless),
        by central difference over 2000 s (the delay varies on month
        scales, so this resolves it to ~1e-12)."""
        return (self.delay(t + 1000.0) - self.delay(t - 1000.0)) / 2000.0
