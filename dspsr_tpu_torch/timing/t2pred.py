"""TEMPO2 "T2" phase predictors (ChebyModelSet files).

TPU-native equivalent of the TEMPO2 predictor path of PSRCHIVE's
``Pulsar::Predictor`` (the reference generates these via
``Fold::get_folding_predictor`` when TEMPO2 is selected,
``Signal/Pulsar/Fold.C:229-267``; evaluation happens through the same
``phase(MJD)`` / ``frequency(MJD)`` virtuals as polycos,
``Fold.C:943-958``).

A T2 predictor file is a set of 2-D Chebyshev models of absolute pulse
phase over a (time, radio frequency) rectangle::

    ChebyModelSet 1 segments
    ChebyModel BEGIN
    PSRNAME J0437-4715
    SITENAME pks
    TIME_RANGE 55299.08 55299.12
    FREQ_RANGE 1182 1582
    DISPERSION_CONSTANT -9.7e+03
    NCOEFF_TIME 12
    NCOEFF_FREQ 2
    COEFFS c00 c01
    ...            (NCOEFF_TIME lines of NCOEFF_FREQ values each)
    ChebyModel END

with phase(t, f) = sum''_{ij} c_ij T_i(x) T_j(y) + DISPERSION_CONSTANT/f**2,
where x, y map TIME_RANGE (MJD) / FREQ_RANGE (MHz) onto [-1, 1] and the
double prime means the i=0 row and j=0 column enter with weight 1/2 (the
Clenshaw/chebev convention tempo2's cheby2d uses).

This module provides parsing, evaluation (float64, host-side — the device
only ever sees per-segment linear anchors, see ops.fold), and *generation*:
``fit_cheby_model`` builds a ChebyModel from any phase function, so a T2
predictor can be created from a polyco or spin ephemeris without shelling
out to tempo2.
"""

from __future__ import annotations

import math
from dataclasses import dataclass, field
from typing import Callable, List, Sequence

import numpy as np

from .mjd import MJD


def _cheby_nodes(n: int) -> np.ndarray:
    """Chebyshev-Gauss nodes cos(pi*(k+1/2)/n) in (-1, 1)."""
    k = np.arange(n, dtype=np.float64)
    return np.cos(np.pi * (k + 0.5) / n)


def _cheby_matrix(x: np.ndarray, n: int) -> np.ndarray:
    """T_i(x) for i in [0, n): shape [len(x), n]."""
    out = np.empty((len(x), n), dtype=np.float64)
    out[:, 0] = 1.0
    if n > 1:
        out[:, 1] = x
    for i in range(2, n):
        out[:, i] = 2.0 * x * out[:, i - 1] - out[:, i - 2]
    return out


@dataclass
class ChebyModel:
    """One (time, freq) Chebyshev phase segment."""

    psrname: str
    sitename: str
    mjd_start: float
    mjd_end: float
    freq_start: float  # MHz
    freq_end: float
    dispersion_constant: float
    coefs: np.ndarray  # float64 [ncoeff_time, ncoeff_freq]

    @property
    def ncoeff_time(self) -> int:
        return self.coefs.shape[0]

    @property
    def ncoeff_freq(self) -> int:
        return self.coefs.shape[1]

    def covers(self, t: MJD) -> bool:
        m = t.days + t.fracday()
        return self.mjd_start <= m <= self.mjd_end

    # -- evaluation ------------------------------------------------------

    def _x(self, t: MJD) -> float:
        # keep precision: offsets from mjd_start in days via two-part MJD
        span = self.mjd_end - self.mjd_start
        d = (t.days - self.mjd_start) + t.fracday()
        return 2.0 * d / span - 1.0

    def _y(self, freq: float) -> float:
        return 2.0 * (freq - self.freq_start) / (self.freq_end - self.freq_start) - 1.0

    def _eval(self, x: float, y: float) -> float:
        tx = _cheby_matrix(np.array([x]), self.ncoeff_time)[0]
        ty = _cheby_matrix(np.array([y]), self.ncoeff_freq)[0]
        w = self.coefs.copy()
        w[0, :] *= 0.5
        w[:, 0] *= 0.5
        return float(tx @ w @ ty)

    def phase(self, t: MJD, freq: float) -> float:
        """Absolute pulse phase in turns at time t, frequency freq (MHz)."""
        return self._eval(self._x(t), self._y(freq)) + self.dispersion_constant / (freq * freq)

    def frequency(self, t: MJD, freq: float) -> float:
        """Apparent spin frequency in Hz: d(phase)/dt."""
        x = self._x(t)
        y = self._y(freq)
        n = self.ncoeff_time
        tx = _cheby_matrix(np.array([x]), n)[0]
        # dT_i/dx = i * U_{i-1}; build U via recurrence
        ux = np.empty(n, dtype=np.float64)
        ux[0] = 1.0
        if n > 1:
            ux[1] = 2.0 * x
        for i in range(2, n):
            ux[i] = 2.0 * x * ux[i - 1] - ux[i - 2]
        dtx = np.zeros(n, dtype=np.float64)
        for i in range(1, n):
            dtx[i] = i * ux[i - 1]
        ty = _cheby_matrix(np.array([y]), self.ncoeff_freq)[0]
        w = self.coefs.copy()
        w[0, :] *= 0.5
        w[:, 0] *= 0.5
        dphase_dx = float(dtx @ w @ ty)
        dx_dt = 2.0 / ((self.mjd_end - self.mjd_start) * 86400.0)  # per second
        return dphase_dx * dx_dt

    # -- text format -----------------------------------------------------

    def unload(self) -> str:
        lines = [
            "ChebyModel BEGIN",
            f"PSRNAME {self.psrname}",
            f"SITENAME {self.sitename}",
            f"TIME_RANGE {float(self.mjd_start)!r} {float(self.mjd_end)!r}",
            f"FREQ_RANGE {float(self.freq_start)!r} {float(self.freq_end)!r}",
            f"DISPERSION_CONSTANT {float(self.dispersion_constant)!r}",
            f"NCOEFF_TIME {self.ncoeff_time}",
            f"NCOEFF_FREQ {self.ncoeff_freq}",
        ]
        for row in self.coefs:
            lines.append("COEFFS " + " ".join(repr(float(c)) for c in row))
        lines.append("ChebyModel END")
        return "\n".join(lines)


@dataclass
class T2Predictor:
    """A ChebyModelSet: the TEMPO2-format Pulsar::Predictor equivalent.

    Implements the same predictor interface as ``timing.polyco.Polyco``
    (phase/fracturns/frequency/period/phase_anchors).  The observing
    frequency (the reference's ``Predictor::set_observing_frequency``) is
    held as ``obsfreq``; set it from the Observation centre frequency
    before folding.
    """

    models: List[ChebyModel] = field(default_factory=list)
    obsfreq: float = 0.0  # MHz

    # -- construction ----------------------------------------------------

    @classmethod
    def load(cls, path: str) -> "T2Predictor":
        with open(path) as f:
            return cls.parse(f.read())

    @classmethod
    def parse(cls, text: str) -> "T2Predictor":
        lines = [ln.strip() for ln in text.splitlines() if ln.strip()]
        if not lines or not lines[0].startswith("ChebyModelSet"):
            raise ValueError("not a ChebyModelSet (T2 predictor) file")
        models: List[ChebyModel] = []
        i = 1
        while i < len(lines):
            if lines[i] != "ChebyModel BEGIN":
                i += 1
                continue
            i += 1
            kv = {}
            rows: List[List[float]] = []
            while i < len(lines) and lines[i] != "ChebyModel END":
                tok = lines[i].split()
                if tok[0] == "COEFFS":
                    rows.append([float(v.replace("D", "E")) for v in tok[1:]])
                else:
                    kv[tok[0]] = tok[1:]
                i += 1
            i += 1
            coefs = np.asarray(rows, dtype=np.float64)
            nt = int(kv["NCOEFF_TIME"][0])
            nf = int(kv["NCOEFF_FREQ"][0])
            if coefs.shape != (nt, nf):
                raise ValueError(
                    f"ChebyModel: expected {nt}x{nf} coefficients, got {coefs.shape}")
            models.append(ChebyModel(
                psrname=kv.get("PSRNAME", ["?"])[0],
                sitename=kv.get("SITENAME", ["?"])[0],
                mjd_start=float(kv["TIME_RANGE"][0]),
                mjd_end=float(kv["TIME_RANGE"][1]),
                freq_start=float(kv["FREQ_RANGE"][0]),
                freq_end=float(kv["FREQ_RANGE"][1]),
                dispersion_constant=float(kv.get("DISPERSION_CONSTANT", ["0"])[0]),
                coefs=coefs,
            ))
        return cls(models)

    def unload(self) -> str:
        head = f"ChebyModelSet {len(self.models)} segments"
        return "\n".join([head] + [m.unload() for m in self.models]) + "\n"

    def save(self, path: str) -> None:
        with open(path, "w") as f:
            f.write(self.unload())

    # -- predictor interface ---------------------------------------------

    def best_model(self, t: MJD) -> ChebyModel:
        covering = [m for m in self.models if m.covers(t)]
        pool = covering or self.models
        if not pool:
            raise ValueError("empty ChebyModelSet")
        mid = t.days + t.fracday()
        return min(pool, key=lambda m: abs(mid - 0.5 * (m.mjd_start + m.mjd_end)))

    def _freq(self) -> float:
        if self.obsfreq <= 0.0:
            m = self.models[0]
            return 0.5 * (m.freq_start + m.freq_end)
        return self.obsfreq

    def phase(self, t: MJD) -> float:
        return self.best_model(t).phase(t, self._freq())

    def fracturns(self, t: MJD) -> float:
        ph = self.phase(t)
        return ph - math.floor(ph)

    def frequency(self, t: MJD) -> float:
        return self.best_model(t).frequency(t, self._freq())

    def period(self, t: MJD) -> float:
        return 1.0 / self.frequency(t)

    def phase_anchors(self, start: MJD, tsamp: float, offsets: Sequence[int]) -> np.ndarray:
        out = np.empty(len(offsets), dtype=np.float64)
        for i, off in enumerate(offsets):
            out[i] = self.fracturns(start + off * tsamp)
        return out


def fit_cheby_model(
    phase_fn: Callable[[MJD, float], float],
    mjd_start: float,
    mjd_end: float,
    freq_start: float,
    freq_end: float,
    ncoeff_time: int = 12,
    ncoeff_freq: int = 2,
    dispersion_constant: float = 0.0,
    psrname: str = "?",
    sitename: str = "?",
) -> ChebyModel:
    """Fit a ChebyModel to ``phase_fn(t, freq_mhz) -> turns``.

    Samples phase at the tensor product of Chebyshev-Gauss nodes and
    projects onto T_i(x) T_j(y) by the discrete orthogonality relation
    (exact for phase polynomials of lower degree).  The dispersion term
    ``dispersion_constant / f**2`` is subtracted before fitting and stored
    separately, matching the tempo2 file layout.
    """
    nx = max(ncoeff_time + 4, ncoeff_time)
    ny = max(ncoeff_freq + 4, ncoeff_freq)
    xs = _cheby_nodes(nx)
    ys = _cheby_nodes(ny)
    tspan = mjd_end - mjd_start
    vals = np.empty((nx, ny), dtype=np.float64)
    for a, x in enumerate(xs):
        d = 0.5 * (x + 1.0) * tspan
        t = MJD(int(mjd_start), (mjd_start - int(mjd_start)) * 86400.0) + d * 86400.0
        for b, y in enumerate(ys):
            f = freq_start + 0.5 * (y + 1.0) * (freq_end - freq_start)
            vals[a, b] = phase_fn(t, f) - dispersion_constant / (f * f)
    tx = _cheby_matrix(xs, ncoeff_time)  # [nx, nt]
    ty = _cheby_matrix(ys, ncoeff_freq)  # [ny, nf]
    # discrete orthogonality at Gauss nodes: sum_k T_i(x_k) T_j(x_k) =
    # nx * (1 if i==j==0 else 1/2 if i==j else 0)
    proj = tx.T @ vals @ ty  # [nt, nf]
    # sum_k T_i(x_k)T_j(x_k) = N if i=j=0, N/2 if i=j>0, else 0; with the
    # eval-time halving of row 0 / column 0 the uniform 2/N scaling below
    # yields the chebev-convention coefficients in both dimensions.
    coefs = proj * (2.0 / nx) * (2.0 / ny)
    return ChebyModel(
        psrname=psrname,
        sitename=sitename,
        mjd_start=mjd_start,
        mjd_end=mjd_end,
        freq_start=freq_start,
        freq_end=freq_end,
        dispersion_constant=dispersion_constant,
        coefs=coefs,
    )


def generate_from_predictor(
    predictor,
    mjd_start: float,
    mjd_end: float,
    freq_start: float,
    freq_end: float,
    dm: float = 0.0,
    reference_freq: float | None = None,
    ncoeff_time: int = 12,
    ncoeff_freq: int = 2,
    psrname: str = "?",
    sitename: str = "?",
    segment_minutes: float = 120.0,
) -> T2Predictor:
    """Build a T2Predictor from any single-frequency predictor.

    The frequency dependence is the cold-plasma dispersion delay relative to
    ``reference_freq`` (default: band centre): phase(t, f) = base_phase(t -
    dt_disp(f)) ~ base(t) - F*dt_disp(f); here we evaluate exactly via the
    time shift.  DISPERSION_CONSTANT is chosen so the stored Chebyshev part
    is smooth in f.
    """
    kdm = 1.0 / 2.41e-4  # s MHz^2 / (pc cm^-3), reference Dedispersion.C:28
    fref = reference_freq or 0.5 * (freq_start + freq_end)

    def phase_fn(t: MJD, f: float) -> float:
        dt = kdm * dm * (1.0 / (f * f) - 1.0 / (fref * fref))
        return predictor.phase(t + (-dt))

    # f0 at midpoint sets the dispersion constant scale (turns * MHz^2)
    mid = MJD(int(mjd_start), (mjd_start - int(mjd_start)) * 86400.0) + \
        0.5 * (mjd_end - mjd_start) * 86400.0
    f0 = predictor.frequency(mid)
    disp_const = -kdm * dm * f0

    models: List[ChebyModel] = []
    seg_days = segment_minutes / 1440.0
    nseg = max(1, int(math.ceil((mjd_end - mjd_start) / seg_days - 1e-9)))
    for s in range(nseg):
        a = mjd_start + s * (mjd_end - mjd_start) / nseg
        b = mjd_start + (s + 1) * (mjd_end - mjd_start) / nseg
        models.append(fit_cheby_model(
            phase_fn, a, b, freq_start, freq_end,
            ncoeff_time=ncoeff_time, ncoeff_freq=ncoeff_freq,
            dispersion_constant=disp_const,
            psrname=psrname, sitename=sitename,
        ))
    return T2Predictor(models, obsfreq=fref)


def load_predictor(path: str):
    """Auto-detect predictor format: T2 ChebyModelSet vs TEMPO polyco.

    Mirrors ``Pulsar::Predictor::load`` factory behaviour (the reference's
    -P option accepts either).
    """
    with open(path) as f:
        text = f.read()
    head = text.lstrip().split(None, 1)
    if head and head[0] == "ChebyModelSet":
        return T2Predictor.parse(text)
    from .polyco import Polyco
    return Polyco.parse(text)
