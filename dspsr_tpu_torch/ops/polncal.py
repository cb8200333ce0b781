"""Polarization calibration: Jones-matrix frequency responses.

The port's copy of ``dspsr_tpu/ops/polncal.py``; ``jones_fft_order`` returns
torch ``complex64`` tensors where the JAX package returns split-complex
pairs.  Equivalent of ``dsp::PolnCalibration``
(``Signal/General/PolnCalibration.C``): load a calibrator solution, match it
onto the observation's channelization, and emit a Jones Response whose
*inverse* is convolved into the voltage stream (matrix convolution,
``Convolution.C:425-436``), calibrating the instrumental response during
coherent dedispersion: the fused front end mixes the two input pols'
spectra with it (``ops.megakernel``), the general chain through
``ops.convolution.overlap_save_convolve_jones``.

The reference obtains solutions from a PSRCHIVE ``pac`` database of
calibrator archives.  Without PSRCHIVE we define an equivalent open format:

- solution file: ``.npz`` with ``freq`` (MHz, [n]) and ``jones``
  (complex [n, 2, 2] instrumental responses), or whitespace text with rows
  ``freq j00r j00i j01r j01i j10r j10i j11r j11i``;
- database file (pac ``database.txt`` equivalent): header line
  ``dspsr_tpu/cal database`` then rows ``path mjd_start mjd_end`` — the
  entry covering the observation epoch (else nearest) is selected, as
  ``Pulsar::Database::best_match`` does by time.
"""

from __future__ import annotations

import dataclasses
import os
from typing import Tuple

import numpy as np
import torch

from ..observation import Observation
from .response import Response


def load_jones_cal(path: str) -> Tuple[np.ndarray, np.ndarray]:
    """Load a calibrator solution: (freq_mhz [n], jones complex128 [n,2,2])."""
    if path.endswith(".npz"):
        z = np.load(path)
        freq = np.asarray(z["freq"], dtype=np.float64)
        jones = np.asarray(z["jones"], dtype=np.complex128)
    else:
        rows = np.loadtxt(path, ndmin=2, dtype=np.float64)
        if rows.shape[1] != 9:
            raise ValueError(
                f"jones cal text needs 9 columns (freq + 4 complex), got {rows.shape[1]}")
        freq = rows[:, 0]
        re = rows[:, 1::2]
        im = rows[:, 2::2]
        jones = (re + 1j * im).reshape(-1, 2, 2)
    if jones.shape != (len(freq), 2, 2):
        raise ValueError(f"jones shape {jones.shape} != ({len(freq)}, 2, 2)")
    order = np.argsort(freq)
    return freq[order], jones[order]


def select_from_database(path: str, epoch_mjd: float) -> str:
    """Pick the solution file covering ``epoch_mjd`` from a cal database."""
    base = os.path.dirname(os.path.abspath(path))
    entries = []
    with open(path) as f:
        for ln in f:
            ln = ln.strip()
            if not ln or ln.startswith("#") or ln.lower().startswith("dspsr"):
                continue
            tok = ln.split()
            if len(tok) < 3:
                raise ValueError(f"bad cal database row: {ln!r}")
            entries.append((tok[0], float(tok[1]), float(tok[2])))
    if not entries:
        raise ValueError(f"empty calibration database: {path}")
    covering = [e for e in entries if e[1] <= epoch_mjd <= e[2]]
    pool = covering or entries
    best = min(pool, key=lambda e: abs(epoch_mjd - 0.5 * (e[1] + e[2])))
    p = best[0]
    return p if os.path.isabs(p) else os.path.join(base, p)


@dataclasses.dataclass
class PolnCalibration:
    """Calibrator solution ready to be matched onto an observation."""

    freq: np.ndarray  # MHz [n], ascending
    jones: np.ndarray  # complex128 [n, 2, 2]

    @classmethod
    def load(cls, path: str, epoch_mjd: float | None = None) -> "PolnCalibration":
        """Load from a solution file, or from a database when the file's
        first token says so (auto-detected like File::create)."""
        if not path.endswith(".npz"):
            with open(path) as f:
                head = f.readline()
            if "database" in head.lower():
                if epoch_mjd is None:
                    raise ValueError("database selection needs the epoch")
                path = select_from_database(path, epoch_mjd)
        return cls(*load_jones_cal(path))

    def match(self, obs: Observation, nchan: int, ndat: int) -> Response:
        """Build the Jones Response on (nchan, ndat) frequency bins
        (reference ``PolnCalibration::match`` + ``Response::match``).

        Each bin's sky frequency interpolates the solution linearly
        (element-wise on Re/Im); the stored phasors are the matrix
        INVERSES, since calibration removes the instrumental response.
        """
        # bin frequencies follow the chirp's natural order (signed bandwidth:
        # bin index runs along the sideband direction — Dedispersion.build):
        # f(ichan, k) = fc - bw/2 + (ichan + k/ndat) * bw/nchan
        f_lo = obs.centre_frequency - 0.5 * obs.bandwidth
        chbw = obs.bandwidth / nchan
        out = np.empty((nchan, ndat, 2, 2), np.complex128)
        for ichan in range(nchan):
            f = f_lo + ichan * chbw + np.arange(ndat) * (chbw / ndat)
            j = np.empty((ndat, 2, 2), np.complex128)
            for a in range(2):
                for b in range(2):
                    j[:, a, b] = (
                        np.interp(f, self.freq, self.jones[:, a, b].real)
                        + 1j * np.interp(f, self.freq, self.jones[:, a, b].imag))
            out[ichan] = np.linalg.inv(j)
        return Response(phasors=out.astype(np.complex64))


def jones_product(scalar: Response | None, jones: Response) -> Response:
    """Chirp (scalar) x Jones calibration -> Jones response
    (reference ``ResponseProduct`` with a ndim=8 factor)."""
    if scalar is None:
        return jones
    if scalar.phasors.shape[:2] != jones.phasors.shape[:2]:
        raise ValueError(
            f"response grids differ: {scalar.phasors.shape} vs {jones.phasors.shape}")
    ph = jones.phasors * scalar.phasors[:, :, None, None]
    return Response(
        phasors=ph.astype(np.complex64),
        impulse_pos=max(scalar.impulse_pos, jones.impulse_pos),
        impulse_neg=max(scalar.impulse_neg, jones.impulse_neg),
    )


def jones_fft_order(resp: Response, complex_input: bool):
    """The Jones response as the four complex64 ``[nchan, ndat]`` tensors
    ``(J00, J01, J10, J11)`` that ``overlap_save_convolve_jones`` takes, in
    the data's FFT bin order."""
    ph = resp.fft_order(complex_input)  # [nchan, ndat, 2, 2]
    return tuple(torch.from_numpy(np.ascontiguousarray(
        ph[:, :, a, b]).astype(np.complex64)) for a in range(2)
        for b in range(2))
