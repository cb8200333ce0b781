"""PSRFITS search-mode input.

Equivalent of the reference ``Kernel/Formats/fits`` backend (FITSFile +
FITSUnpacker; see ``Signal/Pulsar/LoadToFold1.C:137-174``): reads SEARCH-mode
PSRFITS (SUBINT table of NSBLK-sample rows) as a Source, applying per-row
DAT_SCL/DAT_OFFS when reading into floats is required — here the packed bits
are returned raw and scales flow through the header-level Observation
(uniform-scale files; per-row scale support raises otherwise).
"""

from __future__ import annotations

import io
from typing import Dict, List, Tuple

import numpy as np

from ..observation import Observation, Signal
from ..timing.mjd import MJD
from .sources import Source, register_format
from .fits import RECORD


def _parse_headers_with_offsets(path: str) -> List[Tuple[Dict, int, int]]:
    """[(cards, data_offset, data_bytes)] per HDU."""
    out = []
    with open(path, "rb") as f:
        while True:
            cards: Dict = {}
            start = f.tell()
            block = f.read(RECORD)
            if len(block) < RECORD:
                break
            ended = False
            while True:
                for i in range(0, len(block), 80):
                    card = block[i : i + 80].decode("ascii", "replace")
                    key = card[:8].strip()
                    if key == "END":
                        ended = True
                        break
                    if "=" in card[8:10]:
                        cards[key] = card[10:].split("/")[0].strip().strip("'").strip()
                if ended or not block:
                    break
                block = f.read(RECORD)
            if not cards:
                break
            if cards.get("XTENSION", "").startswith("BINTABLE"):
                nbytes = int(cards["NAXIS1"]) * int(cards["NAXIS2"])
            else:
                nax = int(cards.get("NAXIS", "0") or 0)
                nbytes = 0
                if nax:
                    nbytes = abs(int(cards["BITPIX"])) // 8
                    for i in range(1, nax + 1):
                        nbytes *= int(cards[f"NAXIS{i}"])
            data_offset = f.tell()
            out.append((cards, data_offset, nbytes))
            f.seek((nbytes + RECORD - 1) // RECORD * RECORD, io.SEEK_CUR)
    return out


@register_format
class PsrfitsSearchFile(Source):
    """SEARCH-mode PSRFITS reader."""

    def __init__(self, path: str):
        self.path = path
        hdus = _parse_headers_with_offsets(path)
        primary = hdus[0][0]
        subint = None
        for cards, off, nbytes in hdus[1:]:
            if cards.get("EXTNAME", "").strip() == "SUBINT":
                subint = (cards, off, nbytes)
        if subint is None:
            raise ValueError(f"{path}: no SUBINT extension")
        cards, self._data_off, _ = subint
        self._sub = cards
        self.nsblk = int(cards["NSBLK"])
        self.nrows = int(cards["NAXIS2"])
        self.naxis1 = int(cards["NAXIS1"])
        nchan = int(cards["NCHAN"])
        npol = int(cards["NPOL"])
        nbits = int(cards["NBITS"])

        # locate the DATA column byte offset within a row
        tfields = int(cards["TFIELDS"])
        offset = 0
        self._data_col_off = None
        sizes = {"E": 4, "D": 8, "I": 2, "J": 4, "K": 8, "B": 1, "A": 1}
        for i in range(1, tfields + 1):
            tform = cards[f"TFORM{i}"].strip()
            n = int(tform[:-1] or 1)
            width = n * sizes[tform[-1]]
            if cards[f"TTYPE{i}"].strip() == "DATA":
                self._data_col_off = offset
                self._data_col_bytes = width
            offset += width
        if self._data_col_off is None:
            raise ValueError("no DATA column")

        mjd = (int(primary.get("STT_IMJD", 0))
               + (int(primary.get("STT_SMJD", 0))
                  + float(primary.get("STT_OFFS", 0) or 0)) / 86400.0)
        tbin = float(cards["TBIN"])
        self.obs = Observation(
            nchan=nchan, npol=npol, ndim=1, nbit=nbits,
            centre_frequency=float(primary.get("OBSFREQ", 0) or 0),
            bandwidth=float(primary.get("OBSBW", 0) or 0),
            rate=1.0 / tbin,
            start_time=MJD(int(mjd), (mjd - int(mjd)) * 86400.0),
            state=Signal.INTENSITY if npol == 1 else Signal.PPQQ,
            source=primary.get("SRC_NAME", ""),
            telescope=primary.get("TELESCOP", ""),
            instrument=primary.get("BACKEND", ""),
            format="psrfits",
            ndat=self.nsblk * self.nrows,
        )

    @staticmethod
    def is_valid(path: str) -> bool:
        try:
            with open(path, "rb") as f:
                head = f.read(RECORD)
            return (head[:6] == b"SIMPLE"
                    and b"PSRFITS" in head)
        except OSError:
            return False

    @property
    def total_samples(self) -> int:
        return self.obs.ndat

    def read_samples(self, start: int, nsamp: int) -> np.ndarray:
        bps = self.bytes_per_sample_exact()
        out = np.zeros(nsamp * bps, np.uint8)
        row_samples = self.nsblk
        row_bytes = row_samples * bps
        filled = 0
        with open(self.path, "rb") as f:
            while filled < nsamp:
                pos = start + filled
                if pos >= self.total_samples:
                    break
                row = pos // row_samples
                within = pos % row_samples
                take = min(nsamp - filled, row_samples - within)
                f.seek(self._data_off + row * self.naxis1
                       + self._data_col_off + within * bps)
                buf = f.read(take * bps)
                out[filled * bps : filled * bps + len(buf)] = np.frombuffer(
                    buf, np.uint8)
                filled += take
        return out


# ---------------------------------------------------------------------------
# Fold-mode PSRFITS reading (archives written by save_psrfits_fold or by the
# reference Archiver -> Pulsar::Archive; reference reads these via PSRCHIVE,
# Signal/Pulsar/Archiver.C:162-293 describes the layout being inverted here).
# ---------------------------------------------------------------------------

from dataclasses import dataclass, field as _field


@dataclass
class FoldArchive:
    """In-memory fold-mode archive: denormalized profiles + metadata."""

    profiles: np.ndarray          # float64 [nsub, nchan, npol, nbin]
    weights: np.ndarray           # float32 [nsub, nchan] (DAT_WTS)
    freqs: np.ndarray             # float64 [nchan] MHz (DAT_FREQ row 0)
    tsubint: np.ndarray           # float64 [nsub] seconds
    offs_sub: np.ndarray          # float64 [nsub] mid-time offsets (s)
    period: float
    dm: float
    start_time: MJD
    centre_frequency: float
    bandwidth: float
    source: str
    telescope: str
    pol_type: str

    @property
    def nsub(self): return self.profiles.shape[0]

    @property
    def nchan(self): return self.profiles.shape[1]

    @property
    def npol(self): return self.profiles.shape[2]

    @property
    def nbin(self): return self.profiles.shape[3]


def load_psrfits_fold(path: str) -> FoldArchive:
    """Read a fold-mode (OBS_MODE PSR/CAL) PSRFITS archive.

    Inverts the SUBINT layout written by ``save_psrfits_fold``: int16 DATA
    ordered (NPOL, NCHAN, NBIN) bin-fastest per row, denormalized as
    data*DAT_SCL + DAT_OFFS per (sub, chan, pol).
    """
    hdus = _parse_headers_with_offsets(path)
    primary = hdus[0][0]
    mode = primary.get("OBS_MODE", "").strip()
    if mode not in ("PSR", "CAL"):
        raise ValueError(f"not a fold-mode PSRFITS file (OBS_MODE={mode!r})")
    sub = None
    for cards, off, nbytes in hdus:
        if cards.get("EXTNAME", "").strip() == "SUBINT":
            sub = (cards, off, nbytes)
            break
    if sub is None:
        raise ValueError("no SUBINT extension")
    cards, doff, dbytes = sub
    nbin = int(cards["NBIN"])
    nchan = int(cards["NCHAN"])
    npol = int(cards["NPOL"])
    nsub = int(cards["NAXIS2"])
    naxis1 = int(cards["NAXIS1"])

    # column layout walk
    tfields = int(cards["TFIELDS"])
    sizes = {"E": 4, "D": 8, "I": 2, "J": 4, "K": 8, "B": 1, "A": 1}
    dtypes = {"E": ">f4", "D": ">f8", "I": ">i2", "J": ">i4", "K": ">i8",
              "B": "u1", "A": "S1"}
    cols = {}
    offset = 0
    for i in range(1, tfields + 1):
        name = cards[f"TTYPE{i}"].strip()
        tform = cards[f"TFORM{i}"].strip()
        n = int(tform[:-1] or 1)
        code = tform[-1]
        cols[name] = (offset, n, dtypes[code])
        offset += n * sizes[code]

    raw = np.fromfile(path, dtype=np.uint8, offset=doff, count=dbytes)
    rows = raw.reshape(nsub, naxis1)

    def col(name):
        off, n, dt = cols[name]
        w = n * np.dtype(dt).itemsize
        return (rows[:, off:off + w].copy().view(np.dtype(dt))
                .astype(np.dtype(dt).newbyteorder("=")).reshape(nsub, n))

    tsub = col("TSUBINT")[:, 0].astype(np.float64)
    offs_sub = col("OFFS_SUB")[:, 0].astype(np.float64)
    try:
        period = float(col("PERIOD")[0, 0])
    except KeyError:
        period = 0.0
    freqs = col("DAT_FREQ")[0].astype(np.float64)
    wts = col("DAT_WTS").astype(np.float32)
    offsv = col("DAT_OFFS").astype(np.float64).reshape(nsub, nchan, npol)
    scl = col("DAT_SCL").astype(np.float64).reshape(nsub, nchan, npol)
    data = col("DATA").astype(np.float64).reshape(nsub, npol, nchan, nbin)
    data = np.transpose(data, (0, 2, 1, 3))  # -> [nsub, nchan, npol, nbin]
    prof = data * scl[..., None] + offsv[..., None]

    imjd = int(primary.get("STT_IMJD", "0") or 0)
    smjd = float(primary.get("STT_SMJD", "0") or 0)
    soffs = float(primary.get("STT_OFFS", "0") or 0)
    return FoldArchive(
        profiles=prof,
        weights=wts,
        freqs=freqs,
        tsubint=tsub,
        offs_sub=offs_sub,
        period=period,
        dm=float(cards.get("DM", "0") or 0),
        start_time=MJD(imjd, smjd + soffs),
        centre_frequency=float(primary.get("OBSFREQ", "0") or 0),
        bandwidth=float(primary.get("OBSBW", "0") or 0),
        source=primary.get("SRC_NAME", ""),
        telescope=primary.get("TELESCOP", ""),
        pol_type=cards.get("POL_TYPE", ""),
    )
