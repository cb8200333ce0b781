"""Minimal FITS writer/reader: primary HDU + binary table extensions.

Foundation for the PSRFITS writers (io.psrfits).  Implements just enough of
the FITS standard (2880-byte records, 80-char header cards, BINTABLE
extensions with big-endian columns) to produce files readable by cfitsio
tools — the role cfitsio plays for the reference (``configure.ac:74-102``).
"""

from __future__ import annotations

import io
from dataclasses import dataclass, field
from typing import BinaryIO, Dict, List, Sequence, Tuple, Union

import numpy as np

RECORD = 2880


def _card(key: str, value=None, comment: str = "") -> bytes:
    """Format one 80-char header card."""
    if value is None and not comment:
        out = f"{key:<80s}"
    elif key in ("COMMENT", "HISTORY"):
        out = f"{key:<8s}{comment:<72s}"
    else:
        if isinstance(value, bool):
            v = "T" if value else "F"
            out = f"{key:<8s}= {v:>20s}"
        elif isinstance(value, (int, np.integer)):
            out = f"{key:<8s}= {value:>20d}"
        elif isinstance(value, float):
            out = f"{key:<8s}= {value:>20.12G}"
        else:
            s = str(value).replace("'", "''")
            out = f"{key:<8s}= '{s:<8s}'"
        if comment:
            out = f"{out} / {comment}"
        out = f"{out:<80s}"
    return out[:80].encode("ascii")


def _pad(b: bytes, fill: bytes = b" ") -> bytes:
    n = (-len(b)) % RECORD
    return b + fill * n


class FitsWriter:
    """Streaming FITS file writer."""

    def __init__(self, f: BinaryIO):
        self.f = f

    def write_primary(self, cards: List[Tuple] = ()) -> None:
        hdr = [_card("SIMPLE", True, "file conforms to FITS standard"),
               _card("BITPIX", 8),
               _card("NAXIS", 0),
               _card("EXTEND", True)]
        for c in cards:
            hdr.append(_card(*c))
        hdr.append(_card("END"))
        self.f.write(_pad(b"".join(hdr)))

    def write_bintable(self, extname: str, columns: List[Tuple[str, str, str, np.ndarray]],
                       extra_cards: List[Tuple] = ()) -> None:
        """Write a BINTABLE extension.

        columns: list of (name, tform, tunit, data[nrows, ...]); data will be
        converted to big-endian.  tform e.g. '1D', '4096E', '1X'...
        """
        nrows = len(columns[0][3])
        bufs = []
        widths = []
        for name, tform, tunit, data in columns:
            d = np.asarray(data)
            assert len(d) == nrows, (name, len(d), nrows)
            be = d.astype(d.dtype.newbyteorder(">"))
            row_bytes = be.nbytes // nrows
            widths.append(row_bytes)
            bufs.append(be.reshape(nrows, row_bytes // be.dtype.itemsize
                                   if be.dtype.itemsize else 1))
        naxis1 = sum(widths)

        hdr = [
            _card("XTENSION", "BINTABLE", "binary table extension"),
            _card("BITPIX", 8),
            _card("NAXIS", 2),
            _card("NAXIS1", naxis1, "bytes per row"),
            _card("NAXIS2", nrows, "number of rows"),
            _card("PCOUNT", 0),
            _card("GCOUNT", 1),
            _card("TFIELDS", len(columns)),
        ]
        for i, (name, tform, tunit, _) in enumerate(columns, 1):
            hdr.append(_card(f"TTYPE{i}", name))
            hdr.append(_card(f"TFORM{i}", tform))
            if tunit:
                hdr.append(_card(f"TUNIT{i}", tunit))
        hdr.append(_card("EXTNAME", extname))
        for c in extra_cards:
            hdr.append(_card(*c))
        hdr.append(_card("END"))
        self.f.write(_pad(b"".join(hdr)))

        # row-interleaved payload
        out = bytearray()
        views = [b.view(np.uint8).reshape(nrows, -1) for b in bufs]
        for r in range(nrows):
            for v in views:
                out += v[r].tobytes()
        self.f.write(_pad(bytes(out), b"\x00"))

    # ---- streaming bintable (row-at-a-time; NAXIS2 fixed up at end) ----

    def begin_bintable(self, extname: str,
                       columns: List[Tuple[str, str, str, int]],
                       extra_cards: List[Tuple] = ()) -> None:
        """Open a BINTABLE for row streaming.

        columns: (name, tform, tunit, row_bytes) per column.  Rows are
        appended with :meth:`write_row`; the row count is patched into
        NAXIS2 by :meth:`end_bintable` (the cfitsio reserved-keyword trick
        the reference relies on for long digifits runs).  Requires a
        seekable file.
        """
        naxis1 = sum(w for _, _, _, w in columns)
        hdr = [
            _card("XTENSION", "BINTABLE", "binary table extension"),
            _card("BITPIX", 8),
            _card("NAXIS", 2),
            _card("NAXIS1", naxis1, "bytes per row"),
            _card("NAXIS2", 0, "number of rows"),
            _card("PCOUNT", 0),
            _card("GCOUNT", 1),
            _card("TFIELDS", len(columns)),
        ]
        for i, (name, tform, tunit, _) in enumerate(columns, 1):
            hdr.append(_card(f"TTYPE{i}", name))
            hdr.append(_card(f"TFORM{i}", tform))
            if tunit:
                hdr.append(_card(f"TUNIT{i}", tunit))
        hdr.append(_card("EXTNAME", extname))
        for c in extra_cards:
            hdr.append(_card(*c))
        hdr.append(_card("END"))
        self._bt_hdr_pos = self.f.tell()
        self.f.write(_pad(b"".join(hdr)))
        self._bt_naxis1 = naxis1
        self._bt_rows = 0

    def write_row(self, row: bytes) -> None:
        if len(row) != self._bt_naxis1:
            raise ValueError(f"row is {len(row)} bytes, NAXIS1 is "
                             f"{self._bt_naxis1}")
        self.f.write(row)
        self._bt_rows += 1

    def end_bintable(self) -> None:
        n = (-self._bt_rows * self._bt_naxis1) % RECORD
        self.f.write(b"\x00" * n)
        end = self.f.tell()
        # NAXIS2 is the 5th card of the streamed header
        self.f.seek(self._bt_hdr_pos + 4 * 80)
        self.f.write(_card("NAXIS2", self._bt_rows, "number of rows"))
        self.f.seek(end)


def read_fits_headers(path: str) -> List[Dict[str, str]]:
    """Parse all HDU headers (values as raw strings) — for tests."""
    hdus = []
    with open(path, "rb") as f:
        while True:
            cards = {}
            block = f.read(RECORD)
            if not block:
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
                if ended:
                    break
                block = f.read(RECORD)
                if not block:
                    break
            if not cards:
                break
            hdus.append(cards)
            # skip data
            if cards.get("XTENSION", "").startswith("BINTABLE"):
                nbytes = int(cards["NAXIS1"]) * int(cards["NAXIS2"])
            elif int(cards.get("NAXIS", "0") or 0) == 0:
                nbytes = 0
            else:
                nax = int(cards["NAXIS"])
                nbytes = abs(int(cards["BITPIX"])) // 8
                for i in range(1, nax + 1):
                    nbytes *= int(cards[f"NAXIS{i}"])
            skip = (nbytes + RECORD - 1) // RECORD * RECORD
            f.seek(skip, io.SEEK_CUR)
    return hdus


def read_bintable_column(path: str, extname: str, colname: str) -> np.ndarray:
    """Read one column of a BINTABLE (sufficient for round-trip tests)."""
    with open(path, "rb") as f:
        data = f.read()
    # walk HDUs
    pos = 0
    while pos < len(data):
        # read header
        cards = {}
        hpos = pos
        ended = False
        while not ended:
            block = data[hpos : hpos + RECORD]
            hpos += RECORD
            for i in range(0, len(block), 80):
                card = block[i : i + 80].decode("ascii", "replace")
                key = card[:8].strip()
                if key == "END":
                    ended = True
                    break
                if "=" in card[8:10]:
                    cards[key] = card[10:].split("/")[0].strip().strip("'").strip()
        if cards.get("XTENSION", "").startswith("BINTABLE"):
            naxis1 = int(cards["NAXIS1"])
            nrows = int(cards["NAXIS2"])
            nbytes = naxis1 * nrows
        else:
            nax = int(cards.get("NAXIS", "0") or 0)
            nbytes = 0
            if nax:
                nbytes = abs(int(cards["BITPIX"])) // 8
                for i in range(1, nax + 1):
                    nbytes *= int(cards[f"NAXIS{i}"])
        dstart = hpos
        if cards.get("EXTNAME", "").strip() == extname:
            # locate column
            tfields = int(cards["TFIELDS"])
            offset = 0
            for i in range(1, tfields + 1):
                name = cards[f"TTYPE{i}"].strip()
                tform = cards[f"TFORM{i}"].strip()
                n = int(tform[:-1] or 1)
                code = tform[-1]
                size = {"E": 4, "D": 8, "I": 2, "J": 4, "K": 8, "B": 1,
                        "A": 1, "X": 1}[code]
                width = n * size if code != "X" else (n + 7) // 8
                dtype = {"E": ">f4", "D": ">f8", "I": ">i2", "J": ">i4",
                         "K": ">i8", "B": "u1", "A": "S1", "X": "u1"}[code]
                if name == colname:
                    out = np.empty((nrows, n if code != "X" else width),
                                   dtype=np.dtype(dtype).newbyteorder(">"))
                    for r in range(nrows):
                        rowstart = dstart + r * naxis1 + offset
                        out[r] = np.frombuffer(
                            data[rowstart : rowstart + width], dtype=dtype)
                    return out
                offset += width
            raise KeyError(colname)
        pos = dstart + (nbytes + RECORD - 1) // RECORD * RECORD
    raise KeyError(extname)
