"""Minimal ctypes binding to the system cfitsio — INDEPENDENT validation.

The reference reads/writes PSRFITS through cfitsio (``configure.ac:74-102``,
``Kernel/Formats/fits``).  This module opens the files the port writes
(``io/psrfits.py``, ``io/archive.py``) through the same third-party
library, so archive and search output is validated by code this project
did not author: if cfitsio parses the headers, walks the HDUs and returns
the same column values we wrote, the files are structurally sound FITS.

The JAX package's ``dspsr_tpu/io/cfitsio.py`` with the same names, for the
port's ``FoldResult``.  Only the read path is bound — enough for
verification and for ingesting external PSRFITS via a second, independent
parser.  Where no ``libcfitsio`` is installed, :func:`available` is False
and :class:`CfitsioFile` raises :class:`CfitsioError`.
"""

from __future__ import annotations

import ctypes
import ctypes.util
from typing import Dict, List, Optional

import numpy as np

# cfitsio datatype codes (fitsio.h)
TSTRING, TSHORT, TINT, TFLOAT, TDOUBLE, TLONGLONG = 16, 21, 31, 42, 82, 81
BINARY_TBL = 2

_lib = None


def load_cfitsio() -> Optional[ctypes.CDLL]:
    global _lib
    if _lib is not None:
        return _lib
    name = ctypes.util.find_library("cfitsio")
    candidates = [name] if name else []
    candidates += ["libcfitsio.so.10", "libcfitsio.so", "libcfitsio.dylib"]
    for c in candidates:
        if not c:
            continue
        try:
            _lib = ctypes.CDLL(c)
            return _lib
        except OSError:
            continue
    return None


def available() -> bool:
    return load_cfitsio() is not None


class CfitsioError(RuntimeError):
    pass


def _check(status: ctypes.c_int, what: str):
    if status.value != 0:
        lib = load_cfitsio()
        buf = ctypes.create_string_buffer(31)
        lib.ffgerr(status.value, buf)
        raise CfitsioError(f"{what}: cfitsio status {status.value} "
                           f"({buf.value.decode()})")


class CfitsioFile:
    """Read-only FITS access through the system cfitsio."""

    def __init__(self, path: str):
        lib = load_cfitsio()
        if lib is None:
            raise CfitsioError("libcfitsio not found")
        self.lib = lib
        self.fptr = ctypes.c_void_p()
        status = ctypes.c_int(0)
        lib.ffopen(ctypes.byref(self.fptr), path.encode(), 0,
                   ctypes.byref(status))
        _check(status, f"open {path}")

    def close(self):
        if self.fptr:
            status = ctypes.c_int(0)
            self.lib.ffclos(self.fptr, ctypes.byref(status))
            self.fptr = None

    def __enter__(self):
        return self

    def __exit__(self, *a):
        self.close()

    # ---- HDU navigation ----

    def num_hdus(self) -> int:
        n = ctypes.c_int(0)
        status = ctypes.c_int(0)
        self.lib.ffthdu(self.fptr, ctypes.byref(n), ctypes.byref(status))
        _check(status, "num_hdus")
        return n.value

    def move_to(self, extname: str):
        status = ctypes.c_int(0)
        self.lib.ffmnhd(self.fptr, BINARY_TBL, extname.encode(), 0,
                        ctypes.byref(status))
        _check(status, f"move to {extname}")

    def move_abs(self, hdunum: int):
        t = ctypes.c_int(0)
        status = ctypes.c_int(0)
        self.lib.ffmahd(self.fptr, hdunum, ctypes.byref(t),
                        ctypes.byref(status))
        _check(status, f"move to HDU {hdunum}")

    def hdu_names(self) -> List[str]:
        names = []
        for i in range(1, self.num_hdus() + 1):
            self.move_abs(i)
            try:
                names.append(self.key_str("EXTNAME"))
            except CfitsioError:
                names.append("")
        return names

    # ---- keywords ----

    def key_str(self, key: str) -> str:
        buf = ctypes.create_string_buffer(71)
        com = ctypes.create_string_buffer(71)
        status = ctypes.c_int(0)
        self.lib.ffgky(self.fptr, TSTRING, key.encode(), buf, com,
                       ctypes.byref(status))
        _check(status, f"key {key}")
        return buf.value.decode().strip()

    def key_int(self, key: str) -> int:
        v = ctypes.c_longlong(0)
        com = ctypes.create_string_buffer(71)
        status = ctypes.c_int(0)
        self.lib.ffgky(self.fptr, TLONGLONG, key.encode(), ctypes.byref(v),
                       com, ctypes.byref(status))
        _check(status, f"key {key}")
        return v.value

    def key_float(self, key: str) -> float:
        v = ctypes.c_double(0)
        com = ctypes.create_string_buffer(71)
        status = ctypes.c_int(0)
        self.lib.ffgky(self.fptr, TDOUBLE, key.encode(), ctypes.byref(v),
                       com, ctypes.byref(status))
        _check(status, f"key {key}")
        return v.value

    # ---- binary table columns ----

    def num_rows(self) -> int:
        n = ctypes.c_longlong(0)
        status = ctypes.c_int(0)
        self.lib.ffgnrwll(self.fptr, ctypes.byref(n), ctypes.byref(status))
        _check(status, "num_rows")
        return n.value

    def colnum(self, name: str) -> int:
        n = ctypes.c_int(0)
        status = ctypes.c_int(0)
        self.lib.ffgcno(self.fptr, 0, name.encode(), ctypes.byref(n),
                        ctypes.byref(status))
        _check(status, f"column {name}")
        return n.value

    def read_col(self, name: str, nelem_per_row: int,
                 dtype=np.float64) -> np.ndarray:
        """Read a numeric column over all rows -> [nrows, nelem_per_row]."""
        nrows = self.num_rows()
        col = self.colnum(name)
        total = nrows * nelem_per_row
        codes = {np.float64: (TDOUBLE, ctypes.c_double),
                 np.float32: (TFLOAT, ctypes.c_float),
                 np.int16: (TSHORT, ctypes.c_short),
                 np.int64: (TLONGLONG, ctypes.c_longlong)}
        code, ctype = codes[dtype]
        arr = (ctype * total)()
        anynul = ctypes.c_int(0)
        status = ctypes.c_int(0)
        self.lib.ffgcv(self.fptr, code, col,
                       ctypes.c_longlong(1), ctypes.c_longlong(1),
                       ctypes.c_longlong(total), None, arr,
                       ctypes.byref(anynul), ctypes.byref(status))
        _check(status, f"read {name}")
        return np.ctypeslib.as_array(arr).astype(dtype).reshape(
            nrows, nelem_per_row).copy()


def _expect(ok: bool, what) -> None:
    """Raise ``AssertionError`` (as the JAX package's asserts do) unless
    ``ok``; unlike ``assert``, also under ``python -O``."""
    if not ok:
        raise AssertionError(what)


def verify_psrfits_fold(path: str, result) -> Dict[str, float]:
    """Open an archive WE wrote with cfitsio and check it against the
    in-memory ``FoldResult`` (``models/load_to_fold.py``).  Returns check
    metrics; raises on mismatch."""
    obs = result.obs
    nsub = result.profiles.shape[0]
    nchan, npol, nbin = obs.nchan, obs.npol, result.nbin
    with CfitsioFile(path) as f:
        f.move_to("SUBINT")
        _expect(f.num_rows() == nsub, (f.num_rows(), nsub))
        for key, want in (("NBIN", nbin), ("NCHAN", nchan), ("NPOL", npol)):
            _expect(f.key_int(key) == want, (key, f.key_int(key), want))
        offs = f.read_col("OFFS_SUB", 1)[:, 0]
        tsub = f.read_col("TSUBINT", 1)[:, 0]
        want = (np.array([e - obs.start_time for e in result.epochs])
                + np.asarray(result.integration_length) / 2.0)
        np.testing.assert_allclose(offs, want, atol=1e-9)
        np.testing.assert_allclose(tsub, result.integration_length,
                                   rtol=1e-12)
        scl = f.read_col("DAT_SCL", nchan * npol, np.float32)
        offv = f.read_col("DAT_OFFS", nchan * npol, np.float32)
        data = f.read_col("DATA", nbin * nchan * npol, np.int16)
        scl3 = scl.reshape(nsub, nchan, npol).astype(np.float64)
        off3 = offv.reshape(nsub, nchan, npol).astype(np.float64)
        prof = (data.reshape(nsub, npol, nchan, nbin).astype(np.float64)
                .transpose(0, 2, 1, 3))  # -> [nsub, nchan, npol, nbin]
        prof = prof * scl3[..., None] + off3[..., None]
        want_prof = result.normalized()
        scale = np.abs(want_prof).max() or 1.0
        err = np.abs(prof - want_prof).max() / scale
        _expect(err < 1e-3, f"profile round-trip error {err}")
        return {"max_profile_err": float(err), "nsub": nsub}
