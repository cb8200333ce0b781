"""SIGPROC filterbank format: header write/read and sample block output.

Equivalent of the reference ``Kernel/Formats/sigproc`` backend
(``SigProcObservation``, ``SigProcOutputFile``, used by digifil —
``Signal/General/LoadToFil.C:353-374``) and the classic ``sigproc`` header
spec: a stream of (keyword-length-prefixed) header items between
``HEADER_START``/``HEADER_END``, followed by TFP-ordered samples (time-major,
channel within sample, pol outermost of the two... SIGPROC order is
t -> (ifs/pols) -> channels).
"""

from __future__ import annotations

import struct
from dataclasses import dataclass
from typing import BinaryIO, Dict, Tuple

import numpy as np

from ..observation import Observation, Signal
from ..timing.mjd import MJD

_TELESCOPE_IDS = {
    "FAKE": 0, "AO": 1, "OOTY": 2, "NANCAY": 3, "PKS": 4, "JB": 5,
    "GBT": 6, "GMRT": 7, "EFF": 8,
}
_MACHINE_IDS = {"FAKE": 0, "PSPM": 1, "WAPP": 2, "AOFTM": 3, "BPP": 4,
                "OOTY": 5, "SCAMP": 6, "GMRTFB": 7, "PULSAR2000": 8}


def _put_string(f: BinaryIO, s: str):
    b = s.encode()
    f.write(struct.pack("<i", len(b)))
    f.write(b)


def _put_item(f: BinaryIO, key: str, value, fmt: str | None):
    _put_string(f, key)
    if fmt == "str":
        _put_string(f, value)
    elif fmt is not None:
        f.write(struct.pack(fmt, value))


def write_sigproc_header(f: BinaryIO, obs: Observation, nbits: int,
                         source_name: str | None = None) -> None:
    """Write a SIGPROC filterbank header for detected TFP data.

    Channel convention: SIGPROC stores fch1 = frequency of the *first*
    channel and foff = channel step (negative for descending order); our
    natural channel 0 maps directly.
    """
    _put_string(f, "HEADER_START")
    _put_item(f, "telescope_id", _TELESCOPE_IDS.get(obs.telescope.upper(), 0), "<i")
    _put_item(f, "machine_id", 0, "<i")
    _put_item(f, "data_type", 1, "<i")  # 1 = filterbank
    _put_item(f, "source_name", source_name or obs.source or "unknown", "str")
    _put_item(f, "barycentric", 0, "<i")
    _put_item(f, "pulsarcentric", 0, "<i")
    _put_item(f, "nbits", nbits, "<i")
    _put_item(f, "nifs", obs.npol, "<i")
    _put_item(f, "nchans", obs.nchan, "<i")
    _put_item(f, "fch1", obs.centre_frequency_of(0), "<d")
    foff = obs.chan_bandwidth
    _put_item(f, "foff", foff, "<d")
    _put_item(f, "tsamp", 1.0 / obs.rate, "<d")
    _put_item(f, "tstart", obs.start_time.in_days(), "<d")
    if obs.coordinates:
        try:
            from ..timing.skycoord import SkyCoord

            ra, dec = obs.coordinates.split()
            c = SkyCoord.parse(ra, dec)
            _put_item(f, "src_raj", c.sigproc_raj(), "<d")
            _put_item(f, "src_dej", c.sigproc_dej(), "<d")
        except (ValueError, IndexError):
            pass
    _put_string(f, "HEADER_END")


def read_sigproc_header(path: str) -> Tuple[Dict, int]:
    """Parse a SIGPROC header; returns (items, header_size_bytes)."""
    items: Dict = {}
    with open(path, "rb") as f:
        def get_string():
            (n,) = struct.unpack("<i", f.read(4))
            if not 0 < n < 256:
                raise ValueError(f"bad sigproc string length {n}")
            return f.read(n).decode()

        if get_string() != "HEADER_START":
            raise ValueError("not a SIGPROC file")
        int_keys = {"telescope_id", "machine_id", "data_type", "barycentric",
                    "pulsarcentric", "nbits", "nifs", "nchans", "nsamples"}
        dbl_keys = {"fch1", "foff", "tsamp", "tstart", "src_raj", "src_dej",
                    "az_start", "za_start", "refdm", "period"}
        str_keys = {"source_name", "rawdatafile"}
        while True:
            key = get_string()
            if key == "HEADER_END":
                break
            if key in int_keys:
                (items[key],) = struct.unpack("<i", f.read(4))
            elif key in dbl_keys:
                (items[key],) = struct.unpack("<d", f.read(8))
            elif key in str_keys:
                items[key] = get_string()
            else:
                raise ValueError(f"unknown sigproc key {key!r}")
        return items, f.tell()


def observation_from_sigproc(path: str) -> Observation:
    items, hdr = read_sigproc_header(path)
    nchan = items["nchans"]
    foff = items.get("foff", 0.0)
    fch1 = items.get("fch1", 0.0)
    bw = foff * nchan
    cf = fch1 + foff * (nchan - 1) / 2.0
    nbits = items["nbits"]
    obs = Observation(
        nchan=nchan,
        npol=items.get("nifs", 1),
        ndim=1,
        nbit=nbits,
        centre_frequency=cf,
        bandwidth=bw,
        rate=1.0 / items["tsamp"],
        start_time=MJD.from_mjd(items["tstart"]),
        state=Signal.INTENSITY if items.get("nifs", 1) == 1 else Signal.PPQQ,
        source=items.get("source_name", ""),
        format="sigproc",
    )
    obs.obs_offset = hdr  # stash header size
    return obs


class SigProcWriter:
    """Streaming SIGPROC output (reference ``SigProcOutputFile``)."""

    def __init__(self, path: str, obs: Observation, nbits: int = 8):
        self.path = path
        self.nbits = nbits
        self.obs = obs
        self._f = open(path, "wb")
        write_sigproc_header(self._f, obs, nbits)

    def write_block(self, packed: np.ndarray) -> None:
        """packed: uint8 bytes already in SIGPROC TFP order."""
        self._f.write(packed.tobytes())

    def close(self):
        self._f.close()

    def __enter__(self):
        return self

    def __exit__(self, *a):
        self.close()


from .sources import Source, register_format


@register_format
class SigProcFile(Source):
    """SIGPROC filterbank input: registered format probe + positional reads
    (reference ``Kernel/Formats/sigproc/SigProcFile.C``).  Data are detected
    TFP-ordered samples (time-major; per sample: nifs x nchans values)."""

    def __init__(self, path: str):
        self.path = path
        self.items, self.header_bytes = read_sigproc_header(path)
        self.obs = observation_from_sigproc(path)
        import os

        data_bits = (os.path.getsize(path) - self.header_bytes) * 8
        bits_per_samp = self.obs.nchan * self.obs.npol * self.obs.nbit
        self.obs = self.obs.replace(ndat=data_bits // bits_per_samp)
        self.obs.obs_offset = 0

    @staticmethod
    def is_valid(path: str) -> bool:
        try:
            with open(path, "rb") as f:
                head = f.read(16)
            return head[:4] == b"\x0c\x00\x00\x00" and head[4:16] == b"HEADER_START"
        except OSError:
            return False

    @property
    def total_samples(self) -> int:
        return self.obs.ndat

    def read_samples(self, start: int, nsamp: int) -> np.ndarray:
        o = self.obs
        bits_per_samp = o.nchan * o.npol * o.nbit
        if bits_per_samp % 8:
            raise ValueError("sub-byte sample framing not supported")
        bps = bits_per_samp // 8
        out = np.zeros(nsamp * bps, np.uint8)
        if start >= o.ndat:
            return out
        navail = min(nsamp, o.ndat - start)
        with open(self.path, "rb") as f:
            f.seek(self.header_bytes + start * bps)
            buf = f.read(navail * bps)
        out[: len(buf)] = np.frombuffer(buf, np.uint8)
        return out

    def read_detected(self, start: int, nsamp: int) -> np.ndarray:
        """Unpack to float32 [ndat, npol, nchan] host-side (diagnostics)."""
        o = self.obs
        raw = self.read_samples(start, nsamp)
        if o.nbit == 32:
            x = raw.view(np.float32).astype(np.float32)
        elif o.nbit == 8:
            x = raw.astype(np.float32)
        elif o.nbit in (1, 2, 4):
            vals_per_byte = 8 // o.nbit
            shifts = np.arange(vals_per_byte, dtype=np.uint8) * o.nbit
            mask = (1 << o.nbit) - 1
            x = ((raw[:, None] >> shifts[None, :]) & mask).astype(np.float32)
            x = x.reshape(-1)
        else:
            raise ValueError(f"unsupported sigproc nbit {o.nbit}")
        return x.reshape(nsamp, o.npol, o.nchan)
