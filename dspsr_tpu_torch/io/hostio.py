"""ctypes bindings for the host I/O runtime (``csrc/hostio.cpp``).

- :class:`PrefetchSource`: wraps a DADA file source with a C++
  background-thread prefetcher (the reference's Seekable/IOManager
  double-buffering role) so disk reads overlap device compute.
- :class:`RingWriter` / :class:`RingReader`: POSIX shared-memory ring buffer
  for live capture (the psrdada ring role used by ``DADABuffer``; simplified
  protocol, not psrdada binary compatible).
- :class:`DadaWriter` / :class:`DadaReader`: the psrdada-style SysV hdu
  (data block at ``key``, header block at ``key + 1``, semaphore flow
  control).

The JAX package's ``dspsr_tpu/io/hostio.py`` with the same names and
meaning, over the port's own copy of the runtime: both speak one wire
protocol, so a ring written by either package is read by the other.  The
library is built with the host compiler at first use
(``kernels/build.py::build_host``); a missing compiler raises.  The readers
return host ``uint8`` arrays, which the pipelines move to their device.
"""

from __future__ import annotations

import ctypes
import time

import numpy as np

from ..observation import Observation
from .dada import (format_ascii_header, header_from_observation,
                   observation_from_header, parse_ascii_header)
from .sources import DADAFile, Source

_c = ctypes
_P, _I64, _I, _D = _c.c_void_p, _c.c_int64, _c.c_int, _c.c_double

#: function -> (restype, argtypes)
_SIGNATURES = {
    "prefetch_open": (_P, [_c.c_char_p, _I64, _I64, _I64, _I]),
    "prefetch_next": (_I64, [_P, _P, _c.POINTER(_I64)]),
    "prefetch_close": (None, [_P]),
    "ring_create": (_P, [_c.c_char_p, _I64, _I64, _I64]),
    "ring_connect": (_P, [_c.c_char_p]),
    "ring_write_header": (None, [_P, _c.c_char_p, _I64]),
    "ring_read_header": (_I, [_P, _P, _I64]),
    "ring_push": (_I, [_P, _P]),
    "ring_pop": (_I, [_P, _P]),
    "ring_set_eod": (None, [_P]),
    "ring_buf_bytes": (_I64, [_P]),
    "ring_hdr_bytes": (_I64, [_P]),
    "ring_fill": (_I64, [_P]),
    "ring_close": (None, [_P, _I]),
    # psrdada-architecture SysV hdu (data block at key, header at key+1)
    "dada_create": (_P, [_I, _I64, _I64, _I64]),
    "dada_connect": (_P, [_I]),
    "dada_write_header": (None, [_P, _c.c_char_p, _I64]),
    "dada_read_header": (_I, [_P, _P, _I64]),
    "dada_push": (_I, [_P, _P, _D]),
    "dada_pop": (_I, [_P, _P, _D]),
    "dada_set_eod": (None, [_P]),
    "dada_bufsz": (_I64, [_P]),
    "dada_nbufs": (_I64, [_P]),
    "dada_hdr_bufsz": (_I64, [_P]),
    "dada_fill": (_I64, [_P]),
    "dada_close": (None, [_P, _I]),
}


def load_hostio() -> ctypes.CDLL:
    """The host I/O runtime (loaded once a process, built from
    ``csrc/hostio.cpp`` if needed), with every function's ctypes signature
    declared."""
    from ..kernels import build

    lib = build.load("hostio", host=True)
    for name, (restype, argtypes) in _SIGNATURES.items():
        fn = getattr(lib, name)
        fn.restype = restype
        fn.argtypes = argtypes
    return lib


#: psrdada's default ring key (dada_def.h DADA_DEFAULT_BLOCK_KEY)
DADA_DEFAULT_BLOCK_KEY = 0xDADA


def _ptr(a: np.ndarray) -> ctypes.c_void_p:
    return a.ctypes.data_as(ctypes.c_void_p)


class PrefetchSource(Source):
    """Sequential block reader with native background prefetch.

    Serves the pipeline's fixed-stride access pattern: block b covers
    samples [b*stride, b*stride + block_samples).  Random access falls back
    to the inner source; past the end of the file a block is zero-padded.
    """

    def __init__(self, inner, block_samples: int, stride_samples: int,
                 depth: int = 4):
        if not isinstance(inner, DADAFile):
            raise TypeError("PrefetchSource currently wraps DADAFile sources")
        self.inner = inner
        self.obs = inner.obs
        bps = inner.bytes_per_sample_exact()
        self.block_samples = block_samples
        self.stride_samples = stride_samples
        self._bps = bps
        self._lib = load_hostio()
        self._h = self._lib.prefetch_open(
            inner.path.encode(), inner.header_bytes,
            block_samples * bps, stride_samples * bps, depth)
        if not self._h:
            raise OSError(f"prefetch_open failed for {inner.path}")
        self._expected = 0

    @property
    def total_samples(self) -> int:
        return self.inner.total_samples

    def read_samples(self, start: int, nsamp: int) -> np.ndarray:
        if (nsamp == self.block_samples and start == self._expected
                and self._h):
            out = np.empty(nsamp * self._bps, np.uint8)
            off = ctypes.c_int64()
            got = self._lib.prefetch_next(self._h, _ptr(out),
                                          ctypes.byref(off))
            if got > 0 and off.value == start * self._bps:
                self._expected += self.stride_samples
                return out
            # sequence broken (seek or eof): fall back
        return self.inner.read_samples(start, nsamp)

    def close(self):
        if self._h:
            self._lib.prefetch_close(self._h)
            self._h = None

    def __del__(self):
        try:
            self.close()
        except Exception:
            pass


def _header(obs: Observation, hdr_bytes: int) -> bytes:
    return format_ascii_header(header_from_observation(obs), hdr_bytes)


class RingWriter:
    """Producer side of the live-capture SHM ring."""

    def __init__(self, name: str, obs: Observation, buf_bytes: int,
                 nbufs: int = 16, hdr_bytes: int = 4096):
        self._lib = load_hostio()
        self._h = self._lib.ring_create(name.encode(), hdr_bytes, buf_bytes,
                                        nbufs)
        if not self._h:
            raise OSError(f"ring_create({name}) failed")
        self.name = name
        self.buf_bytes = buf_bytes
        hdr = _header(obs, hdr_bytes)
        self._lib.ring_write_header(self._h, hdr, len(hdr))

    def push(self, buf: np.ndarray) -> bool:
        """Copy one buffer in; False (and nothing written) when the ring is
        full."""
        if buf.nbytes != self.buf_bytes:
            raise ValueError(f"push of {buf.nbytes} B into a ring of "
                             f"{self.buf_bytes} B buffers")
        b = np.ascontiguousarray(buf.view(np.uint8))
        return bool(self._lib.ring_push(self._h, _ptr(b)))

    def set_eod(self):
        self._lib.ring_set_eod(self._h)

    def close(self, unlink: bool = True):
        if self._h:
            self._lib.ring_close(self._h, int(unlink))
            self._h = None


class RingReader(Source):
    """Consumer side: a Source over the live ring (DADABuffer equivalent).

    ``read_samples`` serves sequential *forward* reads of any size and
    stride — including the overlapping reads of the coherent-dedispersion
    block loop (stride < block).  Ring buffers are popped as needed and the
    trailing bytes are carried host-side between reads, exactly the role of
    the reference's overlap recycling in ``Seekable::load_data``
    (``Kernel/Classes/Seekable.C:197-222``) that lets ``DADABuffer`` feed
    full pipelines live.  Seeking backwards beyond the carried tail raises
    ``ValueError``; the end of the data raises ``EOFError``.
    """

    def __init__(self, name: str):
        self._lib = load_hostio()
        self._h = self._lib.ring_connect(name.encode())
        if not self._h:
            raise OSError(f"ring_connect({name}) failed")
        hdr_bytes = self._lib.ring_hdr_bytes(self._h)
        buf = ctypes.create_string_buffer(hdr_bytes)
        if not self._lib.ring_read_header(self._h, buf, hdr_bytes):
            raise OSError("ring header not written yet")
        self._start(buf.raw, self._lib.ring_buf_bytes(self._h))

    def _start(self, header: bytes, buf_bytes: int) -> None:
        self.obs = observation_from_header(
            parse_ascii_header(header.decode("latin-1")))
        self.buf_bytes = buf_bytes
        # carried bytes cover stream bytes [_carry_start, _carry_start+len)
        self._carry = np.empty(0, np.uint8)
        self._carry_start = 0

    @property
    def total_samples(self) -> int:
        return 1 << 62  # unbounded stream; ends via end-of-data

    def buffer_samples(self) -> int:
        return self.buf_bytes // int(self.obs.nbytes_per_sample)

    def _pop(self) -> np.ndarray:
        out = np.empty(self.buf_bytes, np.uint8)
        while True:
            r = self._lib.ring_pop(self._h, _ptr(out))
            if r == 1:
                return out
            if r == -1:
                raise EOFError("ring end of data")
            time.sleep(0.0005)

    def read_samples(self, start: int, nsamp: int) -> np.ndarray:
        bps = self.bytes_per_sample_exact()
        a = start * bps
        b = (start + nsamp) * bps
        if a < self._carry_start:
            raise ValueError(
                f"live ring cannot seek back to byte {a} "
                f"(tail carried from {self._carry_start})")
        chunks = [self._carry]
        end = self._carry_start + self._carry.size
        while end < b:
            nxt = self._pop()
            chunks.append(nxt)
            end += nxt.size
        data = np.concatenate(chunks) if len(chunks) > 1 else self._carry
        off = a - self._carry_start
        out = data[off : off + (b - a)].copy()
        # keep everything from byte a onward: the next read may overlap
        self._carry = data[off:]
        self._carry_start = a
        return out

    def close(self, unlink: bool = False):
        if self._h:
            self._lib.ring_close(self._h, int(unlink))
            self._h = None


class DadaWriter:
    """Producer side of the psrdada-style SysV hdu (data block at ``key``,
    header block at ``key + 1``, semaphore flow control — the transport the
    reference's ``DADABuffer`` attaches to; see ``csrc/hostio.cpp`` for the
    layout and the cited psrdada conventions).  Buffer ``i`` of the data
    block is a segment at ``key + 0x100 * (i + 1)``."""

    def __init__(self, key: int, obs: Observation, buf_bytes: int,
                 nbufs: int = 16, hdr_bytes: int = 4096):
        self._lib = load_hostio()
        self._h = self._lib.dada_create(key, nbufs, buf_bytes, hdr_bytes)
        if not self._h:
            raise OSError(f"dada_create(0x{key:x}) failed")
        self.key = key
        self.buf_bytes = buf_bytes
        hdr = _header(obs, hdr_bytes)
        self._lib.dada_write_header(self._h, hdr, len(hdr))

    def push(self, buf: np.ndarray, timeout: float = 10.0) -> bool:
        """Copy one buffer in, waiting up to ``timeout`` seconds for a free
        one; False when none came free."""
        if buf.nbytes != self.buf_bytes:
            raise ValueError(f"push of {buf.nbytes} B into a ring of "
                             f"{self.buf_bytes} B buffers")
        b = np.ascontiguousarray(buf.view(np.uint8))
        return bool(self._lib.dada_push(self._h, _ptr(b), timeout))

    def set_eod(self):
        self._lib.dada_set_eod(self._h)

    def close(self, destroy: bool = True):
        if self._h:
            self._lib.dada_close(self._h, int(destroy))
            self._h = None


class DadaReader(RingReader):
    """Consumer side of the psrdada-style SysV hdu: a Source with the same
    overlap-carrying forward-read semantics as :class:`RingReader` (the
    ``DADABuffer`` role, ``Kernel/Formats/dada/dsp/DADABuffer.h:17-80``).
    A pop that waits ``timeout`` seconds for data raises ``TimeoutError``
    (at the end of the data, after that wait, ``EOFError``)."""

    def __init__(self, key: int = DADA_DEFAULT_BLOCK_KEY,
                 timeout: float = 10.0):
        self._lib = load_hostio()
        self._h = self._lib.dada_connect(key)
        if not self._h:
            raise OSError(f"dada_connect(0x{key:x}) failed")
        self.key = key
        self.timeout = timeout
        hdr_bytes = self._lib.dada_hdr_bufsz(self._h)
        buf = ctypes.create_string_buffer(hdr_bytes)
        if not self._lib.dada_read_header(self._h, buf, hdr_bytes):
            raise OSError("dada header not written yet")
        self._start(buf.raw, self._lib.dada_bufsz(self._h))

    def _pop(self) -> np.ndarray:
        out = np.empty(self.buf_bytes, np.uint8)
        r = self._lib.dada_pop(self._h, _ptr(out), self.timeout)
        if r == 1:
            return out
        if r == -1:
            raise EOFError("dada ring end of data")
        raise TimeoutError(f"dada ring empty after {self.timeout}s")

    def close(self, destroy: bool = False):
        if self._h:
            self._lib.dada_close(self._h, int(destroy))
            self._h = None
