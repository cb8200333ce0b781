"""VDIF format reader (VLBI Data Interchange Format).

Equivalent of the reference ``Kernel/Formats/vdif`` backend (VDIFFile +
bundled ``vdifio.c``): fixed-size frames, each a 32-byte header (16 for
legacy mode) + payload.  Header words (little-endian uint32):

  w0: seconds-from-epoch[30] | legacy[1] | invalid[1]
  w1: frame#-within-second[24] | ref-epoch[6] (6-month units from 2000)
  w2: frame-length/8 incl header[24] | log2(nchan)[5] | version[3]
  w3: station[16] | thread[10] | bits-per-sample-1[5] | complex[1]

Single- AND multi-thread files are supported: the reference's vdif backend
de-interleaves round-robin thread frames (each thread a polarization or a
frequency channel; ``VDIFTwoBitCorrectionMulti`` et al.).  Here two threads
map to the two polarizations and >2 threads map to channels (a sidecar
NPOL can regroup), with frames de-interleaved at sample-code granularity.
Offset-binary sample codes, matching vdifio's convention.
"""

from __future__ import annotations

import os
import struct
from typing import Tuple

import numpy as np

from ..observation import Observation, Signal
from ..timing.mjd import MJD
from .sources import Source, register_format

VDIF_EPOCH_MJD0 = 51544  # 2000-01-01


def _epoch_to_mjd(ref_epoch: int) -> int:
    """VDIF reference epoch (6-month units since 2000-01-01) -> MJD."""
    year = 2000 + ref_epoch // 2
    month = 1 + 6 * (ref_epoch % 2)
    # Fliegel & Van Flandern
    a = (14 - month) // 12
    y2 = year + 4800 - a
    m2 = month + 12 * a - 3
    jdn = 1 + (153 * m2 + 2) // 5 + 365 * y2 + y2 // 4 - y2 // 100 + y2 // 400 - 32045
    return jdn - 2400001


def parse_vdif_header(buf: bytes) -> dict:
    w0, w1, w2, w3 = struct.unpack("<4I", buf[:16])
    return {
        "seconds": w0 & 0x3FFFFFFF,
        "legacy": (w0 >> 30) & 1,
        "invalid": (w0 >> 31) & 1,
        "frame": w1 & 0xFFFFFF,
        "ref_epoch": (w1 >> 24) & 0x3F,
        "frame_bytes": (w2 & 0xFFFFFF) * 8,
        "log2_nchan": (w2 >> 24) & 0x1F,
        "version": (w2 >> 29) & 0x7,
        "station": w3 & 0xFFFF,
        "thread": (w3 >> 16) & 0x3FF,
        "nbit": ((w3 >> 26) & 0x1F) + 1,
        "complex": (w3 >> 31) & 1,
    }


@register_format
class VDIFFile(Source):
    """Single-thread VDIF file reader (reference ``VDIFFile.C``).

    Bandwidth/frequency are not in VDIF headers; supply via a sidecar DADA
    header ``<file>.hdr`` (keys FREQ/BW/TELESCOPE...) or set on ``obs``
    after opening — the sample geometry (rate, nbit, nchan, complexity,
    start time) comes from the frames themselves.
    """

    def __init__(self, path: str):
        self.path = path
        with open(path, "rb") as f:
            hdr = parse_vdif_header(f.read(32))
        if hdr["legacy"]:
            self.header_bytes = 16
        else:
            self.header_bytes = 32
        self.frame_bytes = hdr["frame_bytes"]
        self.payload_bytes = self.frame_bytes - self.header_bytes
        nchan = 1 << hdr["log2_nchan"]
        ndim = 2 if hdr["complex"] else 1
        nbit = hdr["nbit"]
        self._hdr0 = hdr

        bits_per_samp = nbit * nchan * ndim
        self.samples_per_frame = self.payload_bytes * 8 // bits_per_samp

        size = os.path.getsize(path)
        self.nframes = size // self.frame_bytes

        # multi-thread interleave: distinct thread IDs, round-robin frames
        # (reference VDIFFile thread handling); the thread order within one
        # group is recorded and verified over the next groups
        self.thread_order = self._scan_threads()
        self.nthread = len(self.thread_order)
        self._thread_slot = {t: i for i, t in enumerate(self.thread_order)}

        # frame rate from the first second boundary: the frame counter is
        # PER THREAD in VDIF, so the max frame number + 1 is already the
        # per-thread frames/second (assume constant rate, standard VDIF)
        frames_per_sec = self._count_frames_per_second()
        rate = frames_per_sec * self.samples_per_frame

        mjd = _epoch_to_mjd(hdr["ref_epoch"])
        start = MJD(mjd, float(hdr["seconds"])) + (
            hdr["frame"] / frames_per_sec if frames_per_sec else 0.0)

        # threads -> polarizations (the common dual-pol case) or channels
        npol = 1
        if self.nthread == 2:
            npol = 2
        elif self.nthread > 2:
            nchan = nchan * self.nthread
        if self.nthread > 1 and (1 << hdr["log2_nchan"]) != 1:
            raise ValueError(
                "multi-thread VDIF with multi-channel frames not supported")
        self.obs = Observation(
            nchan=nchan, npol=npol, ndim=ndim, nbit=nbit,
            rate=float(rate),
            start_time=start,
            state=Signal.ANALYTIC if ndim == 2 else Signal.NYQUIST,
            format="vdif",
            instrument="VDIF",
            ndat=(self.nframes // self.nthread) * self.samples_per_frame,
        )
        self._load_sidecar()

    def _scan_threads(self):
        """Thread IDs in their round-robin group order; validates that the
        pattern repeats over the first few groups."""
        ids = []
        with open(self.path, "rb") as f:
            for i in range(min(self.nframes, 4096)):
                f.seek(i * self.frame_bytes)
                h = parse_vdif_header(f.read(16).ljust(16, b"\0"))
                t = h["thread"]
                if t in ids:
                    break
                ids.append(t)
        n = len(ids)
        if n > 1:
            with open(self.path, "rb") as f:
                for i in range(min(self.nframes, 8 * n)):
                    f.seek(i * self.frame_bytes)
                    h = parse_vdif_header(f.read(16).ljust(16, b"\0"))
                    if h["thread"] != ids[i % n]:
                        raise ValueError(
                            "irregular VDIF thread interleave (frame "
                            f"{i}: thread {h['thread']}, expected "
                            f"{ids[i % n]})")
        return ids

    def _count_frames_per_second(self) -> int:
        sec0 = self._hdr0["seconds"]
        best = self._hdr0["frame"]
        with open(self.path, "rb") as f:
            for i in range(min(self.nframes, 1 << 20)):
                f.seek(i * self.frame_bytes)
                h = parse_vdif_header(f.read(16).ljust(16, b"\0"))
                if h["seconds"] != sec0:
                    return best + 1
                best = max(best, h["frame"])
        return best + 1

    def _load_sidecar(self):
        side = self.path + ".hdr"
        if os.path.exists(side):
            from .dada import parse_ascii_header

            with open(side) as f:
                kv = parse_ascii_header(f.read())
            if "FREQ" in kv:
                self.obs = self.obs.replace(centre_frequency=float(kv["FREQ"]))
            if "BW" in kv:
                self.obs = self.obs.replace(bandwidth=float(kv["BW"]))
            if "TELESCOPE" in kv:
                self.obs = self.obs.replace(telescope=kv["TELESCOPE"])
            if "SOURCE" in kv:
                self.obs = self.obs.replace(source=kv["SOURCE"])
            if "NPOL" in kv:  # dual-pol recorded as 2 "channels"
                npol = int(kv["NPOL"])
                if npol > 1 and self.obs.nchan % npol == 0:
                    self.obs = self.obs.replace(
                        nchan=self.obs.nchan // npol, npol=npol)

    @staticmethod
    def is_valid(path: str) -> bool:
        try:
            with open(path, "rb") as f:
                buf = f.read(32)
            if len(buf) < 32:
                return False
            h = parse_vdif_header(buf)
            if h["frame_bytes"] == 0 or h["frame_bytes"] > 9032:
                return False
            if h["frame_bytes"] % 8 != 0:
                return False
            size = os.path.getsize(path)
            if size % h["frame_bytes"] and size > 2 * h["frame_bytes"]:
                return False
            # second frame must parse consistently
            with open(path, "rb") as f:
                f.seek(h["frame_bytes"])
                buf2 = f.read(32)
            if len(buf2) == 32:
                h2 = parse_vdif_header(buf2)
                if h2["frame_bytes"] != h["frame_bytes"]:
                    return False
                if h2["log2_nchan"] != h["log2_nchan"]:
                    return False
            return True
        except OSError:
            return False

    @property
    def total_samples(self) -> int:
        return self.obs.ndat

    def read_samples(self, start: int, nsamp: int) -> np.ndarray:
        if self.nthread > 1:
            return self._read_multithread(start, nsamp)
        bps_bits = self.obs.nchan * self.obs.npol * self.obs.ndim * self.obs.nbit
        out = np.zeros(nsamp * bps_bits // 8, np.uint8)
        spf = self.samples_per_frame
        filled = 0
        with open(self.path, "rb") as f:
            while filled < nsamp:
                pos = start + filled
                if pos >= self.total_samples:
                    break
                iframe = pos // spf
                within = pos % spf
                take = min(nsamp - filled, spf - within)
                f.seek(iframe * self.frame_bytes + self.header_bytes
                       + within * bps_bits // 8)
                buf = f.read(take * bps_bits // 8)
                out[filled * bps_bits // 8 :
                    filled * bps_bits // 8 + len(buf)] = np.frombuffer(buf, np.uint8)
                filled += take
        return out

    def _read_thread_stream(self, slot: int, start: int, nsamp: int) -> np.ndarray:
        """One thread's contiguous payload bytes for per-thread samples
        [start, start+nsamp) (whole-byte aligned reads; nbit in 2/4/8
        keeps bits_per_sample a divisor or multiple of 8)."""
        hdr0_bits = self.obs.ndim * self._hdr_nbit
        spf = self.samples_per_frame
        nth = self.nthread
        out = np.zeros(-(-nsamp * hdr0_bits // 8), np.uint8)
        filled = 0
        with open(self.path, "rb") as f:
            while filled < nsamp:
                pos = start + filled
                if pos >= self.total_samples:
                    break
                jframe = pos // spf  # per-thread frame index
                within = pos % spf
                take = min(nsamp - filled, spf - within)
                gframe = jframe * nth + slot  # file frame index
                f.seek(gframe * self.frame_bytes + self.header_bytes
                       + within * hdr0_bits // 8)
                buf = f.read(-(-take * hdr0_bits // 8))
                off = filled * hdr0_bits // 8
                out[off: off + len(buf)] = np.frombuffer(buf, np.uint8)
                filled += take
        return out

    @property
    def _hdr_nbit(self) -> int:
        return self.obs.nbit

    def _read_multithread(self, start: int, nsamp: int) -> np.ndarray:
        """De-interleave round-robin thread frames into TFP byte order
        (time, chan, pol, dim) at sample-code granularity."""
        nbit = self.obs.nbit
        ndim = self.obs.ndim
        nth = self.nthread
        streams = [self._read_thread_stream(s, start, nsamp)
                   for s in range(nth)]
        if nbit == 8:
            # units of ndim bytes per sample per thread
            arr = np.stack([s[: nsamp * ndim].reshape(nsamp, ndim)
                            for s in streams], axis=1)  # [t, thread, dim]
            return np.ascontiguousarray(arr).reshape(-1)
        # sub-byte codes: expand, interleave, repack (MSB first, matching
        # unpack.bytes_to_codes / BitTable extract order)
        per = 8 // nbit
        mask = (1 << nbit) - 1
        shifts = (np.arange(per) * nbit)[::-1]
        codes = []
        for s in streams:
            c = ((s[:, None].astype(np.uint16) >> shifts[None, :]) & mask
                 ).reshape(-1)[: nsamp * ndim]
            codes.append(c.reshape(nsamp, ndim))
        inter = np.stack(codes, axis=1).reshape(-1)  # [t, thread, dim] codes
        pad = (-inter.size) % per
        if pad:
            inter = np.concatenate([inter, np.zeros(pad, inter.dtype)])
        g = inter.reshape(-1, per).astype(np.uint16)
        return (np.sum(g << shifts[None, :].astype(np.uint16), axis=1)
                & 0xFF).astype(np.uint8)
