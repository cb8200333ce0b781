"""GUPPI RAW format reader.

Equivalent of the reference ``Kernel/Formats/guppi`` backend (GUPPIFile with
FITS-style headers via ``hget.c``): a GUPPI RAW file is a sequence of
blocks, each an ASCII header of 80-character FITS-like cards (ending with
``END``) followed by DIRECTIO-padded binary data of ``BLOCSIZE`` bytes.

Data layout within a block: channel-major — for each channel, ``ntime``
samples of (pol0_re, pol0_im, pol1_re, pol1_im) int8 (OBSNCHAN x ntime x
npol x 2 x nbit/8).  The pipeline wants TFP order, so reads transpose on the
fly (numpy, host side).
"""

from __future__ import annotations

import os
from typing import Dict, List, Tuple

import numpy as np

from ..observation import Observation, Signal
from ..timing.mjd import MJD
from .sources import Source, register_format

CARD = 80


def _read_guppi_header(f) -> Tuple[Dict[str, str], int]:
    """Parse cards at the current offset; returns (cards, header_bytes)."""
    cards: Dict[str, str] = {}
    nbytes = 0
    while True:
        raw = f.read(CARD)
        if len(raw) < CARD:
            raise EOFError("truncated GUPPI header")
        nbytes += CARD
        card = raw.decode("ascii", "replace")
        key = card.split("=")[0].strip()
        if card.startswith("END"):
            break
        if "=" in card:
            val = card.split("=", 1)[1].split("/")[0].strip().strip("'").strip()
            cards[key] = val
    return cards, nbytes


@register_format
class GuppiRawFile(Source):
    """GUPPI RAW reader (reference ``GUPPIFile.C`` + ``hget.c``)."""

    def __init__(self, path: str):
        self.path = path
        self._blocks: List[Tuple[int, int]] = []  # (data_offset, data_bytes)
        with open(path, "rb") as f:
            first_cards = None
            size = os.path.getsize(path)
            while f.tell() < size:
                try:
                    cards, hdr_bytes = _read_guppi_header(f)
                except EOFError:
                    break
                if first_cards is None:
                    first_cards = cards
                blocsize = int(cards["BLOCSIZE"])
                directio = int(cards.get("DIRECTIO", 0) or 0)
                if directio:
                    # header padded to 512; data also padded
                    pad = (-f.tell()) % 512
                    f.seek(pad, os.SEEK_CUR)
                data_off = f.tell()
                self._blocks.append((data_off, blocsize))
                skip = blocsize
                if directio:
                    skip += (-blocsize) % 512
                f.seek(skip, os.SEEK_CUR)
        if first_cards is None:
            raise ValueError(f"{path}: no GUPPI blocks")
        c = first_cards
        self.nchan = int(c["OBSNCHAN"])
        self.npol = max(int(c.get("NPOL", 2)) // 2, 1)  # NPOL=4 means 2 cplx pols
        nbit = int(c.get("NBITS", 8))
        tbin = float(c["TBIN"])
        stt_imjd = int(c.get("STT_IMJD", 0))
        stt_smjd = int(c.get("STT_SMJD", 0))
        stt_offs = float(c.get("STT_OFFS", 0) or 0)

        self.block_ntime = (self._blocks[0][1] * 8
                            // (self.nchan * self.npol * 2 * nbit))
        self.obs = Observation(
            nchan=self.nchan, npol=self.npol, ndim=2, nbit=nbit,
            centre_frequency=float(c.get("OBSFREQ", 0) or 0),
            bandwidth=float(c.get("OBSBW", 0) or 0),
            rate=1.0 / tbin,
            start_time=MJD(stt_imjd, stt_smjd + stt_offs),
            state=Signal.ANALYTIC,
            source=c.get("SRC_NAME", ""),
            telescope=c.get("TELESCOP", ""),
            instrument=c.get("BACKEND", "GUPPI"),
            format="guppi",
            ndat=self.block_ntime * len(self._blocks),
        )
        # GUPPI RAW samples are int8 twos complement
        self.twos_complement = True

    @staticmethod
    def is_valid(path: str) -> bool:
        try:
            with open(path, "rb") as f:
                head = f.read(CARD * 3).decode("ascii", "replace")
            return ("BLOCSIZE" in head or "OBSNCHAN" in head
                    or head.startswith("BACKEND = 'GUPPI"))
        except (OSError, UnicodeDecodeError):
            return False

    @property
    def total_samples(self) -> int:
        return self.obs.ndat

    def read_samples(self, start: int, nsamp: int) -> np.ndarray:
        """Returns TFP-ordered bytes (transposed from GUPPI's channel-major)."""
        bps = self.bytes_per_sample_exact()
        out = np.zeros(nsamp * bps, np.uint8)
        per_samp_chan = self.npol * 2 * self.obs.nbit // 8  # bytes/chan/samp
        filled = 0
        with open(self.path, "rb") as f:
            while filled < nsamp:
                pos = start + filled
                if pos >= self.total_samples:
                    break
                iblk = pos // self.block_ntime
                within = pos % self.block_ntime
                take = min(nsamp - filled, self.block_ntime - within)
                off, nbytes = self._blocks[iblk]
                # channel-major: read each channel's strip, then transpose
                strip = np.empty((self.nchan, take * per_samp_chan), np.uint8)
                chan_bytes = self.block_ntime * per_samp_chan
                for ch in range(self.nchan):
                    f.seek(off + ch * chan_bytes + within * per_samp_chan)
                    strip[ch] = np.frombuffer(
                        f.read(take * per_samp_chan), np.uint8)
                # [nchan, take, per] -> [take, nchan, per] (TFP)
                tfp = strip.reshape(self.nchan, take, per_samp_chan)
                tfp = np.ascontiguousarray(tfp.transpose(1, 0, 2))
                out[filled * bps : (filled + take) * bps] = tfp.reshape(-1)
                filled += take
        return out
