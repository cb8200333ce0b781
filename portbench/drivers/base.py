"""What every driver shares: the observation, the ring, the pipeline's
geometry held against the reference's, and the warm-up that sizes the
window."""

from __future__ import annotations

import math
import time

import torch

from portbench.reference.filterbank import Precision, chirp
from portbench.reference.geometry import geometry
from portbench.ring import PinnedRing, RingSource

#: seconds of blocks the warm-up times to size the window
SIZING_SECONDS = 0.5


def start_seconds(utc: str) -> float:
    """Seconds of the day of a DADA ``UTC_START`` (``YYYY-MM-DD-hh:mm:ss``)."""
    hh, mm, ss = utc.split("-")[-1].split(":")
    return int(hh) * 3600.0 + int(mm) * 60.0 + float(ss)


class Driver:
    """One cell's program and reference.  Subclasses give ``build()`` (the
    pipeline), ``run_blocks(n)`` (one call of its public entry for ``n``
    blocks, returning what it produced), ``reference(prec)`` (what the last
    call produced, worked out again at ``prec``) and ``compare(got, want)``
    (the numbers that decide ``correct``)."""

    def __init__(self, cell, seed: int, device: str = "cuda",
                 trace: bool = False):
        from dspsr_tpu_torch.models.load_to_fold import MJD, Observation, \
            Signal

        self.seed = seed
        self.device = torch.device(device)
        self.trace = trace
        cfg, tr = cell.config, cell.traffic
        self.config, self.traffic = cfg, tr
        self.geom = geometry(cfg, tr["dm"], cfg.get("nbin", 0))
        self.obs = Observation(
            nchan=cfg["nchan_in"], npol=cfg["npol"], ndim=1, nbit=8,
            centre_frequency=cfg["centre_frequency_mhz"],
            bandwidth=cfg["bandwidth_mhz"], rate=float(cfg["rate_hz"]),
            start_time=MJD.from_utc(cfg["start_utc"]),
            state=Signal.NYQUIST, source=tr["pulsar"],
            telescope=cfg["telescope"], instrument=cfg["instrument"]).replace(
                ndat=1 << 50)
        self.source = RingSource(self.obs, cfg["npol"])
        t0 = time.perf_counter()
        self.pipe = self.build()
        #: seconds of each part of set-up, for the run's log
        self.setup_parts = {"pipeline": time.perf_counter() - t0}
        g = self.geom
        got = (self.pipe.block_in_samples, self.pipe.stride_in_samples)
        if got != (g.block_ndat, g.stride_ndat):
            raise RuntimeError(f"the pipeline's block and stride {got} are "
                               f"not the reference's {g.block_ndat, g.stride_ndat}")
        t0 = time.perf_counter()
        self.ring = PinnedRing(tr["ring_blocks"], g.stride_bytes,
                               g.block_bytes,
                               float(cfg["assumed"]["rms_levels"]), seed,
                               self.device)
        self.sync()
        self.setup_parts["ring"] = time.perf_counter() - t0
        self.source.ring = self.ring
        #: blocks of each call of ``run_blocks`` so far (each starts at the
        #: stream's first block)
        self.runs: list = []
        self.pinned = bool(torch.from_numpy(self.ring.block(1)).is_pinned())

    # ---- the program ----

    def build(self):
        raise NotImplementedError

    def run_blocks(self, n: int):
        raise NotImplementedError

    def window(self, n: int):
        """The timed call: ``n`` blocks through the public entry."""
        return self.run_blocks(n)

    def sync(self):
        if self.device.type == "cuda":
            torch.cuda.synchronize()

    def warm(self, seconds: float) -> int:
        """Run every shape the window will run, then time ``SIZING_SECONDS``
        of blocks; returns the blocks that last ``seconds``."""
        t0 = time.perf_counter()
        self.run_blocks(2)
        self.sync()
        self.setup_parts["first_blocks"] = time.perf_counter() - t0
        t0 = time.perf_counter()
        self.run_blocks(2)
        self.sync()
        est = (time.perf_counter() - t0) / 2
        m = max(2, min(400, math.ceil(SIZING_SECONDS / max(est, 1e-6))))
        t0 = time.perf_counter()
        self.run_blocks(m)
        self.sync()
        per = (time.perf_counter() - t0) / m
        self.setup_parts["sizing"] = (2 + m) * per
        return max(2, round(seconds / per))

    def release(self) -> None:
        """Drop the program's state before the reference runs."""
        self.pipe = None
        if self.device.type == "cuda":
            torch.cuda.empty_cache()

    # ---- the reference ----

    def chirp(self):
        cfg = self.config
        return chirp(self.geom, self.traffic["dm"],
                     cfg["centre_frequency_mhz"], cfg["bandwidth_mhz"],
                     self.device)

    def ring_block(self, k: int) -> torch.Tensor:
        return torch.from_numpy(self.ring.block(k)).to(self.device)

    def reference(self, prec: Precision):
        raise NotImplementedError

    def work(self) -> tuple:
        """``(bytes, operations)`` one step needs (``portbench/work.py``)."""
        raise NotImplementedError

    def compare(self, got, want) -> dict:
        raise NotImplementedError

    def judge(self, out) -> dict:
        """The numbers of ``out``, what the last call produced, against the
        float64 reference."""
        return self.compare(out, self.reference(Precision("float64")))
