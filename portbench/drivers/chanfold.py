"""dspsr fold mode on channelised complex input: the fold driver's
``FoldPipeline.run(max_blocks=N)`` over a ring of ``nchan_in`` complex
dual-pol 8-bit channels (TFP), each split into the configuration's
``nchan / nchan_in`` subbands, every block folded at a fixed period into
sub-integrations of ``subint_seconds``.

What differs from ``drivers/fold.py`` is the input and the reference: the
observation is complex (``Signal.ANALYTIC``, ``ndim`` 2) and the
filterbank is ``reference/channelised.py``'s, each channel with its own
chirp.  The pipeline, the window, the phases, the divisions, the fold and
the numbers compared are the fold driver's."""

from __future__ import annotations

import time

import torch

from portbench.chanwork import chan_fold_bytes, chan_front_ops
from portbench.drivers.base import start_seconds
from portbench.drivers.fold import Driver as FoldDriver, Folded
from portbench.reference.channelised import channel_chirp, \
    channel_geometry, detect_block
from portbench.reference.filterbank import Precision
from portbench.reference.fold import Divisions, anchors, bins, fold
from portbench.ring import PinnedRing, RingSource


class Driver(FoldDriver):
    def __init__(self, cell, seed: int, device: str = "cuda",
                 trace: bool = False):
        from dspsr_tpu_torch.models.load_to_fold import MJD, Observation, \
            Signal

        self.seed = seed
        self.device = torch.device(device)
        self.trace = trace
        cfg, tr = cell.config, cell.traffic
        self.config, self.traffic = cfg, tr
        self.geom = g = channel_geometry(cfg, tr["dm"], cfg.get("nbin", 0))
        self.obs = Observation(
            nchan=cfg["nchan_in"], npol=cfg["npol"], ndim=cfg["ndim"],
            nbit=cfg["nbit"], centre_frequency=cfg["centre_frequency_mhz"],
            bandwidth=cfg["bandwidth_mhz"], rate=float(cfg["rate_hz"]),
            start_time=MJD.from_utc(cfg["start_utc"]),
            state=Signal.ANALYTIC, source=tr["pulsar"],
            telescope=cfg["telescope"], instrument=cfg["instrument"]).replace(
                ndat=1 << 50)
        self.source = RingSource(self.obs, g.sample_bytes)
        t0 = time.perf_counter()
        self.pipe = self.build()
        #: seconds of each part of set-up, for the run's log
        self.setup_parts = {"pipeline": time.perf_counter() - t0}
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
        self.runs: list = []
        self.pinned = bool(torch.from_numpy(self.ring.block(1)).is_pinned())

    def chirp(self):
        cfg = self.config
        return channel_chirp(self.geom, self.traffic["dm"],
                             cfg["centre_frequency_mhz"],
                             cfg["bandwidth_mhz"], self.device)

    def work(self) -> tuple:
        return chan_fold_bytes(self.geom), chan_front_ops(self.geom)

    def reference(self, prec: Precision) -> Folded:
        """Every sub-integration of the last call, ``[ndiv, nchan,
        nbin]``: the filterbank at ``prec``, the fold in float64."""
        # no TF32 in the reference's float arithmetic on the card
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
        g, tr = self.geom, self.traffic
        n, nring, nuse = self.runs[-1], self.ring.nblocks, g.out_per_block
        div = Divisions(g, start_seconds(self.config["start_utc"]),
                        self.config["subint_seconds"])
        first = div.of(0)
        ndiv = div.of(n * nuse - 1) - first + 1
        start = start_seconds(self.config["start_utc"])
        h = self.chirp()
        prof = torch.zeros(ndiv, g.nchan, g.nbin, dtype=torch.float64,
                           device=self.device)
        hits = torch.zeros(ndiv, g.nbin, dtype=torch.float64,
                           device=self.device)
        for k in range(min(nring, n)):
            d = detect_block(self.ring_block(k), g, h, prec)
            for b in range(k, n, nring):
                phi0, dphi = anchors(g, b, start, tr["period_s"])
                idx = bins(phi0, dphi, g.nkeep, g.nbin, self.device)
                lo = 0
                # the block's spans of kept samples, one a division
                while lo < nuse:
                    j = div.of(b * nuse + lo)
                    hi = min(nuse, div.boundary(j + 1) - b * nuse)
                    fold(prof[j - first], hits[j - first], d[:, lo:hi],
                         idx[lo:hi])
                    lo = hi
            del d
        return Folded(prof.cpu().numpy(), hits.cpu().numpy())
