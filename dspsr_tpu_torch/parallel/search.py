"""Multi-device search-mode pipeline: the LoadToFilN / LoadToFITSN
equivalent.

Counterpart of ``dspsr_tpu/parallel/search.py``.  The reference scales
digifil and digifits by cloning the pipeline across threads and writing the
packed output through ``OutputFileShare`` (``Signal/General/LoadToFilN.C``,
``Kernel/Classes/OutputFileShare.C``).  Here, as in
:class:`parallel.pipeline.ShardedFoldPipeline`, one controller drives the
mesh's ``time`` axis one superblock at a time: each shard runs the single
pipeline's chain (:meth:`FilPipeline._local_chain`: unpack, pol select,
the fused front end or the filterbank, detection, scrunches, weights) on
its stripe, with the overlap handed over as raw bytes, then the rescale and
the digitizer; the packed rows are written in time order.

Rescale across shards: the scales are bootstrapped from the FIRST shard's
first-block statistics (the single pipeline's first block) and then held
(``rescale_constant``: the single run's bytes) or refreshed every
``rescale_seconds`` from the statistics of every shard, summed in shard
order (the JAX package's superblock-granular ``-I``).
"""

from __future__ import annotations

import dataclasses
import time
from typing import Optional

import torch

from ..device import host_to_device
from ..io.sources import Source
from ..models.load_to_fil import FilConfig, FilPipeline, digitize
from ..ops.rescale import (
    RescaleState, accumulate, apply_scales, state_mean_scale)
from .sharded import Mesh


class ShardedFilPipeline:
    """Streams a Source through search-mode superblocks on the mesh's time
    axis."""

    def __init__(self, source: Source, config: FilConfig, mesh: Mesh):
        if "time" not in mesh.shape:
            raise ValueError("mesh needs a 'time' axis")
        if mesh.shape.get("chan", 1) != 1:
            raise NotImplementedError(
                "search-mode chan sharding is not implemented (an output "
                "row needs every channel; use time shards)")
        self.mesh = mesh
        self.n_time = mesh.shape["time"]
        # cap the per-shard block so at least one superblock fits the source
        avail = source.total_samples
        if avail < (1 << 60):
            cap = max(avail // (self.n_time + 1), 4096)
            config = dataclasses.replace(
                config, min_block_samples=min(config.min_block_samples, cap))
        self.config = config
        self.source = source
        self._devs = [mesh.device(t) for t in range(self.n_time)]
        #: one pipeline (constants, plans) per device that hosts a shard
        self._inners = {}
        for d in self._devs:
            if d not in self._inners:
                self._inners[d] = FilPipeline(source, config, device=d)
        inner = self.inner = self._inners[self._devs[0]]
        overlap = inner.block_in_samples - inner.stride_in_samples
        bps = inner.obs_in.nbytes_per_sample
        self.stride_bytes = int(round(inner.stride_in_samples * bps))
        self.halo_bytes = int(round(overlap * bps))
        self.nsamp_overlap = overlap
        self.superblock_samples = (self.n_time * inner.stride_in_samples
                                   + overlap)
        self.superblock_stride = self.n_time * inner.stride_in_samples
        #: seconds in the halo copies and in the statistics' sum, measured
        #: after a device synchronise when ``timed`` is set (CUDA shards)
        self.timed = False
        self.seconds = {"halo": 0.0, "reduce": 0.0}
        self._state = RescaleState.zeros(inner.obs_out.nchan,
                                         inner.obs_out.npol,
                                         self._devs[0])
        self._mean = None
        self._inv = None
        self._out_since_update = 0

    def _shard_raws(self, sb_start: int) -> list:
        """Each shard's bytes with its halo, on its device: the stride row,
        then the next shard's head (moved from its device) or, for the last
        shard, the tail the host reads."""
        src = self.source
        s = self.inner.stride_in_samples
        rows = [host_to_device(src.read_samples(sb_start + i * s, s), d)
                for i, d in enumerate(self._devs)]
        if not self.halo_bytes:
            return rows
        tail = host_to_device(
            src.read_samples(sb_start + self.n_time * s, self.nsamp_overlap),
            self._devs[-1])
        self._sync()
        t0 = time.perf_counter()
        heads = [r[:self.halo_bytes] for r in rows[1:]] + [tail]
        raws = [torch.cat([r, h.to(d)])
                for r, h, d in zip(rows, heads, self._devs)]
        self._sync()
        self.seconds["halo"] += time.perf_counter() - t0
        return raws

    def _sync(self):
        if self.timed:
            for d in set(self._devs):
                if d.type == "cuda":
                    torch.cuda.synchronize(d)

    def run(self, output_path: str, max_superblocks: Optional[int] = None,
            format: str = "sigproc", total_seconds: Optional[float] = None):
        from ..io.psrfits import PsrfitsSearchWriter
        from ..io.sigproc import SigProcWriter

        inner = self.inner
        cfg = self.config
        if format == "sigproc":
            writer = SigProcWriter(output_path, inner.obs_out, cfg.nbits)
        elif format == "psrfits":
            writer = PsrfitsSearchWriter(output_path, inner.obs_out,
                                         cfg.nbits)
        else:
            raise ValueError(f"unknown search output format {format!r}")

        nsamp_total = self.source.total_samples
        if total_seconds is not None:
            # -T (reference SingleThread.C:694-719), clamped as in
            # FilPipeline.run
            nsamp_total = min(nsamp_total,
                              int(total_seconds * inner.obs_in.rate))
        interval_out = (int(cfg.rescale_seconds * inner.obs_out.rate)
                        if cfg.rescale_seconds > 0 else 0)
        dmean, dscale = cfg.digi_params()
        dev0 = self._devs[0]
        nchan, npol = inner.obs_out.nchan, inner.obs_out.npol
        out_per_shard = None
        with writer as out:
            start = 0
            nsb = 0
            while start + self.superblock_samples <= nsamp_total:
                chains = [self._inners[d]._local_chain(raw)
                          for d, raw in zip(self._devs,
                                            self._shard_raws(start))]
                self._sync()
                t0 = time.perf_counter()
                st_all = None
                for x, w in chains:
                    st = accumulate(RescaleState.zeros(
                        nchan, npol, x.device), x, w)
                    st = RescaleState(*(a.to(dev0) for a in st))
                    if st_all is None:
                        st_first = st_all = st
                    else:
                        st_all = RescaleState(*(a + b for a, b in
                                                zip(st_all, st)))
                self._sync()
                self.seconds["reduce"] += time.perf_counter() - t0
                if self._mean is None:
                    # the single pipeline's first-block bootstrap: shard 0;
                    # _state stays zero (st_all holds shard 0 already)
                    self._mean, self._inv = state_mean_scale(st_first)
                # OutputFileShare: rows written strictly in time order
                for x, w in chains:
                    z = apply_scales(x, self._mean.to(x.device),
                                     self._inv.to(x.device), w)
                    packed = digitize(z, cfg.nbits, dmean,
                                      dscale * cfg.scale_factor)
                    arr = packed.cpu().numpy()
                    out.write_block(arr)
                if out_per_shard is None:
                    bits = nchan * npol * cfg.nbits
                    out_per_shard = arr.size * 8 // max(bits, 1)
                if interval_out and not cfg.rescale_constant:
                    self._state = RescaleState(*(a + b for a, b in
                                                 zip(self._state, st_all)))
                    self._out_since_update += out_per_shard * self.n_time
                    if self._out_since_update >= interval_out:
                        self._mean, self._inv = state_mean_scale(self._state)
                        self._state = RescaleState.zeros(nchan, npol, dev0)
                        self._out_since_update = 0
                start += self.superblock_stride
                nsb += 1
                if max_superblocks is not None and nsb >= max_superblocks:
                    break
        return inner.obs_out
