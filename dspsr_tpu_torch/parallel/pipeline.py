"""Multi-device fold pipeline: the LoadToFoldN equivalent.

Counterpart of ``dspsr_tpu/parallel/pipeline.py``.  The reference scales
the fold pipeline by cloning it across threads with a shared Input, the
InputBuffering::Share overlap handoff and UnloaderShare sub-integration
reduction (``Signal/Pulsar/LoadToFoldN.C:64-160``,
``Signal/General/MultiThread.C:90-370``); across nodes it scatters raw
blocks from a root (``Kernel/Classes/MPIRoot.C:318-472``).

Here one controller process drives a ``(time, chan)`` mesh of
``torch.device`` (:func:`parallel.sharded.make_mesh`) one *superblock* at
a time, with explicit launches per shard, where the JAX package runs one
``shard_map`` program:

- the **time axis** is the thread pool: each time shard runs the
  single-device engine of :class:`FoldPipeline` (the fused fold step, the
  hybrid front end and tail, or the general chain: 2-bit excision weights,
  SK, Jones, RFI and cyclic folding all run sharded) on its own contiguous
  stripe of raw bytes;
- the **halo**: shard t's head bytes, the overlap shard t-1 needs, move to
  shard t-1's device with ``.to`` (the JAX package's ``lax.ppermute``;
  InputBuffering::Share); the superblock's last shard takes a tail row the
  host reads, so every window of every shard is whole;
- the **chan axis** is the MPITrans channel scatter, in one of three ways:
  *chan-mega* (the fused fold step on each shard's own group of input
  channels, with its group's rows of the chirp handed in per call),
  *chan-hybrid* (the fused front end on the group, with its rows of the
  chirp or of the Jones response per call, and the tail), or the general
  chain's slice of the block's spectra between the forward transform and
  the inverse;
- **SK pooling**: the channel shards' frequency-scrunched SK sums are added
  before the thresholds (the JAX package's ``psum`` over ``"chan"``);
- the **time sum**: every shard folds into zero-started accumulators, and
  each chan column adds its time shards' in a fixed order on the column's
  device (the ``psum`` over ``"time"``; PhaseSeries::combine).  No two
  shards ever write one buffer, whether their devices differ or not.

Hosts read **disjoint stripes** (:meth:`ShardedFoldPipeline.
host_stripe_layout`), the MPIRoot scatter without a root.  Sub-integrations
divide sample-exactly with per-shard ``[lo, hi)`` bounds, as the single
pipeline divides a block (``run``).

With ``distributed=True`` the mesh spans the processes of a
``torch.distributed`` group that the caller initialized: process r hosts
time shards ``[r k, (r+1) k)`` and reads only their stripes; the halo that
crosses processes travels by ``all_gather`` and the time sums and byte
counts by ``all_reduce`` (:class:`ProcessGroup`).
"""

from __future__ import annotations

import dataclasses
import time
from typing import Optional

import numpy as np
import torch

from ..device import host_to_device
from ..io.sources import Source, open_source
from ..models.load_to_fold import FoldConfig, FoldPipeline, FoldResult
from ..ops.fold import compute_anchors
from ..ops.megakernel import build_megastep
from ..ops.spectral_kurtosis import sk_fscr_sums
from ..timing.mjd import MJD
from ..unpack.unpackers import state_counts_from_byte_counts
from .sharded import Mesh, make_mesh


class ProcessGroup:
    """The processes of a distributed mesh: the default ``torch.distributed``
    group, which the caller initialized, and its collectives.  Gloo takes
    CPU tensors only, so with gloo every collective stages its tensor
    through host memory explicitly (CUDA shards included); NCCL takes the
    rank's CUDA tensors and refuses CPU ones.  No backend stands in for
    another."""

    def __init__(self):
        import torch.distributed as dist

        if not dist.is_initialized():
            raise RuntimeError("distributed=True needs "
                               "torch.distributed.init_process_group first")
        self.dist = dist
        self.rank = dist.get_rank()
        self.size = dist.get_world_size()
        self.backend = str(dist.get_backend())

    def _stage(self, t: torch.Tensor) -> torch.Tensor:
        """A private copy of ``t`` where this backend's collectives take
        it."""
        if self.backend == "gloo":
            return t.detach().to("cpu", copy=True).contiguous()
        if t.device.type != "cuda":
            raise ValueError(f"the {self.backend} backend takes CUDA "
                             f"tensors; got one on {t.device}")
        return t.detach().clone().contiguous()

    def all_reduce(self, t: torch.Tensor) -> torch.Tensor:
        """The sum of ``t`` over the processes, on ``t``'s device."""
        x = self._stage(t)
        self.dist.all_reduce(x)
        return x.to(t.device)

    def all_gather(self, t: torch.Tensor) -> list:
        """Every process's ``t`` (same shape), in rank order, on ``t``'s
        device."""
        x = self._stage(t)
        out = [torch.empty_like(x) for _ in range(self.size)]
        self.dist.all_gather(out, x)
        return [o.to(t.device) for o in out]


def _add(acc, x, dev):
    """``acc + x`` on ``dev`` (``x`` alone when ``acc`` is None)."""
    x = x.to(dev)
    return x if acc is None else acc + x


class ShardedFoldPipeline:
    """Streams a Source through superblocks on a (time, chan) mesh.

    Usage::

        mesh = make_mesh(4, nchan_shards=2)
        pipe = ShardedFoldPipeline(src, config, mesh)
        result = pipe.run()          # FoldResult, as FoldPipeline.run()
    """

    def __init__(self, source: Source, config: FoldConfig, mesh: Mesh,
                 distributed: bool = False):
        if set(mesh.shape) != {"time", "chan"}:
            raise ValueError("mesh needs ('time', 'chan') axes")
        self.mesh = mesh
        self.n_time = mesh.shape["time"]
        self.n_chan = mesh.shape["chan"]
        self.distributed = bool(distributed)
        self.group = ProcessGroup() if distributed else None
        if self.group is not None and self.n_time % self.group.size:
            raise ValueError(f"{self.n_time} time shards over "
                             f"{self.group.size} processes")
        #: seconds a run spends reading stripes, uploading them, counting
        #: their bytes, assembling the halos and summing over time, each
        #: measured between device synchronises when ``timed`` is set
        self.timed = False
        self.seconds = dict.fromkeys(
            ("read", "upload", "count", "halo", "reduce"), 0.0)

        cfg = dataclasses.replace(config)
        # cap the per-shard block so at least one superblock fits the source
        avail = source.total_samples
        if avail < (1 << 60):
            cap = max(avail // (self.n_time + 1), 4096)
            cfg = dataclasses.replace(
                cfg, min_block_samples=min(cfg.min_block_samples, cap))
        refused = (
            (cfg.dump_path, "the dump tap"),
            (cfg.additional_pulsars, "multi-pulsar folding (accumulators "
             "are one source's per shard; use FoldPipeline for --pulsar)"),
            (cfg.sk_also_unzapped, "-noskz_too (a second accumulator; use "
             "FoldPipeline)"),
            (cfg.passband, "passband integration (use FoldPipeline for "
             "--passband)"),
            (cfg.pdmp_stats, "pdmp statistics (use FoldPipeline)"))
        for bad, what in refused:
            if bad:
                raise NotImplementedError(f"{what} is not supported sharded")
        if cfg.rfi_filter and cfg.use_megakernel:
            # the carried-mask RFI mode orders its blocks, which parallel
            # time shards cannot; the two-pass mode (measure the bandpass,
            # zap the same block) carries nothing and runs on every shard
            cfg = dataclasses.replace(cfg, rfi_same_block=True)

        dev0 = mesh.device(self.local_time_shards()[0], 0)
        # channel-grouped fused modes, when the fused engine takes the
        # configuration and the chan axis divides the input channels in
        # whole bytes a sample: chan-mega (the full engine) or chan-hybrid
        self.mega_chan = self.hybrid_chan = False
        inner = None
        obs0 = source.obs
        if (self.n_chan > 1 and cfg.use_megakernel
                and obs0.nchan % self.n_chan == 0
                and (obs0.npol * obs0.ndim * obs0.nbit) % 8 == 0):
            probe = FoldPipeline(source, cfg, device=dev0)
            if probe.mega_mode == "full":
                inner, self.mega_chan = probe, True
            elif probe.mega_mode == "hybrid":
                inner, self.hybrid_chan = probe, True
        if inner is None:
            if self.n_chan > 1:
                # the general chain slices the spectra between its
                # transforms; the fused engines cannot
                cfg = dataclasses.replace(cfg, use_megakernel=False)
            inner = FoldPipeline(source, cfg, device=dev0)
            if inner.mega_plan is not None and self.n_chan > 1:
                raise AssertionError("fused plan despite chan sharding")
        self.inner = inner
        self.config = cfg
        self.source = source
        #: one pipeline (constants, plans) per device that hosts a shard
        self._inners = {dev0: inner}
        for t in self.local_time_shards():
            for c in range(self.n_chan):
                d = mesh.device(t, c)
                if d not in self._inners:
                    self._inners[d] = FoldPipeline(source, cfg, device=d)
        self.mega = inner.mega_mode == "full"
        self.megask = inner.mega_mode == "hybrid" and not self.hybrid_chan
        self.chan_grouped = self.mega_chan or self.hybrid_chan

        if inner.obs_out.nchan % self.n_chan:
            raise ValueError(
                f"nchan_out={inner.obs_out.nchan} not divisible by "
                f"chan shards={self.n_chan}")
        self.nlocal = inner.obs_out.nchan // self.n_chan
        nsub = inner.fb_plan.nchan_subband if inner.fb_plan is not None else 1
        if not (self.nlocal % nsub == 0 or nsub % self.nlocal == 0):
            raise ValueError("chan shard boundary must align with subband "
                             "groups of one input channel")

        bps = inner.obs_in.nbytes_per_sample
        self.stride_bytes = int(round(inner.stride_in_samples * bps))
        self.halo_bytes = int(round(inner.nsamp_overlap * bps))
        if abs(inner.stride_in_samples * bps - self.stride_bytes) > 1e-9 or \
           abs(inner.nsamp_overlap * bps - self.halo_bytes) > 1e-9:
            raise ValueError("shard stride/halo not byte-aligned")
        #: halo bytes of one shard's row (one channel group's when grouped)
        self.halo_row = (self.halo_bytes // self.n_chan if self.chan_grouped
                         else self.halo_bytes)
        self.superblock_samples = (self.n_time * inner.stride_in_samples
                                   + inner.nsamp_overlap)
        self.superblock_stride = self.n_time * inner.stride_in_samples

        if self.chan_grouped:
            self._setup_chan_groups()
        # accumulators: one per chan column, on the column's device
        self._col_dev = [mesh.device(self.local_time_shards()[0], c)
                         for c in range(self.n_chan)]
        self._profiles = [None] * self.n_chan
        self._hits = [None] * self.n_chan
        self._zero_accumulators()
        self._subints = []
        self._current_div = 0
        self._div_samples = 0.0
        self._first_out_time: Optional[MJD] = None
        self._last_out_time: Optional[MJD] = None
        self._div_first_time: Optional[MJD] = None
        #: digitizer byte counts, int64 [256] on the first column's device
        self._byte_counts = None

    # ---- construction of the channel-grouped modes ----

    def _setup_chan_groups(self):
        """The per-device steps and per-(device, group) responses of the
        chan-mega and chan-hybrid modes: one step serves every channel
        group of a device, each group's rows of the band's chirp (or Jones
        response) copied once to each device whose shards take them."""
        inner = self.inner
        obs = inner.obs_in
        L = self.local_nchan = obs.nchan // self.n_chan
        #: bytes per channel per input sample (whole bytes by construction)
        self.bpc = (obs.npol * obs.ndim * obs.nbit) // 8
        self._chan_steps = {}
        self._chan_resp = {}
        for dev, pipe in self._inners.items():
            cst = pipe.constants
            if self.mega_chan:
                lp = dataclasses.replace(pipe.mega_plan, nchan_in=L)
                self._chan_steps[dev] = build_megastep(
                    lp, cst, pipe.npart, response_as_args=True)
            else:
                fp = dataclasses.replace(pipe.front_plan, nchan_in=L)
                shape = (L, fp.n_fft)
                local = dataclasses.replace(
                    cst, jones=None,
                    gr=torch.ones(shape, dtype=torch.float32, device=dev),
                    gi=torch.zeros(shape, dtype=torch.float32, device=dev))
                self._chan_steps[dev] = pipe.shard_front(fp, local)
            for c in range(self.n_chan):
                rows = slice(c * L, (c + 1) * L)
                self._chan_resp[dev, c] = tuple(
                    None if a is None else a[rows].clone()
                    for a in (cst.gr, cst.gi,
                              None if self.mega_chan else cst.jones))

    def _zero_accumulators(self):
        inner = self.inner
        for c, dev in enumerate(self._col_dev):
            if self.mega:
                mp = inner.mega_plan
                shape = (inner.obs_in.nchan // self.n_chan, mp.nplane,
                         mp.nsub, inner.nbin)
                hshape = (shape[0], inner.nbin)
            else:
                shape = (self.nlocal, inner.obs_out.npol, inner.nbin)
                hshape = (self.nlocal, inner.nbin)
            self._profiles[c] = torch.zeros(shape, dtype=torch.float32,
                                            device=dev)
            self._hits[c] = torch.zeros(hshape, dtype=torch.float32,
                                        device=dev)

    # ---- layout ----

    def local_time_shards(self) -> list:
        """Time-shard indices this process hosts: all of them, or process
        r's ``[r k, (r+1) k)`` of a distributed mesh."""
        if self.group is None:
            return list(range(self.n_time))
        k = self.n_time // self.group.size
        return list(range(self.group.rank * k, (self.group.rank + 1) * k))

    def host_stripe_layout(self, sb_start: int):
        """(start_sample, nsamples) read per time shard for the superblock at
        ``sb_start``: disjoint ranges plus one trailing halo read (the
        multi-host striping contract that replaces MPIRoot)."""
        s = self.inner.stride_in_samples
        stripes = [(sb_start + i * s, s) for i in range(self.n_time)]
        tail = (sb_start + self.n_time * s, self.inner.nsamp_overlap)
        return stripes, tail

    def _split_chan_groups(self, row: np.ndarray) -> np.ndarray:
        """One stripe's TFP bytes -> ``[n_chan, bytes]`` channel-group rows
        (the channels of a sample are contiguous, so a group is a
        whole-byte slice of each sample)."""
        g = row.reshape(-1, self.n_chan, self.local_nchan * self.bpc)
        return np.ascontiguousarray(g.transpose(1, 0, 2)).reshape(
            self.n_chan, -1)

    def _read_superblock(self, sb_start: int):
        """This superblock's stripes of the local time shards, ``{t: [n_chan,
        bytes]}`` (one row when not grouped by channel), and the tail row
        (``[n_chan, halo]``; None unless the last shard is local).  No other
        stripe touches the disk."""
        src = self.source
        stripes, tail = self.host_stripe_layout(sb_start)

        def rows_of(raw):
            return (self._split_chan_groups(raw) if self.chan_grouped
                    else raw[None])

        rows = {t: rows_of(src.read_samples(*stripes[t]))
                for t in self.local_time_shards()}
        tail_rows = None
        if self.halo_bytes and (self.n_time - 1) in rows:
            tail_rows = rows_of(src.read_samples(*tail))
        return rows, tail_rows

    def _cols(self) -> range:
        """The chan shards whose rows hold bytes of their own (a chan shard
        of the general chain takes its time row whole: only the first
        counts)."""
        return range(self.n_chan if self.chan_grouped else 1)

    def _upload(self, rows, tail_rows):
        """The local stripe rows on their shards' devices, ``{(t, c):
        bytes}``, and the tail row on the last shard's, ``{c: bytes}``
        (empty unless that shard is local)."""
        g = (lambda c: c) if self.chan_grouped else (lambda c: 0)
        mesh = self.mesh
        up = {(t, c): host_to_device(rows[t][g(c)], mesh.device(t, c))
              for t in rows for c in range(self.n_chan)}
        tail = ({} if tail_rows is None else
                {c: host_to_device(tail_rows[g(c)],
                                   mesh.device(self.n_time - 1, c))
                 for c in range(self.n_chan)})
        return up, tail

    def _count_bytes(self, up, tail):
        """Count each local shard's stride and halo bytes on its device
        (the single pipeline counts a block's overlap again in the next
        block); a halo from the next process is counted there."""
        h = self.halo_row
        local = self.local_time_shards()
        parts = []
        for t in local:
            for c in self._cols():
                parts.append(up[t, c])
                if not h:
                    continue
                if t == self.n_time - 1:
                    parts.append(tail[c])
                elif t + 1 in local:
                    parts.append(up[t + 1, c][:h])
        if h and self.group is not None and local[0] > 0:
            # my first shard's head is the halo of the previous process's
            # last shard
            parts += [up[local[0], c][:h] for c in self._cols()]
        for x in parts:
            self._byte_counts = _add(self._byte_counts, torch.bincount(
                x, minlength=256), self._col_dev[0])

    # ---- the superblock ----

    def _sync(self):
        if self.timed:
            for d in self.mesh.unique_devices():
                if d.type == "cuda":
                    torch.cuda.synchronize(d)

    def _timed(self, key: str, fn, *args):
        """``fn(*args)``, its seconds added to ``seconds[key]`` (after a
        device synchronise at each end when ``timed``)."""
        self._sync()
        t0 = time.perf_counter()
        out = fn(*args)
        self._sync()
        self.seconds[key] += time.perf_counter() - t0
        return out

    def _shard_raws(self, up, tail):
        """``{(t, c): raw bytes of shard (t, c) with its halo}`` on each
        shard's device: the stride row, then the next shard's head (moved
        from its device), the tail row, or the next process's head."""
        if not self.halo_bytes:
            return up
        local = self.local_time_shards()
        h = self.halo_row
        last = local[-1]
        from_next = None
        if self.group is not None and self.group.size > 1:
            # every process hands its first shard's heads to the previous
            # process; the last process's go unused
            heads = torch.stack([up[local[0], c][:h]
                                 for c in range(self.n_chan)])
            from_next = self.group.all_gather(heads)[
                (self.group.rank + 1) % self.group.size]
        raws = {}
        for t in local:
            for c in range(self.n_chan):
                dev = self.mesh.device(t, c)
                if t < last:
                    halo = up[t + 1, c][:h].to(dev)
                elif t == self.n_time - 1:
                    halo = tail[c]
                else:
                    halo = from_next[c].to(dev)
                raws[t, c] = torch.cat([up[t, c], halo])
        return raws

    def _fronts(self, t, raws):
        """Shard row ``t``'s blocks up to the fold: ``[(pipe, (d, weights,
        w_presk, extras))]`` per chan shard, the SK sums pooled over the
        chan shards first."""
        inner = self.inner
        pres = []
        for c in range(self.n_chan):
            dev = self.mesh.device(t, c)
            pipe = self._inners[dev]
            raw = raws[t, c]
            if self.hybrid_chan:
                pres.append(self._chan_steps[dev](raw, *self._chan_resp[
                    dev, c]))
            elif self.megask:
                pres.append(pipe._hybrid_front(raw))
            else:
                pres.append(pipe._general_front(raw, c, self.n_chan))
        pooled = [None] * self.n_chan
        if inner.sk_plan is not None and self.n_chan > 1:
            # the frequency-scrunched round pools the whole band
            nblk = pres[0][2].shape[1] // inner.sk_plan.M
            tot = None
            for c, pre in enumerate(pres):
                tot = _add(tot, sk_fscr_sums(pre[1], inner.sk_plan, nblk),
                           self._col_dev[0])
            pooled = [tot.to(self.mesh.device(t, c))
                      for c in range(self.n_chan)]
        return [(self._inners[self.mesh.device(t, c)],
                 self._inners[self.mesh.device(t, c)]._block_tail(
                     *pres[c], pooled[c], c * self.nlocal))
                for c in range(self.n_chan)]

    def _superblock(self, raws, phi0, dphi, passes):
        """Fold the superblock once per division pass: ``{v: [delta
        (profiles, hits) of each chan column]}``, summed over this
        process's time shards in order (over every process's with a
        process group)."""
        deltas = {v: [[] for _ in range(self.n_chan)] for v, _ in passes}
        for t in self.local_time_shards():
            blks = None if self.mega else self._fronts(t, raws)
            for v, bounds in passes:
                lo, hi = (int(b) for b in bounds[t])
                if lo >= hi:
                    continue  # this shard has no sample in the division
                for c in range(self.n_chan):
                    dev = self.mesh.device(t, c)
                    zp = torch.zeros_like(self._profiles[c], device=dev)
                    zh = torch.zeros_like(self._hits[c], device=dev)
                    p0 = host_to_device(phi0[t], dev)
                    dp = host_to_device(dphi[t], dev)
                    if self.mega_chan:
                        gr, gi, _ = self._chan_resp[dev, c]
                        out = self._chan_steps[dev](zp, zh, raws[t, c], p0,
                                                    dp, gr, gi,
                                                    bounds=(lo, hi))
                    elif self.mega:
                        out = self._inners[dev]._megastep(
                            zp, zh, raws[t, c], p0, dp, (lo, hi))
                    else:
                        pipe, blk = blks[c]
                        out = pipe._fold_tail_d(zp, zh, *blk[:3], p0, dp,
                                                (lo, hi))
                    deltas[v][c].append(out)
        return self._timed("reduce", self._reduce, deltas)

    def _reduce(self, deltas):
        """The time sums: each chan column's shard deltas added in shard
        order on the column's device (zeros where this process folded
        nothing), then over the processes (every process joins every
        collective)."""
        out = {}
        for v, cols in deltas.items():
            out[v] = []
            for c, parts in enumerate(cols):
                tot = [torch.zeros_like(self._profiles[c]),
                       torch.zeros_like(self._hits[c])] if not parts \
                    else [None, None]
                for part in parts:
                    tot = [_add(a, b, self._col_dev[c])
                           for a, b in zip(tot, part)]
                if self.group is not None:
                    tot = [self.group.all_reduce(x) for x in tot]
                out[v].append(tuple(tot))
        return out

    # ---- the host streaming loop ----

    def _flush_division(self):
        if self._div_samples == 0:
            return
        prof = torch.cat([p.cpu() for p in self._profiles]).numpy()
        hits = torch.cat([h.cpu() for h in self._hits]).numpy()
        if self.mega:
            nsub = self.inner.mega_plan.nsub
            prof = np.ascontiguousarray(
                prof.transpose(0, 2, 1, 3).reshape(
                    prof.shape[0] * nsub, prof.shape[1], self.inner.nbin))
            hits = np.repeat(hits, nsub, axis=0)
        self._subints.append(
            (prof, hits, self._div_first_time or self._first_out_time,
             self._div_samples / self.inner.obs_out.rate))
        self._div_first_time = None
        self._zero_accumulators()
        self._div_samples = 0.0

    def run(self, max_superblocks: Optional[int] = None,
            total_seconds: Optional[float] = None) -> FoldResult:
        inner = self.inner
        cfg = self.config
        src = self.source
        seek = int(cfg.seek_seconds * inner.obs_in.rate) \
            if cfg.seek_seconds else 0
        nsamp_total = src.total_samples
        if total_seconds is not None:
            nsamp_total = min(nsamp_total,
                              seek + int(total_seconds * inner.obs_in.rate))

        tsamp_out = 1.0 / inner.obs_out.rate
        seg = inner.fold_plan.seg_len
        # anchors cover the padded tail segment; each shard folds exactly
        # out_per_block samples
        nuse = inner.out_per_block
        nuse_pad = -(-nuse // seg) * seg

        # sample-exact sub-integrations (TimeDivide/SubFold): a boundary
        # may land inside a shard, which then folds once per division with
        # [lo, hi) bounds, as the single pipeline splits a block
        divider = None
        if cfg.subint_seconds > 0 or cfg.subint_turns > 0:
            from ..timing.timedivide import TimeDivide

            lep = cfg.integration_reference_epoch
            divider = TimeDivide(
                rate=inner.obs_out.rate,
                start_time=inner.output_start_time(seek),
                seconds=cfg.subint_seconds, turns=cfg.subint_turns,
                predictor=inner.predictor,
                reference_phase=cfg.reference_phase,
                reference_epoch=(MJD.from_mjd(lep) if lep else None),
                fractional_pulses=cfg.fractional_pulses)
            if self.mega and nuse >= (1 << 24):
                raise ValueError(
                    "sub-integration bounds need out_per_block < 2^24 on "
                    "the fused path; reduce the block size")

        out_off = 0
        start = seek
        nsb = 0
        while start + self.superblock_samples <= nsamp_total:
            t0s = [inner.output_start_time(start + i * inner.stride_in_samples)
                   for i in range(self.n_time)]
            if self._first_out_time is None:
                self._first_out_time = t0s[0]
            rows, tail_rows = self._timed("read", self._read_superblock,
                                          start)
            up, tail = self._timed("upload", self._upload, rows, tail_rows)
            if cfg.digitizer_stats and inner.obs_in.nbit <= 8:
                self._timed("count", self._count_bytes, up, tail)
            phi0 = np.zeros((self.n_time, nuse_pad // seg), np.float32)
            dphi = np.zeros_like(phi0)
            for i in self.local_time_shards():
                p0, dp = compute_anchors(inner.predictor, t0s[i], tsamp_out,
                                         nuse_pad, seg)
                phi0[i] = (p0 - cfg.reference_phase) % 1.0
                dphi[i] = dp
            # one pass per division present in the superblock (one in the
            # common boundary-free case), each shard bounded to exactly its
            # division's samples
            if divider is None:
                full = np.broadcast_to(np.array([0, nuse]), (self.n_time, 2))
                passes = [(0, full)]
                firsts = {0: None}
                nfolds = {0: nuse * self.n_time}
            else:
                shard_segs = [divider.segments(out_off + i * nuse, nuse)
                              for i in range(self.n_time)]
                present = sorted({dv for segs in shard_segs
                                  for (_, _, dv) in segs if dv >= 0})
                passes, firsts, nfolds = [], {}, {}
                for v in present:
                    bounds = np.zeros((self.n_time, 2), np.int64)
                    firsts[v], nfolds[v] = None, 0
                    for i, ss in enumerate(shard_segs):
                        for (lo, hi, dv) in ss:
                            if dv == v:
                                bounds[i] = (lo, hi)
                                nfolds[v] += hi - lo
                                if firsts[v] is None:
                                    firsts[v] = out_off + i * nuse + lo
                    passes.append((v, bounds))
            raws = self._timed("halo", self._shard_raws, up, tail)
            del up, tail
            deltas = self._superblock(raws, phi0, dphi, passes)
            for v, _ in passes:
                if divider is not None:
                    if v != self._current_div:
                        self._flush_division()
                        self._current_div = v
                    if self._div_first_time is None:
                        self._div_first_time = divider.epoch_of(firsts[v])
                elif self._div_first_time is None:
                    self._div_first_time = t0s[0]
                for c in range(self.n_chan):
                    dp, dh = deltas[v][c]
                    self._profiles[c] = self._profiles[c] + dp
                    self._hits[c] = self._hits[c] + dh
                self._div_samples += nfolds[v]
            self._last_out_time = t0s[-1] + nuse * tsamp_out
            out_off += nuse * self.n_time
            start += self.superblock_stride
            nsb += 1
            if max_superblocks is not None and nsb >= max_superblocks:
                break

        self._flush_division()
        return self._finish()

    def _finish(self) -> FoldResult:
        inner = self.inner
        cfg = self.config
        if cfg.minimum_integration_length > 0:
            self._subints = [s for s in self._subints
                             if s[3] >= cfg.minimum_integration_length]
        counts_on = cfg.digitizer_stats and inner.obs_in.nbit <= 8
        if self.group is not None and counts_on:
            # each process counted its own stripes; the condition is the
            # configuration's, so every process joins the collective
            if self._byte_counts is None:
                self._byte_counts = torch.zeros(256, dtype=torch.int64,
                                                device=self._col_dev[0])
            self._byte_counts = self.group.all_reduce(self._byte_counts)
        counts = (np.zeros(256, np.int64) if self._byte_counts is None
                  else self._byte_counts.cpu().numpy())
        if self._subints:
            profs = np.stack([s[0] for s in self._subints])
            hits = np.stack([s[1] for s in self._subints])
        else:
            profs = np.zeros((0, inner.obs_out.nchan, inner.obs_out.npol,
                              inner.nbin))
            hits = np.zeros((0, inner.obs_out.nchan, inner.nbin))
        return FoldResult(
            profiles=profs,
            hits=hits,
            epochs=[s[2] for s in self._subints],
            integration_length=np.array([s[3] for s in self._subints]),
            obs=inner.obs_out,
            nbin=inner.nbin,
            folding_period=inner.folding_period,
            dispersion_measure=inner.dm,
            cyclic_nlag=(inner.cyclic_plan.nlag if inner.cyclic_plan else 0),
            cyclic_mover=(inner.cyclic_plan.mover if inner.cyclic_plan
                          else 1),
            cyclic_npol=(inner.obs_stream.npol if inner.cyclic_plan else 1),
            signal_path=inner.signal_path() + [
                {"op": "ShardedRun", "n_time": self.n_time,
                 "n_chan": self.n_chan}],
            digitizer_counts=(
                state_counts_from_byte_counts(counts, inner.obs_in.nbit)
                if counts_on and counts.any() else None),
            predictor=inner.predictor,
            ephemeris=inner.ephemeris,
        )


def load_to_fold_sharded(path: str, config: FoldConfig,
                         n_devices: Optional[int] = None,
                         nchan_shards: int = 1, devices=None,
                         **run_kw) -> FoldResult:
    """Open, shard, run: ``dspsr -t N`` in a line (the visible cards unless
    ``devices`` names others)."""
    mesh = make_mesh(n_devices, nchan_shards, devices)
    return ShardedFoldPipeline(open_source(path), config, mesh).run(**run_kw)
