"""dspsr fold mode: ``FoldPipeline.run(max_blocks=N)`` over the ring, every
block folded at a fixed period into sub-integrations of the configuration's
``subint_seconds`` (dspsr ``-L``), each a profile of ``nbin`` bins a
subband.

The output compared is every sub-integration of the window: its profiles
and hits, and how many there are.  The reference unpacks, channelises,
dedisperses, detects and folds the same blocks in float64
(``portbench/reference/``) with the phases binned in float32 and the
divisions worked out again, so the hits of every bin must agree exactly
and the profiles within the program's float32 rounding."""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from portbench.work import front_ops, fold_bytes
from portbench.drivers.base import Driver as Base, start_seconds
from portbench.reference.filterbank import Precision, detect_block
from portbench.reference.fold import Divisions, anchors, bins, fold


@dataclass
class Folded:
    """Sub-integrations as the reference works them out: ``profiles
    [ndiv, nsub, nbin]`` and ``hits [ndiv, nbin]``."""

    profiles: np.ndarray
    hits: np.ndarray


class Driver(Base):
    def build(self):
        from dspsr_tpu_torch.models.load_to_fold import FoldConfig, \
            FoldPipeline

        cfg, tr = self.config, self.traffic
        fc = FoldConfig(
            folding_period=tr["period_s"], dispersion_measure=tr["dm"],
            nchan=cfg["nchan"], nbin=cfg["nbin"],
            block_parts=cfg["block_parts"], npol_out=1,
            min_block_samples=cfg["min_block_samples"],
            subint_seconds=cfg["subint_seconds"],
            digitizer_stats=cfg["digitizer_stats"], report=self.trace)
        pipe = FoldPipeline(self.source, fc, device=self.device)
        if pipe.mega_mode != "full":
            raise RuntimeError(f"the fold runs mega_mode {pipe.mega_mode!r}, "
                               "not the fused step")
        self.made = 0
        return pipe

    def run_blocks(self, n: int):
        """``(profiles [ndiv, nsub, nbin], hits [ndiv, nsub, nbin])``: the
        sub-integrations this call of ``n`` blocks made (the pipeline's
        result holds those of its earlier calls before them)."""
        res = self.pipe.run(max_blocks=n)
        self.runs.append(n)
        before, self.made = self.made, len(res.profiles)
        return res.profiles[before:, :, 0, :], res.hits[before:]

    def work(self) -> tuple:
        return fold_bytes(self.geom), front_ops(self.geom)

    def reference(self, prec: Precision) -> Folded:
        """Every sub-integration of the last call, the filterbank at
        ``prec`` and the fold in float64."""
        g, tr = self.geom, self.traffic
        n, nring, nuse = self.runs[-1], self.ring.nblocks, g.out_per_block
        start = start_seconds(self.config["start_utc"])
        div = Divisions(g, start, self.config["subint_seconds"])
        first = div.of(0)
        ndiv = div.of(n * nuse - 1) - first + 1
        # each block's spans [lo, hi) of kept samples and their division
        spans = []
        for b in range(n):
            lo, parts = 0, []
            while lo < nuse:
                k = div.of(b * nuse + lo)
                hi = min(nuse, div.boundary(k + 1) - b * nuse)
                parts.append((k - first, lo, hi))
                lo = hi
            spans.append(parts)
        h = self.chirp()
        prof = torch.zeros(ndiv, g.nsub, g.nbin, dtype=torch.float64,
                           device=self.device)
        hits = torch.zeros(ndiv, g.nbin, dtype=torch.float64,
                           device=self.device)
        for k in range(min(nring, n)):
            d = detect_block(self.ring_block(k), g, h, prec)
            for b in range(k, n, nring):
                phi0, dphi = anchors(g, b, start, tr["period_s"])
                idx = bins(phi0, dphi, g.nkeep, g.nbin, self.device)
                for j, lo, hi in spans[b]:
                    fold(prof[j], hits[j], d[:, lo:hi], idx[lo:hi])
            del d
        return Folded(prof.cpu().numpy(), hits.cpu().numpy())

    def compare(self, got, want: Folded) -> dict:
        """``subints_diff``: sub-integrations made against due;
        ``hits_diff``: the largest difference of a bin's hits;
        ``profile_err``: the largest difference of a bin over its
        subband's mean level in that sub-integration.  A sub-integration
        that is missing counts as all zeros."""
        if isinstance(got, Folded):
            prof, hits = got.profiles, got.hits[:, None, :]
        else:
            prof, hits = (np.asarray(a, np.float64) for a in got)
        rprof, rhits = want.profiles, want.hits[:, None, :]
        made, ndiv = len(prof), len(rprof)
        m = min(made, ndiv)
        pad = ((0, ndiv - m), (0, 0), (0, 0))
        prof, hits = np.pad(prof[:m], pad), np.pad(hits[:m], pad)
        level = rprof.mean(axis=-1, keepdims=True)
        return {
            "subints_diff": float(abs(made - ndiv)),
            "hits_diff": float(np.abs(hits - rhits).max()),
            "profile_err": float((np.abs(prof - rprof) / level).max()),
        }
