"""The port's multi-process fold (``parallel/multiproc.py``), as
``tests/test_multiproc.py`` holds the JAX package's: 2 OS processes of 4
CPU shards each, joined by ``torch.distributed`` over gloo, give the archive
of 1 process with 8 shards, of the JAX package's 8-device sharded run and of
the single pipeline, each process having read only its own stripes; and
the local stripe assignment of a distributed mesh.
"""

import numpy as np
import pytest
import torch

from dspsr_tpu.io.sources import open_source as jopen
from dspsr_tpu.models import load_to_fold as jl
from dspsr_tpu.parallel.pipeline import ShardedFoldPipeline as JSharded
from dspsr_tpu.parallel.sharded import make_mesh as jmesh

from dspsr_tpu_torch.io.dada import (
    format_ascii_header, header_from_observation)
from dspsr_tpu_torch.io.sources import open_source
from dspsr_tpu_torch.models.load_to_fold import FoldConfig, FoldPipeline
from dspsr_tpu_torch.observation import Observation, Signal
from dspsr_tpu_torch.parallel import multiproc
from dspsr_tpu_torch.parallel.pipeline import ProcessGroup, ShardedFoldPipeline
from dspsr_tpu_torch.parallel.sharded import make_mesh
from dspsr_tpu_torch.timing.mjd import MJD

torch.set_num_threads(2)

CPU = torch.device("cpu")
RATE = 1e6
CFG = dict(folding_period=0.004, dispersion_measure=3.0, nchan=4, nbin=32,
           block_parts=2, min_block_samples=1 << 15, use_megakernel=False)


def _obs():
    return Observation(
        nchan=1, npol=2, ndim=1, nbit=8, centre_frequency=1400.0,
        bandwidth=-2.0, rate=RATE, start_time=MJD(55000, 0.2),
        state=Signal.NYQUIST, source="MPTEST", telescope="PKS",
        instrument="RAW")


def _write_dada(tmp_path, nbytes, seed=7):
    rng = np.random.default_rng(seed)
    p = str(tmp_path / "mp.dada")
    with open(p, "wb") as f:
        f.write(format_ascii_header(header_from_observation(_obs())))
        f.write(rng.integers(0, 256, nbytes).astype(np.uint8).tobytes())
    return p


def _mesh(n, nc=1):
    return make_mesh(n, nc, devices=[CPU] * n)


@pytest.mark.parametrize("kw", [{}, dict(subint_seconds=0.05)],
                         ids=["whole", "subints"])
def test_two_process_parity(tmp_path, kw):
    """2 gloo processes x 4 shards == 1 process x 8 shards == the JAX
    8-device run == the single pipeline (profiles, hits, sub-integrations,
    digitizer counts); the sub-integration boundary lands inside a
    process's shards."""
    cfg_kw = dict(CFG, **kw)
    cfg = FoldConfig(**cfg_kw)
    probe = ShardedFoldPipeline(open_source(_write_dada(tmp_path, 1 << 20)),
                                cfg, _mesh(8))
    total = 2 * probe.superblock_stride + probe.inner.nsamp_overlap
    path = _write_dada(tmp_path, int(total * _obs().nbytes_per_sample))

    r1 = ShardedFoldPipeline(open_source(path), cfg, _mesh(8)).run()
    r0 = FoldPipeline(open_source(path), cfg, device="cpu").run()
    rj = JSharded(jopen(path), jl.FoldConfig(**cfg_kw), jmesh(8, 1)).run()
    d = multiproc.launch_fold(path, cfg_kw, n_procs=2, shards_per_proc=4,
                              backend="gloo", device="cpu",
                              out_path=str(tmp_path / "mp_out.npz"),
                              timeout=240.0)

    assert d["profiles"].shape == r1.profiles.shape
    assert r1.profiles.shape[0] >= (2 if kw else 1)
    for want, tol in ((r1, 1e-5), (rj, 2e-5), (r0, 2e-5)):
        scale = np.abs(want.profiles).max() + 1e-30
        assert np.abs(d["profiles"] - want.profiles).max() / scale < tol
        np.testing.assert_array_equal(d["hits"], want.hits)
        np.testing.assert_allclose(d["integration_length"],
                                   want.integration_length, rtol=1e-12)
        np.testing.assert_array_equal(d["digitizer_counts"],
                                      want.digitizer_counts)
        np.testing.assert_array_equal(d["epochs_days"],
                                      [e.days for e in want.epochs])
        np.testing.assert_allclose(d["epochs_frac"],
                                   [e.fracday() for e in want.epochs],
                                   rtol=0, atol=1e-12)


class _Reads:
    """A source of zero bytes that records each read."""

    obs = _obs().replace(ndat=1 << 22)
    total_samples = 1 << 22

    def __init__(self):
        self.reads = []

    def read_samples(self, start, n):
        self.reads.append((start, n))
        return np.zeros(int(n * 2), np.uint8)


class _Rank:
    """Rank ``rank`` of ``size`` without a process group (construction and
    reads only)."""

    def __init__(self, rank, size, backend="gloo"):
        self.rank, self.size, self.backend = rank, size, backend


def test_local_stripe_assignment(monkeypatch):
    """Each process hosts a contiguous block of time shards and reads only
    their stripes (and the tail, on the last process); in one process all
    shards are local (the MPIRoot-free striping contract)."""
    cfg = FoldConfig(**CFG)
    pipe = ShardedFoldPipeline(_Reads(), cfg, _mesh(8))
    assert pipe.local_time_shards() == list(range(8))
    stripes, tail = pipe.host_stripe_layout(0)
    assert len(stripes) == 8
    ends = [s + n for s, n in stripes]
    assert [s for s, _ in stripes][1:] == ends[:-1]
    for rank, want in ((0, [0, 1, 2, 3]), (1, [4, 5, 6, 7])):
        monkeypatch.setattr(
            "dspsr_tpu_torch.parallel.pipeline.ProcessGroup",
            lambda rank=rank: _Rank(rank, 2))
        src = _Reads()
        pipe = ShardedFoldPipeline(src, cfg, _mesh(8), distributed=True)
        assert pipe.local_time_shards() == want
        src.reads.clear()
        rows, tail_rows = pipe._read_superblock(0)
        assert sorted(rows) == want
        read = [stripes[t] for t in want] + ([tail] if rank == 1 else [])
        assert src.reads == read
        assert (tail_rows is None) == (rank == 0)


def test_backends_are_not_swapped(monkeypatch):
    """NCCL takes CUDA tensors only (no silent host staging); gloo stages
    every tensor through a private host copy; launch_fold names its
    backend."""
    import torch.distributed as dist

    monkeypatch.setattr(dist, "is_initialized", lambda: True)
    monkeypatch.setattr(dist, "get_rank", lambda: 0)
    monkeypatch.setattr(dist, "get_world_size", lambda: 2)
    monkeypatch.setattr(dist, "get_backend", lambda: "nccl")
    with pytest.raises(ValueError, match="CUDA tensors"):
        ProcessGroup()._stage(torch.ones(3))
    monkeypatch.setattr(dist, "get_backend", lambda: "gloo")
    x = torch.ones(3)
    y = ProcessGroup()._stage(x)
    assert torch.equal(x, y) and y.data_ptr() != x.data_ptr()
    with pytest.raises(ValueError, match="backend"):
        multiproc.launch_fold("x.dada", CFG, backend="mpi")
    with pytest.raises(ValueError, match="2 devices for 3"):
        multiproc.launch_fold("x.dada", CFG, n_procs=3,
                              device=["cpu", "cpu"])
    monkeypatch.setattr(dist, "is_initialized", lambda: False)
    with pytest.raises(RuntimeError, match="init_process_group"):
        ShardedFoldPipeline(_Reads(), FoldConfig(**CFG), _mesh(8),
                            distributed=True)


@pytest.mark.parametrize("timed", [False, True], ids=["untimed", "timed"])
def test_launch_defaults_to_the_card(monkeypatch, tmp_path, timed):
    """Called with its defaults, ``launch_fold`` puts every rank's shards on
    the card (CPU shards are only ever named), and its workers synchronise
    the devices around each stage only when the caller asks for the stage
    times."""
    cmds = []

    class _Done:
        def __init__(self, cmd, env=None):
            cmds.append(cmd)

        def poll(self):
            return 0

    monkeypatch.setattr(multiproc.subprocess, "Popen", _Done)
    out = tmp_path / "out.npz"
    np.savez(out, profiles=np.zeros(1))
    kw = dict(timed=True) if timed else {}
    multiproc.launch_fold("x.dada", CFG, out_path=str(out), **kw)
    assert len(cmds) == 2
    for rank, cmd in enumerate(cmds):
        assert cmd[cmd.index("--device") + 1] == "cuda"
        assert cmd[cmd.index("--process-id") + 1] == str(rank)
        assert ("--timed" in cmd) == timed
