"""The port's host I/O runtime (``dspsr_tpu_torch/io/hostio.py`` over its
own ``csrc/hostio.cpp``) and live decimator (``apps/decimator_app.py``),
on the CPU.

Mirrors ``tests/test_hostio.py`` test for test with the port's classes and
``device="cpu"`` pipelines (prefetch, the POSIX ring, live folds, the
psrdada-style SysV hdu), and adds parity with the JAX package on the same
bytes: a live port fold against the JAX fold of the file (profiles 2e-4,
hits exact: the pipelines' tolerance, ``tests/test_torch_pipeline.py``),
the port's decimator against the JAX decimator, each on its own ring of
one file (SIGPROC bytes within 1 LSB and at least 99% exact: the search
rule, ``tests/test_torch_search.py``), and rings written by either
package read by the other.

Needs ``g++`` (the library is built at first use) and ``/dev/shm``.  SysV
keys stay clear of ``tests/test_hostio.py``'s (``0x5A000 + ...``), which
runs beside this file: each test takes its own slot of a span per process,
``0x10000000 + (pid % 4096) * 0x10000 + slot * 0x2000`` (a ring also takes
``key + 1`` and ``key + 0x100 * (i + 1)`` for its buffers).  Every feeder
thread and process has a deadline and is joined with a timeout.
"""

import ctypes
import ctypes.util
import os
import subprocess
import sys
import threading
import time
from pathlib import Path

import numpy as np
import pytest
import torch

import dspsr_tpu.io.hostio as jhostio
from dspsr_tpu.apps import decimator_app as jdecimator
from dspsr_tpu.io.sigproc import read_sigproc_header
from dspsr_tpu.io.sources import open_source as jopen
from dspsr_tpu.models import load_to_fold as jl

from dspsr_tpu_torch.apps import decimator_app as tdecimator
from dspsr_tpu_torch.io.hostio import (
    DadaReader, DadaWriter, PrefetchSource, RingReader, RingWriter,
    load_hostio)
from dspsr_tpu_torch.io.sources import open_source
from dspsr_tpu_torch.models import load_to_fil as tfil
from dspsr_tpu_torch.models import load_to_fold as tl
from dspsr_tpu_torch.observation import Observation, Signal
from dspsr_tpu_torch.timing.mjd import MJD
from test_pipeline import DM, PERIOD, RATE, synth_pulsar_dada
from test_torch_pipeline import plain

torch.set_num_threads(2)

REPO = Path(__file__).resolve().parent.parent
DEADLINE = 60.0  # seconds a feeder may run, and a join may wait


@pytest.fixture(scope="module")
def lib():
    return load_hostio()


def sysv_key(slot: int) -> int:
    return 0x10000000 + (os.getpid() % 4096) * 0x10000 + slot * 0x2000


def posix_name(tag: str) -> str:
    return f"/dspsr_torch_{tag}_{os.getpid()}"


def small_obs(**kw) -> Observation:
    return Observation(**dict(
        dict(nchan=1, npol=1, ndim=1, nbit=8, rate=1e6,
             centre_frequency=1400.0, bandwidth=1.0, state=Signal.NYQUIST,
             start_time=MJD(55000, 0.0)), **kw))


def push(writer, buf) -> None:
    """One buffer into either ring kind, waiting for room up to
    ``DEADLINE``."""
    t_end = time.time() + DEADLINE
    if isinstance(writer, (DadaWriter, jhostio.DadaWriter)):
        if not writer.push(buf, timeout=DEADLINE):
            raise TimeoutError("SysV ring stayed full")
        return
    while not writer.push(buf):
        if time.time() > t_end:
            raise TimeoutError("POSIX ring stayed full")
        time.sleep(0.0005)


def start_feeder(writer, bufs) -> tuple:
    """A thread that pushes ``bufs`` (an iterable of arrays) into
    ``writer`` and then signals end-of-data, also when a push failed;
    returns (thread, errors)."""
    errors = []

    def run():
        try:
            for b in bufs:
                push(writer, b)
        except Exception as e:  # reported by join_feeder
            errors.append(e)
        finally:
            writer.set_eod()

    t = threading.Thread(target=run, daemon=True)
    t.start()
    return t, errors


def join_feeder(t, errors) -> None:
    t.join(timeout=DEADLINE)
    assert not t.is_alive(), "feeder still running"
    assert not errors, errors


def file_buffers(src, nsamp_buf: int):
    """Whole ring buffers of ``nsamp_buf`` samples from ``src``."""
    start = 0
    while start + nsamp_buf <= src.total_samples:
        yield src.read_samples(start, nsamp_buf)
        start += nsamp_buf


def destroy_hdu(key: int) -> None:
    """Remove the SysV hdu at ``key`` if a test left it behind."""
    try:
        DadaReader(key, timeout=0.1).close(destroy=True)
    except OSError:
        pass


class TestHostBuild:
    """``kernels/build.py::build_host``: the g++ build of
    ``csrc/hostio.cpp`` at first use, named by the source and the flags;
    a failed or impossible build raises, with no fallback."""

    def test_library_named_by_source_and_flags(self, tmp_path, monkeypatch):
        from dspsr_tpu_torch.kernels import build

        path = build.library_path("hostio", ".cpp")
        assert path.parent == build.BUILD_DIR
        assert path.name.startswith("libhostio-") and path.suffix == ".so"
        assert path != build.library_path("megastep")
        src = tmp_path / "hostio.cpp"
        src.write_bytes((build._SRC_DIR / "hostio.cpp").read_bytes())
        monkeypatch.setattr(build, "_SRC_DIR", tmp_path)
        assert build.library_path("hostio", ".cpp") == path
        src.write_bytes(src.read_bytes() + b"\n// edited\n")
        assert build.library_path("hostio", ".cpp") != path
        monkeypatch.setattr(build, "HOST_FLAGS", build.HOST_FLAGS + ("-g",))
        assert build.library_path("hostio", ".cpp") != path

    def test_failed_build_raises(self, tmp_path, monkeypatch):
        from dspsr_tpu_torch.kernels import build

        monkeypatch.setattr(build, "BUILD_DIR", tmp_path)
        with monkeypatch.context() as m:
            m.setattr(build, "cxx_path", lambda: "false")
            with pytest.raises(RuntimeError, match="g\\+\\+ failed"):
                build.build_host("hostio")
        assert not list(tmp_path.iterdir())
        with monkeypatch.context() as m:
            m.setattr(build.shutil, "which", lambda _: None)
            with pytest.raises(RuntimeError, match="g\\+\\+ not found"):
                build.build_host("hostio")

    def test_native_library_untouched(self, lib):
        """The port loads its own build, never the JAX package's tracked
        ``native/libhostio.so``."""
        from dspsr_tpu_torch.kernels import build

        assert lib._name == str(build.library_path("hostio", ".cpp"))
        assert "native" not in lib._name


class TestPrefetch:
    def test_matches_direct_reads(self, lib, tmp_path):
        p = synth_pulsar_dada(str(tmp_path / "pf.dada"), nsec=0.05)
        direct = open_source(p)
        block, stride = 40000, 32000  # overlapping blocks
        pf = PrefetchSource(open_source(p), block, stride)
        start = 0
        n = 0
        while start + block <= direct.total_samples:
            a = pf.read_samples(start, block)
            b = direct.read_samples(start, block)
            np.testing.assert_array_equal(a, b)
            start += stride
            n += 1
        assert n >= 3
        pf.close()

    def test_fallback_random_access(self, lib, tmp_path):
        p = synth_pulsar_dada(str(tmp_path / "pf2.dada"), nsec=0.02)
        direct = open_source(p)
        pf = PrefetchSource(open_source(p), 8192, 8192)
        np.testing.assert_array_equal(
            pf.read_samples(5000, 100), direct.read_samples(5000, 100))
        pf.close()

    def test_eof_zero_padding(self, lib, tmp_path):
        p = synth_pulsar_dada(str(tmp_path / "pf3.dada"), nsec=0.01)
        src = open_source(p)
        total = src.total_samples
        pf = PrefetchSource(open_source(p), total + 100, total + 100)
        a = pf.read_samples(0, total + 100)
        b = src.read_samples(0, total + 100)
        np.testing.assert_array_equal(a, b)
        assert not a[total * src.bytes_per_sample_exact():].any()
        pf.close()

    def test_wraps_dada_files_only(self, lib):
        from dspsr_tpu_torch.io.sources import DummySource

        with pytest.raises(TypeError):
            PrefetchSource(DummySource(small_obs(ndat=1 << 20)), 64, 64)


class TestRing:
    def test_header_and_data_roundtrip(self, lib):
        name = posix_name("rt")
        obs = small_obs(nchan=2, npol=2, ndim=2, rate=16e6, bandwidth=16.0,
                        state=Signal.ANALYTIC, source="RINGTEST")
        nbuf_bytes = 8192
        w = RingWriter(name, obs, nbuf_bytes, nbufs=4)
        try:
            r = RingReader(name)
            assert r.obs.source == "RINGTEST"
            assert r.obs.nchan == 2
            assert abs(r.obs.rate - 16e6) < 1

            rng = np.random.default_rng(0)
            bufs = [rng.integers(0, 256, nbuf_bytes).astype(np.uint8)
                    for _ in range(6)]
            t, errors = start_feeder(w, bufs)
            nsamp = nbuf_bytes // r.bytes_per_sample_exact()
            got = [r.read_samples(i * nsamp, nsamp) for i in range(6)]
            join_feeder(t, errors)
            for a, b in zip(got, bufs):
                np.testing.assert_array_equal(a, b)
            with pytest.raises(EOFError):
                r.read_samples(6 * nsamp, nsamp)
            r.close()
        finally:
            w.close(unlink=True)

    def test_backpressure(self, lib):
        name = posix_name("bp")
        w = RingWriter(name, small_obs(), 64, nbufs=2)
        try:
            b = np.zeros(64, np.uint8)
            assert w.push(b) and w.push(b)
            assert not w.push(b)  # full: non-blocking refusal
            with pytest.raises(ValueError):
                w.push(np.zeros(32, np.uint8))
        finally:
            w.close(unlink=True)

    def test_overlap_carry_and_seek_back(self, lib):
        """Forward reads of any size and stride, overlapping when stride <
        block, come from the carried tail; a seek behind it raises."""
        name = posix_name("carry")
        w = RingWriter(name, small_obs(), 256, nbufs=8)
        try:
            r = RingReader(name)
            stream = np.arange(256 * 6, dtype=np.int64).astype(np.uint8)
            t, errors = start_feeder(w, stream.reshape(6, 256))
            for start, n in ((0, 300), (200, 300), (450, 100), (500, 700)):
                np.testing.assert_array_equal(r.read_samples(start, n),
                                              stream[start:start + n])
            with pytest.raises(ValueError):
                r.read_samples(100, 10)
            with pytest.raises(EOFError):
                r.read_samples(1200, 600)
            join_feeder(t, errors)
            r.close()
        finally:
            w.close(unlink=True)


def live_fold(reader, cfg, max_blocks=None):
    """The port's ``FoldPipeline`` on the CPU over a live ring until the
    ring ends (``EOFError``, then ``_finish()``, as the JAX test does)."""
    pipe = tl.FoldPipeline(reader, cfg, device="cpu")
    try:
        res = pipe.run(max_blocks=max_blocks)
    except EOFError:
        res = pipe._finish()
    return res, pipe


COHERENT = dict(folding_period=PERIOD, dispersion_measure=DM, nchan=4,
                nbin=32, min_block_samples=8192, block_parts=2)


def coherent_live(tmp_path, tag: str, nsec: float = 0.15):
    """A DM > 0 fold of a synthetic pulsar read live from a POSIX ring of
    16384-sample buffers; returns (file path, live result, pipeline)."""
    p = synth_pulsar_dada(str(tmp_path / f"{tag}.dada"), nsec=nsec)
    file_src = open_source(p)
    nsamp_buf = 16384
    w = RingWriter(posix_name(tag), file_src.obs,
                   nsamp_buf * file_src.bytes_per_sample_exact(), nbufs=8)
    try:
        r = RingReader(posix_name(tag))
        t, errors = start_feeder(w, file_buffers(file_src, nsamp_buf))
        res, pipe = live_fold(r, tl.FoldConfig(**COHERENT), max_blocks=50)
        join_feeder(t, errors)
        r.close()
    finally:
        w.close(unlink=True)
    return p, res, pipe


def blocks_folded(res, pipe) -> int:
    nuse = -(-pipe.out_per_block // pipe.fold_plan.seg_len) \
        * pipe.fold_plan.seg_len
    return int(round(res.hits.sum() / (res.obs.nchan * nuse)))


class TestLivePipeline:
    def test_fold_from_ring(self, lib, tmp_path, capsys):
        """End-to-end live mode: writer feeds ring, fold pipeline
        consumes; its run report (``report=True``) is printed when the
        ring's end stops the run, with one read a block."""
        p = synth_pulsar_dada(str(tmp_path / "live.dada"), nsec=0.1)
        file_src = open_source(p)
        name = posix_name("live")
        nsamp_buf = 65536
        buf_bytes = nsamp_buf * file_src.bytes_per_sample_exact()
        w = RingWriter(name, file_src.obs, buf_bytes, nbufs=8)
        try:
            r = RingReader(name)
            t, errors = start_feeder(w, file_buffers(file_src, nsamp_buf))
            cfg = tl.FoldConfig(folding_period=PERIOD,
                                dispersion_measure=0.0, coherent=False,
                                nbin=64, min_block_samples=nsamp_buf,
                                block_parts=1, report=True)
            res, pipe = live_fold(r, cfg, max_blocks=100)
            nblocks = file_src.total_samples // nsamp_buf
            err = capsys.readouterr().err
            assert "run report:" in err
            assert f"({nblocks} calls" in err.split("read")[1]
            # the block is a whole number of ring buffers
            assert pipe.block_in_samples % nsamp_buf == 0
            join_feeder(t, errors)
            assert res.hits.sum() > 0
            r.close()
        finally:
            w.close(unlink=True)

    def test_live_coherent_dedispersion_matches_offline(self, lib,
                                                        tmp_path):
        """DM > 0 live: the ring reader carries the overlap-save tail
        host-side (Seekable.C:197-222 recycling), so the coherent pipeline
        runs on a live stream and matches the offline fold of the same
        bytes."""
        p, res_live, pipe = coherent_live(tmp_path, "livedm")
        assert pipe.nsamp_overlap > 0, "must exercise overlapping reads"
        assert pipe.mega_mode == "full"
        nblocks = blocks_folded(res_live, pipe)
        assert nblocks >= 2
        off = tl.FoldPipeline(open_source(p), tl.FoldConfig(**COHERENT),
                              device="cpu")
        res_off = off.run(max_blocks=nblocks)
        np.testing.assert_allclose(res_live.profiles, res_off.profiles,
                                   rtol=1e-6, atol=1e-3)
        np.testing.assert_array_equal(res_live.hits, res_off.hits)

    def test_live_fold_matches_jax_file_fold(self, lib, tmp_path,
                                             monkeypatch):
        """The port's live fold against the JAX package's FoldPipeline on
        the file: profiles 2e-4, hits exact.  The JAX full step runs
        through its ``mega_reference`` (``test_torch_extras.
        reference_route``): at this period samples land exactly on turns,
        where its Pallas kernel in interpret mode rounds the phase once and
        moves them a bin."""
        from test_torch_extras import reference_route

        p, live, pipe = coherent_live(tmp_path, "livejax")
        nblocks = blocks_folded(live, pipe)
        assert nblocks >= 2
        jpipe = reference_route(monkeypatch)(jopen(p),
                                             jl.FoldConfig(**COHERENT))
        assert jpipe.mega_mode == pipe.mega_mode == "full"
        want = jpipe.run(max_blocks=nblocks)
        assert live.profiles.shape == want.profiles.shape
        assert np.abs(live.profiles - want.profiles).max() \
            / np.abs(want.profiles).max() < 2e-4
        np.testing.assert_array_equal(live.hits, want.hits)
        # a live stream has no length (ndat 0), and the ring's header names
        # the file's empty RECEIVER "unknown" (either package's header)
        assert plain(live.obs) == plain(want.obs.replace(
            ndat=0, receiver="unknown"))
        assert plain(live.epochs) == plain(want.epochs)
        np.testing.assert_array_equal(live.digitizer_counts,
                                      want.digitizer_counts)


class TestDadaSysVRing:
    """psrdada-architecture SysV hdu (csrc/hostio.cpp dada_*): data block at
    key, header block at key+1, semaphore flow control — the wire the
    reference's DADABuffer attaches to (DADABuffer.C:175-208,
    dada_def.h DADA_DEFAULT_BLOCK_KEY)."""

    def test_header_and_data_roundtrip(self, lib):
        key = sysv_key(0)
        obs = small_obs(nchan=2, npol=2, ndim=2, rate=16e6, bandwidth=16.0,
                        state=Signal.ANALYTIC, source="DADATEST")
        nbuf_bytes = 8192
        w = DadaWriter(key, obs, nbuf_bytes, nbufs=4)
        try:
            r = DadaReader(key, timeout=5.0)
            assert r.obs.source == "DADATEST"
            assert r.obs.nchan == 2
            rng = np.random.default_rng(1)
            bufs = [rng.integers(0, 256, nbuf_bytes).astype(np.uint8)
                    for _ in range(6)]
            t, errors = start_feeder(w, bufs)
            nsamp = nbuf_bytes // r.bytes_per_sample_exact()
            got = [r.read_samples(i * nsamp, nsamp) for i in range(6)]
            join_feeder(t, errors)
            for a, b in zip(got, bufs):
                np.testing.assert_array_equal(a, b)
            with pytest.raises(EOFError):
                r.read_samples(6 * nsamp, nsamp)
            r.close()
        finally:
            w.close(destroy=True)

    def test_sysv_segments_at_key_conventions(self, lib):
        """The data block's sync segment lives at the hdu key and the
        header block's at key+1 — independently visible through raw SysV
        shmget (the psrdada dada_hdu convention)."""
        key = sysv_key(1)
        w = DadaWriter(key, small_obs(), 128, nbufs=2)
        libc = ctypes.CDLL(ctypes.util.find_library("c"), use_errno=True)
        try:
            # IPC_EXCL create must FAIL: segments already exist at key, key+1
            IPC_CREAT, IPC_EXCL = 0o1000, 0o2000
            assert libc.shmget(key, 0, 0o600) >= 0
            assert libc.shmget(key + 1, 0, 0o600) >= 0
            assert libc.shmget(key + 0x100, 0, 0o600) >= 0  # buffer 0
            assert libc.shmget(key, 4096, IPC_CREAT | IPC_EXCL | 0o600) < 0
            # semaphore set exists at the data key
            assert libc.semget(key, 0, 0o600) >= 0
        finally:
            w.close(destroy=True)
        # destroyed: gone from the system
        assert libc.shmget(key, 0, 0o600) < 0
        assert libc.shmget(key + 1, 0, 0o600) < 0

    def test_blocking_backpressure_and_timeout(self, lib):
        key = sysv_key(2)
        w = DadaWriter(key, small_obs(), 64, nbufs=2)
        try:
            b = np.zeros(64, np.uint8)
            assert w.push(b) and w.push(b)
            t0 = time.time()
            assert not w.push(b, timeout=0.2)  # full: blocks then times out
            assert time.time() - t0 >= 0.15
            r = DadaReader(key, timeout=0.2)
            r.read_samples(0, 64)  # frees a slot
            assert w.push(b, timeout=1.0)
            r.read_samples(64, 128)  # drains both
            t0 = time.time()
            with pytest.raises(TimeoutError):  # empty, no end-of-data
                r.read_samples(192, 64)
            assert time.time() - t0 >= 0.15
            r.close()
        finally:
            w.close(destroy=True)

    def test_cross_process_fold(self, lib, tmp_path):
        """A separate OS process (under the import hook that refuses jax
        and dspsr_tpu) writes the SysV ring; the fold pipeline consumes it
        live (the real DAQ->pipeline topology)."""
        key = sysv_key(3)
        path = synth_pulsar_dada(str(tmp_path / "dd.dada"), nsec=0.08)
        buf_bytes = 16384
        proc = subprocess.Popen(
            [sys.executable, "-c", writer_script(path, key, buf_bytes, 8)],
            cwd=REPO, env=dict(os.environ, PYTHONPATH=str(REPO)))
        try:
            r = connect_when_ready(lambda: DadaReader(key, timeout=3.0),
                                   proc)
            cfg = tl.FoldConfig(folding_period=PERIOD,
                                dispersion_measure=DM, nchan=4, nbin=32,
                                block_parts=2, min_block_samples=0,
                                use_megakernel=False)
            # to the end of the stream, so the writer pushes all it has
            res, pipe = live_fold(r, cfg)
            assert pipe.mega_mode is None
            assert blocks_folded(res, pipe) >= 4
            prof = res.normalized()[0, :, 0, :]
            assert np.isfinite(prof).all()
            r.close(destroy=True)
        finally:
            rc = proc.wait(timeout=DEADLINE)
            destroy_hdu(key)
        assert rc == 0


#: a writer process: pushes every whole buffer of a DADA file into a SysV
#: hdu with the port's classes, refusing any import of jax or dspsr_tpu
WRITER = r"""
import importlib.abc, sys


class Refuse(importlib.abc.MetaPathFinder):
    def find_spec(self, name, path=None, target=None):
        if name.split(".")[0] in ("jax", "dspsr_tpu"):
            raise ImportError(f"the port imported {{name}}")
        return None


sys.meta_path.insert(0, Refuse())
from dspsr_tpu_torch.io.hostio import DadaWriter
from dspsr_tpu_torch.io.sources import open_source
src = open_source({path!r})
w = DadaWriter({key}, src.obs, {buf_bytes}, nbufs={nbufs})
n = {buf_bytes} // src.bytes_per_sample_exact()
i = 0
while (i + 1) * n <= src.total_samples:
    if not w.push(src.read_samples(i * n, n), timeout=60.0):
        sys.exit("ring stayed full")
    i += 1
w.set_eod()
w.close(destroy=False)
"""


def writer_script(path: str, key: int, buf_bytes: int, nbufs: int) -> str:
    return WRITER.format(path=path, key=key, buf_bytes=buf_bytes,
                         nbufs=nbufs)


def connect_when_ready(connect, proc):
    """``connect()`` once the writer process has made its ring, within
    ``DEADLINE``."""
    t_end = time.time() + DEADLINE
    while True:
        try:
            return connect()
        except OSError:
            if proc.poll() is not None or time.time() > t_end:
                raise
            time.sleep(0.1)  # writer still importing or creating


#: ring kind -> (JAX writer, JAX reader, port writer, port reader, address)
KINDS = {
    "posix": (jhostio.RingWriter, jhostio.RingReader, RingWriter, RingReader,
              lambda: posix_name("wire")),
    "sysv": (jhostio.DadaWriter, jhostio.DadaReader, DadaWriter, DadaReader,
             lambda: sysv_key(4)),
}


def described(obs) -> tuple:
    """What a ring header carries of ``obs``, comparable across the two
    packages' classes."""
    return (obs.source, obs.nchan, obs.npol, obs.ndim, obs.nbit, obs.rate,
            obs.centre_frequency, obs.bandwidth, obs.state.value)


def close_writer(w) -> None:
    if isinstance(w, (DadaWriter, jhostio.DadaWriter)):
        w.close(destroy=True)
    else:
        w.close(unlink=True)


@pytest.mark.parametrize("direction", ["jax_to_port", "port_to_jax"])
@pytest.mark.parametrize("kind", ["posix", "sysv"])
def test_wire_compatible(lib, kind, direction):
    """A ring written by one package is read by the other: the header's
    observation and every byte, then the end of the data."""
    from dspsr_tpu.observation import Observation as JObs, Signal as JSig
    from dspsr_tpu.timing.mjd import MJD as JMJD

    jw, jr, tw, tr, addr = KINDS[kind]
    addr = addr()
    fields = dict(nchan=2, npol=2, ndim=2, nbit=8, rate=16e6,
                  centre_frequency=1400.0, bandwidth=16.0, source="WIRE")
    if direction == "jax_to_port":
        obs = JObs(state=JSig.ANALYTIC, start_time=JMJD(55000, 0.0),
                   **fields)
        writer_cls, reader_cls = jw, tr
    else:
        obs = Observation(state=Signal.ANALYTIC,
                          start_time=MJD(55000, 0.0), **fields)
        writer_cls, reader_cls = tw, jr
    nbuf_bytes = 4096
    w = writer_cls(addr, obs, nbuf_bytes, nbufs=4)
    try:
        r = (reader_cls(addr, timeout=2.0) if kind == "sysv"
             else reader_cls(addr))
        assert described(r.obs) == described(obs)
        assert (r.obs.start_time.days, r.obs.start_time.secs) == (55000, 0.0)
        rng = np.random.default_rng(7)
        bufs = [rng.integers(0, 256, nbuf_bytes).astype(np.uint8)
                for _ in range(6)]
        t, errors = start_feeder(w, bufs)
        got = r.read_samples(0, 6 * nbuf_bytes // 8)
        join_feeder(t, errors)
        np.testing.assert_array_equal(got, np.concatenate(bufs))
        with pytest.raises(EOFError):
            r.read_samples(6 * nbuf_bytes // 8, 1)
        r.close()
    finally:
        close_writer(w)


def decimate(module, kind: str, tag: str, path: str, out: str,
             argv: list) -> None:
    """``module.main`` (either package's decimator) on its own ring of kind
    ``kind`` (its own package's writer), fed the file's whole buffers."""
    jw, _, tw, _, _ = KINDS[kind]
    writer_cls = jw if module is jdecimator else tw
    src = (jopen if module is jdecimator else open_source)(path)
    addr = posix_name(tag) if kind == "posix" else sysv_key(
        5 if module is jdecimator else 6)
    nsamp_buf = 4096
    w = writer_cls(addr, src.obs, nsamp_buf * src.bytes_per_sample_exact(),
                   nbufs=8)
    try:
        t, errors = start_feeder(w, file_buffers(src, nsamp_buf))
        ring = addr if kind == "posix" else hex(addr)
        assert module.main([ring, "-o", out, "-q", *argv]) == 0
        join_feeder(t, errors)
    finally:
        close_writer(w)


def sigproc(path: str) -> tuple:
    items, hdr = read_sigproc_header(path)
    with open(path, "rb") as f:
        return items, np.frombuffer(f.read()[hdr:], np.uint8)


def _code(path: Path) -> str:
    """A C++ source with its leading comment block taken off."""
    lines = path.read_text().splitlines()
    while lines and (not lines[0].strip() or lines[0].startswith("//")):
        lines.pop(0)
    return "\n".join(lines)


def test_hostio_source_matches_native():
    """The port's csrc/hostio.cpp is the JAX package's native/hostio.cpp
    below its header comment, so that both packages keep one wire
    protocol: an edit goes to both files."""
    port = _code(REPO / "dspsr_tpu_torch" / "csrc" / "hostio.cpp")
    assert port and port == _code(REPO / "native" / "hostio.cpp")


@pytest.mark.parametrize("kind", ["posix", "sysv"])
def test_decimator_matches_jax(lib, tmp_path, monkeypatch, kind):
    """The port's decimator (``--device cpu``) and the JAX decimator, each
    on its own ring of the same file: the same SIGPROC header, bytes within
    1 LSB and at least 99% exact; and against the port's FilPipeline on
    the file with the app's own FilConfig."""
    monkeypatch.setenv("DSPSR_TPU_CACHE_DIR", "0")
    # 30 whole ring buffers of 4096 samples: the rings carry the file
    p = synth_pulsar_dada(str(tmp_path / "dec.dada"),
                          nsec=(30 * 4096 + 0.5) / RATE, dm=0.0)
    argv = ["-F", "8", "-t", "2"]
    outs = {}
    for tag, module, extra in (("jdec", jdecimator, []),
                               ("tdec", tdecimator, ["--device", "cpu"])):
        outs[tag] = str(tmp_path / f"{tag}.fil")
        decimate(module, kind, tag, p, outs[tag], argv + extra)
    (ji, jd), (ti, td) = sigproc(outs["jdec"]), sigproc(outs["tdec"])
    assert ji == ti
    assert int(ti["nchans"]) == 8 and td.size > 0
    assert jd.shape == td.shape
    diff = np.abs(jd.astype(np.int64) - td.astype(np.int64))
    assert diff.max() <= 1 and (diff == 0).mean() >= 0.99

    # the same file through FilPipeline with the app's config
    args = tdecimator.build_parser().parse_args(["x", "-o", "y", *argv])
    src = open_source(p)
    pipe = tfil.FilPipeline(src, tdecimator.fil_config(args, 4096),
                            device="cpu")
    assert pipe.megafil_plan is None  # no -D: the general chain
    ref = str(tmp_path / "ref.fil")
    pipe.run(ref)
    assert src.total_samples == 30 * 4096
    _, rd = sigproc(ref)
    np.testing.assert_array_equal(td, rd)
