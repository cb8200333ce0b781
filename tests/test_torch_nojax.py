"""The port stands alone: in a fresh interpreter whose import system refuses
``jax`` and ``dspsr_tpu`` (a ``sys.meta_path`` finder that raises on either
and on their submodules, but not on ``dspsr_tpu_torch``), every module of
dspsr_tpu_torch imports (the general chain's modules ``ops/fft.py`` and
``ops/polyphase.py`` among them), and its fold pipeline (full engine, on
real and on complex input), its hybrid fold engine with in-stream spectral
kurtosis, its search pipeline (to a SIGPROC file) and the general chain of
both (fold with ``use_megakernel=False``, polyphase search) and the sharded
pipelines (``parallel/*`` on a mesh of the CPU four times: fused time
shards, hybrid channel shards with pooled SK, time-sharded search) run on
the CPU from inputs built with the port's own classes, and so do the
command-line tools run as ``__main__`` (``dspsr_app`` to PSRFITS and with
``-G``, ``diagnostics digistat`` and ``passband``), and the live rings
(``io/hostio.py`` with its library built from ``csrc/hostio.cpp``,
``io/cfitsio.py``, a fold read from a POSIX ring, the decimator as
``__main__``); neither ``jax`` nor ``dspsr_tpu`` is in ``sys.modules``
afterwards.  Runs in
a subprocess, since this test process has both loaded already."""

import os
import subprocess
import sys
from pathlib import Path

import torch

torch.set_num_threads(2)

REPO = Path(__file__).resolve().parent.parent

SCRIPT = r"""
import importlib.abc, sys

BLOCKED = ("jax", "dspsr_tpu")


class Refuse(importlib.abc.MetaPathFinder):
    def find_spec(self, name, path=None, target=None):
        if name.split(".")[0] in BLOCKED:
            raise ImportError(f"the port imported {name}")
        return None


sys.meta_path.insert(0, Refuse())

import importlib, pkgutil, tempfile
import numpy as np
import torch
torch.set_num_threads(2)
import dspsr_tpu_torch
mods = [m.name for m in pkgutil.walk_packages(dspsr_tpu_torch.__path__,
                                              "dspsr_tpu_torch.")]
assert {"dspsr_tpu_torch.ops.fft", "dspsr_tpu_torch.ops.polyphase",
        "dspsr_tpu_torch.parallel.sharded", "dspsr_tpu_torch.parallel.pipeline",
        "dspsr_tpu_torch.parallel.search",
        "dspsr_tpu_torch.parallel.multiproc", "dspsr_tpu_torch.io.hostio",
        "dspsr_tpu_torch.io.cfitsio",
        "dspsr_tpu_torch.apps.decimator_app"} <= set(mods)
for name in mods:
    importlib.import_module(name)
from dspsr_tpu_torch.io.sources import RawFileSource
from dspsr_tpu_torch.io.sigproc import read_sigproc_header
from dspsr_tpu_torch.models.load_to_fil import FilConfig, FilPipeline
from dspsr_tpu_torch.models.load_to_fold import (
    MJD, FoldConfig, FoldPipeline, Observation, Signal)
rng = np.random.default_rng(0)
obs = Observation(nchan=1, npol=2, ndim=1, nbit=8, centre_frequency=1400.0,
                  bandwidth=-2.0, rate=2e6,
                  start_time=MJD.from_utc("2010-04-13-02:05:45"),
                  state=Signal.NYQUIST, source="FAKE", telescope="PKS",
                  instrument="RAW")
fold = dict(folding_period=0.005, dispersion_measure=5.0, nchan=4, nbin=32,
            block_parts=2, min_block_samples=0)
with tempfile.TemporaryDirectory() as d:
    raw, fil = d + "/in.raw", d + "/out.fil"
    with open(raw, "wb") as f:
        f.write(rng.integers(0, 256, 1 << 15, dtype=np.uint8).tobytes())
    pipe = FoldPipeline(RawFileSource(raw, obs), FoldConfig(**fold),
                        device="cpu")
    assert pipe.mega_mode == "full"
    assert pipe.run().hits.sum() > 0
    pipe = FoldPipeline(RawFileSource(raw, obs),
                        FoldConfig(**dict(fold, frequency_resolution=128,
                                          block_parts=4, sk_enable=True,
                                          sk_m=64)),
                        device="cpu")
    assert pipe.mega_mode == "hybrid"
    assert pipe.run(max_blocks=2).hits.sum() > 0
    FilPipeline(RawFileSource(raw, obs),
                FilConfig(nchan=4, dispersion_measure=5.0, block_parts=2,
                          min_block_samples=0),
                device="cpu").run(fil)
    items, hdr = read_sigproc_header(fil)
    with open(fil, "rb") as f:
        assert items["nchans"] == 4 and len(f.read()) > hdr
    cplx = obs.replace(ndim=2, state=Signal.ANALYTIC, rate=1e6)
    pipe = FoldPipeline(RawFileSource(raw, cplx), FoldConfig(**fold),
                        device="cpu")
    assert pipe.mega_mode == "full" and not pipe.mega_plan.real_input
    assert pipe.run().hits.sum() > 0
    pipe = FoldPipeline(RawFileSource(raw, obs),
                        FoldConfig(**dict(fold, use_megakernel=False)),
                        device="cpu")
    assert pipe.mega_mode is None
    assert pipe.run().hits.sum() > 0
    pipe = FilPipeline(RawFileSource(raw, obs),
                       FilConfig(nchan=4, channelizer="polyphase",
                                 min_block_samples=4096), device="cpu")
    assert pipe.megafil_plan is None
    pipe.run(fil)
    # the sharded pipelines on a mesh of the CPU four times: the fused fold
    # step on time shards, the hybrid engine's SK pooled over 2 chan
    # shards of 2 complex channels, and the time-sharded search
    from dspsr_tpu_torch.parallel.pipeline import ShardedFoldPipeline
    from dspsr_tpu_torch.parallel.search import ShardedFilPipeline
    from dspsr_tpu_torch.parallel.sharded import make_mesh
    cpu4 = [torch.device("cpu")] * 4
    sh = ShardedFoldPipeline(RawFileSource(raw, obs), FoldConfig(**fold),
                             make_mesh(4, 1, devices=cpu4))
    assert sh.mega and sh.run().hits.sum() > 0
    mc = obs.replace(nchan=2, ndim=2, state=Signal.ANALYTIC, rate=5e5)
    sh = ShardedFoldPipeline(
        RawFileSource(raw, mc),
        FoldConfig(**dict(fold, nchan=8, frequency_resolution=128,
                          sk_enable=True, sk_m=64)),
        make_mesh(4, 2, devices=cpu4))
    assert sh.hybrid_chan and sh.run().hits.sum() > 0
    ShardedFilPipeline(RawFileSource(raw, obs),
                       FilConfig(nchan=4, dispersion_measure=5.0,
                                 block_parts=2, min_block_samples=0),
                       make_mesh(4, 1, devices=cpu4)).run(fil)
    if not torch.cuda.is_available():
        try:
            make_mesh(4)
            raise AssertionError("make_mesh fell back to the CPU")
        except RuntimeError:
            pass
loaded = sorted(m for m in sys.modules if m.split(".")[0] in BLOCKED)
print(len(mods), loaded)
"""


def test_port_imports_no_jax():
    env = dict(os.environ, PYTHONPATH=str(REPO))
    out = subprocess.run([sys.executable, "-c", SCRIPT], cwd=REPO, env=env,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    nmods, loaded = out.stdout.split(" ", 1)
    assert int(nmods) >= 30
    assert loaded.strip() == "[]"


def test_refusal_is_real():
    """The same finder stops an import of the JAX package's own modules."""
    head = SCRIPT.split("import importlib, pkgutil")[0]
    env = dict(os.environ, PYTHONPATH=str(REPO))
    out = subprocess.run(
        [sys.executable, "-c", head + "import dspsr_tpu.observation\n"],
        cwd=REPO, env=env, capture_output=True, text=True, timeout=120)
    assert out.returncode != 0
    assert "the port imported dspsr_tpu" in out.stderr


CLI_SCRIPT = r"""
import runpy, sys, tempfile
import numpy as np
import torch
torch.set_num_threads(2)
rng = np.random.default_rng(0)
hdr = ["--header", "FREQ=1400", "BW=-2", "NCHAN=1", "NPOL=2", "NDIM=1",
       "NBIT=8", "TSAMP=1.0", "UTC_START=2010-04-13-02:05:45"]


def run(module, argv):
    sys.argv = [module] + argv
    try:
        runpy.run_module(module, run_name="__main__", alter_sys=True)
    except SystemExit as e:
        assert e.code in (0, None), (module, e.code)


with tempfile.TemporaryDirectory() as d:
    raw = d + "/in.raw"
    with open(raw, "wb") as f:
        f.write(rng.integers(0, 256, 1 << 16, dtype=np.uint8).tobytes())
    run("dspsr_tpu_torch.apps.dspsr_app",
        [raw, *hdr, "-c", "0.005", "-F", "4", "-D", "3", "-b", "32", "-q",
         "-O", d + "/out.ar", "-a", "psrfits", "--device", "cpu"])
    run("dspsr_tpu_torch.apps.dspsr_app",
        [raw, *hdr, "-c", "0.005", "-G", "8", "--plfb-chan", "16", "-q",
         "-O", d + "/plfb.npz", "--device", "cpu"])
    from dspsr_tpu_torch.io.dada import format_ascii_header
    dada = d + "/in.dada"
    with open(dada, "wb") as f:
        f.write(format_ascii_header({
            "HDR_VERSION": "1.0", "HDR_SIZE": "4096", "BW": "4.0",
            "FREQ": "1400.0", "NCHAN": "1", "NPOL": "2", "NDIM": "1",
            "NBIT": "8", "TSAMP": "0.125", "OBS_OFFSET": "0",
            "UTC_START": "2010-04-13-02:05:45"}))
        f.write(rng.integers(0, 256, 1 << 14, dtype=np.uint8).tobytes())
    run("dspsr_tpu_torch.apps.diagnostics",
        ["digistat", dada, "-n", "4096", "--device", "cpu"])
    run("dspsr_tpu_torch.apps.diagnostics",
        ["passband", dada, "-F", "16", "--device", "cpu"])
    with np.load(d + "/plfb.npz") as z:
        assert z["hits"].sum() > 0
    import os
    assert os.path.getsize(d + "/out.ar") > 2880
loaded = sorted(m for m in sys.modules if m.split(".")[0] in BLOCKED)
print("loaded", loaded)
"""


def test_clis_run_without_jax():
    """``python -m dspsr_tpu_torch.apps.dspsr_app`` (fold to PSRFITS, and
    ``-G``) and two diagnostics tools, each run as ``__main__`` with
    ``--device cpu`` under the hook that refuses ``jax`` and
    ``dspsr_tpu``."""
    head = SCRIPT.split("import importlib, pkgutil")[0]
    env = dict(os.environ, PYTHONPATH=str(REPO))
    out = subprocess.run([sys.executable, "-c", head + CLI_SCRIPT],
                         cwd=REPO, env=env, capture_output=True, text=True,
                         timeout=300)
    assert out.returncode == 0, out.stderr
    assert "chan 0 pol 1: mean" in out.stdout
    assert out.stdout.strip().splitlines()[-1] == "loaded []"



LIVE_SCRIPT = r"""
import os, runpy, sys, tempfile, threading, time
import numpy as np
import torch
torch.set_num_threads(2)
from dspsr_tpu_torch.apps import decimator_app
from dspsr_tpu_torch.io import cfitsio
from dspsr_tpu_torch.io.hostio import RingReader, RingWriter, load_hostio
from dspsr_tpu_torch.io.sigproc import read_sigproc_header
from dspsr_tpu_torch.models.load_to_fold import (
    MJD, FoldConfig, FoldPipeline, Observation, Signal)
load_hostio()
cfitsio.available()
obs = Observation(nchan=1, npol=2, ndim=1, nbit=8, centre_frequency=1400.0,
                  bandwidth=-2.0, rate=2e6,
                  start_time=MJD.from_utc("2010-04-13-02:05:45"),
                  state=Signal.NYQUIST, source="FAKE", telescope="PKS",
                  instrument="RAW")
rng = np.random.default_rng(0)
bufs = rng.integers(0, 256, (16, 8192), dtype=np.uint8)


def feed(name):
    w = RingWriter(name, obs, 8192, nbufs=4)

    def run():
        t_end = time.time() + 60
        try:
            for b in bufs:
                while not w.push(b) and time.time() < t_end:
                    time.sleep(0.0005)
        finally:
            w.set_eod()

    t = threading.Thread(target=run, daemon=True)
    t.start()
    return w, t


def done(w, t):
    t.join(timeout=60)
    assert not t.is_alive()
    w.close(unlink=True)


name = f"/dspsr_torch_nojax_{os.getpid()}"
w, t = feed(name)
pipe = FoldPipeline(RingReader(name), FoldConfig(
    folding_period=0.005, dispersion_measure=5.0, nchan=4, nbin=32,
    block_parts=2, min_block_samples=0), device="cpu")
assert pipe.mega_mode == "full"
try:
    res = pipe.run()
except EOFError:
    res = pipe._finish()
done(w, t)
assert res.hits.sum() > 0
with tempfile.TemporaryDirectory() as d:
    w, t = feed(name)
    sys.argv = ["decimator_app", name, "-F", "4", "-o", d + "/live.fil",
                "-q", "--device", "cpu"]
    try:
        runpy.run_module("dspsr_tpu_torch.apps.decimator_app",
                         run_name="__main__", alter_sys=True)
    except SystemExit as e:
        assert e.code in (0, None), e.code
    done(w, t)
    items, hdr = read_sigproc_header(d + "/live.fil")
    assert items["nchans"] == 4 and os.path.getsize(d + "/live.fil") > hdr
loaded = sorted(m for m in sys.modules if m.split(".")[0] in BLOCKED)
print("loaded", loaded)
"""


def test_live_ring_without_jax():
    """``io/hostio.py`` (its library built from the port's
    ``csrc/hostio.cpp``), ``io/cfitsio.py`` and ``apps/decimator_app.py``
    under the hook that refuses ``jax`` and ``dspsr_tpu``: a fold on the CPU
    read live from a POSIX ring, and the decimator run as ``__main__`` on
    another."""
    head = SCRIPT.split("import importlib, pkgutil")[0]
    env = dict(os.environ, PYTHONPATH=str(REPO))
    out = subprocess.run([sys.executable, "-c", head + LIVE_SCRIPT],
                         cwd=REPO, env=env, capture_output=True, text=True,
                         timeout=300)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip().splitlines()[-1] == "loaded []"
