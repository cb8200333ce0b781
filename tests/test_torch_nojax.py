"""The port stands alone: in a fresh interpreter whose import system refuses
``jax`` and ``dspsr_tpu`` (a ``sys.meta_path`` finder that raises on either
and on their submodules, but not on ``dspsr_tpu_torch``), every module of
dspsr_tpu_torch imports, and its fold pipeline (full engine), its hybrid
fold engine with in-stream spectral kurtosis and its search pipeline (to a
SIGPROC file) run on the CPU from inputs built with the port's own classes;
neither ``jax`` nor ``dspsr_tpu`` is in ``sys.modules`` afterwards.  Runs in
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
