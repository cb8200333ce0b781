"""The port never imports jax: importing every module of dspsr_tpu_torch and
running a small CPU pipeline leaves ``jax`` out of ``sys.modules``.  Runs in
a fresh interpreter, since this test process has jax loaded already."""

import os
import subprocess
import sys
from pathlib import Path

import torch

torch.set_num_threads(2)

REPO = Path(__file__).resolve().parent.parent

SCRIPT = r"""
import importlib, pkgutil, sys, tempfile
import numpy as np
import torch
torch.set_num_threads(2)
import dspsr_tpu_torch
mods = [m.name for m in pkgutil.walk_packages(dspsr_tpu_torch.__path__,
                                              "dspsr_tpu_torch.")]
for name in mods:
    importlib.import_module(name)
from dspsr_tpu.io.sources import RawFileSource
from dspsr_tpu.observation import Observation, Signal
from dspsr_tpu.timing.mjd import MJD
from dspsr_tpu_torch.models.load_to_fold import FoldConfig, FoldPipeline
rng = np.random.default_rng(0)
with tempfile.NamedTemporaryFile(suffix=".raw") as f:
    f.write(rng.integers(0, 256, 1 << 15, dtype=np.uint8).tobytes())
    f.flush()
    obs = Observation(nchan=1, npol=2, ndim=1, nbit=8,
                      centre_frequency=1400.0, bandwidth=-2.0, rate=2e6,
                      start_time=MJD.from_utc("2010-04-13-02:05:45"),
                      state=Signal.NYQUIST, source="FAKE", telescope="PKS",
                      instrument="RAW")
    res = FoldPipeline(RawFileSource(f.name, obs),
                       FoldConfig(folding_period=0.005, dispersion_measure=5.0,
                                  nchan=4, nbin=32, block_parts=2,
                                  min_block_samples=0),
                       device="cpu").run()
assert res.hits.sum() > 0
print(len(mods), sorted(m for m in sys.modules if m.split(".")[0] == "jax"))
"""


def test_port_imports_no_jax():
    env = dict(os.environ, PYTHONPATH=str(REPO))
    out = subprocess.run([sys.executable, "-c", SCRIPT], cwd=REPO, env=env,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    nmods, jax_mods = out.stdout.split(" ", 1)
    assert int(nmods) >= 10
    assert jax_mods.strip() == "[]"
