"""The port's sharded fold pipeline on its fused engines, against the JAX
package's ``ShardedFoldPipeline`` (Pallas in interpret mode) and the port's
single pipeline, case by case as ``tests/test_sharded_pipeline.py``: the
fused fold step on time shards (8-bit, and JA98 2-bit with excision), the
hybrid engine on time shards (the two-pass RFI filter, cyclic folding),
chan-mega (each shard's own input-channel group, its chirp rows handed to
``build_megastep(response_as_args=True)``; 8-bit and JA98 2-bit) and
chan-hybrid (``build_megafil`` with the group's chirp or Jones rows per
call: SK pooled over the channel shards, cyclic, two-pass RFI, Jones, RFI x
Jones, SK with sub-integrations).  Helpers and tolerances are
``test_torch_sharded.py``'s; the channel-grouped hybrid cases take the JAX
tests' 5e-5.
"""

import dataclasses

import pytest
import torch

from dspsr_tpu_torch.models import load_to_fold as tl
from dspsr_tpu_torch.parallel.pipeline import ShardedFoldPipeline
from test_sharded_pipeline import _write
from test_torch_sharded import (
    BASE, RATE, jones_file, port_mesh, source, three_runs)

torch.set_num_threads(2)

FUSED = dict(BASE, use_megakernel=True, digitizer_stats=False)
#: two complex channels (``test_sharded_pipeline._obs_mc``)
MC = dict(ndim=2, nchan=2, bandwidth=-1.0, rate=RATE / 2)
TWOBIT = dict(twobit=True, rfi_stretch=(30000, 34096))

#: name -> (observation keywords, config keywords, time shards, chan
#: shards, run keywords, expected mode)
CASES = {
    "mega_time": ({}, dict(FUSED, frequency_resolution=64), 4, 1, {},
                  "mega"),
    "mega_twobit": (dict(nbit=2, ndim=2), dict(
        FUSED, dispersion_measure=0.0, frequency_resolution=1024,
        ndat_per_weight=64, min_block_samples=8192), 4, 1, TWOBIT, "mega"),
    "hybrid_rfi_two_pass": ({}, dict(FUSED, rfi_filter=True,
                                     frequency_resolution=128), 4, 1, {},
                            "megask"),
    "hybrid_cyclic": ({}, dict(FUSED, cyclic_nchan=4,
                               frequency_resolution=1024,
                               min_block_samples=8192), 4, 1, {}, "megask"),
    "chan_mega": (dict(ndim=2, nchan=4, bandwidth=-4.0, rate=RATE / 4),
                  dict(FUSED, nchan=64, frequency_resolution=256,
                       min_block_samples=8192, digitizer_stats=True),
                  2, 2, {}, "mega_chan"),
    "chan_mega_twobit": (dict(nbit=2, ndim=2, nchan=2, bandwidth=-2.0,
                              rate=RATE / 2),
                         dict(FUSED, nchan=8, frequency_resolution=1024,
                              ndat_per_weight=64, min_block_samples=8192,
                              dispersion_measure=0.0), 2, 2, TWOBIT,
                         "mega_chan"),
    "chan_hybrid_sk": (MC, dict(FUSED, nchan=8, frequency_resolution=128,
                                sk_enable=True, sk_m=64), 2, 2,
                       dict(atol=5e-5), "hybrid_chan"),
    "chan_hybrid_cyclic": (MC, dict(FUSED, nchan=8, frequency_resolution=128,
                                    cyclic_nchan=4), 2, 2, dict(atol=5e-5),
                           "hybrid_chan"),
    "chan_hybrid_rfi_two_pass": (MC, dict(
        FUSED, nchan=8, frequency_resolution=128, rfi_filter=True,
        rfi_same_block=True, rfi_median_width=9), 2, 2, dict(atol=5e-5),
        "hybrid_chan"),
    "chan_hybrid_jones": (MC, dict(FUSED, nchan=2, npol_out=4,
                                   frequency_resolution=256,
                                   dispersion_measure=1.0), 2, 2,
                          dict(atol=5e-5), "hybrid_chan"),
    "chan_hybrid_rfi_jones": (MC, dict(
        FUSED, nchan=2, npol_out=4, frequency_resolution=256,
        dispersion_measure=1.0, rfi_filter=True, rfi_same_block=True,
        rfi_median_width=9), 2, 2, dict(atol=5e-5), "hybrid_chan"),
}


@pytest.mark.parametrize("name", list(CASES))
def test_fused_sharded_matches_jax(tmp_path, name):
    obs_kw, cfg_kw, nt, nc, kw, mode = CASES[name]
    if "jones" in name:
        cfg_kw = dict(cfg_kw, calibration_path=jones_file(tmp_path,
                                                          "cal.npz"))
    tsh, rj, rt, r1 = three_runs(tmp_path, obs_kw, cfg_kw, nt, nc,
                                 name=f"{name}.raw", **kw)
    assert getattr(tsh, mode)
    assert rt.hits.max() > 0
    if "twobit" in name:
        # the saturated stretch is excised in every run
        assert rt.hits.min() < rt.hits.max()
    if name == "chan_mega":
        assert tsh.local_nchan == 2
    if "jones" in name:
        assert tsh.inner.jones is not None
    if "cyclic" in name:
        assert rt.cyclic_spectra().shape == rj.cyclic_spectra().shape


def test_chan_hybrid_sk_subints(tmp_path):
    """Chan-hybrid SK with sample-exact -L boundaries inside the shards."""
    cfg_kw = dict(FUSED, nchan=8, frequency_resolution=128, sk_enable=True,
                  sk_m=64)
    probe = ShardedFoldPipeline(
        source("port", _write(tmp_path, "hcsub.raw", 1 << 22), MC),
        tl.FoldConfig(**cfg_kw), port_mesh(2, 2))
    sub = probe.inner.stride_in_samples / RATE * 1.3
    tsh, rj, rt, r1 = three_runs(
        tmp_path, MC, dict(cfg_kw, subint_seconds=sub), 2, 2, nsuper=3,
        name="hcsub.raw", atol=5e-5)
    assert tsh.hybrid_chan and rt.profiles.shape[0] >= 3


def test_chan_hybrid_rfi_needs_two_passes(tmp_path):
    """A channel shard's front end runs the RFI filter in its state-free
    two-pass form only (the sharded pipeline sets it)."""
    pipe = tl.FoldPipeline(
        source("port", _write(tmp_path, "r.raw", 1 << 20), MC),
        tl.FoldConfig(**dict(FUSED, nchan=8, frequency_resolution=128,
                             rfi_filter=True)), device="cpu")
    assert pipe.mega_mode == "hybrid"
    fp = dataclasses.replace(pipe.front_plan, nchan_in=1)
    with pytest.raises(ValueError, match="two passes"):
        pipe.shard_front(fp, pipe.constants)
