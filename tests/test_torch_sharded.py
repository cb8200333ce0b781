"""The port's sharded pipelines (``dspsr_tpu_torch.parallel``) on a mesh of
repeated CPU devices, against the JAX package's ``ShardedFoldPipeline`` and
``ShardedFilPipeline`` on the conftest's 8 virtual CPU devices, and against
the port's single pipeline, case by case as ``tests/test_sharded_pipeline.py``
holds the JAX package's: here the general chain (``use_megakernel=False``)
with time and channel shards, 2-bit excision weights, SK (pooled over the
channel shards), the RFI filter, Jones calibration, sub-integrations on,
off and across superblock edges, Stokes, fourth moments and cyclic folding;
the sharded search bytes and PSRFITS; the refusals, the mesh and the stripe
layout.  The fused engines sharded are in ``test_torch_sharded_fused.py``.

Tolerances are the JAX tests': profiles within 2e-5 (5e-5 for Jones and
cyclic) of their largest value, hits exact, integration lengths to 1e-12,
epochs to 1e-12 days, digitizer counts exact; search bytes within 1 LSB and
at least 99% exact, and exact with ``rescale_constant`` against the single
pipeline.  Each side builds its sources from its own package
(``test_torch_pipeline.plain`` compares its output observations).
"""

import numpy as np
import pytest
import torch

import dspsr_tpu.io.sources as jsrc
import dspsr_tpu.observation as jobs
import dspsr_tpu.timing.mjd as jmjd
from dspsr_tpu.models import load_to_fil as jfil
from dspsr_tpu.models import load_to_fold as jl
from dspsr_tpu.parallel.pipeline import ShardedFoldPipeline as JSharded
from dspsr_tpu.parallel.search import ShardedFilPipeline as JShardedFil
from dspsr_tpu.parallel.sharded import make_mesh as jmesh

import dspsr_tpu_torch.io.sources as tsrc
import dspsr_tpu_torch.observation as tobs
import dspsr_tpu_torch.timing.mjd as tmjd
from dspsr_tpu_torch.models import load_to_fil as tfil
from dspsr_tpu_torch.models import load_to_fold as tl
from dspsr_tpu_torch.parallel.pipeline import ShardedFoldPipeline
from dspsr_tpu_torch.parallel.search import ShardedFilPipeline
from dspsr_tpu_torch.parallel.sharded import Mesh, make_mesh
from test_sharded_pipeline import _write
from test_torch_pipeline import plain

torch.set_num_threads(2)

RATE = 1e6
CPU = torch.device("cpu")
PKGS = {"jax": (jsrc, jobs, jmjd, jl), "port": (tsrc, tobs, tmjd, tl)}
BASE = dict(folding_period=0.004, dispersion_measure=3.0, nchan=4, nbin=32,
            block_parts=2, min_block_samples=0, use_megakernel=False,
            digitizer_stats=True)


def obs(pkg, nbit=8, ndim=1, **kw):
    """``test_sharded_pipeline._obs`` from package ``pkg``'s classes."""
    _, o, m, _ = PKGS[pkg]
    return o.Observation(
        nchan=1, npol=2, ndim=ndim, nbit=nbit, centre_frequency=1400.0,
        bandwidth=-1.0 if ndim == 2 else -2.0, rate=RATE,
        start_time=m.MJD.from_utc("2010-04-13-02:05:45"),
        state=o.Signal.ANALYTIC if ndim == 2 else o.Signal.NYQUIST,
        source="FAKE", telescope="PKS", instrument="RAW").replace(**kw)


def port_mesh(nt, nc=1):
    return make_mesh(nt * nc, nc, devices=[CPU] * (nt * nc))


def source(pkg, path, obs_kw):
    return PKGS[pkg][0].RawFileSource(path, obs(pkg, **obs_kw))


def assert_same(a, b, atol=2e-5):
    """Fold results ``a`` and ``b`` (either package) agree."""
    assert a.profiles.shape == b.profiles.shape
    assert a.profiles.shape[0] > 0
    scale = np.abs(b.profiles).max() + 1e-30
    np.testing.assert_allclose(a.profiles / scale, b.profiles / scale,
                               atol=atol)
    np.testing.assert_array_equal(a.hits, b.hits)
    np.testing.assert_allclose(a.integration_length, b.integration_length,
                               rtol=1e-12)
    assert len(a.epochs) == len(b.epochs)
    for x, y in zip(a.epochs, b.epochs):
        assert abs((x.days - y.days) + (x.fracday() - y.fracday())) < 1e-12
    assert plain(a.obs) == plain(b.obs)
    assert (a.digitizer_counts is None) == (b.digitizer_counts is None)
    if a.digitizer_counts is not None:
        np.testing.assert_array_equal(a.digitizer_counts,
                                      b.digitizer_counts)


def sized_file(tmp_path, obs_kw, cfg, nt, nc, nsuper, name, **write_kw):
    """A file of exactly ``nsuper`` superblocks of the port's geometry
    (probed on a file of 4 MiB first)."""
    probe = ShardedFoldPipeline(
        source("port", _write(tmp_path, name, 1 << 22, **write_kw), obs_kw),
        cfg, port_mesh(nt, nc))
    total = nsuper * probe.superblock_stride + probe.inner.nsamp_overlap
    nbytes = int(round(total * probe.inner.obs_in.nbytes_per_sample))
    return _write(tmp_path, name, nbytes, **write_kw), probe


def three_runs(tmp_path, obs_kw, cfg_kw, nt, nc, nsuper=2, name="d.raw",
               atol=2e-5, **write_kw):
    """The JAX sharded run, the port's sharded run and the port's single run
    (at the sharded run's block geometry) over one file; each port result
    held against the other two.  Returns the port's sharded pipeline and
    the three results."""
    tcfg = tl.FoldConfig(**cfg_kw)
    path, _ = sized_file(tmp_path, obs_kw, tcfg, nt, nc, nsuper, name,
                         **write_kw)
    jsh = JSharded(source("jax", path, obs_kw), jl.FoldConfig(**cfg_kw),
                   jmesh(nt * nc, nc))
    tsh = ShardedFoldPipeline(source("port", path, obs_kw), tcfg,
                              port_mesh(nt, nc))
    assert (tsh.mega, tsh.megask, tsh.mega_chan, tsh.hybrid_chan) == \
        (jsh.mega, jsh.megask, jsh.mega_chan, jsh.hybrid_chan)
    assert tsh.superblock_stride == jsh.superblock_stride
    rj, rt = jsh.run(), tsh.run()
    single = tl.FoldPipeline(source("port", path, obs_kw), tsh.config,
                             device="cpu")
    assert single.mega_mode == tsh.inner.mega_mode
    r1 = single.run()
    assert_same(rt, rj, atol)
    assert_same(rt, r1, atol)
    assert rt.signal_path[-1] == {"op": "ShardedRun", "n_time": nt,
                                  "n_chan": nc}
    return tsh, rj, rt, r1


def jones_file(tmp_path, name):
    """``test_sharded_pipeline``'s calibration database: 64 leaky Jones
    matrices over 1399-1401 MHz."""
    rng = np.random.default_rng(2)
    freqs = np.linspace(1399.0, 1401.0, 64)
    j = np.empty((64, 2, 2), np.complex128)
    for i in range(64):
        a = 0.1 * rng.standard_normal(2)
        j[i] = np.eye(2) + np.array([[0, a[0] + 1j * a[1]],
                                     [a[0] - 1j * a[1], 0]])
    path = tmp_path / name
    np.savez(path, freq=freqs, jones=j)
    return str(path)


#: name -> (observation keywords, config keywords, time shards, chan shards,
#: run keywords): the general-chain cases of test_sharded_pipeline.py
GENERAL = {
    "8bit_time": ({}, {}, 8, 1, {}),
    "chan_general": ({}, {}, 4, 2, {}),
    "twobit_excision": (dict(nbit=2, ndim=2),
                        dict(ndat_per_weight=128, min_block_samples=4096),
                        4, 1, dict(rfi_stretch=(10000, 12000), twobit=True)),
    "sk": ({}, dict(sk_enable=True, sk_m=64), 4, 1, {}),
    "sk_chan": ({}, dict(sk_enable=True, sk_m=64), 2, 2, {}),
    "sk_chan_burst": ({}, dict(sk_enable=True, sk_m=64), 2, 2,
                      dict(rfi_stretch=(20000, 24000))),
    "rfi_filter": ({}, dict(rfi_filter=True), 4, 1, {}),
    "jones": (dict(ndim=2), dict(nchan=1, npol_out=4,
                                 frequency_resolution=128,
                                 dispersion_measure=1.0), 4, 1,
              dict(atol=5e-5)),
    "stokes": ({}, dict(npol_out=4), 4, 2, {}),
    "fourth_moment": ({}, dict(npol_out=4, fourth_moment=True), 4, 1, {}),
    "cyclic": (dict(ndim=2), dict(nchan=1, cyclic_nchan=8, npol_out=1,
                                  frequency_resolution=64,
                                  dispersion_measure=1.0), 4, 1,
               dict(atol=5e-5)),
}


@pytest.mark.parametrize("name", list(GENERAL))
def test_general_chain_matches_jax(tmp_path, name):
    obs_kw, cfg_kw, nt, nc, kw = GENERAL[name]
    cfg_kw = dict(BASE, **cfg_kw)
    if name == "jones":
        cfg_kw["calibration_path"] = jones_file(tmp_path, "cal.npz")
    tsh, rj, rt, r1 = three_runs(tmp_path, obs_kw, cfg_kw, nt, nc, **kw)
    assert tsh.inner.mega_mode is None
    assert rt.hits.max() > 0
    if name == "twobit_excision":
        # healthy blocks survived and the saturated stretch was excised
        assert rt.hits.sum() < rt.profiles.shape[1] * rt.hits.shape[-1] \
            * rt.hits.max()
    if name == "fourth_moment":
        assert rt.profiles.shape[2] == 14
    if name == "cyclic":
        assert rt.cyclic_spectra().shape == rj.cyclic_spectra().shape


@pytest.mark.parametrize("where", ["aligned", "misaligned", "turns"])
def test_subints_match_jax(tmp_path, where):
    """Sub-integration boundaries on superblock edges, inside every
    superblock (1.6 shard blocks), and several inside each superblock
    (--turns 1 over 24 superblocks): divided as the single pipeline
    divides its blocks."""
    probe = ShardedFoldPipeline(
        source("port", _write(tmp_path, "s.raw", 1 << 22), {}),
        tl.FoldConfig(**BASE), port_mesh(4))
    if where == "aligned":
        # slightly under one superblock so the boundary is unambiguous
        seconds = probe.superblock_stride / RATE * 0.98
        kw, nsuper = dict(subint_seconds=seconds), 3
    elif where == "misaligned":
        seconds = probe.inner.stride_in_samples / RATE * 1.6
        kw, nsuper = dict(subint_seconds=seconds), 3
    else:
        kw, nsuper = dict(subint_turns=1), 24
    tsh, rj, rt, r1 = three_runs(tmp_path, {}, dict(BASE, **kw), 4, 1,
                                 nsuper=nsuper, name="s.raw")
    if where == "aligned":
        assert rt.profiles.shape[0] == 4
        for k in range(3):
            assert abs(rt.integration_length[k] - seconds) \
                <= 1.0 / rt.obs.rate
    else:
        assert rt.profiles.shape[0] >= (4 if where == "misaligned" else 3)


# ------------------------------------------------------------------ search

SEARCH = dict(nchan=4, nbits=8, dispersion_measure=2.0,
              min_block_samples=0, block_parts=2)


@pytest.mark.parametrize("constant", [True, False], ids=["c", "I"])
def test_sharded_digifil_bytes(tmp_path, constant):
    """Time-sharded digifil against the JAX sharded run (the 1-LSB rule)
    and, with constant levels (-c), against the single pipeline exactly
    (the sharded output a prefix: the single run may take a trailing
    ragged block the superblock grid drops); -I 0.01 refreshes the scales
    from every shard's statistics."""
    kw = dict(SEARCH, rescale_constant=constant,
              rescale_seconds=0.0 if constant else 0.01)
    probe = ShardedFilPipeline(
        source("port", _write(tmp_path, "sf.raw", 1 << 22), {}),
        tfil.FilConfig(**kw), port_mesh(4))
    total = 3 * probe.superblock_stride + probe.nsamp_overlap
    path = _write(tmp_path, "sf.raw",
                  int(round(total * probe.inner.obs_in.nbytes_per_sample)))
    outs = {k: str(tmp_path / f"{k}.fil") for k in ("j", "t", "one")}
    JShardedFil(source("jax", path, {}), jfil.FilConfig(**kw),
                jmesh(4, 1)).run(outs["j"])
    sh = ShardedFilPipeline(source("port", path, {}), tfil.FilConfig(**kw),
                            port_mesh(4))
    assert plain(sh.run(outs["t"])) == plain(sh.inner.obs_out)
    tfil.FilPipeline(source("port", path, {}), tfil.FilConfig(**kw),
                     device="cpu").run(outs["one"])
    a, b, one = (open(outs[k], "rb").read() for k in ("j", "t", "one"))
    assert len(a) == len(b) > 1000
    diff = np.abs(np.frombuffer(a, np.uint8).astype(np.int64)
                  - np.frombuffer(b, np.uint8).astype(np.int64))
    assert diff.max() <= 1 and (diff == 0).mean() >= 0.99
    if constant:
        assert b == one[:len(b)]


def test_sharded_digifits(tmp_path):
    """digifits sharded: the PSRFITS file against the JAX sharded one, with
    the same rows (the 1-LSB rule on every byte)."""
    path = _write(tmp_path, "sfit.raw", 1 << 21)
    kw = dict(SEARCH, rescale_constant=True)
    JShardedFil(source("jax", path, {}), jfil.FilConfig(**kw),
                jmesh(4, 1)).run(str(tmp_path / "j.sf"), format="psrfits")
    ShardedFilPipeline(source("port", path, {}), tfil.FilConfig(**kw),
                       port_mesh(4)).run(str(tmp_path / "t.sf"),
                                         format="psrfits")
    a = np.fromfile(tmp_path / "j.sf", np.uint8).astype(np.int64)
    b = np.fromfile(tmp_path / "t.sf", np.uint8).astype(np.int64)
    assert a.size == b.size > 0
    diff = np.abs(a - b)
    assert diff.max() <= 1 and (diff == 0).mean() >= 0.99


def test_search_chan_shards_raise(tmp_path):
    path = _write(tmp_path, "sc.raw", 1 << 20)
    with pytest.raises(NotImplementedError, match="chan sharding"):
        ShardedFilPipeline(source("port", path, {}),
                           tfil.FilConfig(**SEARCH), port_mesh(2, 2))


# ---------------------------------------------------------- construction


@pytest.mark.parametrize("kw", [
    dict(additional_pulsars=(0.007,)), dict(passband=True),
    dict(dump_path="/nonexistent/dump.dada"),
    dict(sk_enable=True, sk_also_unzapped=True), dict(pdmp_stats=True)],
    ids=["pulsars", "passband", "dump", "noskz_too", "pdmp"])
def test_sharded_rejects_unsupported_configs(tmp_path, kw):
    """What the sharded accumulators do not carry fails at construction, as
    in the JAX package (whose pdmp extras would not unpack from its step:
    refused here)."""
    path = _write(tmp_path, "rej.raw", 1 << 20)
    with pytest.raises(NotImplementedError, match="not supported sharded"):
        ShardedFoldPipeline(source("port", path, {}),
                            tl.FoldConfig(**dict(BASE, **kw)), port_mesh(4))


def test_make_mesh_shapes():
    m = make_mesh(8, 2, devices=[CPU] * 8)
    assert isinstance(m, Mesh)
    assert m.shape == {"time": 4, "chan": 2} == dict(jmesh(8, 2).shape)
    assert m.device(3, 1) == CPU and m.unique_devices() == [CPU]
    assert make_mesh(devices=[CPU] * 3).shape == {"time": 3, "chan": 1}
    with pytest.raises(ValueError, match="divisible"):
        make_mesh(8, 3, devices=[CPU] * 8)
    with pytest.raises(ValueError, match="only 2 devices"):
        make_mesh(4, devices=[CPU] * 2)


def test_make_mesh_without_a_card_raises(monkeypatch):
    """The default devices are the visible cards; with none, no mesh (and
    no CPU in their place)."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        make_mesh(4)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        make_mesh()


def test_host_stripe_layout_disjoint(tmp_path):
    sh = ShardedFoldPipeline(
        source("port", _write(tmp_path, "l.raw", 1 << 22), {}),
        tl.FoldConfig(**BASE), port_mesh(8))
    stripes, tail = sh.host_stripe_layout(0)
    jsh = JSharded(source("jax", _write(tmp_path, "l.raw", 1 << 22), {}),
                   jl.FoldConfig(**BASE), jmesh(8, 1))
    assert (stripes, tail) == jsh.host_stripe_layout(0)
    ends = [s + n for s, n in stripes]
    assert [s for s, _ in stripes][1:] == ends[:-1]  # contiguous, disjoint
    assert tail == (ends[-1], sh.inner.nsamp_overlap)
    assert sh.local_time_shards() == list(range(8))
