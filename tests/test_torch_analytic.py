"""Complex (analytic) 8-bit input through the port, against the JAX package
on the CPU.

- Kernel modules: the port's plain fused step (float64) against the JAX
  package's float64 ``mega_reference``, and (float32) against its Pallas
  kernel in interpret mode; the plain search front end (detected, and with
  the passband tap and a masked chirp) against the JAX ``build_megafil`` in
  interpret mode.  All with a random-phase chirp, so a chirp or spectrum
  misplaced by the complex input's ``N/2`` centring cannot pass.  Tolerance
  2e-5 relative (``tests/test_megakernel.py:80-81, 102-103``), hits exact.
- The chirp carried over from the JAX package (``convert``), which also
  undoes its ``-N/2`` roll: bitwise.
- Readers: GUPPI RAW and two-thread VDIF complex 8-bit blocks reach the
  pipelines in TFP order with the right byte count.
- Slice: a complex DADA file (``tests/test_pipeline.py::synth_pulsar_dada``)
  through ``FoldPipeline`` (full engine and hybrid with in-stream SK:
  profiles 2e-4, hits exact) and ``FilPipeline`` (header equal, bytes
  within 1 LSB, at least 99% exact), and GUPPI and VDIF files through
  ``FoldPipeline``.
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import dspsr_tpu.io.sources as jsrc
from dspsr_tpu.io.sigproc import read_sigproc_header
from dspsr_tpu.models import load_to_fil as jf
from dspsr_tpu.models import load_to_fold as jl
from dspsr_tpu.ops import megakernel as jmk
from dspsr_tpu.ops.filterbank import FilterbankPlan

import dspsr_tpu_torch.io.sources as tsrc
from dspsr_tpu_torch import convert
from dspsr_tpu_torch.models import load_to_fil as tf
from dspsr_tpu_torch.models import load_to_fold as tl
from dspsr_tpu_torch.ops import megakernel as tmk
from test_formats import make_guppi, make_vdif_multithread
from test_pipeline import synth_pulsar_dada
from test_torch_pipeline import plain

torch.set_num_threads(2)

NSUB, FREQ_RES, NBIN, NPART = 4, 64, 32, 3
TOL = 2e-5
TOL_PROFILE = 2e-4


def _plan(nsub=NSUB, freq_res=FREQ_RES, npol=2, nchan_in=1, **kw):
    fb = FilterbankPlan(real_input=False, nchan_subband=nsub,
                        freq_res=freq_res, nfilt_pos=5, nfilt_neg=6)
    plan = jmk.MegaPlan.from_filterbank(fb, nbin=NBIN, npol=npol,
                                        nchan_in=nchan_in, **kw)
    assert plan is not None and not plan.real_input and plan.ndim == 2
    return plan


def _setup(seed, **kw):
    """A complex plan, one block of random bytes, a random-phase chirp and
    the fold anchors."""
    plan = _plan(**kw)
    rng = np.random.default_rng(seed)
    nci = plan.nchan_in
    raw = rng.integers(0, 256, plan.block_ndat(NPART) * nci * plan.npol * 2,
                       dtype=np.uint8)
    resp = np.exp(1j * rng.uniform(-3, 3, (nci * plan.nsub, plan.freq_res)))
    phi0 = rng.uniform(0, 1, NPART).astype(np.float32)
    dphi = np.full(NPART, 0.013, np.float32)
    return plan, raw, resp, phi0, dphi


def _tplan(plan):
    return tmk.MegaPlan(**dataclasses.asdict(plan))


def _port_cst(plan, resp):
    scale, offset = tmk.unpack_affine(8, plan.twos_complement)
    return tmk.MegaConstants.build(_tplan(plan), resp, scale, offset).to(
        "cpu")


def _jax_cst(plan, resp, dtype):
    scale, offset = jmk.unpack_affine(8, plan.twos_complement)
    return jmk.MegaConstants(plan, resp, dtype=dtype, unpack_scale=scale,
                             unpack_offset=offset)


def _port_step(plan, raw, resp, phi0, dphi, dtype, cst=None):
    cst = _port_cst(plan, resp) if cst is None else cst
    nci = plan.nchan_in
    p, h = tmk.megastep_plain(
        _tplan(plan), cst,
        torch.zeros(nci, plan.nplane, plan.nsub, NBIN, dtype=dtype),
        torch.zeros(nci, NBIN, dtype=dtype), torch.from_numpy(raw),
        torch.from_numpy(phi0), torch.from_numpy(dphi))
    return p.numpy(), h.numpy()


def _close(got, want, tol=TOL):
    (pg, hg), (pw, hw) = got, want
    assert pg.shape == pw.shape and hg.shape == hw.shape
    assert np.abs(pg - pw).max() / np.abs(pw).max() < tol
    assert np.abs(hg - hw).max() == 0


STEP_CASES = [
    dict(npol_out=1), dict(npol_out=2), dict(npol_out=1, detection="pp"),
    dict(npol_out=1, detection="qq"),
    dict(npol_out=4, detection="coherence"),
    dict(npol_out=4, fourth_moment=True), dict(npol=1, npol_out=1),
    dict(npol_out=4, nchan_in=2), dict(npol_out=1, twos_complement=True),
]


@pytest.mark.parametrize("kw", STEP_CASES, ids=lambda kw: "-".join(
    f"{k}={v}" for k, v in kw.items()))
def test_plain_step_matches_reference(kw):
    plan, raw, resp, phi0, dphi = _setup(sum(map(ord, str(kw))), **kw)
    got = _port_step(plan, raw, resp, phi0, dphi, torch.float64)
    want = jmk.mega_reference(raw, plan, _jax_cst(plan, resp, np.float64),
                              phi0.astype(np.float64),
                              dphi.astype(np.float64), NPART)
    _close(got, want)
    assert got[1].sum() == NPART * plan.nkeep * plan.nchan_in


@pytest.mark.parametrize("kw", [dict(npol_out=4, detection="coherence"),
                                dict(npol_out=1, nchan_in=2)],
                         ids=["coherence", "two_chan"])
def test_plain_step_matches_pallas_interpret(kw):
    plan, raw, resp, phi0, dphi = _setup(3, **kw)
    got = _port_step(plan, raw, resp, phi0, dphi, torch.float32)
    step = jmk.build_megastep(plan, _jax_cst(plan, resp, np.float32), NPART,
                              interpret=True)
    nci = plan.nchan_in
    p, h = step(jnp.zeros((nci, plan.nplane, plan.nsub, NBIN)),
                jnp.zeros((nci, NBIN)), jnp.asarray(raw), jnp.asarray(phi0),
                jnp.asarray(dphi))
    _close(got, (np.asarray(p), np.asarray(h)))


FRONT_CASES = {
    "sum": dict(), "pp": dict(detection="pp"), "ppqq": dict(npol_out=2),
    "coherence": dict(npol_out=4, detection="coherence"),
    "stokes": dict(npol_out=4), "one_pol": dict(npol=1),
    "two_chan": dict(nchan_in=2), "twos": dict(twos_complement=True),
    "wide": dict(nsub=1, freq_res=256),
}


def _rel(got, want):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert got.shape == want.shape
    return np.abs(got - want).max() / np.abs(want).max()


@pytest.mark.parametrize("name", list(FRONT_CASES))
def test_megafil_plain_matches_pallas_interpret(name):
    plan, raw, resp, _, _ = _setup(sum(map(ord, name)), **FRONT_CASES[name])
    plan = dataclasses.replace(plan, nbin=2)
    got = tmk.megafil_plain(_tplan(plan), _port_cst(plan, resp),
                            torch.from_numpy(raw), NPART,
                            dtype=torch.float64).numpy()
    step = jmk.build_megafil(plan, _jax_cst(plan, resp, np.float32), NPART,
                             interpret=True)
    assert _rel(got, np.asarray(step(jnp.asarray(raw)))) < TOL


@pytest.mark.parametrize("name", ["sum", "pp", "ppqq", "coherence",
                                  "two_chan"])
def test_megafil_passband_and_masked_chirp_match_pallas(name):
    """The hybrid front end on complex input: the passband (centred natural
    order) and a chirp times a zap mask handed in, against the JAX kernel
    fed the same response through its permutation (``permute_response``),
    carried over by ``convert.response_from_numpy``."""
    plan, raw, resp, _, _ = _setup(5, **FRONT_CASES[name])
    plan = dataclasses.replace(plan, nbin=2)
    jcst = _jax_cst(plan, resp, np.float32)
    m = (np.random.default_rng(9).uniform(size=(plan.nchan_in, plan.n_fft))
         > 0.1).astype(np.float32)
    mr, _ = jmk.permute_response(jnp.asarray(m), jnp.zeros_like(m), plan)
    jresp = (jnp.asarray(jcst.gr) * mr, jnp.asarray(jcst.gi) * mr)
    jstep = jmk.build_megafil(plan, jcst, NPART, interpret=True,
                              passband=True, return_weights=True,
                              response_as_args=True)
    jdata, jw, jpb = (np.asarray(a) for a in jstep(jnp.asarray(raw), *jresp))
    gr, gi = convert.response_from_numpy([np.asarray(a) for a in jresp],
                                         plan, "cpu")
    cst = _port_cst(plan, resp)
    assert torch.equal(gr, cst.gr * torch.from_numpy(m))
    assert torch.equal(gi, cst.gi * torch.from_numpy(m))
    data, w, pb = tmk.build_megafil(_tplan(plan), cst, NPART, passband=True,
                                    return_weights=True,
                                    response_as_args=True)(
        torch.from_numpy(raw), gr, gi)
    assert pb.shape == (plan.nchan_in * plan.nsub, plan.npol, plan.freq_res)
    assert _rel(data.numpy(), jdata) < TOL
    assert _rel(pb.numpy(), jpb) < TOL
    assert np.array_equal(w.numpy(), jw)


@pytest.mark.parametrize("name", ["test", "two_channel", "flagship"])
def test_chirp_bitwise_and_convert(name):
    """The port's natural-order chirp is the JAX package's after undoing
    its [k1, k2] permutation AND its -N/2 roll, bit for bit, on its own and
    through ``convert.constants_from_numpy``."""
    if name == "flagship":
        obs = _analytic_obs("port", rate=400e6, bandwidth=-400.0,
                            centre_frequency=1382.0, instrument="DUMMY",
                            ndat=1 << 40)
        pipe = tl.FoldPipeline(tsrc.DummySource(obs), tl.FoldConfig(
            folding_period=0.00575745, dispersion_measure=2.64, nchan=64,
            nbin=1024, block_parts=8, min_block_samples=1 << 24),
            device="cpu")
        plan, resp = pipe.mega_plan, pipe.kernel.phasors
        assert (plan.R1, plan.R2, plan.row_len, pipe.npart) == \
            (512, 512, 512, 75)
    else:
        plan = _plan(npol_out=4, nchan_in=2 if name == "two_channel" else 1)
        resp = np.exp(1j * np.random.default_rng(1).uniform(
            -3, 3, (plan.nchan_in * NSUB, FREQ_RES)))
    jplan = jmk.MegaPlan(**dataclasses.asdict(plan))
    jcst = _jax_cst(jplan, resp, np.float32)
    tcst = tmk.MegaConstants.build(_tplan(jplan), resp,
                                   *tmk.unpack_affine(8))
    n, N = plan.nchan_in, plan.n_fft
    for jarr, tarr in ((jcst.gr, tcst.gr), (jcst.gi, tcst.gi)):
        natural = np.roll(np.ascontiguousarray(jarr.transpose(0, 2, 1))
                          .reshape(n, N), N // 2, axis=1)
        assert tarr.shape == natural.shape
        assert np.array_equal(tarr.view(np.uint32), natural.view(np.uint32))
    conv = convert.constants_from_numpy({"gr": jcst.gr, "gi": jcst.gi},
                                        _tplan(jplan), "cpu")
    own = tcst.to("cpu")
    assert torch.equal(conv.gr, own.gr) and torch.equal(conv.gi, own.gi)
    back = convert.response_from_numpy((jcst.gr, jcst.gi), _tplan(jplan),
                                       "cpu")
    assert torch.equal(back[0], own.gr) and torch.equal(back[1], own.gi)


# ---------------------------------------------------------------- readers


def test_guppi_and_vdif_blocks_in_tfp_order(tmp_path):
    """Complex 8-bit blocks of both readers are TFP bytes ``[t, chan, pol,
    (re, im)]``, ``npol * 2`` bytes a sample per channel, as the JAX
    package's readers give them."""
    g = str(tmp_path / "g.raw")
    blocks = make_guppi(g, nblocks=2, ntime=64, nchan=2)
    for pkg in (jsrc, tsrc):
        src = pkg.open_source(g)
        o = src.obs
        assert (o.nchan, o.npol, o.ndim, o.nbit) == (2, 2, 2, 8)
        a = src.read_samples(60, 8)
        assert a.size == 8 * 2 * 2 * 2
        a = a.reshape(8, 2, 4)
        for i in range(8):
            blk, t = divmod(60 + i, 64)
            for c in range(2):
                assert np.array_equal(a[i, c], blocks[blk][c, 4 * t:4 * t + 4])
    v = str(tmp_path / "v.vdif")
    data = make_vdif_multithread(v, nthread=2, nframes_per_thread=4)
    want = np.stack([data[0].reshape(-1, 2), data[1].reshape(-1, 2)], axis=1)
    for pkg in (jsrc, tsrc):
        src = pkg.open_source(v)
        assert (src.obs.npol, src.obs.ndim) == (2, 2)
        got = src.read_samples(500, 30)
        assert np.array_equal(got, want[500:530].reshape(-1))
    assert np.array_equal(tsrc.open_source(v).read_samples(0, 2048),
                          jsrc.open_source(v).read_samples(0, 2048))


# ---------------------------------------------------------------- slice


def _analytic_obs(pkg, **kw):
    """A complex dual-pol 8-bit Observation from package ``pkg``."""
    from test_torch_pipeline import make_obs

    return make_obs(pkg, state="ANALYTIC", ndim=2, **kw)


FOLD = dict(folding_period=0.005, dispersion_measure=5.0, nchan=4, nbin=32,
            block_parts=2, min_block_samples=0, digitizer_stats=False)
SK = dict(sk_enable=True, sk_m=64, frequency_resolution=128, block_parts=4)


@pytest.fixture(scope="module")
def dada(tmp_path_factory):
    """A complex 8-bit DADA file with a pulse dispersed at DM 5."""
    p = tmp_path_factory.mktemp("analytic") / "c.dada"
    return synth_pulsar_dada(str(p), nsec=0.05, dm=5.0)


def _assert_same(a, b):
    assert a.profiles.shape == b.profiles.shape and a.profiles.size
    assert _rel(b.profiles, a.profiles) < TOL_PROFILE
    assert np.array_equal(a.hits, b.hits)
    assert plain(a.obs) == plain(b.obs)
    assert a.signal_path == b.signal_path
    assert plain(a.epochs) == plain(b.epochs)


@pytest.mark.parametrize("kw", [dict(), dict(npol_out=4),
                                dict(SK), dict(SK, npol_out=2,
                                               rfi_filter=True)],
                         ids=["full", "full_stokes", "hybrid_sk",
                              "hybrid_sk_rfi"])
def test_fold_pipeline_matches_jax(dada, kw):
    cfg = dict(FOLD, **kw)
    jp = jl.FoldPipeline(jsrc.open_source(dada), jl.FoldConfig(**cfg))
    tp = tl.FoldPipeline(tsrc.open_source(dada), tl.FoldConfig(**cfg),
                         device="cpu")
    assert jp.mega_mode == tp.mega_mode == \
        ("hybrid" if "sk_enable" in kw else "full")
    assert dataclasses.asdict(tp.mega_plan) == \
        dataclasses.asdict(jp.mega_plan)
    assert not tp.mega_plan.real_input
    a, b = jp.run(max_blocks=4), tp.run(max_blocks=4)
    _assert_same(a, b)
    assert b.hits.sum() > 0
    if "sk_enable" in kw:
        assert 0 < tp.zapped_share()["sk"] < 1


def test_fold_pipeline_recovers_the_pulse(dada):
    """The dispersed pulse folds to the phase it was injected at
    (``PULSE_PHASE`` 0.3 of ``tests/test_pipeline.py``), on both sides."""
    cfg = dict(FOLD, nbin=50)
    res = [jl.FoldPipeline(jsrc.open_source(dada),
                           jl.FoldConfig(**cfg)).run(),
           tl.FoldPipeline(tsrc.open_source(dada), tl.FoldConfig(**cfg),
                           device="cpu").run()]
    peaks = [int(np.argmax(r.dedispersed()[0].sum(axis=(0, 1))))
             for r in res]
    assert peaks[0] == peaks[1]
    assert abs(peaks[1] / 50 - 0.3) < 0.05


def test_fil_pipeline_matches_jax(dada, tmp_path):
    cfg = dict(nchan=4, dispersion_measure=5.0, block_parts=2,
               min_block_samples=0)
    out = {}
    for tag, pipe in (
            ("jax", jf.FilPipeline(jsrc.open_source(dada),
                                   jf.FilConfig(**cfg))),
            ("port", tf.FilPipeline(tsrc.open_source(dada),
                                    tf.FilConfig(**cfg), device="cpu"))):
        p = str(tmp_path / f"{tag}.fil")
        pipe.run(p)
        _, hdr = read_sigproc_header(p)
        blob = open(p, "rb").read()
        out[tag] = (blob[:hdr], np.frombuffer(blob[hdr:], np.uint8))
        if tag == "port":
            assert not pipe.megafil_plan.real_input
            assert pipe._blocks_done >= 3
    assert out["jax"][0] == out["port"][0]
    a, b = out["jax"][1].astype(np.int64), out["port"][1].astype(np.int64)
    assert a.shape == b.shape and a.size > 0
    diff = np.abs(a - b)
    assert diff.max() <= 1 and (diff == 0).mean() >= 0.99


@pytest.mark.parametrize("fmt", ["guppi", "vdif"])
def test_guppi_and_vdif_fold_match_jax(tmp_path, fmt):
    """GUPPI RAW (two channels, each its own filterbank) and two-thread VDIF
    (two pols) files fold on the full engine as in the JAX package.
    GUPPI's int8 samples are two's complement: the pipelines take that from
    ``FoldConfig.twos_complement``, as the JAX package does."""
    p = str(tmp_path / f"x.{fmt}")
    if fmt == "guppi":
        make_guppi(p, nblocks=8, ntime=4096, nchan=2)
        cfg = dict(FOLD, folding_period=0.001, dispersion_measure=1.0,
                   nchan=8, nbin=16, twos_complement=True,
                   frequency_resolution=64)
    else:
        make_vdif_multithread(p, nthread=2, nframes_per_thread=64)
        with open(p + ".hdr", "w") as f:
            f.write("FREQ 1400\nBW -2\nTELESCOPE PKS\nSOURCE FAKE\n")
        cfg = dict(FOLD, folding_period=0.004, dispersion_measure=1.0,
                   nbin=16, frequency_resolution=64)
    jp = jl.FoldPipeline(jsrc.open_source(p), jl.FoldConfig(**cfg))
    tp = tl.FoldPipeline(tsrc.open_source(p), tl.FoldConfig(**cfg),
                         device="cpu")
    assert jp.mega_mode == tp.mega_mode == "full"
    assert not tp.mega_plan.real_input
    _assert_same(jp.run(), tp.run())
