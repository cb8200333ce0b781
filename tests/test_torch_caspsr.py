"""CASPSR-layout 8-bit input through the port (the reference benchmark's own
instrument: two's complement, four consecutive samples of each pol
together; reference ``CASPSRSingleUnpacker.C:103-151``), mirroring
``tests/test_caspsr.py``, against the JAX package on the CPU.

- Unpack plan and the plain reorder: the instrument is detected, the
  reorder equals the JAX package's ``reorder_bytes_tfp`` byte for byte.
- Kernel modules: the plain fused step (float64) against ``mega_reference``
  at 2e-5 with hits exact, and the plain search front end (detected, and
  with the passband tap and a masked chirp) against the JAX
  ``build_megafil`` in interpret mode at 2e-5.
- Slice: a CASPSR file folds (full and hybrid engines) as in the JAX
  package and exactly as the equivalent TFP two's-complement file in the
  port; the search path writes the same bytes as the TFP file and the
  JAX package's (within 1 LSB, at least 99% exact); an ``INSTRUMENT
  CASPSR`` DADA file recovers its pulse end to end.
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import dspsr_tpu.io.sources as jsrc
from dspsr_tpu.models import load_to_fil as jf
from dspsr_tpu.models import load_to_fold as jl
from dspsr_tpu.ops import megakernel as jmk
from dspsr_tpu.ops.filterbank import FilterbankPlan
from dspsr_tpu.unpack.unpackers import reorder_bytes_tfp as jax_reorder

import dspsr_tpu_torch.io.sources as tsrc
from dspsr_tpu_torch.models import load_to_fil as tf
from dspsr_tpu_torch.models import load_to_fold as tl
from dspsr_tpu_torch.ops import megakernel as tmk
from dspsr_tpu_torch.unpack.unpackers import UnpackPlan, reorder_bytes_tfp
from test_caspsr import RATE, _caspsr_bytes
from test_torch_pipeline import make_obs, plain

torch.set_num_threads(2)

NSUB, FREQ_RES, NBIN, NPART = 4, 64, 32, 3
TOL = 2e-5
TOL_PROFILE = 2e-4


def test_unpack_plan_detects_caspsr():
    plan = UnpackPlan(make_obs("port", instrument="CASPSR"))
    assert plan.layout == "caspsr" and plan.twos_complement
    plan = UnpackPlan(make_obs("port"))
    assert plan.layout == "tfp" and not plan.twos_complement
    for kw in (dict(nchan=2), dict(ndim=2, state="ANALYTIC")):
        with pytest.raises(ValueError, match="CASPSR"):
            UnpackPlan(make_obs("port", instrument="CASPSR", **kw))


@pytest.mark.parametrize("npol", [1, 2])
def test_reorder_matches_jax(npol):
    raw = np.random.default_rng(npol).integers(0, 256, 4096 * npol,
                                               dtype=np.uint8)
    got = reorder_bytes_tfp(torch.from_numpy(raw), "caspsr", npol).numpy()
    want = np.asarray(jax_reorder(jnp.asarray(raw), "caspsr", npol))
    assert np.array_equal(got, want)
    signed = raw.view(np.int8).reshape(-1, npol)
    if npol == 2:
        assert np.array_equal(
            reorder_bytes_tfp(torch.from_numpy(_caspsr_bytes(signed)),
                              "caspsr", 2).numpy(), signed.view(np.uint8)
            .reshape(-1))


def _setup(seed, npol=2, twos_complement=True, **kw):
    fb = FilterbankPlan(real_input=True, nchan_subband=NSUB,
                        freq_res=FREQ_RES, nfilt_pos=5, nfilt_neg=6)
    plan = jmk.MegaPlan.from_filterbank(fb, nbin=NBIN, npol=npol,
                                        twos_complement=twos_complement,
                                        interleave="caspsr", **kw)
    rng = np.random.default_rng(seed)
    raw = rng.integers(0, 256, plan.block_ndat(NPART) * npol, dtype=np.uint8)
    resp = np.exp(1j * rng.uniform(-3, 3, (NSUB, FREQ_RES)))
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


def _rel(got, want):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert got.shape == want.shape
    return np.abs(got - want).max() / np.abs(want).max()


@pytest.mark.parametrize("kw", [
    dict(npol_out=1), dict(npol_out=2), dict(npol_out=4),
    dict(npol_out=1, detection="pp"), dict(npol_out=1, detection="qq"),
    dict(npol_out=4, fourth_moment=True), dict(npol=1),
    dict(npol_out=1, twos_complement=False)],
    ids=lambda kw: "-".join(f"{k}={v}" for k, v in kw.items()))
def test_plain_step_matches_reference(kw):
    plan, raw, resp, phi0, dphi = _setup(sum(map(ord, str(kw))), **kw)
    p, h = tmk.megastep_plain(
        _tplan(plan), _port_cst(plan, resp),
        torch.zeros(1, plan.nplane, NSUB, NBIN, dtype=torch.float64),
        torch.zeros(1, NBIN, dtype=torch.float64), torch.from_numpy(raw),
        torch.from_numpy(phi0), torch.from_numpy(dphi))
    pr, hr = jmk.mega_reference(raw, plan, _jax_cst(plan, resp, np.float64),
                                phi0.astype(np.float64),
                                dphi.astype(np.float64), NPART)
    assert _rel(p.numpy(), pr) < TOL
    assert np.array_equal(h.numpy(), hr)


@pytest.mark.parametrize("kw,passband", [
    (dict(), False), (dict(npol_out=2), False), (dict(npol=1), False),
    (dict(), True), (dict(detection="qq"), True)],
    ids=["sum", "ppqq", "one_pol", "sum_passband", "qq_passband"])
def test_megafil_plain_matches_pallas_interpret(kw, passband):
    plan, raw, resp, _, _ = _setup(7, **kw)
    plan = dataclasses.replace(plan, nbin=2)
    jcst = _jax_cst(plan, resp, np.float32)
    cst = _port_cst(plan, resp)
    if not passband:
        want = np.asarray(jmk.build_megafil(plan, jcst, NPART,
                                            interpret=True)(jnp.asarray(raw)))
        got = tmk.megafil_plain(_tplan(plan), cst, torch.from_numpy(raw),
                                NPART, dtype=torch.float64)
        assert _rel(got.numpy(), want) < TOL
        return
    m = (np.random.default_rng(2).uniform(size=(1, plan.n_fft))
         > 0.1).astype(np.float32)
    mr, _ = jmk.permute_response(jnp.asarray(m), jnp.zeros_like(m), plan)
    jdata, jpb = (np.asarray(a) for a in jmk.build_megafil(
        plan, jcst, NPART, interpret=True, passband=True,
        response_as_args=True)(jnp.asarray(raw), jnp.asarray(jcst.gr) * mr,
                               jnp.asarray(jcst.gi) * mr))
    mt = torch.from_numpy(m)
    data, pb = tmk.build_megafil(_tplan(plan), cst, NPART, passband=True,
                                 response_as_args=True)(
        torch.from_numpy(raw), cst.gr * mt, cst.gi * mt)
    assert _rel(data.numpy(), jdata) < TOL
    assert _rel(pb.numpy(), jpb) < TOL


# ---------------------------------------------------------------- slice


def _files(tmp_path, ndat=1 << 15, seed=12345, period=0.005):
    """The same int8 samples as a CASPSR file and as a TFP file (a pulse
    every ``period`` s)."""
    rng = np.random.default_rng(seed)
    t = np.arange(ndat) / RATE
    noise = rng.normal(0, 18, (ndat, 2))
    noise[(t % period) < 0.00025] *= 3.0
    signed = np.clip(np.round(noise), -128, 127).astype(np.int8)
    p_c, p_t = str(tmp_path / "caspsr.raw"), str(tmp_path / "tfp.raw")
    with open(p_c, "wb") as f:
        f.write(_caspsr_bytes(signed).tobytes())
    with open(p_t, "wb") as f:
        f.write(signed.reshape(-1).view(np.uint8).tobytes())
    return p_c, p_t


def _src(pkg, path, **kw):
    return {"jax": jsrc, "port": tsrc}[pkg].RawFileSource(
        path, make_obs(pkg, **dict(dict(instrument="CASPSR"), **kw)))


FOLD = dict(folding_period=0.005, dispersion_measure=5.0, nchan=4, nbin=32,
            block_parts=2, min_block_samples=0, digitizer_stats=False)
SK = dict(sk_enable=True, sk_m=64, frequency_resolution=128, block_parts=4)


@pytest.mark.parametrize("kw", [dict(), dict(npol_out=4), dict(SK)],
                         ids=["full", "full_stokes", "hybrid_sk"])
def test_fold_parity(tmp_path, kw):
    """A CASPSR file folds as in the JAX package, and exactly as the
    equivalent TFP two's-complement file in the port."""
    p_c, p_t = _files(tmp_path)
    cfg = dict(FOLD, **kw)
    jp = jl.FoldPipeline(_src("jax", p_c), jl.FoldConfig(**cfg))
    tp = tl.FoldPipeline(_src("port", p_c), tl.FoldConfig(**cfg),
                         device="cpu")
    assert jp.mega_mode == tp.mega_mode == \
        ("hybrid" if "sk_enable" in kw else "full")
    assert tp.mega_plan.interleave == "caspsr"
    assert tp.mega_plan.twos_complement
    a, b = jp.run(max_blocks=4), tp.run(max_blocks=4)
    assert _rel(b.profiles, a.profiles) < TOL_PROFILE
    assert np.array_equal(a.hits, b.hits)
    assert plain(a.obs) == plain(b.obs) and a.signal_path == b.signal_path
    t = tl.FoldPipeline(_src("port", p_t, instrument="RAW"),
                        tl.FoldConfig(**dict(cfg, twos_complement=True)),
                        device="cpu").run(max_blocks=4)
    assert np.array_equal(t.profiles, b.profiles)
    assert np.array_equal(t.hits, b.hits)


def test_search_parity(tmp_path):
    """digifil over CASPSR input: the same file as the TFP two's-complement
    stream in the port, and as the JAX package's CASPSR run."""
    p_c, p_t = _files(tmp_path)
    cfg = dict(nchan=8, nbits=8, dispersion_measure=5.0, block_parts=2,
               min_block_samples=0)
    out = {}
    for tag, pipe in (
            ("jax", jf.FilPipeline(_src("jax", p_c), jf.FilConfig(**cfg))),
            ("port", tf.FilPipeline(_src("port", p_c), tf.FilConfig(**cfg),
                                    device="cpu")),
            ("tfp", tf.FilPipeline(_src("port", p_t, instrument="RAW"),
                                   tf.FilConfig(**dict(
                                       cfg, twos_complement=True)),
                                   device="cpu"))):
        p = str(tmp_path / f"{tag}.fil")
        pipe.run(p)
        out[tag] = open(p, "rb").read()
        if tag == "port":
            assert pipe.megafil_plan.interleave == "caspsr"
    assert out["port"] == out["tfp"]
    a = np.frombuffer(out["jax"], np.uint8).astype(np.int64)
    b = np.frombuffer(out["port"], np.uint8).astype(np.int64)
    assert a.shape == b.shape and a.size > 0
    diff = np.abs(a - b)
    assert diff.max() <= 1 and (diff == 0).mean() >= 0.99


def test_caspsr_dada_end_to_end(tmp_path):
    """A DADA file with INSTRUMENT CASPSR (the benchmark header's
    instrument) opens through the port's registry, folds on the full engine
    as in the JAX package, and recovers the pulse."""
    from dspsr_tpu.io.dada import format_ascii_header, header_from_observation

    rng = np.random.default_rng(12345)
    ndat = 1 << 17
    t = np.arange(ndat) / RATE
    noise = rng.normal(0, 10, (ndat, 2))
    noise[(t % 0.004) < 0.0002] *= 6.0
    signed = np.clip(np.round(noise), -128, 127).astype(np.int8)
    obs = make_obs("jax", instrument="CASPSR").replace(ndat=ndat)
    path = str(tmp_path / "caspsr.dada")
    with open(path, "wb") as f:
        f.write(format_ascii_header(header_from_observation(obs)))
        f.write(_caspsr_bytes(signed).tobytes())
    cfg = dict(folding_period=0.004, dispersion_measure=5.0, nchan=4,
               nbin=64, block_parts=2, min_block_samples=0,
               digitizer_stats=False)
    src = tsrc.open_source(path)
    assert src.obs.instrument.upper() == "CASPSR"
    pipe = tl.FoldPipeline(src, tl.FoldConfig(**cfg), device="cpu")
    assert pipe.mega_mode == "full" and pipe.mega_plan.interleave == "caspsr"
    res = pipe.run()
    want = jl.FoldPipeline(jsrc.open_source(path), jl.FoldConfig(**cfg)).run()
    assert _rel(res.profiles, want.profiles) < TOL_PROFILE
    assert np.array_equal(res.hits, want.hits)
    prof = res.normalized()[0].sum(axis=(0, 1))
    snr = (prof.max() - np.median(prof)) / (prof.std() + 1e-9)
    assert snr > 1.5
