"""Cyclic spectroscopy in the port against the JAX package, on the CPU.

- Ops: ``ops.cyclic`` (``lag_products``, ``lag_planes``, ``cyclic_spectra``)
  against ``dspsr_tpu.ops.cyclic`` on the same numpy inputs; the chunked
  lag fold (``fold_lag_products``) against ``fold_block`` of the whole lag
  planes; ``fold_block`` with a trailing partial segment against the JAX
  fold of the zero-weight-padded block (the JAX pipeline's padding).
- The voltage front end: ``megafil_plain(output="voltage")`` in float64
  against the JAX ``build_megafil(output="voltage")`` (its Pallas kernel in
  interpret mode) for real input with several subbands, complex input and
  CASPSR bytes, with the passband tap and a masked chirp handed in, within
  2e-5 relative (the reference's tolerance for its front end); and against
  the JAX package's XLA filterbank, which applies the reference's per-chunk
  ``ifftshift`` itself, so a wrong ``(-1)^t`` sign cannot pass.
- The slice: ``FoldPipeline(cyclic_nchan=...)`` on ``device="cpu"`` against
  the JAX ``FoldPipeline``, both hybrid, at the matched framing of
  ``tests/test_hybrid.py`` (dm 36.5, freq_res 128, nchan 4): profiles and
  cyclic spectra within 2e-4 relative (the pipelines' rule of
  ``test_torch_pipeline.py``), hits exact.
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dspsr_tpu.models import load_to_fold as jl
from dspsr_tpu.ops import cyclic as jcy
from dspsr_tpu.ops import megakernel as jmk
from dspsr_tpu.ops.filterbank import FilterbankPlan, filterbank_block
from dspsr_tpu.ops.fold import FoldPlan as JFoldPlan
from dspsr_tpu.ops.fold import fold_block as jfold_block
from dspsr_tpu.unpack.unpackers import unpack_fixed

from dspsr_tpu_torch.models import load_to_fold as tl
from dspsr_tpu_torch.ops import cyclic as tcy
from dspsr_tpu_torch.ops import megakernel as tmk
from dspsr_tpu_torch.ops.fold import FoldPlan, fold_block
from test_megakernel import RATE
from test_torch_hybrid import _write_rfi
from test_torch_pipeline import plain, raw_source

torch.set_num_threads(2)

NSUB, FREQ_RES, NPART = 4, 64, 3
TOL_FRONT = 2e-5
TOL_PROFILE = 2e-4


def _rel(got, want):
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape
    return np.abs(got - want).max() / np.abs(want).max()


def _voltage(rng, nchan=3, npol=2, ndat=200):
    return (rng.normal(size=(nchan, npol, ndat))
            + 1j * rng.normal(size=(nchan, npol, ndat))).astype(np.complex64)


def _sc(x):
    return jnp.asarray(x.real), jnp.asarray(x.imag)


# ---------------------------------------------------------------- ops


@pytest.mark.parametrize("nlag", [1, 3, 5, 33])
def test_lag_products_and_planes_match_jax(nlag):
    x = _voltage(np.random.default_rng(nlag))
    cr, ci = jcy.lag_products(_sc(x), nlag)
    got = tcy.lag_products(torch.from_numpy(x), nlag).numpy()
    want = np.asarray(cr) + 1j * np.asarray(ci)
    assert got.shape == want.shape == (3, 2, nlag, 200 - nlag + 1)
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)
    planes = tcy.lag_planes(torch.from_numpy(x), nlag).numpy()
    np.testing.assert_allclose(planes, np.asarray(jcy.lag_planes(_sc(x), nlag)),
                               rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("mover,npol", [(1, 1), (1, 2), (2, 1), (2, 2)])
def test_cyclic_spectra_match_jax(mover, npol):
    nlag = tcy.CyclicPlan(8, mover).nlag
    assert nlag == jcy.CyclicPlan(8, mover).nlag == mover * 4 + 1
    folded = np.random.default_rng(mover * 10 + npol).normal(
        size=(3, npol * nlag * 2, 16))
    got = tcy.cyclic_spectra(folded, nlag, mover, npol)
    want = jcy.cyclic_spectra(folded, nlag, mover, npol)
    assert got.shape == (3, npol, 16, 8)
    assert _rel(got, want) < 1e-10


def _anchors(rng, nseg):
    phi0 = rng.uniform(0, 1, nseg).astype(np.float32)
    dphi = np.full(nseg, 0.0137, np.float32)
    return phi0, dphi


def test_fold_lag_products_is_the_fold_of_the_lag_planes(monkeypatch):
    """Built and folded a few lags a pass (here 2), the lag fold equals
    ``fold_block`` of the whole lag planes."""
    rng = np.random.default_rng(3)
    nlag, seg, nbin = 5, 16, 8
    x = torch.from_numpy(_voltage(rng, ndat=100)).to(torch.complex128)
    n = 100 - nlag + 1
    w = torch.from_numpy((rng.uniform(size=(3, n)) > 0.2).astype(np.float64))
    phi0, dphi = (torch.from_numpy(a) for a in _anchors(rng, -(-n // seg)))
    plan = FoldPlan(nbin, seg)
    prof0 = torch.zeros(3, 2 * nlag * 2, nbin, dtype=torch.float64)
    hits0 = torch.zeros(3, nbin, dtype=torch.float64)
    want = fold_block(prof0, hits0, tcy.lag_planes(x, nlag), w, phi0, dphi,
                      plan)
    monkeypatch.setattr(tcy, "LAG_PASS_BYTES", 2 * 3 * 2 * n * 16)
    got = tcy.fold_lag_products(prof0, hits0, x, nlag, w, phi0, dphi, plan)
    assert torch.allclose(got[0], want[0], rtol=1e-12, atol=1e-12)
    assert torch.equal(got[1], want[1])
    assert float(got[1].sum()) == float(w.sum())


@pytest.mark.parametrize("ndat", [96, 100, 7])
def test_fold_block_partial_segment_matches_jax(ndat):
    """Anchors over ``ceil(ndat / seg)`` segments fold every sample; the
    JAX pipeline pads the block to whole segments with zero weights."""
    rng = np.random.default_rng(ndat)
    seg, nbin = 16, 8
    nseg = -(-ndat // seg)
    x = rng.normal(size=(2, 3, ndat)).astype(np.float32)
    w = (rng.uniform(size=(2, ndat)) > 0.2).astype(np.float32)
    phi0, dphi = _anchors(rng, nseg)
    got = fold_block(torch.zeros(2, 3, nbin), torch.zeros(2, nbin),
                     torch.from_numpy(x), torch.from_numpy(w),
                     torch.from_numpy(phi0), torch.from_numpy(dphi),
                     FoldPlan(nbin, seg))
    pad = nseg * seg - ndat
    xp = np.concatenate([x, np.zeros((2, 3, pad), np.float32)], axis=-1)
    wp = np.concatenate([w, np.zeros((2, pad), np.float32)], axis=-1)
    want = jfold_block(jnp.zeros((2, 3, nbin)), jnp.zeros((2, nbin)),
                       jnp.asarray(xp), jnp.asarray(wp), jnp.asarray(phi0),
                       jnp.asarray(dphi), JFoldPlan(nbin, seg))
    assert _rel(got[0].numpy(), want[0]) < 1e-6
    assert np.array_equal(got[1].numpy(), np.asarray(want[1]))
    assert float(got[1].sum()) == float(w.sum())
    # fewer anchors than the block needs: the tail past them is dropped
    short = fold_block(torch.zeros(2, 3, nbin), torch.zeros(2, nbin),
                       torch.from_numpy(x), torch.from_numpy(w),
                       torch.from_numpy(phi0[:1]), torch.from_numpy(dphi[:1]),
                       FoldPlan(nbin, seg))
    assert float(short[1].sum()) == float(w[:, :min(seg, ndat)].sum())


# ---------------------------------------------------------------- front end


def _plan(kind, **kw):
    """The front-end test geometry (nsub 4, freq_res 64, nfilt 5/6) for real
    TFP, complex or CASPSR input (the JAX package's plan)."""
    fb = FilterbankPlan(real_input=kind != "complex", nchan_subband=NSUB,
                        freq_res=FREQ_RES, nfilt_pos=5, nfilt_neg=6)
    if kind == "caspsr":
        kw = dict(dict(interleave="caspsr", twos_complement=True), **kw)
    plan = jmk.MegaPlan.from_filterbank(fb, nbin=2, npol=2, **kw)
    assert plan is not None
    return plan


def _front(kind, seed, **kw):
    plan = _plan(kind, **kw)
    rng = np.random.default_rng(seed)
    raw = rng.integers(0, 256, plan.block_ndat(NPART) * plan.nchan_in
                       * plan.npol * plan.ndim, dtype=np.uint8)
    resp = np.exp(1j * rng.uniform(-3, 3, (plan.nchan_in * NSUB, FREQ_RES)))
    scale, offset = jmk.unpack_affine(8, plan.twos_complement)
    jcst = jmk.MegaConstants(plan, resp, dtype=np.float32,
                             unpack_scale=scale, unpack_offset=offset)
    tplan = tmk.MegaPlan(**dataclasses.asdict(plan))
    cst = tmk.MegaConstants.build(tplan, resp, scale, offset).to("cpu")
    return plan, tplan, raw, resp, jcst, cst


KINDS = ["real", "complex", "caspsr"]


@pytest.mark.parametrize("kind", KINDS)
@pytest.mark.parametrize("variant", ["plain", "passband", "masked_chirp"])
def test_voltage_front_end_matches_pallas(kind, variant):
    """Bare; with the passband tap (and the weights); with the tap and a
    masked chirp handed in."""
    plan, tplan, raw, resp, jcst, cst = _front(kind, 11 + len(kind))
    t = torch.from_numpy(raw)
    tap = variant != "plain"
    kw = dict(output="voltage", passband=tap, return_weights=tap,
              response_as_args=variant == "masked_chirp")
    jargs, args, gr, gi = (), (), None, None
    if variant == "masked_chirp":
        m = (np.random.default_rng(5).uniform(size=(1, plan.n_fft))
             > 0.1).astype(np.float32)
        mr, _ = jmk.permute_response(jnp.asarray(m), jnp.zeros_like(m), plan)
        jargs = (jnp.asarray(jcst.gr) * mr, jnp.asarray(jcst.gi) * mr)
        mt = torch.from_numpy(m)
        args = (cst.gr * mt, cst.gi * mt)
        gr, gi = (a.double() for a in args)
    jout = jmk.build_megafil(plan, jcst, NPART, interpret=True, **kw)(
        jnp.asarray(raw), *jargs)
    out = tmk.build_megafil(tplan, cst, NPART, **kw)(t, *args)
    got = tmk.megafil_plain(tplan, cst, t, NPART, torch.float64,
                            passband=tap, gr=gr, gi=gi, output="voltage")
    if tap:
        (vr, vi), jw, jpb = jout
        data, w, pb = out
        got, pb64 = got
        assert pb.dtype == torch.float32
        assert _rel(pb.numpy(), jpb) < TOL_FRONT
        assert _rel(pb64.numpy(), jpb) < TOL_FRONT
        assert np.array_equal(w.numpy(), np.asarray(jw))
    else:
        vr, vi = jout
        data = out
    assert data.dtype == torch.complex64 and got.dtype == torch.complex128
    assert got.shape == (NSUB, 2, NPART * plan.nkeep)
    # the step on CPU tensors is the plain version in float32
    assert _rel(data.numpy(), got.numpy()) < TOL_FRONT
    want = np.asarray(vr) + 1j * np.asarray(vi)
    assert _rel(got.numpy(), want) < TOL_FRONT


@pytest.mark.parametrize("kind", ["real", "complex"])
def test_voltage_sign_matches_xla_filterbank(kind):
    """The voltage equals the JAX package's XLA filterbank, which takes the
    reference's per-chunk ``ifftshift``; without the ``(-1)^t`` sign the odd
    samples would be negated."""
    plan, tplan, raw, resp, _, cst = _front(kind, 7)
    assert tmk.voltage_sign_flips(tplan)
    got = tmk.megafil_plain(tplan, cst, torch.from_numpy(raw), NPART,
                            torch.float64, output="voltage").numpy()
    fb = FilterbankPlan(real_input=plan.real_input, nchan_subband=NSUB,
                        freq_res=FREQ_RES, nfilt_pos=plan.nfilt_pos,
                        nfilt_neg=plan.nfilt_neg)
    x = unpack_fixed(jnp.asarray(raw), 8, 1, 2, plan.ndim)
    y = filterbank_block(x, fb, NPART, (
        jnp.asarray(np.ascontiguousarray(resp.real), jnp.float32),
        jnp.asarray(np.ascontiguousarray(resp.imag), jnp.float32)))
    want = np.asarray(y[0]) + 1j * np.asarray(y[1])
    assert _rel(got, want) < TOL_FRONT
    # the same samples without the sign are far off
    t = np.arange(plan.nkeep) + plan.nfilt_pos
    unsigned = got.reshape(NSUB, 2, NPART, -1) * (1 - 2 * (t % 2))
    assert _rel(unsigned.reshape(got.shape), want) > 0.5


def test_one_subband_real_voltage_takes_no_sign():
    plan = tmk.MegaPlan(nsub=1, freq_res=256, R1=16, nfilt_pos=16,
                        nfilt_neg=16, nbin=2, npol=2)
    assert not tmk.voltage_sign_flips(plan)
    assert tmk.voltage_sign_flips(dataclasses.replace(plan, nsub=2))
    assert tmk.voltage_sign_flips(dataclasses.replace(plan, real_input=False))


# ---------------------------------------------------------------- slice

#: the matched framing of tests/test_hybrid.py (the mega overlap rounding
#: is a no-op)
CYC = dict(folding_period=0.005, dispersion_measure=36.5, nchan=4,
           frequency_resolution=128, nbin=32, block_parts=2,
           min_block_samples=0, digitizer_stats=False, cyclic_nchan=4)
MAX_BLOCKS = 3


def _complex_file(tmp_path, npol=2, ndat=1 << 14, seed=21):
    """Complex 8-bit bytes (t, pol, re/im) at 2 MHz, a pulse every 5 ms."""
    rng = np.random.default_rng(seed)
    t = np.arange(ndat) / RATE
    x = rng.normal(0, 12, (ndat, npol, 2))
    x[(t % 0.005) < 0.0004] *= 1.5
    p = str(tmp_path / "c.raw")
    np.clip(np.round(x + 127.5), 0, 255).astype(np.uint8).tofile(p)
    return p


def _one_pol_file(tmp_path, ndat=1 << 15, seed=22):
    rng = np.random.default_rng(seed)
    t = np.arange(ndat) / RATE
    x = rng.normal(0, 12, ndat)
    x[(t % 0.005) < 0.0004] *= 1.5
    p = str(tmp_path / "p.raw")
    np.clip(np.round(x + 127.5), 0, 255).astype(np.uint8).tofile(p)
    return p


SLICE = {
    "mover1": (dict(), None),
    "mover2": (dict(cyclic_mover=2), None),
    "sk": (dict(sk_enable=True, sk_m=64, block_parts=4), None),
    "rfi": (dict(rfi_filter=True), None),
    "subints": (dict(subint_seconds=0.002), None),
    "complex": (dict(), dict(state="ANALYTIC", ndim=2)),
    "one_pol": (dict(), dict(npol=1)),
}


@pytest.mark.parametrize("name", list(SLICE))
def test_cyclic_pipeline_matches_jax(tmp_path, name):
    kw, obs_kw = SLICE[name]
    if name == "complex":
        path = _complex_file(tmp_path)
    elif name == "one_pol":
        path = _one_pol_file(tmp_path)
    else:
        path = _write_rfi(tmp_path)
    obs_kw = obs_kw or {}
    cfg = dict(CYC, **kw)
    jp = jl.FoldPipeline(raw_source("jax", path, **obs_kw),
                         jl.FoldConfig(**cfg))
    tp = tl.FoldPipeline(raw_source("port", path, **obs_kw),
                         tl.FoldConfig(**cfg), device="cpu")
    assert jp.mega_mode == tp.mega_mode == "hybrid"
    assert (jp.npart, jp.out_per_block, jp.fold_plan.seg_len) == \
        (tp.npart, tp.out_per_block, tp.fold_plan.seg_len)
    nlag = tp.cyclic_plan.nlag
    assert tp.out_per_block == tp.npart * tp.mega_plan.nkeep - (nlag - 1)
    a, b = jp.run(max_blocks=MAX_BLOCKS), tp.run(max_blocks=MAX_BLOCKS)
    npol_in = 1 if name == "one_pol" else 2
    assert b.obs.npol == a.obs.npol == npol_in * nlag * 2
    assert b.profiles.shape == a.profiles.shape and b.profiles.size
    assert _rel(b.profiles, a.profiles) < TOL_PROFILE
    assert np.array_equal(a.hits, b.hits)
    assert plain(a.obs) == plain(b.obs)
    assert plain(a.epochs) == plain(b.epochs)
    assert np.array_equal(a.integration_length, b.integration_length)
    assert a.signal_path == b.signal_path
    assert {"op": "CyclicFold", "nlag": nlag,
            "mover": tp.cyclic_plan.mover} in b.signal_path
    assert (b.cyclic_nlag, b.cyclic_mover, b.cyclic_npol) == \
        (a.cyclic_nlag, a.cyclic_mover, a.cyclic_npol)
    sa, sb = a.cyclic_spectra(), b.cyclic_spectra()
    assert sb.shape == (b.profiles.shape[0], 4, npol_in, 32, 4)
    assert _rel(sb, sa) < TOL_PROFILE
    if name == "subints":
        assert b.profiles.shape[0] >= 2
    if name == "sk":
        assert 0 < tp.zapped_share()["sk"] < 1
    # every folded output sample is counted once per channel
    folded = MAX_BLOCKS * tp.out_per_block
    if name == "sk":
        assert b.hits[:, 0].sum() < folded
    else:
        assert b.hits[:, 0].sum() == folded


def test_cyclic_result_and_refusals(tmp_path):
    """A detected result has no cyclic spectra; fourth moments of lag
    products are refused, and so is cyclic folding of a real stream with no
    FFT stage at all (nsub == 1 at DM 0: there is no complex voltage; the
    JAX package fails on its first block; at DM > 0 it runs,
    ``test_torch_conv.py``, and complex input runs on the general chain,
    ``test_torch_general.py``)."""
    path = _write_rfi(tmp_path, ndat=1 << 13)
    det = dict(CYC, cyclic_nchan=0)
    res = tl.FoldPipeline(raw_source("port", path), tl.FoldConfig(**det),
                          device="cpu").run(max_blocks=1)
    with pytest.raises(ValueError, match="not a cyclic"):
        res.cyclic_spectra()
    with pytest.raises(ValueError, match="fourth moments"):
        tl.FoldPipeline(raw_source("port", path), tl.FoldConfig(
            **dict(CYC, npol_out=4, fourth_moment=True)), device="cpu")
    real_no_fft = dict(CYC, nchan=1, dispersion_measure=0.0)
    with pytest.raises(ValueError, match="complex voltages"):
        tl.FoldPipeline(raw_source("port", path),
                        tl.FoldConfig(**real_no_fft), device="cpu")
    with pytest.raises(ValueError):
        jl.FoldPipeline(raw_source("jax", path),
                        jl.FoldConfig(**real_no_fft)).run(max_blocks=1)
