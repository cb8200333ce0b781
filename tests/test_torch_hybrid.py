"""The port's hybrid fold engine (``mega_mode == "hybrid"``: the fused front
end ``build_megafil`` plus the fold tail in plain PyTorch) against the JAX
package's, on the CPU.

- Kernel module: ``build_megafil(passband=True, return_weights=True,
  response_as_args=True)`` of both packages on the same bytes and the same
  chirp-times-mask response (the JAX package's permuted planes carried over
  by ``convert.response_from_numpy``): data and passband within 2e-5
  relative (the reference's own tolerance for its front end), weights equal.
- Slice: ``FoldPipeline(device="cpu")`` against the JAX ``FoldPipeline``
  over several blocks of 8-bit dual-pol bytes at 2 MHz with interference (a
  narrow-band tone and impulsive bursts), 4 channels: in-stream SK,
  ``-noskz_too``, the carried and the two-pass RFI filter, the passband, two
  extra pulsars, Stokes with fourth moments and SK, NthPower, pdmp moments,
  a dump file and sub-integrations whose boundaries fall mid-block.
  Profiles agree to 2e-4 relative (the rule of ``test_torch_pipeline.py``),
  hits (and so the SK masks, which zero fold weights) and the RFI masks
  exactly; passband, pdmp moments and dump samples to 2e-5 relative.
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dspsr_tpu.models import load_to_fold as jl
from dspsr_tpu.ops import megakernel as jmk

from dspsr_tpu_torch import convert
from dspsr_tpu_torch.models import load_to_fold as tl
from dspsr_tpu_torch.ops import megakernel as tmk
from test_megakernel import RATE
from test_torch_megafil import NPART, _port_cst, _setup, _tplan
from test_torch_pipeline import BASE, plain, raw_source

torch.set_num_threads(2)

TOL_FRONT = 2e-5
TOL_PROFILE = 2e-4
TOL_EXTRA = 2e-5
#: 96 kept samples a window, 4 windows a block: SK cells of 64 fit 6 times
HYB = dict(BASE, frequency_resolution=128, block_parts=4)
SK = dict(sk_enable=True, sk_m=64)
MAX_BLOCKS = 4


def _rel(got, want):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert got.shape == want.shape
    return np.abs(got - want).max() / np.abs(want).max()


# ---------------------------------------------------------------- kernel


def _mask(plan, seed):
    """A random 0/1 zap mask, natural order ``[nchan_in, n_fft]``."""
    rng = np.random.default_rng(seed)
    return (rng.uniform(size=(plan.nchan_in, plan.n_fft)) > 0.1).astype(
        np.float32)


@pytest.mark.parametrize("kw", [
    dict(), dict(npol_out=2), dict(npol_out=4, detection="coherence"),
    dict(detection="pp", npol_out=1), dict(detection="qq", npol_out=1),
    dict(npol=1), dict(nchan_in=2)],
    ids=["sum", "ppqq", "coherence", "pp", "qq", "one_pol", "two_chan"])
def test_megafil_variants_match_pallas(kw):
    plan, raw, resp = _setup(seed=3, **kw)
    scale, offset = jmk.unpack_affine(8)
    jcst = jmk.MegaConstants(plan, resp, dtype=np.float32,
                             unpack_scale=scale, unpack_offset=offset)
    m = _mask(plan, 5)
    mr, _ = jmk.permute_response(jnp.asarray(m), jnp.zeros_like(m), plan)
    jresp = (jnp.asarray(jcst.gr) * mr, jnp.asarray(jcst.gi) * mr)
    jstep = jmk.build_megafil(plan, jcst, NPART, interpret=True,
                              passband=True, return_weights=True,
                              response_as_args=True)
    jdata, jw, jpb = (np.asarray(a) for a in jstep(jnp.asarray(raw), *jresp))

    gr, gi = convert.response_from_numpy(
        [np.asarray(a) for a in jresp], plan, "cpu")
    cst = _port_cst(plan, resp)
    assert torch.equal(gr, cst.gr * torch.from_numpy(m))
    step = tmk.build_megafil(_tplan(plan), cst, NPART, passband=True,
                             return_weights=True, response_as_args=True)
    data, w, pb = step(torch.from_numpy(raw), gr, gi)
    assert data.dtype == pb.dtype == w.dtype == torch.float32
    assert pb.shape == (plan.nchan_in * plan.nsub, plan.npol, plan.freq_res)
    assert _rel(data.numpy(), jdata) < TOL_FRONT
    assert _rel(pb.numpy(), jpb) < TOL_FRONT
    assert np.array_equal(w.numpy(), jw)

    # float64: the same numbers, the mask really zeroes the chirp's bins
    d64, pb64 = tmk.megafil_plain(_tplan(plan), cst, torch.from_numpy(raw),
                                  NPART, dtype=torch.float64, passband=True,
                                  gr=gr.double(), gi=gi.double())
    assert _rel(d64.numpy(), jdata) < TOL_FRONT
    bare = tmk.megafil_plain(_tplan(plan), cst, torch.from_numpy(raw), NPART)
    assert _rel(bare.numpy(), jdata) > 1e-3


def test_megafil_step_outputs():
    """``data[, wgt][, pb]`` in the JAX package's order, the chirp as an
    argument only when asked for."""
    plan, raw, resp = _setup()
    cst = _port_cst(plan, resp)
    t = torch.from_numpy(raw)
    data = tmk.build_megafil(_tplan(plan), cst, NPART)(t)
    d, pb = tmk.build_megafil(_tplan(plan), cst, NPART, passband=True)(t)
    d2, w = tmk.build_megafil(_tplan(plan), cst, NPART,
                              return_weights=True)(t)
    assert torch.equal(data, d) and torch.equal(data, d2)
    assert torch.equal(w, torch.ones(plan.nchan_in, NPART))
    with pytest.raises(TypeError, match="gr, gi"):
        tmk.build_megafil(_tplan(plan), cst, NPART,
                          response_as_args=True)(t)
    with pytest.raises(TypeError, match="gr, gi"):
        tmk.build_megafil(_tplan(plan), cst, NPART)(t, cst.gr, cst.gi)


# ---------------------------------------------------------------- slice


def _write_rfi(tmp_path, ndat=1 << 15, seed=11):
    """8-bit dual-pol real bytes at 2 MHz: noise with a pulse every 5 ms, a
    narrow-band tone in both pols and impulsive bursts."""
    rng = np.random.default_rng(seed)
    t = np.arange(ndat) / RATE
    x = rng.normal(0, 10, (ndat, 2))
    x[(t % 0.005) < 0.0004] *= 1.2
    x += 3.0 * np.cos(2 * np.pi * 0.3711e6 * t)[:, None]
    for t0 in rng.integers(0, ndat - 400, 6):
        x[t0:t0 + 300] *= 5.0
    q = np.clip(np.round(x + 127.5), 0, 255).astype(np.uint8)
    p = str(tmp_path / "rfi.raw")
    q.tofile(p)
    return p


def _pipes(path, **kw):
    cfg = dict(HYB, **kw)
    jp = jl.FoldPipeline(raw_source("jax", path), jl.FoldConfig(**cfg))
    tp = tl.FoldPipeline(raw_source("port", path), tl.FoldConfig(**cfg),
                         device="cpu")
    assert jp.mega_mode == tp.mega_mode == "hybrid"
    assert (jp.npart, jp.out_per_block, jp.nbins) == \
        (tp.npart, tp.out_per_block, tp.nbins)
    return jp, tp


def _assert_results(a, b):
    assert a.profiles.shape == b.profiles.shape and a.profiles.size
    assert _rel(b.profiles, a.profiles) < TOL_PROFILE
    assert np.array_equal(a.hits, b.hits)
    assert plain(a.epochs) == plain(b.epochs)
    assert np.array_equal(a.integration_length, b.integration_length)
    assert plain(a.obs) == plain(b.obs)
    assert a.signal_path == b.signal_path
    assert (a.nbin, a.folding_period, a.dispersion_measure, a.label) == \
        (b.nbin, b.folding_period, b.dispersion_measure, b.label)
    for x, y in (("passband", TOL_EXTRA), ("pdmp_stats", TOL_EXTRA)):
        u, v = getattr(a, x), getattr(b, x)
        assert (u is None) == (v is None), x
        if u is not None:
            assert _rel(v, u) < y, x
    assert a.pdmp_nsamp == b.pdmp_nsamp
    assert len(a.extra_sources or ()) == len(b.extra_sources or ())
    for x, y in zip(a.extra_sources or (), b.extra_sources or ()):
        _assert_results(x, y)


CASES = {
    "sk": dict(SK),
    "sk_ppqq": dict(SK, npol_out=2),
    "sk_range": dict(SK, sk_chan_start=1, sk_chan_end=3, sk_no_tscr=True),
    "noskz_too": dict(SK, sk_also_unzapped=True),
    "rfi_carried": dict(rfi_filter=True),
    "rfi_two_pass": dict(rfi_filter=True, rfi_same_block=True),
    "passband": dict(passband=True),
    "rfi_passband_sk": dict(rfi_filter=True, passband=True, **SK),
    "two_pulsars": dict(additional_pulsars=(0.004, 0.0031)),
    "stokes_fourth_sk": dict(SK, npol_out=4, fourth_moment=True),
    "nthpower": dict(npol_out=3),
    "pdmp": dict(pdmp_stats=True, npol_out=2),
    "subints_sk": dict(SK, subint_seconds=0.002),
    "subints_rfi_pulsars": dict(rfi_filter=True, subint_seconds=0.002,
                                additional_pulsars=(0.0042,)),
}


@pytest.mark.parametrize("name", list(CASES))
def test_hybrid_matches_jax(tmp_path, name):
    path = _write_rfi(tmp_path)
    jp, tp = _pipes(path, **CASES[name])
    a = jp.run(max_blocks=MAX_BLOCKS)
    b = tp.run(max_blocks=MAX_BLOCKS)
    _assert_results(a, b)
    assert b.hits.sum() > 0
    zapped = tp.zapped_share()
    if tp.sk_plan is not None:
        # the interference trips SK cells and leaves others: the masks
        # above were exercised
        assert 0 < zapped["sk"] < 1
        assert b.hits.sum() < b.hits.shape[0] * tp.obs_out.nchan * \
            MAX_BLOCKS * tp.out_per_block
    if "subint_seconds" in CASES[name]:
        assert b.profiles.shape[0] >= 3
    if tp.config.rfi_filter:
        assert 0 < zapped["rfi"] < 0.5
        if not tp.config.rfi_same_block:
            # the carried chirp x mask after the last block, zeros and all
            gr, gi = convert.response_from_numpy(
                [np.asarray(r) for r in jp._rfi_resp], jp.mega_plan, "cpu")
            for j, t in ((gr, tp._rfi_resp[0]), (gi, tp._rfi_resp[1])):
                assert torch.equal(j == 0, t == 0)
                assert torch.allclose(t, j, rtol=0, atol=1e-6)
    if CASES[name].get("sk_also_unzapped"):
        nosk = b.extra_sources[-1]
        assert nosk.label == "nosk"
        assert nosk.hits.sum() > b.hits.sum()


def test_dump_matches_jax(tmp_path):
    path = _write_rfi(tmp_path)
    jd, td = str(tmp_path / "j.dump"), str(tmp_path / "t.dump")
    cfg = dict(SK, npol_out=2)
    jp = jl.FoldPipeline(raw_source("jax", path),
                         jl.FoldConfig(**dict(HYB, dump_path=jd, **cfg)))
    tp = tl.FoldPipeline(raw_source("port", path),
                         tl.FoldConfig(**dict(HYB, dump_path=td, **cfg)),
                         device="cpu")
    assert jp.mega_mode == tp.mega_mode == "hybrid"
    _assert_results(jp.run(max_blocks=MAX_BLOCKS),
                    tp.run(max_blocks=MAX_BLOCKS))
    a, b = (open(p, "rb").read() for p in (jd, td))
    assert len(a) == len(b)
    hdr = 4096
    assert a[:hdr] == b[:hdr]
    x = np.frombuffer(a[hdr:], np.float32)
    y = np.frombuffer(b[hdr:], np.float32)
    assert x.size == MAX_BLOCKS * tp.out_per_block * 4 * 2
    assert _rel(y, x) < TOL_EXTRA


def test_resume_from_jax_hybrid_state(tmp_path):
    """A port pipeline that takes over the JAX pipeline's carried RFI
    response and its per-source accumulators after block 1 ends where the
    JAX pipeline does after block 2 (``convert.response_from_numpy``,
    ``convert.accumulators_from_numpy``)."""
    path = _write_rfi(tmp_path)
    cfg = dict(rfi_filter=True, additional_pulsars=(0.004,))
    jp2, _ = _pipes(path, **cfg)
    want = jp2.run(max_blocks=2)
    jp1, tp = _pipes(path, **cfg)
    jp1.run(max_blocks=1)
    # the JAX pipeline flushed its accumulators into its result; take its
    # state from its sub-integration and its carried response
    prof1 = tuple(np.asarray(p) for p in jp1._subints[0][0])
    hits1 = tuple(np.asarray(h) for h in jp1._subints[0][1])
    tp._profiles, tp._hits = convert.accumulators_from_numpy(prof1, hits1,
                                                             "cpu")
    assert isinstance(tp._profiles, tuple) and len(tp._profiles) == 2
    tp._rfi_resp = convert.response_from_numpy(
        [np.asarray(r) for r in jp1._rfi_resp], tp.mega_plan, "cpu")
    tp._rfi_primed = True
    tp._div_samples = jp1.out_per_block
    tp._first_out_time = tp._div_first_time = tp.output_start_time(0)
    got = tp.run(max_blocks=1, seek_seconds=tp.stride_in_samples / RATE)
    assert _rel(got.profiles, want.profiles) < TOL_PROFILE
    assert np.array_equal(got.hits, want.hits)
    assert np.array_equal(got.extra_sources[0].hits,
                          want.extra_sources[0].hits)


@pytest.mark.parametrize("kw", [
    dict(sk_enable=True), dict(rfi_filter=True),
    dict(additional_pulsars=(0.004,)), dict(passband=True),
    dict(pdmp_stats=True), dict(npol_out=3), dict(dump_path="x.dump")],
    ids=lambda kw: next(iter(kw)))
def test_hybrid_configs_are_hybrid(tmp_path, kw):
    """What raised before the hybrid engine now builds it, on both
    sides; the full engine keeps the rest."""
    path = _write_rfi(tmp_path, ndat=1 << 12)
    if "dump_path" in kw:
        kw = dict(dump_path=str(tmp_path / kw["dump_path"]))
    jp = jl.FoldPipeline(raw_source("jax", path),
                         jl.FoldConfig(**dict(BASE, **kw)))
    tp = tl.FoldPipeline(raw_source("port", path),
                         tl.FoldConfig(**dict(BASE, **kw)), device="cpu")
    assert jp.mega_mode == tp.mega_mode == "hybrid"
    assert dataclasses.asdict(tp.mega_plan) == \
        dataclasses.asdict(jp.mega_plan)
    full = tl.FoldPipeline(raw_source("port", path), tl.FoldConfig(**BASE),
                           device="cpu")
    assert full.mega_mode == "full"


@pytest.mark.parametrize("ext", [".npz", ".sf"])
def test_archive_of_hybrid_result(tmp_path, ext):
    """A hybrid result with a passband, pdmp moments and an extra pulsar
    through the port's own archive writers, against the JAX package's
    writers on its own result: the same layout, the values to the slice's
    tolerances."""
    from dspsr_tpu.io.archive import save_archive as jsave

    from dspsr_tpu_torch.io.archive import load_archive, save_archive

    path = _write_rfi(tmp_path)
    jp, tp = _pipes(path, passband=True, pdmp_stats=True, npol_out=2,
                    additional_pulsars=(0.004,))
    a, b = jp.run(max_blocks=2), tp.run(max_blocks=2)
    ja, ta = str(tmp_path / f"j{ext}"), str(tmp_path / f"t{ext}")
    jsave(ja, a)
    save_archive(ta, b)
    save_archive(str(tmp_path / f"x{ext}"), b.extra_sources[0])
    if ext == ".sf":
        # FITS: the same headers and tables; the values differ in the last
        # bits, so only the layout is held to bytes
        x, y = (open(p, "rb").read() for p in (ja, ta))
        assert len(x) == len(y) and x[:2880] == y[:2880]
        assert b"BANDPASS" in y
        return
    u, v = load_archive(ja), load_archive(ta)
    assert sorted(u) == sorted(v) and u["meta"] == v["meta"]
    assert _rel(v["profiles"], u["profiles"]) < TOL_PROFILE
    assert np.array_equal(v["hits"], u["hits"])
    assert _rel(v["pdmp_stats"], u["pdmp_stats"]) < TOL_EXTRA
    assert v["pdmp_nsamp"] == u["pdmp_nsamp"] == 2 * tp.out_per_block
