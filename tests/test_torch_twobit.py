"""JA98 2-bit input (Jenet & Anderson 1998 dynamic output levels with
excision weights) in the port against the JAX package on the CPU.

- ``unpack/twobit.py``'s tables equal the JAX copy bit for bit;
- ``bytes_to_codes`` and ``unpack_twobit_dynamic`` equal the JAX unpack
  exactly;
- the plain fused step (``megastep_plain``, float64) equals the JAX
  package's ``mega_reference`` to 2e-5 relative with hits exact, real and
  complex, with windows excised; one case against the Pallas kernel in
  interpret mode;
- the plain front end (``megafil_plain``) with its weights output against
  ``build_megafil`` in interpret mode;
- ``FoldPipeline(device="cpu")`` against the JAX ``FoldPipeline`` on a
  complex 2-bit file with a saturated stretch, on the full engine and on
  the hybrid engine (``sk_enable``), profiles to 2e-4 relative and hits
  exact; ``FilPipeline`` refuses JA98 input as the JAX package sends it to
  its XLA chain.

The module's helpers (``setup``, ``port_step``, ``reference_step`` ...)
serve ``test_torch_subbyte.py`` too: they build one block of any code
kind and both packages' constants from the same arrays.
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dspsr_tpu.ops import megakernel as jmk
from dspsr_tpu.ops.filterbank import FilterbankPlan
from dspsr_tpu.unpack import twobit as jtb
from dspsr_tpu.unpack import unpackers as jup

from dspsr_tpu_torch import convert
from dspsr_tpu_torch.ops import apodization as tap
from dspsr_tpu_torch.ops import megakernel as tmk
from dspsr_tpu_torch.unpack import twobit as ttb
from dspsr_tpu_torch.unpack import unpackers as tup
from test_megakernel import _twobit_bytes
from test_torch_pipeline import PKGS, make_obs, plain

torch.set_num_threads(2)

NSUB, FREQ_RES, NPOL, NBIN, NPART = 4, 64, 2, 32, 3
NPW = 16  # divides row_len (32 real, 16 complex) at this geometry
TOL = 2e-5


def codes_bytes(rng, ncodes, nbit):
    """Random packed bytes holding ``ncodes`` codes of ``nbit`` bits."""
    return rng.integers(0, 256, size=ncodes * nbit // 8, dtype=np.uint8)


def pack2(codes):
    """2-bit codes (a multiple of 4 of them) packed four a byte, the first
    in the most significant bits."""
    c = np.asarray(codes, np.uint8).reshape(-1, 4)
    return ((c[:, 0] << 6) | (c[:, 1] << 4) | (c[:, 2] << 2) | c[:, 3]
            ).astype(np.uint8)


def clean_twobit_codes(rng, ndat, ndig, npw):
    """2-bit codes ``[ndat, ndig]`` (TFP order) in which every
    ``npw``-sample block of every digitizer holds a number of low codes (1
    or 2) drawn from inside the JA98 keep range, so that no block is
    excised by chance; the signs are random."""
    lo, hi = ttb.TwoBitCorrection(npw).nlow_range
    nblk = ndat // npw
    nlow = rng.integers(lo, hi + 1, size=(ndig, nblk, 1))
    rank = np.argsort(rng.random((ndig, nblk, npw)), axis=-1)
    low = rank < nlow
    pos = rng.random((ndig, nblk, npw)) < 0.5
    codes = np.where(low, np.where(pos, 2, 1), np.where(pos, 3, 0))
    return codes.reshape(ndig, ndat).T.astype(np.uint8)


def setup(nbit=8, real=True, npw=0, nchan_in=1, twos=False, window=None,
          npol=NPOL, seed=0, rfi=(), **kw):
    """One block of the test geometry for code kind ``nbit`` (32: float32
    samples), JA98 when ``npw``: returns ``(plan, jraw, traw, resp, phi0,
    dphi, win)``, where ``jraw`` is what the JAX package takes (float32
    values for 32-bit input, else bytes) and ``traw`` the port's bytes.
    JA98 codes are clean (``clean_twobit_codes``) but for ``rfi``, a list
    of code index spans ``(a, b)`` saturated to code 3; ``window`` names an
    apodization window."""
    rng = np.random.default_rng(seed)
    fb = FilterbankPlan(real_input=real, nchan_subband=NSUB,
                        freq_res=FREQ_RES, nfilt_pos=5, nfilt_neg=6)
    plan = jmk.MegaPlan.from_filterbank(
        fb, nbin=NBIN, npol=npol, nbit=nbit, nchan_in=nchan_in,
        ndat_per_weight=npw, twos_complement=twos, **kw)
    assert plan is not None and plan.npw == npw
    ncodes = plan.block_ndat(NPART) * nchan_in * npol * plan.ndim
    if nbit == 32:
        jraw = rng.normal(0, 3, ncodes).astype(np.float32)
        traw = jraw.view(np.uint8)
    elif npw:
        ndig = nchan_in * npol * plan.ndim
        codes = clean_twobit_codes(rng, ncodes // ndig, ndig, npw).reshape(-1)
        for a, b in rfi:
            codes[a:b] = 3
        jraw = traw = pack2(codes)
    else:
        jraw = traw = codes_bytes(rng, ncodes, nbit)
    resp = np.exp(1j * rng.uniform(-3, 3, (nchan_in * NSUB, FREQ_RES)))
    phi0 = rng.uniform(0, 1, NPART).astype(np.float32)
    dphi = np.full(NPART, 0.013, np.float32)
    win = (None if window is None else
           tap.build_window(tap.WindowType(window), plan.nsamp_fft))
    return plan, jraw, traw, resp, phi0, dphi, win


def tplan_of(plan):
    return tmk.MegaPlan(**dataclasses.asdict(plan))


def _affine(plan):
    if plan.npw:
        return 1.0, 0.0
    return jmk.unpack_affine(plan.nbit, plan.twos_complement)


def port_cst(plan, resp, win=None, device="cpu"):
    scale, offset = _affine(plan)
    tb = ttb.TwoBitCorrection(plan.npw) if plan.npw else None
    return tmk.MegaConstants.build(tplan_of(plan), resp, scale, offset,
                                   twobit=tb, window=win).to(device)


def jax_cst(plan, resp, win=None, dtype=np.float64):
    scale, offset = _affine(plan)
    tb = jtb.TwoBitCorrection(plan.npw) if plan.npw else None
    return jmk.MegaConstants(plan, resp, dtype=dtype, unpack_scale=scale,
                             unpack_offset=offset, twobit=tb, window=win)


def port_step(plan, jraw, traw, resp, phi0, dphi, win, cst=None,
              dtype=torch.float64):
    cst = port_cst(plan, resp, win) if cst is None else cst
    p, h = tmk.megastep_plain(
        tplan_of(plan), cst,
        torch.zeros(plan.nchan_in, plan.nplane, NSUB, NBIN, dtype=dtype),
        torch.zeros(plan.nchan_in, NBIN, dtype=dtype), torch.from_numpy(traw),
        torch.from_numpy(phi0), torch.from_numpy(dphi))
    return p.numpy(), h.numpy()


def reference_step(plan, jraw, traw, resp, phi0, dphi, win):
    return jmk.mega_reference(jraw, plan, jax_cst(plan, resp, win),
                              phi0.astype(np.float64),
                              dphi.astype(np.float64), NPART)


def pallas_step(plan, jraw, traw, resp, phi0, dphi, win):
    step = jmk.build_megastep(plan, jax_cst(plan, resp, win, np.float32),
                              NPART, interpret=True)
    p, h = step(jnp.zeros((plan.nchan_in, plan.nplane, NSUB, NBIN)),
                jnp.zeros((plan.nchan_in, NBIN)), jnp.asarray(traw),
                jnp.asarray(phi0), jnp.asarray(dphi))
    return np.asarray(p), np.asarray(h)


def port_front(plan, jraw, traw, resp, phi0, dphi, win, output="detected",
               dtype=torch.float64):
    """``megafil_plain`` with the weights output: ``(data, weights)``, the
    voltage as its (re, im) pair."""
    data, w = tmk.megafil_plain(tplan_of(plan), port_cst(plan, resp, win),
                                torch.from_numpy(traw), NPART, dtype=dtype,
                                output=output, return_weights=True)
    if output == "voltage":
        data = (data.real.numpy(), data.imag.numpy())
    else:
        data = data.numpy()
    return data, w.numpy()


def pallas_front(plan, jraw, traw, resp, phi0, dphi, win, output="detected"):
    step = jmk.build_megafil(plan, jax_cst(plan, resp, win, np.float32),
                             NPART, interpret=True, return_weights=True,
                             output=output)
    data, w = step(jnp.asarray(traw))
    if output == "voltage":
        data = (np.asarray(data[0]), np.asarray(data[1]))
    else:
        data = np.asarray(data)
    return data, np.asarray(w)


def close(got, want, tol=TOL):
    (pg, hg), (pw, hw) = got, want
    assert pg.shape == pw.shape and hg.shape == hw.shape
    assert np.abs(pg - pw).max() / np.abs(pw).max() < tol
    assert np.abs(hg - hw).max() == 0


def close_front(got, want, tol=TOL):
    (dg, wg), (dw, ww) = got, want
    if isinstance(dw, tuple):
        scale = max(np.abs(dw[0]).max(), np.abs(dw[1]).max())
        for a, b in zip(dg, dw):
            assert a.shape == b.shape
            assert np.abs(a - b).max() / scale < tol
    else:
        assert dg.shape == dw.shape
        assert np.abs(dg - dw).max() / np.abs(dw).max() < tol
    assert np.array_equal(wg, ww)


# ---- tables and decode ----


@pytest.mark.parametrize("npw", [16, 64, 256, 512])
def test_tables_equal_jax(npw):
    a, b = ttb.TwoBitCorrection(npw), jtb.TwoBitCorrection(npw)
    assert a.nlow_range == b.nlow_range
    for x, y in zip(a.level_tables, b.level_tables):
        assert x.dtype == y.dtype == np.float32
        assert np.array_equal(x.view(np.uint32), y.view(np.uint32))
    assert np.array_equal(a.weight_table, b.weight_table)


@pytest.mark.parametrize("nbit", [1, 2, 4, 8])
def test_bytes_to_codes_equal_jax(nbit):
    raw = np.random.default_rng(nbit).integers(0, 256, 997, dtype=np.uint8)
    got = tup.bytes_to_codes(torch.from_numpy(raw), nbit).numpy()
    assert np.array_equal(got, np.asarray(jup.bytes_to_codes(
        jnp.asarray(raw), nbit)))


@pytest.mark.parametrize("nchan,ndim", [(1, 1), (1, 2), (2, 1), (2, 2)],
                         ids=["real-1", "complex-1", "real-2", "complex-2"])
def test_unpack_twobit_dynamic_equal_jax(nchan, ndim):
    """Levels and weights exactly, with a saturated stretch excised."""
    npw, ndat = 64, 4096
    rng = np.random.default_rng(nchan * 10 + ndim)
    ncodes = ndat * nchan * NPOL * ndim
    raw = _twobit_bytes(rng, ncodes // 4, rfi=(ncodes // 3,
                                               ncodes // 3 + 8 * npw))
    jt, tt = jtb.TwoBitCorrection(npw), ttb.TwoBitCorrection(npw)
    jx, jw = jup.unpack_twobit_dynamic(
        jnp.asarray(raw), *(jnp.asarray(t) for t in jt.level_tables),
        jnp.asarray(jt.weight_table), nchan, NPOL, ndim, npw)
    tx, tw = tup.unpack_twobit_dynamic(
        torch.from_numpy(raw), *(torch.from_numpy(t) for t in tt.level_tables),
        torch.from_numpy(tt.weight_table), nchan, NPOL, ndim, npw)
    jx = jx if ndim == 2 else (jx,)
    tx = tx if ndim == 2 else (tx,)
    for a, b in zip(tx, jx):
        assert np.array_equal(a.numpy(), np.asarray(b))
    assert np.array_equal(tw.numpy(), np.asarray(jw))
    assert tw.min() == 0 and tw.max() == 1


def test_twobit_plain_counts_and_weights():
    """The plain JA98 pre-pass: nlow per digitizer block, and the window
    weights the least block weight over each window's span."""
    plan, jraw, traw, *_ = setup(nbit=2, npw=NPW, real=False,
                                 rfi=[(2000, 2100)])
    tplan = tplan_of(plan)
    cst = port_cst(plan, None)
    codes = tup.bytes_to_codes(torch.from_numpy(traw), 2).reshape(
        -1, 1, NPOL, 2).permute(1, 2, 3, 0)
    nlow, wwin = tmk.twobit_plain(tplan, cst, codes, NPART)
    c = codes.numpy()
    want = ((c == 1) | (c == 2)).reshape(1, NPOL, 2, -1, NPW).sum(-1)
    assert np.array_equal(nlow.numpy(), want)
    wd = ttb.TwoBitCorrection(NPW).weight_table[want].reshape(1, 4, -1).min(1)
    spans = tmk.window_weight_spans(tplan, NPART)
    assert spans == jmk.window_weight_spans(plan, NPART)
    assert np.array_equal(wwin.numpy()[0], [wd[0, a:b].min() for a, b in spans])
    assert wwin.min() == 0 and wwin.max() == 1


# ---- the fused step and front end ----


def _excised(plan, traw):
    w = tmk.megafil_plain(tplan_of(plan), port_cst(plan, None),
                          torch.from_numpy(traw), NPART,
                          return_weights=True)[1]
    return w.numpy()


@pytest.mark.parametrize("real,nchan_in,npol_out", [
    (True, 1, 1), (False, 1, 1), (True, 2, 4), (False, 2, 2)],
    ids=["real", "complex", "real-2chan-stokes", "complex-2chan-ppqq"])
def test_step_matches_reference(real, nchan_in, npol_out):
    ndim = 1 if real else 2
    ncodes_t = nchan_in * NPOL * ndim  # codes a time sample
    # saturate two blocks of the first channel's pol 0 in window 0 only
    args = setup(nbit=2, npw=NPW, real=real, nchan_in=nchan_in,
                 npol_out=npol_out, seed=11 + nchan_in,
                 rfi=[(t * ncodes_t, t * ncodes_t + 1)
                      for t in range(8, 8 + 2 * NPW)])
    w = _excised(args[0], args[2])
    assert w[0, 0] == 0 and w[0, 1:].min() == 1
    assert nchan_in == 1 or w[1].min() == 1
    close(port_step(*args), reference_step(*args))


def test_step_matches_pallas_interpret():
    args = setup(nbit=2, npw=NPW, real=False, seed=5,
                 rfi=[(4 * t, 4 * t + 4) for t in range(500, 540)])
    got = port_step(*args, dtype=torch.float32)
    close(got, pallas_step(*args))
    assert got[1].sum() < NPART * args[0].nkeep  # a window was excised


@pytest.mark.parametrize("output", ["detected", "voltage"])
def test_front_end_weights_match_pallas_interpret(output):
    args = setup(nbit=2, npw=NPW, real=False, seed=9,
                 rfi=[(4 * t, 4 * t + 4) for t in range(100, 130)])
    got = port_front(*args, output=output)
    close_front(got, pallas_front(*args, output=output))
    assert got[1].min() == 0 and got[1].max() == 1


def test_jax_constants_through_convert():
    """The JAX package's JA98 constants (twobit, the chirp) carried over."""
    args = setup(nbit=2, npw=NPW, real=False, seed=3,
                 rfi=[(4 * t, 4 * t + 4) for t in range(100, 130)])
    plan, resp = args[0], args[3]
    jc = jax_cst(plan, resp, dtype=np.float32)
    cst = convert.constants_from_numpy(
        {"gr": jc.gr, "gi": jc.gi, "twobit": jc.twobit}, plan, "cpu")
    assert torch.equal(cst.twobit, port_cst(plan, resp).twobit)
    close(port_step(*args, cst=cst), reference_step(*args))
    with pytest.raises(ValueError, match="twobit"):
        convert.constants_from_numpy({"gr": jc.gr, "gi": jc.gi}, plan, "cpu")


def test_constants_check_npw():
    plan = setup(nbit=2, npw=NPW)[0]
    with pytest.raises(ValueError, match="ndat_per_weight"):
        tmk.MegaConstants.build(tplan_of(plan), None,
                                twobit=ttb.TwoBitCorrection(2 * NPW))
    cst = tmk.MegaConstants.build(tplan_of(plan), None)
    assert cst.twobit.shape == (3, NPW + 1)


def test_cuda_wrappers_refuse_cpu_tensors():
    from dspsr_tpu_torch.kernels.megastep import ja98_cuda

    plan, jraw, traw, resp, *_ = setup(nbit=2, npw=NPW)
    with pytest.raises(ValueError, match="CUDA"):
        ja98_cuda(tplan_of(plan), port_cst(plan, resp),
                  torch.from_numpy(traw), NPART)


# ---- pipelines ----


RATE = 2e6
FOLD = dict(folding_period=0.00513, nbin=32, block_parts=2,
            min_block_samples=0, digitizer_stats=True)


def twobit_file(tmp_path, nsamp=1 << 16, seed=31, stretch=(40000, 44096)):
    """A complex 2-bit dual-pol file (one channel) with a saturated
    stretch of ``stretch`` codes (as ``test_megakernel.py``'s JA98
    pipeline test)."""
    raw = _twobit_bytes(np.random.default_rng(seed), nsamp, rfi=stretch)
    path = str(tmp_path / "tb.raw")
    raw.tofile(path)
    return path


def twobit_source(pkg, path, **kw):
    obs = make_obs(pkg, nbit=2, ndim=2, state="ANALYTIC", bandwidth=-1.0,
                   **kw)
    return PKGS[pkg][0].RawFileSource(path, obs)


def assert_same(a, b, tol=2e-4):
    assert a.profiles.shape == b.profiles.shape
    assert np.abs(b.profiles - a.profiles).max() / \
        np.abs(a.profiles).max() < tol
    assert np.array_equal(a.hits, b.hits)
    assert plain(a.epochs) == plain(b.epochs)
    assert plain(a.obs) == plain(b.obs)
    assert a.signal_path == b.signal_path
    if a.digitizer_counts is not None or b.digitizer_counts is not None:
        assert np.array_equal(a.digitizer_counts, b.digitizer_counts)


def run_both(src_fn, mode, **cfg):
    from dspsr_tpu.models import load_to_fold as jl
    from dspsr_tpu_torch.models import load_to_fold as tl

    jp = jl.FoldPipeline(src_fn("jax"), jl.FoldConfig(**cfg))
    tp = tl.FoldPipeline(src_fn("port"), tl.FoldConfig(**cfg), device="cpu")
    assert jp.mega_mode == tp.mega_mode == mode
    if mode is not None:
        assert dataclasses.asdict(jp.mega_plan) == \
            dataclasses.asdict(tp.mega_plan)
    return jp.run(), tp.run(), tp


@pytest.mark.parametrize("mode,kw", [
    ("full", dict(dispersion_measure=0.0, nchan=16,
                  frequency_resolution=256, ndat_per_weight=64)),
    ("full", dict(dispersion_measure=2.0, nchan=8, frequency_resolution=256,
                  npol_out=4, ndat_per_weight=32)),
    ("hybrid", dict(dispersion_measure=0.0, nchan=16,
                    frequency_resolution=256, sk_enable=True, sk_m=64,
                    ndat_per_weight=64)),
], ids=["full", "full-dm-stokes", "hybrid-sk"])
def test_fold_pipeline_matches_jax(tmp_path, mode, kw):
    """A complex 2-bit JA98 stream with a saturated stretch: excised
    windows lose their hits in both packages alike."""
    path = twobit_file(tmp_path)
    a, b, tp = run_both(lambda pkg: twobit_source(pkg, path), mode,
                        **dict(FOLD, **kw))
    assert tp.mega_plan.npw == kw["ndat_per_weight"]
    assert_same(a, b)
    # excision visible: fewer hits than output samples, none lost
    nout = round(b.integration_length.sum() * b.obs.rate)
    assert 0 < b.hits[:, 0].sum() < nout


def test_fixed_levels_when_asked(tmp_path):
    """dynamic_twobit=False: the fixed BitTable map, no JA98 plan."""
    path = twobit_file(tmp_path)
    a, b, tp = run_both(lambda pkg: twobit_source(pkg, path), "full",
                        **dict(FOLD, dispersion_measure=0.0, nchan=16,
                               frequency_resolution=256,
                               dynamic_twobit=False))
    assert tp.mega_plan.npw == 0 and tp.unpack_plan.twobit is None
    assert_same(a, b)


def test_npw_not_dividing_row_raises(tmp_path):
    """npw that does not divide the row: ``MegaPlan.from_filterbank``
    returns None, and both packages take their general chain, once refused
    here; the saturated stretch is excised alike.  (With DM > 0: without
    an overlap the JAX chain cannot frame a block that JA98 shortens to
    whole weight blocks, ROADMAP Queue 3.)"""
    path = twobit_file(tmp_path)
    a, b, tp = run_both(lambda pkg: twobit_source(pkg, path), None,
                        **dict(FOLD, dispersion_measure=2.0, nchan=8,
                               frequency_resolution=256, ndat_per_weight=48))
    assert_same(a, b)
    nout = round(b.integration_length.sum() * b.obs.rate)
    assert 0 < b.hits[:, 0].sum() < nout


def test_twos_complement_ja98_raises(tmp_path):
    """JA98 with two's complement, once refused here: both packages run it
    on their general chain, whose JA98 unpack reads the codes as offset
    binary (ROADMAP Queue 3)."""
    path = twobit_file(tmp_path)
    cfg = dict(FOLD, dispersion_measure=0.0, nchan=16,
               frequency_resolution=256, twos_complement=True)
    a, b, tp = run_both(lambda pkg: twobit_source(pkg, path), None, **cfg)
    assert_same(a, b)
    off = run_both(lambda pkg: twobit_source(pkg, path), None,
                   **dict(cfg, twos_complement=False, use_megakernel=False))
    assert np.array_equal(off[1].profiles, b.profiles)
