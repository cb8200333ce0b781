"""The ``nsub == 1`` convolution (pure coherent dedispersion per input
channel, the ``hybrid_conv32`` cell's path) in the port, on the CPU:

- ``ops.convolution.OverlapSavePlan`` against the JAX package's;
- the plain front end at ``nsub == 1`` (``megafil_plain``) against the JAX
  package's ``build_megafil`` (its Pallas kernel in interpret mode), real
  and complex input, detected and voltage output, with the passband tap and
  a masked chirp: 2e-5 relative (the reference's own front-end tolerance);
- a float64 numpy mirror of the CUDA multi-pass inverse at nsub == 1
  (``mega_inva`` in ``csrc/mega_common.cuh``, ``megafil_invb`` in
  ``csrc/megafil.cu``; nsub > 1 in ``test_torch_multipass.py``): the k/n split,
  the length-R2 and length-R1 passes on the register-FFT mirror of
  ``test_torch_fourstep.py``, the twiddle from the lo/hi tables of the
  geometry (R1, R2, N), the tile walk, the time-order store index and the
  voltage sign, held to 1e-12 against ``numpy.fft.ifft`` and to the plain
  front end;
- the wrapper's choice of inverse (one CTA while it fits, multi-pass past
  it at any nsub, forced by an argument);
- ``FoldPipeline`` at ``nsub == 1`` against the JAX ``FoldPipeline`` (its
  hybrid engine): Intensity, Stokes, PPQQ with sub-integrations, the RFI
  filter (carried masks exact), cyclic folding (with SK), ``-K`` and
  complex input, at 2e-4 with hits exact.
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dspsr_tpu.models import load_to_fold as jl
from dspsr_tpu.ops import convolution as jconv
from dspsr_tpu.ops import megakernel as jmk
from dspsr_tpu.ops.filterbank import FilterbankPlan

from dspsr_tpu_torch import convert
from dspsr_tpu_torch.kernels.megafil import INVB_ROWS, inverse_passes
from dspsr_tpu_torch.kernels.megastep import INVA_COLS
from dspsr_tpu_torch.kernels.megastep import MAX_THREADS, twiddle_tables
from dspsr_tpu_torch.models import load_to_fold as tl
from dspsr_tpu_torch.ops import convolution as tconv
from dspsr_tpu_torch.ops import megakernel as tmk
from test_torch_fourstep import Geom, _raw, mirror_forward
from test_torch_multipass import inva_mirror, invb_mirror, tables_m
from test_torch_hybrid import _assert_results, _write_rfi
from test_torch_pipeline import BASE, raw_source

torch.set_num_threads(2)

TOL = 2e-5
TOL_MIRROR = 1e-12
NPART = 3


def _rel(got, want):
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape
    return np.abs(got - want).max() / np.abs(want).max()


# ------------------------------------------------------------------ plan


@pytest.mark.parametrize("args", [(True, 1024, 100, 60), (False, 512, 7, 0),
                                  (True, 64, 0, 0), (False, 1 << 19, 29710,
                                                     31730)])
def test_overlap_save_plan_matches_jax(args):
    j, t = jconv.OverlapSavePlan(*args), tconv.OverlapSavePlan(*args)
    assert dataclasses.asdict(j) == dataclasses.asdict(t)
    for name in ("nfilt_tot", "nsamp_fft", "nsamp_overlap", "nsamp_step",
                 "nkeep_c"):
        assert getattr(j, name) == getattr(t, name), name
    for n in (0, t.nsamp_overlap, t.nsamp_overlap + 1, 10 * t.nsamp_fft):
        assert j.npart(n) == t.npart(n)
        assert j.block_ndat(n % 7) == t.block_ndat(n % 7)
        assert j.output_ndat(n % 7) == t.output_ndat(n % 7)
    t.validate()


def test_overlap_save_plan_refuses_what_jax_refuses():
    for args in ((True, 1, 0, 0), (False, 64, 40, 24)):
        for mod in (jconv, tconv):
            with pytest.raises(ValueError):
                mod.OverlapSavePlan(*args).validate()


# ------------------------------------------------------------- front end


def conv_plan(real=True, freq_res=256, npol=2, nchan_in=1, **kw):
    """A JAX ``MegaPlan`` of the one-subband geometry (nfilt 5/6)."""
    fb = FilterbankPlan(real_input=real, nchan_subband=1, freq_res=freq_res,
                        nfilt_pos=5, nfilt_neg=6)
    plan = jmk.MegaPlan.from_filterbank(fb, nbin=2, npol=npol,
                                        nchan_in=nchan_in, **kw)
    assert plan is not None and plan.nsub == 1
    return plan


def _inputs(plan, seed):
    rng = np.random.default_rng(seed)
    raw = rng.integers(0, 256, size=plan.block_ndat(NPART) * plan.nchan_in
                       * plan.npol * plan.ndim, dtype=np.uint8)
    resp = np.exp(1j * rng.uniform(-3, 3, (plan.nchan_in, plan.freq_res)))
    mask = (rng.uniform(size=(plan.nchan_in, plan.n_fft)) > 0.1).astype(
        np.float32)
    return raw, resp, mask


FRONT_CASES = {
    "real_sum": dict(),
    "real_stokes": dict(npol_out=4),
    "real_one_pol": dict(npol=1),
    "complex_sum": dict(real=False),
    "complex_coherence": dict(real=False, npol_out=4, detection="coherence"),
    "complex_two_chan": dict(real=False, nchan_in=2, npol_out=2),
    "real_voltage": dict(output="voltage"),
    "complex_voltage": dict(real=False, output="voltage"),
}


@pytest.mark.parametrize("name", list(FRONT_CASES))
@pytest.mark.parametrize("tap", [False, True], ids=["bare", "masked_tap"])
def test_front_end_matches_pallas(name, tap):
    kw = dict(FRONT_CASES[name])
    output = kw.pop("output", "detected")
    plan = conv_plan(freq_res=512 if kw.get("real", True) else 256, **kw)
    raw, resp, mask = _inputs(plan, len(name))
    scale, offset = jmk.unpack_affine(8)
    jcst = jmk.MegaConstants(plan, resp, dtype=np.float32,
                             unpack_scale=scale, unpack_offset=offset)
    tplan = tmk.MegaPlan(**dataclasses.asdict(plan))
    cst = tmk.MegaConstants.build(tplan, resp, scale, offset).to("cpu")
    if tap:
        mr, _ = jmk.permute_response(jnp.asarray(mask), jnp.zeros_like(mask),
                                     plan)
        jresp = (jnp.asarray(jcst.gr) * mr, jnp.asarray(jcst.gi) * mr)
        jstep = jmk.build_megafil(plan, jcst, NPART, interpret=True,
                                  output=output, passband=True,
                                  response_as_args=True)
        jdata, jpb = jstep(jnp.asarray(raw), *jresp)
        gr, gi = convert.response_from_numpy([np.asarray(a) for a in jresp],
                                             tplan, "cpu")
        assert torch.equal(gr, cst.gr * torch.from_numpy(mask))
        step = tmk.build_megafil(tplan, cst, NPART, output=output,
                                 passband=True, response_as_args=True)
        data, pb = step(torch.from_numpy(raw), gr, gi)
        assert _rel(pb.numpy(), np.asarray(jpb)) < TOL
    else:
        jdata = jmk.build_megafil(plan, jcst, NPART, interpret=True,
                                  output=output)(jnp.asarray(raw))
        data = tmk.build_megafil(tplan, cst, NPART,
                                 output=output)(torch.from_numpy(raw))
    if output == "voltage":
        jdata = np.asarray(jdata[0]) + 1j * np.asarray(jdata[1])
        assert data.dtype == torch.complex64
        assert data.shape == (plan.nchan_in, plan.npol, NPART * plan.nkeep)
    assert _rel(data.numpy(), np.asarray(jdata)) < TOL


def test_voltage_sign_rule_at_nsub_1():
    """One subband of real input has no (-1)^t factor (the convolution's
    convention); complex input has it (its spectra are centred)."""
    assert not tmk.voltage_sign_flips(
        tmk.MegaPlan(**dataclasses.asdict(conv_plan())))
    assert tmk.voltage_sign_flips(
        tmk.MegaPlan(**dataclasses.asdict(conv_plan(real=False))))


# ------------------------------------------------- the multi-pass mirror


def mirror_multipass(ybuf, R1, R2, nchan, nout, nfilt_pos, nkeep, flip,
                     ta, tb_rows, jones=None, jpol0=0):
    """The multi-pass inverse at nsub == 1 (q = R2, M = N) on the mirrors
    of ``test_torch_multipass.py``: ``mega_inva``'s tile walk of ``ta``
    columns (with a Jones response ``jones`` [nchan, 4, N], both output
    pols mixed in its stages from the two stored input pols, each read
    once), every zbuf element written once, then ``megafil_invb``'s tiles
    of ``tb_rows`` rows.  ybuf is [nchan*nin, npart, N] (nin 2 with Jones,
    else nout); returns out [nchan*nout, npart, nkeep] (1/N, the (-1)^t
    sign when ``flip``) and how often each output sample was written."""
    tb = tables_m(R1, R2)
    z, zw = inva_mirror(ybuf, R1, R2, R2, tb, ta, nout=nout, jones=jones,
                        jpol0=jpol0)
    assert (zw == 1).all()
    assert z.shape[0] == nchan * nout
    out, writes = invb_mirror(z, R1, R2, R2, tb, tb_rows, nfilt_pos, nkeep,
                              flip, nout=nout)
    return out[:, :, 0], writes[:, :, 0]


MIRROR_CASES = [
    dict(R1=R1, R2=R2, ta=ta, tb=tb, flip=flip)
    for R1, R2 in ((8, 8), (16, 32), (64, 8), (64, 64))
    for ta, tb in ((1, 1), (min(INVA_COLS, R1), min(INVB_ROWS[0], R2)),
                   (2, min(INVB_ROWS[1], R2)), (R1, 2))
    for flip in (0, 1)
]


@pytest.mark.parametrize("case", MIRROR_CASES, ids=lambda c: "-".join(
    f"{k}{v}" for k, v in c.items()))
def test_multipass_mirror_matches_ifft(case):
    """Every kept sample of every sequence and window is written once and
    equals numpy's length-N ifft of the stored spectrum, signed."""
    R1, R2 = case["R1"], case["R2"]
    N = R1 * R2
    rng = np.random.default_rng(R1 + 7 * R2)
    ybuf = rng.normal(size=(4, 2, N)) + 1j * rng.normal(size=(4, 2, N))
    nfilt_pos, nkeep = 3, N - 3 - 5
    got, writes = mirror_multipass(ybuf, R1, R2, 2, 2, nfilt_pos, nkeep,
                                   case["flip"], case["ta"], case["tb"])
    assert (writes == 1).all()
    t = np.arange(nfilt_pos, nfilt_pos + nkeep)
    sign = np.where(case["flip"] & t & 1, -1.0, 1.0)
    want = np.fft.ifft(ybuf, axis=-1)[..., nfilt_pos:nfilt_pos + nkeep]
    assert _rel(got, want * sign) < TOL_MIRROR


@pytest.mark.parametrize("jpol0,nout", [(0, 2), (0, 1), (1, 1)])
def test_multipass_mirror_jones_mix(jpol0, nout):
    """With a Jones response the load mixes the two stored pols per output
    pol (``out_bin``)."""
    R1, R2, nchan = 16, 8, 2
    N = R1 * R2
    rng = np.random.default_rng(jpol0 + 3 * nout)
    ybuf = rng.normal(size=(2 * nchan, 2, N)) + 1j * rng.normal(
        size=(2 * nchan, 2, N))
    J = rng.normal(size=(nchan, 4, N)) + 1j * rng.normal(size=(nchan, 4, N))
    got, _ = mirror_multipass(ybuf, R1, R2, nchan, nout, 0, N, 0, 8, 4,
                              jones=J, jpol0=jpol0)
    x = ybuf.reshape(nchan, 2, 2, N)
    for q in range(nout):
        p = jpol0 + q
        y = J[:, 2 * p, None] * x[:, 0] + J[:, 2 * p + 1, None] * x[:, 1]
        assert _rel(got.reshape(nchan, nout, 2, N)[:, q],
                    np.fft.ifft(y, axis=-1)) < TOL_MIRROR


def _geom(plan, pols):
    g = Geom(R1=plan.R1, R2=plan.R2, M=plan.freq_res, nchan=plan.nchan_in,
             npol=plan.npol, pols=pols, npart=NPART, step=plan.nsamp_step,
             cplx=not plan.real_input)
    g.scale, g.offset = tmk.unpack_affine(8)
    return g


@pytest.mark.parametrize("real", [True, False], ids=["real", "complex"])
@pytest.mark.parametrize("jones", [False, True], ids=["chirp", "jones"])
def test_multipass_mirror_matches_plain_front_end(real, jones):
    """The forward mirror of ``test_torch_fourstep.py`` and the multi-pass
    mirror give the port's float64 plain voltage at nsub == 1, with the
    sign of ``voltage_sign_flips``, with or without the Jones mix."""
    plan = tmk.MegaPlan(**dataclasses.asdict(conv_plan(real=real,
                                                       nchan_in=2)))
    rng = np.random.default_rng(5)
    g = _geom(plan, (0, 1))
    raw = _raw(g, rng)
    resp = np.exp(1j * rng.uniform(-3, 3, (2, plan.freq_res)))
    J = (rng.normal(size=(2, plan.n_fft, 2, 2))
         + 1j * rng.normal(size=(2, plan.n_fft, 2, 2))) if jones else None
    cst = tmk.MegaConstants.build(plan, resp, g.scale, g.offset,
                                  jones=J).to("cpu")
    chirp = cst.gr.double().numpy() + 1j * cst.gi.double().numpy()
    tile = min(8, plan.R1 // 2) if real else min(8, plan.R1)
    ybuf, writes = mirror_forward(g, raw, chirp, tile)
    assert (writes == 1).all()
    jn = None
    if jones:
        jn = torch.view_as_complex(cst.jones.double()).numpy()
    got, w = mirror_multipass(ybuf, plan.R1, plan.R2, 2, 2, plan.nfilt_pos,
                              plan.nkeep, int(tmk.voltage_sign_flips(plan)),
                              8, 4, jones=jn)
    assert (w == 1).all()
    want = tmk._front_plain(plan, cst, torch.from_numpy(raw), NPART,
                            torch.float64, voltage=True)[0].numpy()
    assert _rel(got, want[:, :, :, 0].reshape(got.shape)) < TOL_MIRROR


# ------------------------------------------------------ the wrapper's choice


def _res(R1, R2, M, nout, real):
    """The C library's ``megafil_resources`` in Python (``pass_resources``
    of ``csrc/mega_common.cuh``)."""
    from test_torch_multipass import pass_resources

    row_len = 2 * R2 if real else R2

    def res(kind, which, tile):
        return pass_resources(kind, which, R1, row_len, M, nout, tile,
                              not real, 0)

    return res


def test_inverse_choice():
    """One CTA while it fits; the multi-pass inverse past it (the
    hybrid_conv32 geometry: pass A 16 columns of 32 threads, 512 threads;
    pass B 4 rows of 64 threads, or 8 for four detected planes) or when
    forced (q = 64: pass A all 64 columns of 4 threads); at nsub 4 and
    freq_res 16384, past one CTA's 512 threads, pass A's tile of 32 columns
    (q = 256: 16 threads a column, 512 threads)."""
    from dspsr_tpu_torch.kernels.megastep import INVA, INVB

    limit = 232448
    small = tmk.MegaPlan(**dataclasses.asdict(conv_plan(freq_res=4096)))
    assert inverse_passes(_res(64, 64, 4096, 2, True), small, limit) == (0, 0)
    ta, tb = inverse_passes(_res(64, 64, 4096, 2, True), small, limit,
                            "multipass")
    assert (ta, tb) == (64, INVB_ROWS[0])
    big = dataclasses.replace(small, freq_res=1 << 19, R1=1024,
                              real_input=False)
    assert (big.R1, big.R2) == (1024, 512)
    res = _res(1024, 512, 1 << 19, 2, False)
    ta, tb = inverse_passes(res, big, limit)
    assert (ta, tb) == (INVA_COLS, INVB_ROWS[0])
    assert inverse_passes(res, dataclasses.replace(big, npol_out=4),
                          limit) == (INVA_COLS, INVB_ROWS[1])
    assert inverse_passes(res, dataclasses.replace(big, npol_out=4), limit,
                          output="voltage") == (INVA_COLS, INVB_ROWS[0])
    for which, tile, threads in ((INVA, ta, MAX_THREADS),
                                 (INVB, tb, MAX_THREADS // 2),
                                 (INVB, INVB_ROWS[1], MAX_THREADS)):
        assert res(0, which, tile) <= limit
        assert res(1, which, tile) == threads
    sub = dataclasses.replace(small, nsub=4, freq_res=16384)
    assert (sub.R1, sub.R2, sub.q) == (64, 1024, 256)
    res = _res(64, 1024, 16384, 2, True)
    assert res(1, 2, 0) > MAX_THREADS
    assert inverse_passes(res, sub, limit) == (32, INVB_ROWS[0])
    for which, tile in ((INVA, 32), (INVB, INVB_ROWS[0])):
        assert res(0, which, tile) <= limit
        assert res(1, which, tile) <= MAX_THREADS
    assert res(1, INVA, 32) == MAX_THREADS


def test_hybrid_conv32_geometry():
    """The hybrid_conv32 cell's plan (``bench.py:438-442``: 32 complex
    channels, -400 MHz at 1382 MHz, DM 71, freq_res 2^19, 4 windows a
    block), from the smear and ``MegaPlan.from_filterbank`` alone (no chirp
    is built at this size on the CPU)."""
    from dspsr_tpu_torch.ops.dedispersion import Dedispersion
    from dspsr_tpu_torch.ops.filterbank import FilterbankPlan as TFB

    nfp, nfn = (Dedispersion._half_smearing_samples(
        71.0, 1382.0, -400.0, 32, sign, 0.1) for sign in (+1, -1))
    p = tmk.MegaPlan.from_filterbank(
        TFB(real_input=False, nchan_subband=1, freq_res=1 << 19,
            nfilt_pos=nfp, nfilt_neg=nfn), nbin=1024, npol=2, nchan_in=32)
    assert (p.nsub, p.R1, p.R2, p.q) == (1, 1024, 512, 512)
    assert (p.nfilt_pos, p.nfilt_neg, p.nkeep) == (29710, 31730, 462848)
    assert p.block_ndat(4) == 1912832
    limit = 232448
    ta, tb = inverse_passes(_res(1024, 512, 1 << 19, 2, False), p, limit)
    assert (ta, tb) == (INVA_COLS, INVB_ROWS[0])


# ------------------------------------------------------------- the slice


CONV = dict(BASE, nchan=1)
PIPE_CASES = {
    "intensity": dict(),
    "stokes": dict(npol_out=4),
    "ppqq_subints": dict(npol_out=2, subint_seconds=0.002),
    "rfi": dict(rfi_filter=True),
    "rfi_two_pass": dict(rfi_filter=True, rfi_same_block=True),
    "cyclic": dict(cyclic_nchan=4),
    "sk_cyclic": dict(sk_enable=True, sk_m=64, cyclic_nchan=4),
    "align": dict(interchannel_align=True),
    "complex": dict(complex=True),
    "complex_stokes_rfi": dict(complex=True, npol_out=4, rfi_filter=True),
    "complex_cyclic": dict(complex=True, cyclic_nchan=4),
}


@pytest.mark.parametrize("name", list(PIPE_CASES))
def test_pipeline_matches_jax(tmp_path, name):
    kw = dict(PIPE_CASES[name])
    cplx = kw.pop("complex", False)
    path = _write_rfi(tmp_path)
    obs_kw = dict(state="ANALYTIC", ndim=2) if cplx else {}
    cfg = dict(CONV, **kw)
    jp = jl.FoldPipeline(raw_source("jax", path, **obs_kw),
                         jl.FoldConfig(**cfg))
    tp = tl.FoldPipeline(raw_source("port", path, **obs_kw),
                         tl.FoldConfig(**cfg), device="cpu")
    assert jp.mega_mode == tp.mega_mode == "hybrid"
    assert tp.fb_plan is None and jp.fb_plan is None
    assert dataclasses.asdict(tp.conv_plan) == dataclasses.asdict(
        jp.conv_plan)
    assert dataclasses.asdict(tp.mega_plan) == dataclasses.asdict(
        jp.mega_plan)
    assert tp.mega_plan.nsub == 1 and tp.mega_plan.real_input != cplx
    a, b = jp.run(max_blocks=3), tp.run(max_blocks=3)
    _assert_results(a, b)
    assert b.hits.sum() > 0
    assert any(op["op"] == "Convolution" for op in b.signal_path)
    if tp.config.rfi_filter:
        assert 0 < tp.zapped_share()["rfi"] < 0.5
        if not tp.config.rfi_same_block:
            gr, gi = convert.response_from_numpy(
                [np.asarray(r) for r in jp._rfi_resp], jp.mega_plan, "cpu")
            for j, t in ((gr, tp._rfi_resp[0]), (gi, tp._rfi_resp[1])):
                assert torch.equal(j == 0, t == 0)
                assert torch.allclose(t, j, rtol=0, atol=1e-6)
