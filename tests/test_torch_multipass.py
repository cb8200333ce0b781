"""Every geometry the JAX package fuses, in the port, on the CPU:

- the plain twin of the kernels' multi-pass inverse
  (``ops.megakernel.inverse_subbands_twopass``) against each subband's
  ``torch.fft.ifft`` (1e-6), and through the plain steps against the
  plain inverse and the JAX package's float64 ``mega_reference`` (2e-5,
  hits exact): real, complex and CASPSR input, nsub 2 and 4, detected and
  voltage output;
- float64 numpy mirrors of the CUDA passes at nsub > 1: ``mega_inva``
  (tiles of S columns and G subbands, the length-q inverse on the register
  FFT of ``test_torch_fourstep.py``, the lo/hi twiddle over M),
  ``megafil_invb`` (the time-order store of each subband), the tile walk of
  ``mega_invbfold`` (every kept sample folded once, hits from subband 0),
  and the long row pass (``mega_rowfft`` with 32 points a thread,
  ``mega_rowpair``), against ``numpy.fft`` and the mirror of
  ``mega_fwd2``;
- the work division of both fold kernels (``mega_invfold``,
  ``mega_invbfold``): a CTA an item, each thread's runs of one bin over
  its consecutive samples (``fold_runs``), added to the block accumulator
  with the window weight: every kept sample folded once into its bin at
  the test geometry and at the flagship, ``mega_guppi_2bit``, J1713 and
  J0613 plans, with windows that start just before a turn, windows over
  several turns, bounds inside a window and windows of weight 0;
- the resource map: a Python copy of ``pass_resources``
  (``csrc/mega_common.cuh``) run through the wrappers' pass choosers over
  every plan ``MegaPlan.choose_r1`` accepts, real and complex, nplane 1, 2,
  4 and 14, nbin 64-8192: every pass fits a CTA of the H100 (232448 B of
  shared memory, 512 threads), so no plan is refused;
- ``external_weights`` on the fused fold step against ``mega_reference``;
- ``FoldPipeline`` (full and hybrid engines) and ``FilPipeline`` at a
  geometry the card refused before (nsub 4, freq_res 16384) against the
  JAX package's.
"""

import dataclasses

import numpy as np
import pytest
import torch

from dspsr_tpu.models import load_to_fil as jfil
from dspsr_tpu.models import load_to_fold as jl
from dspsr_tpu.ops import megakernel as jmk
from dspsr_tpu.ops.filterbank import FilterbankPlan

from dspsr_tpu_torch.kernels import megafil as kfil
from dspsr_tpu_torch.kernels import megastep as kstep
from dspsr_tpu_torch.kernels.megastep import twiddle_tables
from dspsr_tpu_torch.models import load_to_fil as tfil
from dspsr_tpu_torch.models import load_to_fold as tl
from dspsr_tpu_torch.ops import megakernel as tmk
from test_megakernel import _write_raw
from test_torch_fourstep import (
    Geom, _raw, dft, fft_points, fft_regs, fwd1, fwd2, num_passes, pass_bits,
    polpow, seq_ld, tables64)
from test_torch_pipeline import BASE, raw_source
from test_torch_search import _assert_data_close, _run_both

torch.set_num_threads(2)

TOL = 2e-5
TOL_TWIN = 1e-6
TOL_MIRROR = 1e-12
NPART = 3
#: the H100's shared memory a block may opt in to, and the kernels' threads
LIMIT = 232448
MAX_THREADS = kstep.MAX_THREADS
#: ring stages of ``mega_inva`` (``kPassStages``)
PASS_STAGES = 3


def _rel(got, want):
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape
    return np.abs(got - want).max() / np.abs(want).max()


# ------------------------------------------------------------ resources


def pass_resources(kind, which, R1, row_len, M, nout, tile, cplx):
    """``pass_resources`` of ``csrc/mega_common.cuh`` in Python."""
    R2 = row_len if cplx else row_len // 2
    if which == kstep.FWD1:
        return (tile * (R1 // fft_points(R1)) if kind
                else tile * seq_ld(R1) * 8)
    if which == kstep.FWD2:
        return (tile * (row_len // fft_points(row_len)) if kind
                else (1 if cplx else 2) * tile * seq_ld(row_len) * 8)
    if which == kstep.INV:
        return M // fft_points(M) if kind else nout * seq_ld(M) * 8
    if which == kstep.INVA:
        q = M // R1
        return (tile * (q // fft_points(q)) if kind
                else PASS_STAGES * q * tile * 8)
    if which == kstep.INVB:
        return (tile * (R1 // fft_points(R1)) if kind
                else nout * tile * seq_ld(R1) * 8)
    if which == kstep.ROWFFT:  # half a row a CTA, 32 points a thread
        H = row_len // 2
        return H // min(32, H) if kind else seq_ld(H) * 8
    if which == kstep.FWD2_CLUSTER:
        return R2 // fft_points(R2) if kind else seq_ld(R2) * 8
    assert which == kstep.ROWPAIR
    return 8 * min(32, R2) if kind else 0


def step_res(plan, npolf):
    """``megastep_resources`` for ``plan`` (the fold holds no profile in
    shared memory)."""
    def res(kind, which, tile):
        return pass_resources(kind, which, plan.R1, plan.row_len,
                              plan.freq_res, npolf, tile,
                              not plan.real_input)
    return res


def fil_res(plan, nout):
    """``megafil_resources`` for ``plan``."""
    def res(kind, which, tile):
        return pass_resources(kind, which, plan.R1, plan.row_len,
                              plan.freq_res, nout, tile,
                              not plan.real_input)
    return res


def _map_plan(nsub, freq_res, real, nbin, npol_out, fourth=False):
    r1 = tmk.MegaPlan.choose_r1(nsub * freq_res, freq_res)
    if r1 is None:
        return None
    return tmk.MegaPlan(nsub=nsub, freq_res=freq_res, R1=r1, nfilt_pos=0,
                        nfilt_neg=8 * (freq_res // r1), nbin=nbin, npol=2,
                        npol_out=npol_out, real_input=real,
                        fourth_moment=fourth)


def _fitting(res, passes):
    for which, tile in passes:
        assert res(0, which, tile) <= LIMIT, (which, tile)
        assert 0 < res(1, which, tile) <= MAX_THREADS, (which, tile)
    kstep.check_resources(res, None, passes, LIMIT)


@pytest.mark.parametrize("real", [True, False], ids=["real", "complex"])
@pytest.mark.parametrize("nsub", [1 << k for k in range(11)])
def test_no_plan_is_refused(nsub, real):
    """Every plan ``choose_r1`` accepts at this nsub (freq_res 16-2^17),
    through both wrappers' pass choosers, for every detection width and
    nbin 64-8192: each pass it launches fits the card; the multi-pass
    inverse takes over exactly where the one-CTA inverse does not fit, and
    the long row pass exactly where the row pair does not."""
    seen = 0
    for freq_res in (1 << k for k in range(4, 18)):
        for nplane, npol_out, fourth in ((1, 1, False), (2, 2, False),
                                         (4, 4, False), (14, 4, True)):
            for nbin in (64, 512, 1024, 4096, 8192):
                plan = _map_plan(nsub, freq_res, real, nbin, npol_out,
                                 fourth)
                if plan is None:
                    continue
                assert plan.nplane == nplane
                seen += 1
                npolf = 2
                res = step_res(plan, npolf)
                tc, tk = kstep.forward_tiles(res, plan, LIMIT)
                assert (tk == 0) == (real and plan.R2 == 8192)
                if not real:
                    # a row tile of 4 or more, else clusters of up to
                    # CLUSTER_ROWS one-row CTAs
                    cluster = plan.R2 >= kstep.CLUSTER_R2
                    assert cluster == (not kstep.fits(
                        res, kstep.FWD2, min(4, plan.R1), LIMIT))
                    if cluster:
                        assert tk == min(kstep.CLUSTER_ROWS, plan.R1)
                ta, tb = kstep.fold_passes(res, plan, LIMIT)
                one_cta = kstep.fits(res, kstep.INV, 0, LIMIT)
                assert (ta == 0) == one_cta
                # no plan leaves the one-CTA inverse: every plan that fit
                # one CTA with the [nplane, nbin] profile the fold held in
                # shared memory before (4 bytes a bin and plane, and a hit
                # count a bin) still does
                prof = (plan.nplane * plan.nbin + plan.nbin) * 4
                if (res(0, kstep.INV, 0) + prof <= LIMIT
                        and res(1, kstep.INV, 0) <= MAX_THREADS):
                    assert one_cta
                if ta:
                    assert tb <= plan.q and plan.q % tb == 0
                    # pass A: whole columns of R1, rows of 128 bytes
                    # wherever 16 columns fit 512 threads
                    assert plan.R1 % ta == 0
                    if plan.q <= 512:
                        assert ta >= min(16, plan.R1)
                inv = ((kstep.INVA, ta), (kstep.INVB, tb)) if ta \
                    else ((kstep.INV, 0),)
                _fitting(res, ((kstep.FWD1, tc),)
                         + kstep.step_passes(plan, tk, inv))
                if fourth:
                    continue  # the search front end takes no fourth moments
                for nout in (1, 2):
                    fres = fil_res(plan, nout)
                    ta, tb = kfil.inverse_passes(fres, plan, LIMIT)
                    assert (ta == 0) == kstep.fits(fres, kstep.INV, 0, LIMIT)
                    inv = ((kstep.INVA, ta), (kstep.INVB, tb)) if ta \
                        else ((kstep.INV, 0),)
                    if ta:
                        # pass B: 4 rows, 8 for four planes (32-byte
                        # runs of each), where R2 allows
                        rows = kfil.INVB_ROWS[int(nplane == 4)]
                        assert tb == min(rows, plan.R2)
                    _fitting(fres, ((kstep.FWD1, tc),)
                             + kstep.step_passes(plan, tk, inv))
    assert seen > 0
    if nsub == 64:
        # the fold main path's one-CTA plans keep mega_invfold: the flagship
        # (real, 75 windows of R1 = R2 = 512) and mega_guppi_2bit (32
        # complex 2-bit channels, R1 512, R2 256)
        plan = (tmk.MegaPlan(nsub=64, freq_res=4096, R1=512, nfilt_pos=288,
                             nfilt_neg=288, nbin=1024, npol=2)
                if real else
                tmk.MegaPlan(nsub=64, freq_res=2048, R1=512, nfilt_pos=16,
                             nfilt_neg=16, nbin=1024, npol=2, nbit=2,
                             real_input=False, nchan_in=32, npw=256))
        assert (plan.R2, plan.nkeep) == ((512, 3520) if real else (256, 2016))
        res = step_res(plan, 2)
        assert kstep.fold_passes(res, plan, LIMIT) == (0, 0)
        _fitting(res, ((kstep.INV, 0),))


def test_flagship_dm_plans():
    """The flagship band (1382 MHz, -400 MHz, real 8-bit, ``-F 64:D``) at
    J1713+0747's DM 15.99 and J0613-0200's 38.78: the plans and passes the
    port's planning code gives them."""
    from dspsr_tpu_torch.ops.dedispersion import Dedispersion
    from dspsr_tpu_torch.ops.filterbank import FilterbankPlan as TFB

    want = {15.99: (32768, 1024, 2048, 32), 38.78: (131072, 1024, 8192, 128)}
    for dm, (freq_res, R1, R2, q) in want.items():
        nfp, nfn = (Dedispersion._half_smearing_samples(
            dm, 1382.0, -400.0, 64, sign, 0.1) for sign in (+1, -1))
        plan = tmk.MegaPlan.from_filterbank(
            TFB(real_input=True, nchan_subband=64, freq_res=freq_res,
                nfilt_pos=nfp, nfilt_neg=nfn), nbin=1024, npol=2)
        assert (plan.R1, plan.R2, plan.q) == (R1, R2, q)
        res = step_res(plan, 2)
        assert not kstep.fits(res, kstep.INV, 0, LIMIT)
        # pass A: 512 threads, q / 16 a column (256 or 64 columns of one
        # subband); pass B: 4 rows, 256 threads, as the search front end's
        # on Intensity (two CTAs an SM)
        ta = MAX_THREADS // (q // 16)
        assert kstep.fold_passes(res, plan, LIMIT) == (ta, 4)
        assert kfil.inverse_passes(fil_res(plan, 1), plan, LIMIT) == (ta, 4)
        assert (kstep.forward_tiles(res, plan, LIMIT)[1] == 0) == (
            R2 == 8192)


# ------------------------------------------------------ the plain twin


def _stored(spec, plan):
    """The spectrum in the kernels' stored order (centred for complex)."""
    return spec if plan.real_input else torch.fft.fftshift(spec, dim=-1)


@pytest.mark.parametrize("real", [True, False], ids=["real", "complex"])
@pytest.mark.parametrize("nsub,freq_res", [(2, 64), (4, 64), (4, 256),
                                           (2, 128)])
def test_twin_matches_ifft(real, nsub, freq_res):
    """The two passes, indexed as the kernels index them (the complex
    shift, t = n2 + q n1), give each stored subband's inverse FFT."""
    fb = FilterbankPlan(real_input=real, nchan_subband=nsub,
                        freq_res=freq_res, nfilt_pos=5, nfilt_neg=6)
    plan = tmk.MegaPlan(**dataclasses.asdict(jmk.MegaPlan.from_filterbank(
        fb, nbin=8, npol=2)))
    assert plan.q > 1
    rng = np.random.default_rng(nsub + freq_res)
    spec = torch.from_numpy(rng.normal(size=(2, 3, plan.n_fft))
                            + 1j * rng.normal(size=(2, 3, plan.n_fft)))
    got = tmk.inverse_subbands_twopass(spec, plan)
    want = torch.fft.ifft(_stored(spec, plan).reshape(
        2, 3, nsub, freq_res), dim=-1)
    assert _rel(got.numpy(), want.numpy()) < TOL_TWIN


KINDS = ("real", "complex", "caspsr")


def _kind_plan(kind, nsub, nbin=32, **kw):
    fb = FilterbankPlan(real_input=kind != "complex", nchan_subband=nsub,
                        freq_res=64, nfilt_pos=5, nfilt_neg=6)
    if kind == "caspsr":
        kw["interleave"] = "caspsr"
    return jmk.MegaPlan.from_filterbank(fb, nbin=nbin, npol=2, **kw)


def _kind_setup(kind, nsub, seed=0, **kw):
    plan = _kind_plan(kind, nsub, **kw)
    rng = np.random.default_rng(seed)
    raw = rng.integers(0, 256, size=plan.block_ndat(NPART) * plan.npol
                       * plan.ndim * plan.nchan_in, dtype=np.uint8)
    resp = np.exp(1j * rng.uniform(-3, 3, (plan.nchan_in * nsub, 64)))
    phi0 = rng.uniform(0, 1, NPART).astype(np.float32)
    dphi = np.full(NPART, 0.013, np.float32)
    return plan, raw, resp, phi0, dphi


def _port_cst(plan, resp):
    tplan = tmk.MegaPlan(**dataclasses.asdict(plan))
    scale, offset = tmk.unpack_affine(8, plan.twos_complement)
    return tplan, tmk.MegaConstants.build(tplan, resp, scale, offset).to(
        "cpu")


@pytest.mark.parametrize("output", ["detected", "voltage"])
@pytest.mark.parametrize("nsub", [2, 4])
@pytest.mark.parametrize("kind", KINDS)
def test_twopass_front_matches_plain(kind, nsub, output):
    """``megafil_plain(twopass=True)`` against the plain inverse (float64),
    Stokes or every input pol's voltage with its sign."""
    plan, raw, resp, _, _ = _kind_setup(kind, nsub, npol_out=4)
    tplan, cst = _port_cst(plan, resp)
    raw_t = torch.from_numpy(raw)
    got = tmk.megafil_plain(tplan, cst, raw_t, NPART, torch.float64,
                            output=output, twopass=True)
    want = tmk.megafil_plain(tplan, cst, raw_t, NPART, torch.float64,
                             output=output)
    assert _rel(torch.view_as_real(got) if got.is_complex() else got,
                torch.view_as_real(want) if want.is_complex() else want) \
        < TOL_TWIN


@pytest.mark.parametrize("nsub", [2, 4])
@pytest.mark.parametrize("kind", KINDS)
def test_twopass_step_matches_reference(kind, nsub):
    """``megastep_plain(twopass=True)`` against ``mega_reference`` at the
    reference's tolerance, hits exact (coherence, so every cross term)."""
    plan, raw, resp, phi0, dphi = _kind_setup(kind, nsub, npol_out=4,
                                              detection="coherence")
    tplan, cst = _port_cst(plan, resp)
    shp = (1, plan.nplane, nsub, plan.nbin)
    p, h = tmk.megastep_plain(
        tplan, cst, torch.zeros(shp, dtype=torch.float64),
        torch.zeros(1, plan.nbin, dtype=torch.float64), torch.from_numpy(raw),
        torch.from_numpy(phi0), torch.from_numpy(dphi), twopass=True)
    scale, offset = jmk.unpack_affine(8, plan.twos_complement)
    c64 = jmk.MegaConstants(plan, resp, dtype=np.float64,
                            unpack_scale=scale, unpack_offset=offset)
    pr, hr = jmk.mega_reference(raw, plan, c64, phi0.astype(np.float64),
                                dphi.astype(np.float64), NPART)
    assert _rel(p.numpy(), pr) < TOL
    assert np.array_equal(h.numpy(), hr)


# ---------------------------------------------------- external weights


@pytest.mark.parametrize("wext", [[1.0, 0.0, 1.0], [0.5, 1.0, 0.25]],
                         ids=["mask", "fractional"])
@pytest.mark.parametrize("kind", ["real", "complex"])
def test_external_weights_match_reference(kind, wext):
    """``build_megastep(external_weights=True)`` (plain on the CPU) against
    ``mega_reference(ext_weights=...)``: the case of
    ``tests/test_megakernel.py::test_external_weights_reach_fused_fold``
    (window 1 killed) and fractional weights, at 2e-5, hits exact."""
    plan, raw, resp, phi0, dphi = _kind_setup(kind, 4, npol_out=1)
    tplan, cst = _port_cst(plan, resp)
    w = np.array([wext])
    step = tmk.build_megastep(tplan, cst, NPART, external_weights=True)
    p, h = step(torch.zeros(1, 1, 4, plan.nbin),
                torch.zeros(1, plan.nbin), torch.from_numpy(raw),
                torch.from_numpy(phi0), torch.from_numpy(dphi),
                torch.tensor(w, dtype=torch.float32))
    scale, offset = jmk.unpack_affine(8)
    c64 = jmk.MegaConstants(plan, resp, dtype=np.float64,
                            unpack_scale=scale, unpack_offset=offset)
    pr, hr = jmk.mega_reference(raw, plan, c64, phi0.astype(np.float64),
                                dphi.astype(np.float64), NPART,
                                ext_weights=w)
    pa, ha = jmk.mega_reference(raw, plan, c64, phi0.astype(np.float64),
                                dphi.astype(np.float64), NPART)
    assert hr.sum() < ha.sum()
    assert _rel(p.numpy(), pr) < TOL
    assert np.abs(h.numpy() - hr).max() == 0


def test_external_weights_multiply_ja98():
    """On a JA98 plan (with an excised stretch) the external weights
    multiply the excision weights, as ``mega_reference`` does."""
    from test_torch_twobit import NPART as NP, jax_cst, port_cst, setup

    plan, jraw, traw, resp, phi0, dphi, win = setup(
        nbit=2, real=False, npw=16, seed=4, rfi=((40, 80),))
    w = np.linspace(0.25, 1.0, NP)[None, :].repeat(plan.nchan_in, 0)
    shp = (plan.nchan_in, plan.nplane, plan.nsub, plan.nbin)
    p, h = tmk.megastep_plain(
        tmk.MegaPlan(**dataclasses.asdict(plan)), port_cst(plan, resp, win),
        torch.zeros(shp, dtype=torch.float64),
        torch.zeros(plan.nchan_in, plan.nbin, dtype=torch.float64),
        torch.from_numpy(traw), torch.from_numpy(phi0),
        torch.from_numpy(dphi), weights=torch.from_numpy(w))
    pr, hr = jmk.mega_reference(jraw, plan, jax_cst(plan, resp, win),
                                phi0.astype(np.float64),
                                dphi.astype(np.float64), NP, ext_weights=w)
    pa, ha = jmk.mega_reference(jraw, plan, jax_cst(plan, resp, win),
                                phi0.astype(np.float64),
                                dphi.astype(np.float64), NP)
    assert not np.allclose(hr, ha)
    assert _rel(p.numpy(), pr) < TOL
    assert np.abs(h.numpy() - hr).max() < 1e-9


def test_external_weights_signature():
    """The JAX package's signature, ``step(profiles, hits, raw, phi0,
    dphi, weights, bounds=None)``: a missing weights operand raises."""
    plan, raw, resp, phi0, dphi = _kind_setup("real", 4, npol_out=1)
    tplan, cst = _port_cst(plan, resp)
    step = tmk.build_megastep(tplan, cst, NPART, external_weights=True)
    args = (torch.zeros(1, 1, 4, plan.nbin), torch.zeros(1, plan.nbin),
            torch.from_numpy(raw), torch.from_numpy(phi0),
            torch.from_numpy(dphi))
    with pytest.raises(TypeError, match="weights"):
        step(*args)
    with pytest.raises(ValueError, match="not both"):
        tmk.build_megastep(tplan, cst, NPART, external_weights=True,
                           response_as_args=True)
    ones = torch.ones(1, NPART)
    p1, h1 = step(*args, ones, (7, 70))
    p0, h0 = tmk.build_megastep(tplan, cst, NPART)(*args, (7, 70))
    assert torch.equal(p1, p0) and torch.equal(h1, h0)


# ------------------------------------------------ mirrors of the passes


def tables_m(R1, q):
    """The multi-pass table buffer (geometry (R1, q, M)), float64."""
    M = R1 * q
    buf = twiddle_tables(R1, q, M, dtype=np.complex128)
    log2m = M.bit_length() - 1
    lo_bits = (log2m + 1) // 2
    o = np.cumsum([0, R1, q, M, 1 << lo_bits, 1 << (log2m - lo_bits)])
    r1, row, _, lo, hi = (buf[o[i]:o[i + 1]] for i in range(5))
    return dict(r1=r1, row=row, lo=lo, hi=hi, lo_bits=lo_bits)


def ring_walk(nitems, grid, NU, stages=PASS_STAGES):
    """The persistent tile walk of ``mega_inva``: CTA b takes items b, b +
    grid, ...; its unit u (part u % NU of its item u // NU: an input pol)
    lands in stage u % stages.  Checks what the kernel relies on: each
    unit is issued once and before it is waited on; a stage is refilled
    only after the item holding it has been transformed; the cp.async
    groups a wait leaves pending number 0 .. stages - 1.  Returns, per CTA,
    its items in order, each with the stages of its units."""
    walks, taken = [], []
    for b in range(grid):
        nlocal = (nitems - 1 - b) // grid + 1 if b < nitems else 0
        nunits = nlocal * NU
        holder = [None] * stages
        issued, walk = 0, []

        def fill(upto):
            nonlocal issued
            while issued < min(nunits, upto):
                assert holder[issued % stages] is None
                holder[issued % stages] = issued
                issued += 1
        fill(stages)
        for k in range(nlocal):
            units = [k * NU + part for part in range(NU)]
            assert issued > units[-1]
            assert 0 <= issued - (k + 1) * NU <= stages - 1
            for u in units:
                assert holder[u % stages] == u
            walk.append((b + k * grid, [u % stages for u in units]))
            taken.append(b + k * grid)
            for u in units:
                holder[u % stages] = None
            fill((k + 1) * NU + stages)
        assert issued == nunits
        walks.append(walk)
    assert sorted(taken) == list(range(nitems))
    return walks


def stage_fft(st, q, S, tw):
    """``mega_inva``'s transform of one landed box: st, flat [q*S]
    (row-major), holds column col's element i at i*S + col (``ColIdx``);
    the passes of ``fft_seqs`` run in place in it, thread (col, j) on
    elements j + T*i.  Returns the registers (KEEP): v[i][j, col] = X[j +
    T*i] of column col, the length-q inverse (unscaled)."""
    P = fft_points(q)
    T = q // P
    j = np.arange(T)[:, None]
    at = np.arange(S)[None, :]

    def pos(i):
        return i * S + at

    v = np.stack([st[pos(j + T * i)] for i in range(P)])
    if P == 1:
        return v
    lgP, logL = min(P.bit_length() - 1, 4), q.bit_length() - 1
    n, Ns, toff = num_passes(logL, lgP), 1, 0
    for s in range(n):
        if s > 0:
            v = np.stack([st[pos(j + T * i)] for i in range(P)])
        bits = pass_bits(s, logL, lgP)
        R, last = 1 << bits, s == n - 1
        B = P // R
        for u in range(B):
            b = j + u * T
            k = b & (Ns - 1)
            base = (b - k) * R + k
            x = [v[u + r * B].copy() for r in range(R)]
            if Ns > 1:
                for r in range(1, R):
                    x[r] = x[r] * np.conj(tw[toff + (r - 1) * Ns + k])
            x = dft(x, +1)
            for r in range(R):
                if last:
                    v[u + r * B] = x[r]
                else:
                    st[pos(base + r * Ns)] = x[r]
        if s > 0:
            toff += (R - 1) * Ns
        Ns <<= bits
    return v


def inva_mirror(y, R1, R2, q, tb, S, nout=1, grid=3, jones=None, jpol0=0):
    """``mega_inva`` over its tile walk (``ring_walk``): item (w, column
    tile of S k1, subband s, channel c[, output pol]) with w fastest; each
    unit's [q, S] box of y [nchan*nin, w, N] (rows s*q + k2l, R1 apart;
    nin = 2 input pols with a Jones response ``jones`` [nchan, 4, N], else
    nout) lands in its stage; under Jones both output pols are mixed in
    place from the two landed input pols, reading each once; each column
    is inverse-transformed in place (``stage_fft``), twiddled by
    exp(+2 pi i k1 n2 / M) (two lo/hi table reads a thread and a
    recurrence) and stored at Z[s*M + n2*R1 + k1] in rows of S consecutive
    k1.  Returns z [nchan*nout, w, N] and how often each element was
    written."""
    M, nsub = R1 * q, R2 // q

    def turn(e):
        e = e & (M - 1)
        return np.conj(tb["hi"][e >> tb["lo_bits"]]
                       * tb["lo"][e & ((1 << tb["lo_bits"]) - 1)])

    nin = 2 if jones is not None else nout
    nchan, npart, N = y.shape[0] // nin, y.shape[1], y.shape[2]
    ntile = R1 // S
    P = fft_points(q)
    T = q // P
    nitems = npart * ntile * nsub * nchan * (1 if jones is not None else nout)
    z = np.full((nchan * nout,) + y.shape[1:], np.nan, complex)
    writes = np.zeros(z.shape, int)
    rows = np.arange(q)[:, None] * R1
    for walk in ring_walk(nitems, grid, 2 if jones is not None else 1):
        for it, _ in walk:
            w, rest = it % npart, it // npart
            k0, rest = (rest % ntile) * S, rest // ntile
            s, rest = rest % nsub, rest // nsub
            c, p = rest % nchan, rest // nchan
            box = s * q * R1 + k0 + rows + np.arange(S)[None, :]  # [q, S]
            if jones is None:
                boxes = [y[c * nout + p, w][box].ravel()]
                pols = [p]
            else:
                a, b = (y[c * 2 + i, w][box].ravel() for i in range(2))
                jb = [jones[c, i][box].ravel() for i in range(4)]
                pols = list(range(nout))
                boxes = [jb[2 * (jpol0 + o)] * a + jb[2 * (jpol0 + o) + 1] * b
                         for o in pols]
            k1 = k0 + np.arange(S)[None, :]
            j = np.arange(T)[:, None]
            for st, po in zip(boxes, pols):
                v = stage_fft(st, q, S, tb["row"])
                # exp(+2 pi i k1 n2 / M) = f g^i from two table reads a
                # thread, the powers by recurrence
                f, g = turn(k1 * j), turn(k1 * T)
                for i in range(P):
                    n2 = j + T * i
                    dst = s * M + n2 * R1 + k1
                    # a row of the store: S consecutive k1
                    assert (np.diff(dst, axis=1) == 1).all()
                    z[c * nout + po, w][dst] = v[i] * f
                    np.add.at(writes[c * nout + po, w], dst, 1)
                    f = f * g
    return z, writes


def invb_rows(z, R1, R2, tb, a, S):
    """The length-R1 inverse of rows a .. a + S - 1 of z [seq, w, N]
    (unscaled), [S, R1, seq, w], on the register-FFT mirror."""
    P = fft_points(R1)
    T = R1 // P
    zz = z.reshape(*z.shape[:2], R2, R1)
    rows = a + np.arange(S)
    v = np.stack([zz[:, :, rows][..., np.arange(T) + T * ii]
                  for ii in range(P)])
    v = fft_regs(np.moveaxis(v, 4, 1), R1, +1, tb["r1"])
    sm = np.empty((S, R1) + z.shape[:2], complex)
    for ii in range(P):
        sm[:, np.arange(T) + T * ii] = np.moveaxis(v[ii], 3, 0)
    return sm


def invb_mirror(z, R1, R2, q, tb, S, nfilt_pos, nkeep, flip, nout=1):
    """``megafil_invb`` over its grid of tiles (S rows a .. a + S - 1,
    window w, channel c; each tile loads the nout pols' rows, then
    transforms them): out [nchan*nout, w, nsub, nkeep] (1/M, the (-1)^t
    sign when ``flip``) and how often each output sample was written.
    While S <= q, the S rows of each n1 are S consecutive samples (runs of
    S outputs of each plane)."""
    M, nsub = R1 * q, R2 // q
    nchan, npart = z.shape[0] // nout, z.shape[1]
    out = np.full((*z.shape[:2], nsub, nkeep), np.nan, complex)
    writes = np.zeros(out.shape, int)
    lg = S.bit_length() - 1
    idx = np.arange(S * R1)
    n1, r = idx >> lg, idx & (S - 1)
    for a in range(0, R2, S):
        rows = invb_rows(z, R1, R2, tb, a, S)
        row = a + r
        s, t = row // q, row % q + q * n1
        o = t - nfilt_pos
        if S <= q:
            assert (np.diff(o.reshape(R1, S), axis=1) == 1).all()
        keep = (o >= 0) & (o < nkeep)
        g = np.where(flip & t & 1, -1.0, 1.0) / M
        for w in range(npart):
            for c in range(nchan):
                for p in range(nout):
                    sq = c * nout + p
                    out[sq, w, s[keep], o[keep]] = (
                        rows[r[keep], n1[keep], sq, w] * g[keep])
                    np.add.at(writes[sq, w], (s[keep], o[keep]), 1)
    return out, writes


MIRROR_CASES = [
    dict(R1=R1, R2=R2, q=q, ta=ta, tb=tb)
    for R1, R2, q in ((8, 16, 2), (16, 32, 4), (16, 64, 16), (32, 64, 32),
                      (8, 64, 1), (64, 64, 16))
    for ta, tb in ((1, 1), (min(16, R1), 8), (2, 2), (R1, 4))
]


@pytest.mark.parametrize("case", MIRROR_CASES, ids=lambda c: "-".join(
    f"{k}{v}" for k, v in c.items()))
def test_multipass_mirror_matches_subband_ifft(case):
    """Every zbuf element and every kept sample of every subband is
    written once, and each sample equals numpy's length-M ifft of the
    subband, signed."""
    R1, R2, q = case["R1"], case["R2"], case["q"]
    N, M = R1 * R2, R1 * q
    rng = np.random.default_rng(R1 + 7 * R2 + q)
    y = rng.normal(size=(2, 2, N)) + 1j * rng.normal(size=(2, 2, N))
    tb = tables_m(R1, q)
    z, zw = inva_mirror(y, R1, R2, q, tb, case["ta"], nout=2)
    assert (zw == 1).all()
    nfilt_pos, nkeep = 1, M - 3
    for flip in (0, 1):
        got, writes = invb_mirror(z, R1, R2, q, tb, case["tb"], nfilt_pos,
                                  nkeep, flip, nout=2)
        assert (writes == 1).all()
        t = np.arange(nfilt_pos, nfilt_pos + nkeep)
        sign = np.where(flip & t & 1, -1.0, 1.0)
        want = np.fft.ifft(y.reshape(2, 2, R2 // q, M), axis=-1)[
            ..., nfilt_pos:nfilt_pos + nkeep] * sign
        assert _rel(got, want) < TOL_MIRROR


@pytest.mark.parametrize("jpol0,nout", [(0, 2), (0, 1), (1, 1)])
@pytest.mark.parametrize("R1,R2,q,S", [(16, 64, 16, 16), (8, 32, 4, 8),
                                       (32, 64, 32, 16)])
def test_multipass_mirror_jones_reads_once(R1, R2, q, S, jpol0, nout):
    """Pass A's Jones form at nsub > 1: both output pols mixed in the
    stages from the two landed input pols (each read once), then
    transformed: every zbuf element written once, and each subband of each
    output pol the ifft of its mix."""
    N, M, nchan = R1 * R2, R1 * q, 2
    rng = np.random.default_rng(R1 + q + 5 * nout + jpol0)
    y = rng.normal(size=(2 * nchan, 2, N)) + 1j * rng.normal(
        size=(2 * nchan, 2, N))
    J = rng.normal(size=(nchan, 4, N)) + 1j * rng.normal(size=(nchan, 4, N))
    tb = tables_m(R1, q)
    z, zw = inva_mirror(y, R1, R2, q, tb, S, nout=nout, jones=J,
                        jpol0=jpol0)
    assert (zw == 1).all()
    got, writes = invb_mirror(z, R1, R2, q, tb, min(8, R2), 0, M, 0,
                              nout=nout)
    assert (writes == 1).all()
    x = y.reshape(nchan, 2, 2, N)
    for o in range(nout):
        p = jpol0 + o
        mix = J[:, 2 * p, None] * x[:, 0] + J[:, 2 * p + 1, None] * x[:, 1]
        want = np.fft.ifft(mix.reshape(nchan, 2, R2 // q, M), axis=-1)
        assert _rel(got.reshape(nchan, nout, 2, R2 // q, M)[:, o],
                    want) < TOL_MIRROR


@pytest.mark.parametrize("nitems,grid,NU", [(1, 3, 1), (7, 3, 1),
                                            (7, 3, 2), (132, 132, 2),
                                            (1000, 132, 1), (5, 8, 2)])
def test_ring_walk(nitems, grid, NU):
    """The persistent walk covers every item once, in order within each
    CTA, and its ring keeps every unit in a stage of its own until its item
    is done (``ring_walk``'s checks)."""
    walks = ring_walk(nitems, grid, NU)
    assert len(walks) == grid
    for b, walk in enumerate(walks):
        assert [it for it, _ in walk] == list(range(b, nitems, grid))
        for _, st in walk:
            assert len(set(st)) == NU


# ------------------------------------------- the fold's work division
#
# Mirrors of ``csrc/megastep.cu``'s fold (``mega_invfold``,
# ``mega_invbfold``): a CTA an item (a window of one subband, or a pass-B
# tile), thread k on its items k*per .. k*per + per - 1 in time order
# (``fold_runs``), each run of one bin summed and added to the block
# accumulator with the window weight (``add_run``), subband 0 counting the
# hits.


def fold_bin32(p0, dp, i, nbin):
    """``fold_bin``: the phase bin of kept samples i, float32 with each
    operation rounded (numpy does not contract to an FMA)."""
    i = np.asarray(i)
    phi = np.float32(p0) + np.float32(dp) * i.astype(np.float32)
    frac = phi - np.floor(phi)
    b = np.floor(frac * np.float32(nbin)).astype(np.int64)
    return np.clip(b, 0, nbin - 1)


def kept_range(w, nkeep, lo, hi):
    """``kept_range``: the kept samples of window w inside [lo, hi)."""
    return max(0, lo - w * nkeep), min(nkeep, hi - w * nkeep)


def fold_runs(bins, nthreads):
    """The runs ``fold_runs`` hands to ``add_run`` for one CTA's items in
    time order (bins [n], -1 where an item does not fold): thread k takes
    items k*per .. k*per + per - 1 (per = ceil(n / nthreads)) and sums
    them while the bin stays the same, passing over items that do not
    fold.  Returns, for each run in thread order, (thread, bin, its items'
    indices)."""
    n = len(bins)
    per = -(-n // nthreads)
    out = []
    for k in range(nthreads):
        items = np.arange(k * per, min(k * per + per, n))
        items = items[bins[items] >= 0]
        if not len(items):
            continue
        b = bins[items]
        cut = np.flatnonzero(b[1:] != b[:-1]) + 1
        for run in np.split(items, cut):
            out.append((k, int(bins[run[0]]), run))
    return out


def item_bins(p0, dp, i, i0, i1, nbin):
    """Bins of kept samples i (-1 outside [i0, i1))."""
    ok = (i >= i0) & (i < i1)
    return np.where(ok, fold_bin32(p0, dp, np.where(ok, i, 0), nbin), -1)


def invfold_item(w, nkeep, phi0, dphi, lo, hi, nbin):
    """``mega_invfold``'s samples for window w (any subband and channel):
    the kept indices i0 .. i1 - 1 in time order and their bins; None when
    none is kept."""
    i0, i1 = kept_range(w, nkeep, lo, hi)
    if i0 >= i1:
        return None
    i = np.arange(i0, i1)
    return i, fold_bin32(phi0[w], dphi[w], i, nbin)


def invbfold_item(j, w, q, S, R1, nfilt_pos, nkeep, phi0, dphi, lo, hi,
                  nbin):
    """``mega_invbfold``'s samples for tile j of a subband (rows j*S ..
    j*S + S - 1 of it) and window w, in time order idx = n1*S + r: sample t
    = j*S + r + q*n1, kept index t - nfilt_pos, and their bins (-1 where
    not kept or outside [lo, hi)); None when the window keeps none."""
    i0, i1 = kept_range(w, nkeep, lo, hi)
    if i0 >= i1:
        return None
    idx = np.arange(S * R1)
    i = j * S + (idx & (S - 1)) + q * (idx // S) - nfilt_pos
    return i, item_bins(phi0[w], dphi[w], i, i0, i1, nbin)


def fold_hits(runs, i, nbin, wt=1.0):
    """What the runs add to the hits (subband 0): each run's count times
    the window weight in its bin; also checks that every run's items share
    its bin and that no item is in two runs."""
    h = np.zeros(nbin)
    seen = np.concatenate([r[2] for r in runs]) if runs else np.zeros(0, int)
    assert len(np.unique(seen)) == len(seen)
    for _, b, items in runs:
        h[b] += len(items) * wt
    return h, i[seen]


def want_hits(npart, nkeep, phi0, dphi, lo, hi, nbin, wt=None):
    """Every kept sample inside [lo, hi) once in its bin (``fold_bin32``),
    times its window's weight ``wt[w]`` (1 when None)."""
    h = np.zeros(nbin)
    for w in range(npart):
        i0, i1 = kept_range(w, nkeep, lo, hi)
        if i0 < i1:
            h += (1.0 if wt is None else wt[w]) * np.bincount(
                fold_bin32(phi0[w], dphi[w], np.arange(i0, i1), nbin),
                minlength=nbin)
    return h


def fold_mirror(z, R1, R2, q, tb, S, nfilt_pos, nkeep, phi0, dphi, nbin,
                lo, hi):
    """``mega_invbfold`` on one pol (Intensity |x|^2) over its grid of
    tiles: each tile's unscaled rows (``invb_rows``), its threads' runs
    (``fold_runs``, ``invbfold_item``), each run's sums times 1/M^2 added to
    its subband's profile; profiles [nsub, nbin] and hits [nbin] (from the
    tiles of subband 0)."""
    nsub, M, npart = R2 // q, R1 * q, z.shape[1]
    nthreads = S * (R1 // fft_points(R1))
    prof = np.zeros((nsub, nbin))
    hits = np.zeros(nbin)
    idx = np.arange(S * R1)
    for a in range(0, R2, S):
        s, j = a // q, (a % q) // S
        rows = invb_rows(z, R1, R2, tb, a, S)[..., 0, :]  # [S, R1, w]
        for w in range(npart):
            got = invbfold_item(j, w, q, S, R1, nfilt_pos, nkeep, phi0, dphi,
                                lo, hi, nbin)
            if got is None:
                continue
            _, bins = got
            v = np.abs(rows[idx & (S - 1), idx // S, w]) ** 2
            for _, b, items in fold_runs(bins, nthreads):
                prof[s, b] += v[items].sum() / M ** 2
                if s == 0:
                    hits[b] += len(items)
    return prof, hits


@pytest.mark.parametrize("S", [1, 4, 8])
def test_fold_tile_walk_matches_plain_fold(S):
    """Each kept sample of each subband lands in its bin once, inside the
    bounds, and subband 0's tiles count every kept sample once, through
    the threads' runs of unscaled samples scaled by 1/M^2 a run."""
    R1, R2, q, nbin = 16, 64, 16, 8
    N, M = R1 * R2, R1 * q
    rng = np.random.default_rng(S)
    y = rng.normal(size=(1, 2, N)) + 1j * rng.normal(size=(1, 2, N))
    tb = tables_m(R1, q)
    z, _ = inva_mirror(y, R1, R2, q, tb, 8)
    nfilt_pos, nkeep = 3, M - 11
    phi0, dphi = np.float32([0.1, 0.7]), np.float32([0.013, 0.011])
    lo, hi = 40, 2 * nkeep - 30
    prof, hits = fold_mirror(z, R1, R2, q, tb, S, nfilt_pos, nkeep, phi0,
                             dphi, nbin, lo, hi)
    v = np.fft.ifft(y[0].reshape(2, R2 // q, M), axis=-1)[
        ..., nfilt_pos:nfilt_pos + nkeep]
    b = tmk.fold_bins(tmk.MegaPlan(nsub=R2 // q, freq_res=M, R1=R1,
                                   nfilt_pos=nfilt_pos,
                                   nfilt_neg=M - nkeep - nfilt_pos,
                                   nbin=nbin, npol=1),
                      torch.from_numpy(phi0), torch.from_numpy(dphi)).numpy()
    gidx = np.arange(2 * nkeep).reshape(2, nkeep)
    keep = (gidx >= lo) & (gidx < hi)
    want = np.zeros((R2 // q, nbin))
    for s in range(R2 // q):
        np.add.at(want[s], b[keep], (np.abs(v[:, s]) ** 2)[keep])
    assert _rel(prof, want) < TOL_MIRROR
    assert np.array_equal(hits, np.bincount(b[keep], minlength=nbin))


@pytest.mark.parametrize("nthreads", [1, 4, 32, 256])
@pytest.mark.parametrize("pattern", ["monotone", "random", "gaps"])
def test_fold_runs_cover_items_once(nthreads, pattern):
    """``fold_runs``' division: every item that folds is in exactly one
    run, a run's items share its bin and lie in one thread's range in time
    order, and a thread's consecutive runs differ in bin; items that do
    not fold end no run."""
    rng = np.random.default_rng(nthreads)
    n = 1000
    if pattern == "monotone":
        bins = np.sort(rng.integers(0, 40, n))
    elif pattern == "random":
        bins = rng.integers(0, 6, n)
    else:
        bins = np.repeat(rng.integers(-1, 5, n // 10), 10)
    runs = fold_runs(bins, nthreads)
    per = -(-n // nthreads)
    items = np.concatenate([r[2] for r in runs])
    assert np.array_equal(np.sort(items), np.flatnonzero(bins >= 0))
    for (k, b, run), nxt in zip(runs, runs[1:] + [None]):
        assert (bins[run] == b).all()
        assert (run // per == k).all() and (np.diff(run) > 0).all()
        if nxt is not None and nxt[0] == k:
            assert nxt[1] != b
    if pattern == "gaps":
        # a run passes over items that do not fold
        ok = bins >= 0
        assert len(runs) <= (np.diff(bins[ok]) != 0).sum() + nthreads


def _anchors(npart, nkeep, period_samples, phase0, jitter=0.0, rng=None):
    """Anchors of consecutive windows as a predictor gives them: dphi the
    turns a sample, phi0 the phase at each window's first kept sample
    (``jitter`` turns of noise where windows need not join)."""
    dphi = np.full(npart, 1.0 / period_samples, np.float32)
    phi0 = (phase0 + np.arange(npart) * nkeep / period_samples)
    if jitter:
        phi0 = phi0 + rng.uniform(-jitter, jitter, npart)
    return phi0.astype(np.float32), dphi


#: (name, kernel, windows, kept samples a window, nbin, samples a turn,
#: threads a CTA or pass B's (q, S, R1, nfilt_pos)): the test geometry's
#: and the main path's plans (the flagship: 256 threads; mega_guppi_2bit:
#: 128; J1713 and J0613: pass B at FOLD_ROWS = 4 rows, 256 threads)
WALK_PLANS = [
    ("test", "invfold", 3, 61, 8, 700.0, 4),
    ("flagship", "invfold", 75, 3520, 1024, 35982.8, 256),
    ("mega_guppi_2bit", "invfold", 16, 2016, 1024, 1124.2, 128),
    ("mega_j1713", "invbfold", 9, 29184, 1024, 35982.8,
     (32, kstep.FOLD_ROWS, 1024, 1700)),
    ("mega_j0613", "invbfold", 8, 121856, 1024, 35982.8,
     (128, kstep.FOLD_ROWS, 1024, 4122)),
]


@pytest.mark.parametrize("case", ["plain", "wrap", "turns", "bounds",
                                  "weights"])
@pytest.mark.parametrize("plan", WALK_PLANS, ids=lambda p: p[0])
def test_fold_walk_folds_every_sample_once(plan, case):
    """Both fold kernels' division at the test geometry and the main path's
    plans: every kept sample inside [lo, hi) of every window of nonzero
    weight is in exactly one run of one thread, in its ``fold_bin`` bin,
    so the hits (subband 0: the count of each run times the window
    weight) equal every kept sample once; with windows that start just
    before a turn, windows over several turns, bounds inside a window and
    windows of weight 0 (skipped whole)."""
    name, kernel, npart, nkeep, nbin, per_turn, geo = plan
    rng = np.random.default_rng(len(name) + len(case))
    lo, hi, wt = 0, npart * nkeep, np.ones(npart)
    phi0, dphi = _anchors(npart, nkeep, per_turn, 0.37)
    if case == "wrap":
        # each window's first kept sample a few bins before a turn
        phi0 = (np.floor(phi0) + 1 - 3.0 / nbin).astype(np.float32)
    elif case == "turns":
        phi0, dphi = _anchors(npart, nkeep, nkeep / 3.7, 0.81, 0.3, rng)
    elif case == "bounds":
        lo, hi = nkeep // 3, npart * nkeep - nkeep // 2 - 7
    elif case == "weights":
        wt[::3] = 0
        wt[1] = 0.5
    hits = np.zeros(nbin)
    for w in range(npart):
        if wt[w] == 0:
            continue
        if kernel == "invfold":
            got = invfold_item(w, nkeep, phi0, dphi, lo, hi, nbin)
            items = [got] if got else []
            nthreads = geo
        else:
            q, S, R1, nfilt_pos = geo
            nthreads = S * R1 // 16
            items = [invbfold_item(j, w, q, S, R1, nfilt_pos, nkeep, phi0,
                                   dphi, lo, hi, nbin) for j in range(q // S)]
            items = [x for x in items if x is not None]
        folded = []
        for i, bins in items:
            h, seen = fold_hits(fold_runs(bins, nthreads), i, nbin, wt[w])
            hits += h
            folded.append(seen)
        if items:
            # every kept sample of the window once, in one tile's run
            i0, i1 = kept_range(w, nkeep, lo, hi)
            folded = np.sort(np.concatenate(folded))
            assert np.array_equal(folded, np.arange(i0, i1))
    assert np.array_equal(hits, want_hits(npart, nkeep, phi0, dphi, lo, hi,
                                          nbin, wt))


def rowpos(k, H):
    """``rowpos``: where bin k of a row of 2H points lies after
    ``mega_rowfft`` (the even bins, then the odd ones)."""
    return (k & 1) * H + (k >> 1)


def rowfft_mirror(cbuf, L, half):
    """``mega_rowfft``: each row of cbuf [nchan, npart, R1, L] over a
    cluster of two CTAs, half a row (H = L/2 points, 32 a thread, or 16
    at H = 16) each: CTA ``rank`` holds x[rank*H + j + T*i], takes the
    partner's half from its shared memory (what the partner wrote there),
    forms the first radix-2 stage (rank 0 x[n] + x[n + H], rank 1 (x[n] -
    x[n + H]) times ``half[n]``), runs the H-point FFT with the table
    ``half[H:]`` and stores its bins over its own half: the row's bins in
    ``rowpos`` order.  ``half`` is the wrapper's long-row block of the
    table buffer."""
    H = L // 2
    P = min(32, H)
    T = H // P
    n = np.arange(T)[None, :] + T * np.arange(P)[:, None]  # [P, T]
    out = np.empty_like(cbuf)
    own = [np.moveaxis(cbuf[..., rank * H + n], (-2, -1), (0, 1))
           for rank in (0, 1)]  # v[i, j, ...] of each CTA
    shared = [own[1], own[0]]  # the partner's half, by sidx(j + T*i)
    tw = half[n].reshape(n.shape + (1,) * (own[0].ndim - 2))
    first = [own[0] + shared[0], (shared[1] - own[1]) * tw]
    for rank in (0, 1):
        v = fft_regs(first[rank], H, -1, half[H:])
        for i in range(P):
            out[..., rank * H + np.arange(T) + T * i] = np.moveaxis(
                v[i], 0, -1)
    return out


def rowpair_mirror(g, C, e, chirp, store=None):
    """``mega_rowpair`` over every tile of 8 k1 and min(32, R2) k2, each
    bin and its partner read through ``rowpos``: ybuf [nchan*nstore, npart,
    N] and how often each bin was written."""
    R1, R2, L = g.R1, g.R2, g.row_len
    H = L // 2
    npolf = len(g.pols)
    store = (3 if npolf == 2 else 1) if store is None else store
    nstore = (store & 1) + (store >> 1)
    ybuf = np.full((g.nchan * nstore, g.npart, g.n), np.nan, complex)
    writes = np.zeros(g.n, int)
    kc = min(32, R2)
    unscale = np.ldexp(1.0, -e)
    for blk in range((R1 // 8) * (R2 // kc)):
        tid = np.arange(8 * kc)
        k1 = (blk % (R1 // 8)) * 8 + (tid & 7)
        k2 = (blk // (R1 // 8)) * kc + tid // 8
        # a tile's columns of a row are two runs: its even bins, its odd
        # bins, each a contiguous stretch of the stored row
        for par in (0, 1):
            pos = rowpos(k2[::8][k2[::8] % 2 == par], H)
            assert pos.size == kc // 2 and (np.diff(pos) == 1).all()
        pk1 = np.where((k1 == 0) | (2 * k1 == R1), k1, R1 - k1)
        pcol = np.where(k1 == 0, (L - k2) & (L - 1), L - 1 - k2)
        z = C[:, :, k1, rowpos(k2, H)]  # [nchan, npart, tid]
        p = C[:, :, pk1, rowpos(pcol, H)]
        k = k2 * R1 + k1
        np.add.at(writes, k, 1)
        xs = [0.5 * (z + np.conj(p))]
        if npolf == 2:
            xs.append(-0.5j * (z - np.conj(p)) * unscale[:, :, None])
        for c in range(g.nchan):
            slot = c * nstore
            for q, x in enumerate(xs):
                if store >> q & 1:
                    ybuf[slot][:, k] = x[c] * chirp[c, k][None, :]
                    slot += 1
    return ybuf, writes


@pytest.mark.parametrize("R1,R2,pols", [(16, 16, (0, 1)), (8, 64, (0, 1)),
                                        (32, 32, (1,)), (16, 128, (0, 1)),
                                        (8, 32, (0, 1)), (8, 16, (1,)),
                                        (8, 8192, (0, 1))])
def test_long_row_pass_mirror(R1, R2, pols):
    """The long row pass (a row over a cluster of two CTAs, half a row's
    FFT each after a radix-2 stage through the partner's shared memory,
    the bins stored even then odd; then the pair pass through device
    memory, reading through ``rowpos``) stores what ``mega_fwd2`` stores,
    and each bin once: the rfft of each pol.  Rows of 32 points (the
    shortest the pass takes) to 16384 (R2 = 8192, the J0613-0200 cells)."""
    g = Geom(R1=R1, R2=R2, M=R1 * R2 // 4, nchan=2, npol=2, pols=pols,
             npart=2, step=R1 * R2)
    g.scale, g.offset = tmk.unpack_affine(8)
    rng = np.random.default_rng(R1 * R2)
    raw = _raw(g, rng)
    chirp = np.exp(1j * rng.uniform(-3, 3, (g.nchan, g.n)))
    tb = tables64(g)
    psum = polpow(g, raw) if len(pols) == 2 else None
    cbuf, e = fwd1(g, raw, tb, psum, min(8, g.row_len))
    rows = rowfft_mirror(cbuf, g.row_len, tb["half"])
    H = g.row_len // 2
    k = np.arange(g.row_len)
    assert _rel(rows[..., rowpos(k, H)], np.fft.fft(cbuf, axis=-1)) < 1e-12
    got, writes = rowpair_mirror(g, rows, e, chirp)
    assert (writes == 1).all()
    want, _ = fwd2(g, cbuf, e, tb, chirp, min(4, R1 // 2))
    assert _rel(got, want) < TOL_MIRROR
    # and the rfft of each pol's window, chirped
    from test_torch_fourstep import values
    for q, pol in enumerate(pols):
        x = values(g, raw, pol)
        for w in range(g.npart):
            spec = np.fft.rfft(x[:, w * g.step:w * g.step + 2 * g.n])[
                :, :g.n] * chirp
            assert _rel(got.reshape(g.nchan, len(pols), g.npart, g.n)[
                :, q, w], spec) < 1e-10


# ------------------------------------------------- pipelines against JAX


WIDE = dict(BASE, frequency_resolution=16384, nbin=64)


def _reference_step(jp):
    """The JAX pipeline's fused step through its float64 ``mega_reference``
    (per-operation f32 phase rounding, as the kernels and the port's plain
    step do): the Pallas kernel in interpret mode rounds ``phi0 + dphi *
    i`` once on the CPU, and at nkeep 15872 samples of this pulsar land on
    bin edges, so it moves some of them against its own reference
    (``test_pallas_step_rounds_phase_once``)."""
    import jax.numpy as jnp

    p = jp.mega_plan
    scale, offset = jmk.unpack_affine(8)
    c64 = jmk.MegaConstants(p, jp.kernel.phasors, dtype=np.float64,
                            unpack_scale=scale, unpack_offset=offset)

    def step(profiles, hits, raw, phi0, dphi, bounds=None):
        assert bounds is None
        pr, hr = jmk.mega_reference(
            np.asarray(raw), p, c64, np.asarray(phi0, np.float64),
            np.asarray(dphi, np.float64), phi0.shape[0])
        return (profiles + jnp.asarray(pr, jnp.float32),
                hits + jnp.asarray(hr, jnp.float32))
    return step


def _spy(jp):
    """Record the ``(raw, phi0, dphi)`` of each call of the JAX pipeline's
    fused step (unchanged) in the returned list."""
    calls, step = [], jp._megastep

    def spy(profiles, hits, raw, phi0, dphi, *rest):
        calls.append((np.array(raw), np.array(phi0), np.array(dphi)))
        return step(profiles, hits, raw, phi0, dphi, *rest)
    jp._megastep = spy
    return calls


def _rounding_moves(calls, nkeep, nbin):
    """Over the windows of the recorded steps: the hits the fold gains
    with ``phi0 + dphi * i`` rounded per operation (``compute_bins``, the
    kernels' rule) against rounded once (a fused multiply-add: the
    float64 product of two float32 values is exact), ``[nbin]``, and the
    bins a moved sample leaves or enters."""
    from dspsr_tpu_torch.ops.fold import compute_bins

    gain, touched = np.zeros(nbin), set()
    i = np.arange(nkeep)
    for _, phi0, dphi in calls:
        for w in range(phi0.shape[0]):
            two = compute_bins(torch.from_numpy(phi0[w:w + 1]),
                               torch.from_numpy(dphi[w:w + 1]), nkeep,
                               nbin).numpy()
            ph = (np.float64(phi0[w]) + np.float64(dphi[w]) * i).astype(
                np.float32)
            one = np.clip(np.floor((ph - np.floor(ph)) * np.float32(nbin)),
                          0, nbin - 1).astype(np.int64)
            gain += (np.bincount(two, minlength=nbin)
                     - np.bincount(one, minlength=nbin))
            touched |= set(one[one != two]) | set(two[one != two])
    return gain, sorted(touched)


def test_pallas_step_rounds_phase_once(tmp_path):
    """Why the fold parity test below holds the port against the JAX
    pipeline's ``mega_reference``: at nsub 4, freq_res 16384 (nkeep
    15872) the JAX Pallas step in interpret mode disagrees with its own
    float64 reference on the first block, by exactly the samples whose bin
    one rounding of ``phi0 + dphi * i`` moves, while the port's plain step
    matches the reference (2e-5, hits exact)."""
    path = _write_raw(tmp_path, 600000)
    jp = jl.FoldPipeline(raw_source("jax", path), jl.FoldConfig(**WIDE))
    tp = tl.FoldPipeline(raw_source("port", path), tl.FoldConfig(**WIDE),
                         device="cpu")
    calls = _spy(jp)
    a = jp.run(max_blocks=1)
    assert len(calls) == 1
    raw, phi0, dphi = calls[0]
    p = tp.mega_plan
    scale, offset = jmk.unpack_affine(8)
    c64 = jmk.MegaConstants(jp.mega_plan, jp.kernel.phasors,
                            dtype=np.float64, unpack_scale=scale,
                            unpack_offset=offset)
    pr, hr = jmk.mega_reference(raw, jp.mega_plan, c64,
                                phi0.astype(np.float64),
                                dphi.astype(np.float64), phi0.shape[0])
    gain, touched = _rounding_moves(calls, p.nkeep, p.nbin)
    # the Pallas step's hits (the pipeline's, one per output channel)
    assert np.abs(gain).sum() > 0
    for c in range(a.hits.shape[1]):
        assert np.array_equal(hr.reshape(-1) - a.hits[0, c], gain)
    prof = torch.zeros(1, p.nplane, p.nsub, p.nbin)
    hits = torch.zeros(1, p.nbin)
    pk, hk = tmk.megastep_plain(p, tp.constants, prof, hits,
                                torch.from_numpy(raw),
                                torch.from_numpy(phi0),
                                torch.from_numpy(dphi))
    assert _rel(pk.numpy(), pr.reshape(pk.shape)) < TOL
    assert np.array_equal(hk.numpy().reshape(-1), hr.reshape(-1))


def test_fold_pipeline_at_refused_geometry(tmp_path):
    """``FoldPipeline`` at nsub 4, freq_res 16384 (the geometry the card
    refused before: its one-CTA inverse needs 1024 threads), 2 blocks,
    against the JAX package's pipeline with its step through
    ``mega_reference``: profiles 2e-4, hits exact; and against the JAX
    pipeline as it is: hits differ by exactly the samples one rounding of
    the phase moves (``test_pallas_step_rounds_phase_once``), profiles
    2e-4 on every bin no such sample touches."""
    path = _write_raw(tmp_path, 600000)
    jp = jl.FoldPipeline(raw_source("jax", path), jl.FoldConfig(**WIDE))
    tp = tl.FoldPipeline(raw_source("port", path), tl.FoldConfig(**WIDE),
                         device="cpu")
    assert jp.mega_mode == tp.mega_mode == "full"
    assert dataclasses.asdict(jp.mega_plan) == dataclasses.asdict(
        tp.mega_plan)
    p = tp.mega_plan
    assert (p.nsub, p.freq_res, p.R1, p.R2, p.q) == (4, 16384, 256, 256, 64)
    b = tp.run(max_blocks=2)
    ju = jl.FoldPipeline(raw_source("jax", path), jl.FoldConfig(**WIDE))
    calls = _spy(ju)
    u = ju.run(max_blocks=2)
    jp._megastep = _reference_step(jp)
    a = jp.run(max_blocks=2)
    assert np.abs(b.profiles - a.profiles).max() / \
        np.abs(a.profiles).max() < 2e-4
    assert np.array_equal(a.hits, b.hits)
    assert b.hits.sum() == 2 * tp.out_per_block * 4
    # the JAX pipeline unchanged
    assert len(calls) == 2
    gain, touched = _rounding_moves(calls, p.nkeep, p.nbin)
    assert np.array_equal(b.hits - u.hits,
                          np.broadcast_to(gain, b.hits.shape))
    keep = np.ones(p.nbin, bool)
    keep[touched] = False
    assert 0 < len(touched) <= 8
    assert np.abs(b.profiles - u.profiles)[..., keep].max() / \
        np.abs(u.profiles).max() < 2e-4


@pytest.mark.parametrize("kw", [dict(sk_enable=True, sk_m=64),
                                dict(rfi_filter=True),
                                dict(cyclic_nchan=4)],
                         ids=["sk", "rfi", "cyclic"])
def test_hybrid_pipeline_at_refused_geometry(tmp_path, kw):
    """The hybrid fold engine (in-stream SK, the RFI filter, cyclic
    folding) at nsub 4, freq_res 16384, whose front end takes the same
    multi-pass inverse on the card, against the JAX package's hybrid
    engine: 2e-4, hits exact."""
    from test_torch_hybrid import _assert_results

    path = _write_raw(tmp_path, 600000)
    cfg = dict(WIDE, **kw)
    jp = jl.FoldPipeline(raw_source("jax", path), jl.FoldConfig(**cfg))
    tp = tl.FoldPipeline(raw_source("port", path), tl.FoldConfig(**cfg),
                         device="cpu")
    assert jp.mega_mode == tp.mega_mode == "hybrid"
    assert tp.mega_plan.freq_res == 16384 and tp.mega_plan.nsub == 4
    _assert_results(jp.run(max_blocks=2), tp.run(max_blocks=2))


def test_search_pipeline_at_refused_geometry(tmp_path):
    """``FilPipeline`` at nsub 4, freq_res 16384 against the JAX package's
    (its Pallas kernel in interpret mode): header equal, bytes within 1 LSB
    and at least 99% exact."""
    path = _write_raw(tmp_path, 600000)
    cfg = dict(nchan=4, block_parts=2, min_block_samples=0,
               dispersion_measure=5.0, frequency_resolution=16384)
    jp = jfil.FilPipeline(raw_source("jax", path), jfil.FilConfig(**cfg))
    tp = tfil.FilPipeline(raw_source("port", path), tfil.FilConfig(**cfg),
                          device="cpu")
    assert dataclasses.asdict(jp.megafil_plan) == dataclasses.asdict(
        tp.megafil_plan)
    assert tp.megafil_plan.freq_res == 16384
    out = _run_both(tmp_path, jp, tp, max_blocks=2)
    assert out["jax"][0] == out["port"][0]
    assert len(out["port"][1]) > 0
    _assert_data_close(np.frombuffer(out["jax"][1], np.uint8).astype(
        np.int64), np.frombuffer(out["port"][1], np.uint8).astype(np.int64),
        8)
