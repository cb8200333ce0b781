"""The port's general chain (plain PyTorch on ``complex64`` streams, on the
CPU) against the JAX package's XLA chain on the CPU, from the same inputs
made from numpy seeds.

- Ops: each against its JAX function at 2e-5 relative to the largest
  magnitude (the FFT stages differ: pocketfft here, dense DFT matmuls
  there); the unpack exactly, weights included; the RFI weights exactly.
- Fold: ``FoldPipeline`` with ``mega_mode is None`` on both sides, profiles
  at 2e-4 relative, hits exact (``test_torch_pipeline._assert_same``); and
  the engine choice, which must be the JAX package's.
- Search: ``FilPipeline`` with ``megafil_plan is None`` on both sides,
  bytes within 1 LSB and at least 99% exact, float32 output at 2e-4.

Each side builds its own ``Observation`` and ``Source``
(``test_torch_pipeline.raw_source``).
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dspsr_tpu.models import load_to_fil as jfil
from dspsr_tpu.models import load_to_fold as jl
from dspsr_tpu.observation import Signal as JSignal
from dspsr_tpu.ops import convolution as jconv
from dspsr_tpu.ops import filterbank as jfb
from dspsr_tpu.ops import mxfft as jfft
from dspsr_tpu.ops import polncal as jpc
from dspsr_tpu.ops import polyphase as jpp
from dspsr_tpu.ops import rfifilter as jrfi
from dspsr_tpu.ops import scrunch as jsc
from dspsr_tpu.ops.response import Response as JResponse
from dspsr_tpu.unpack import unpackers as ju

from dspsr_tpu_torch.models import load_to_fil as tfil
from dspsr_tpu_torch.models import load_to_fold as tl
from dspsr_tpu_torch.observation import Signal as TSignal
from dspsr_tpu_torch.ops import convolution as tconv
from dspsr_tpu_torch.ops import fft as tfft
from dspsr_tpu_torch.ops import filterbank as tfb
from dspsr_tpu_torch.ops import polncal as tpc
from dspsr_tpu_torch.ops import polyphase as tpp
from dspsr_tpu_torch.ops import rfifilter as trfi
from dspsr_tpu_torch.ops import scrunch as tsc
from dspsr_tpu_torch.ops.response import Response as TResponse
from dspsr_tpu_torch.unpack import unpackers as tu
from test_megakernel import _write_raw
from test_torch_cyclic import _complex_file, _one_pol_file
from test_torch_pipeline import BASE, _assert_same, make_obs, plain, raw_source
from test_torch_search import _run_both, _samples, _assert_data_close
from test_torch_twobit import clean_twobit_codes, pack2

torch.set_num_threads(2)

TOL = 2e-5


def _c(x) -> np.ndarray:
    """A JAX split-complex pair, or a real array, as numpy."""
    if isinstance(x, tuple):
        return np.asarray(x[0]) + 1j * np.asarray(x[1])
    return np.asarray(x)


def _sc(x: np.ndarray):
    """numpy complex -> a JAX split-complex pair (float32)."""
    return (jnp.asarray(x.real.astype(np.float32)),
            jnp.asarray(x.imag.astype(np.float32)))


def _rel(got, want) -> float:
    got = got.numpy() if isinstance(got, torch.Tensor) else got
    return float(np.abs(got - want).max() / np.abs(want).max())


def _signal(rng, shape, real: bool) -> np.ndarray:
    x = rng.standard_normal(shape)
    if not real:
        x = x + 1j * rng.standard_normal(shape)
    return x.astype(np.complex64 if not real else np.float32)


def _pair(x: np.ndarray):
    """The same samples for each package: (JAX input, port input)."""
    if np.iscomplexobj(x):
        return _sc(x), torch.from_numpy(x)
    return jnp.asarray(x), torch.from_numpy(x)


# ------------------------------------------------------------------- ops


@pytest.mark.parametrize("nfft,step,npart,ndat", [
    (64, 48, 5, 48 * 4 + 64), (64, 48, 5, 200), (32, 32, 6, 192),
    (16, 5, 7, 46)], ids=["exact", "padded", "no_overlap", "k4"])
def test_frame_matches_jax(nfft, step, npart, ndat):
    x = np.random.default_rng(ndat).standard_normal((2, 3, ndat)).astype(
        np.float32)
    want = np.asarray(jconv.frame(jnp.asarray(x), nfft, step, npart))
    got = tconv.frame(torch.from_numpy(x), nfft, step, npart)
    assert got.shape == want.shape
    assert np.array_equal(got.numpy(), want)


@pytest.mark.parametrize("n", [8, 64, 1024])
def test_fft_wrappers_match_jax(n):
    rng = np.random.default_rng(n)
    x = _signal(rng, (3, 2 * n), real=True)
    assert _rel(tfft.rfft(torch.from_numpy(x)),
                _c(jfft.rfft_sc(jnp.asarray(x), 2 * n))) < TOL
    z = _signal(rng, (3, n), real=False)
    assert _rel(tfft.fft(torch.from_numpy(z)),
                _c(jfft.fft_sc(_sc(z), n))) < TOL
    assert _rel(tfft.ifft(torch.from_numpy(z)),
                _c(jfft.ifft_sc(_sc(z), n))) < TOL
    assert np.array_equal(tfft.fftshift(torch.from_numpy(z)).numpy(),
                          _c(jfft.fftshift_sc(_sc(z))))
    assert np.array_equal(tfft.ifftshift(torch.from_numpy(z)).numpy(),
                          _c(jfft.ifftshift_sc(_sc(z))))


FB = {
    "real": dict(real_input=True, nchan_subband=4, freq_res=64, nfilt_pos=5,
                 nfilt_neg=6),
    "complex": dict(real_input=False, nchan_subband=4, freq_res=64,
                    nfilt_pos=5, nfilt_neg=6),
    "critical": dict(real_input=True, nchan_subband=8, freq_res=1),
    "complex_critical": dict(real_input=False, nchan_subband=8, freq_res=1),
}


def _fb_inputs(name, npart=3, nchan_in=2, seed=0):
    kw = FB[name]
    jplan, tplan = jfb.FilterbankPlan(**kw), tfb.FilterbankPlan(**kw)
    rng = np.random.default_rng(seed)
    x = _signal(rng, (nchan_in, 2, tplan.block_ndat(npart)),
                real=kw["real_input"])
    return jplan, tplan, x, rng


@pytest.mark.parametrize("apod", [False, True], ids=["bare", "apodized"])
@pytest.mark.parametrize("name", ["real", "complex", "critical"])
def test_forward_spectra_chunked_matches_jax(name, apod):
    jplan, tplan, x, rng = _fb_inputs(name)
    win = (rng.uniform(0.2, 1.0, tplan.nsamp_fft).astype(np.float32)
           if apod else None)
    jx, tx = _pair(x)
    want = _c(jfb.forward_spectra_chunked(
        jx, jplan, 3, None if win is None else jnp.asarray(win)))
    got = tfb.forward_spectra_chunked(
        tx, tplan, 3, None if win is None else torch.from_numpy(win))
    assert got.shape == want.shape == (2 * tplan.nchan_subband, 2, 3,
                                       tplan.freq_res)
    assert _rel(got, want) < TOL


@pytest.mark.parametrize("rfi", [None, (5, 2.0)], ids=["chirp", "chirp_rfi"])
def test_apply_response_chunked_matches_jax(rfi):
    rng = np.random.default_rng(1)
    spec = _signal(rng, (8, 2, 3, 64), real=False)
    # narrow-band spikes for the zap to find
    spec[1, :, :, 7] *= 30
    spec[6, 0, :, 40] *= 30
    resp = np.exp(1j * rng.uniform(-3, 3, (8, 64))).astype(np.complex64)
    want = _c(jfb.apply_response_chunked(_sc(spec), _sc(resp), rfi_zap=rfi,
                                         nchan_sub_present=4))
    got = tfb.apply_response_chunked(torch.from_numpy(spec),
                                     torch.from_numpy(resp), rfi_zap=rfi,
                                     nchan_sub_present=4)
    assert _rel(got, want) < TOL
    if rfi:
        zapped = np.abs(got.numpy()) == 0
        assert np.array_equal(zapped, np.abs(want) == 0) and zapped.any()


@pytest.mark.parametrize("name", ["real", "critical"])
def test_invert_subbands_matches_jax(name):
    jplan, tplan, _, rng = _fb_inputs(name)
    spec = _signal(rng, (8, 2, 3, tplan.freq_res), real=False)
    want = _c(jfb.invert_subbands(_sc(spec), jplan))
    got = tfb.invert_subbands(torch.from_numpy(spec), tplan)
    assert got.shape == want.shape == (8, 2, 3 * tplan.nkeep)
    assert _rel(got, want) < TOL


@pytest.mark.parametrize("name", list(FB))
def test_filterbank_block_matches_jax(name):
    jplan, tplan, x, rng = _fb_inputs(name, seed=2)
    resp = None
    if tplan.freq_res > 1:
        resp = np.exp(1j * rng.uniform(-3, 3, (2 * tplan.nchan_subband,
                                               tplan.freq_res))).astype(
            np.complex64)
    jx, tx = _pair(x)
    want = _c(jfb.filterbank_block(jx, jplan, 3,
                                   None if resp is None else _sc(resp)))
    got = tfb.filterbank_block(tx, tplan, 3, None if resp is None
                               else torch.from_numpy(resp))
    assert got.dtype == torch.complex64 and got.shape == want.shape
    assert _rel(got, want) < TOL


def _conv_inputs(real, seed):
    kw = dict(real_input=real, n_fft=128, nfilt_pos=9, nfilt_neg=14)
    jplan, tplan = jconv.OverlapSavePlan(**kw), tconv.OverlapSavePlan(**kw)
    rng = np.random.default_rng(seed)
    x = _signal(rng, (2, 2, tplan.block_ndat(3)), real=real)
    return jplan, tplan, x, rng


@pytest.mark.parametrize("apod", [False, True], ids=["bare", "apodized"])
@pytest.mark.parametrize("real", [True, False], ids=["real", "complex"])
def test_overlap_save_convolve_matches_jax(real, apod):
    jplan, tplan, x, rng = _conv_inputs(real, 3)
    resp = np.exp(1j * rng.uniform(-3, 3, (2, 128))).astype(np.complex64)
    win = (rng.uniform(0.2, 1, tplan.nsamp_fft).astype(np.float32) if apod
           else None)
    jx, tx = _pair(x)
    want = _c(jconv.overlap_save_convolve(
        jx, _sc(resp), jplan, 3, None if win is None else jnp.asarray(win)))
    got = tconv.overlap_save_convolve(
        tx, torch.from_numpy(resp), tplan, 3,
        None if win is None else torch.from_numpy(win))
    assert got.shape == want.shape == (2, 2, 3 * tplan.nkeep_c)
    assert _rel(got, want) < TOL


@pytest.mark.parametrize("real", [True, False], ids=["real", "complex"])
def test_overlap_save_convolve_jones_matches_jax(real):
    jplan, tplan, x, rng = _conv_inputs(real, 4)
    ph = (rng.standard_normal((2, 128, 2, 2))
          + 1j * rng.standard_normal((2, 128, 2, 2))).astype(np.complex64)
    jj = jpc.jones_fft_order(JResponse(ph), complex_input=not real)
    tj = tpc.jones_fft_order(TResponse(ph), complex_input=not real)
    for a, b in zip(jj, tj):
        assert np.array_equal(_c(a), b.numpy())
    jx, tx = _pair(x)
    want = _c(jconv.overlap_save_convolve_jones(jx, jj, jplan, 3))
    got = tconv.overlap_save_convolve_jones(tx, tj, tplan, 3)
    assert got.shape == want.shape == (2, 2, 3 * tplan.nkeep_c)
    assert _rel(got, want) < TOL


@pytest.mark.parametrize("real", [True, False], ids=["real", "complex"])
@pytest.mark.parametrize("nc,ntaps", [(8, 4), (16, 8)])
def test_polyphase_matches_jax(real, nc, ntaps):
    h = tpp.prototype_lowpass(nc, ntaps)
    assert np.array_equal(h, jpp.prototype_lowpass(nc, ntaps))
    jplan = jpp.PolyphasePlan(real_input=real, nchan_subband=nc, ntaps=ntaps)
    tplan = tpp.PolyphasePlan(real_input=real, nchan_subband=nc, ntaps=ntaps)
    npart = 37
    assert tplan.block_ndat(npart) == jplan.block_ndat(npart)
    assert tplan.npart(1000) == jplan.npart(1000)
    x = _signal(np.random.default_rng(nc), (2, 2, tplan.block_ndat(npart)),
                real=real)
    jx, tx = _pair(x)
    want = _c(jpp.polyphase_filterbank_block(jx, jnp.asarray(h), jplan,
                                             npart))
    got = tpp.polyphase_filterbank_block(tx, torch.from_numpy(h), tplan,
                                         npart)
    assert got.shape == want.shape == (2 * nc, 2, npart)
    assert _rel(got, want) < TOL


@pytest.mark.parametrize("width,thresh", [(5, 2.0), (21, 4.0)])
def test_rfi_bandpass_weights_match_jax(width, thresh):
    rng = np.random.default_rng(width)
    spec = _signal(rng, (2, 2, 3, 4, 32), real=False)
    spec[0, 1, :, 2, 5] *= 20
    spec[1, 0, :, 0, 31] *= 20
    want = np.asarray(jrfi.rfi_bandpass_weights(_sc(spec), width, thresh))
    got = trfi.rfi_bandpass_weights(torch.from_numpy(spec), width, thresh)
    assert got.shape == want.shape == (2, 2, 1, 4, 32)
    assert np.array_equal(got.numpy(), want) and (want == 0).any()


def test_scrunch_ops_match_jax():
    from dspsr_tpu.observation import Observation as JObs

    from dspsr_tpu_torch.observation import Observation as TObs

    x = np.random.default_rng(9).standard_normal((6, 4, 50)).astype(
        np.float32)
    jx, tx = jnp.asarray(x), torch.from_numpy(x)
    assert np.array_equal(tsc.poln_select(tx, 2).numpy(),
                          np.asarray(jsc.poln_select(jx, 2)))
    assert np.array_equal(tsc.fzoom(tx, 1, 3).numpy(),
                          np.asarray(jsc.fzoom(jx, 1, 3)))
    states = [("COHERENCE", "STOKES"), ("STOKES", "COHERENCE"),
              ("COHERENCE", "INTENSITY"), ("STOKES", "INTENSITY"),
              ("PPQQ", "INTENSITY"), ("STOKES", "STOKES")]
    for a, b in states:
        want = np.asarray(jsc.poln_reshape(jx, JSignal[a], JSignal[b]))
        got = tsc.poln_reshape(tx, TSignal[a], TSignal[b])
        assert np.allclose(got.numpy(), want, rtol=0, atol=1e-6), (a, b)
    with pytest.raises(ValueError, match="unsupported"):
        tsc.poln_reshape(tx, TSignal.PPQQ, TSignal.STOKES)
    kw = dict(nchan=16, npol=1, ndim=1, nbit=8, centre_frequency=1400.0,
              bandwidth=-64.0, rate=1e6)
    assert plain(tsc.update_observation_fzoom(TObs(**kw), 3, 5)) == \
        plain(jsc.update_observation_fzoom(JObs(**kw), 3, 5))


UNPACK = {
    "8bit": dict(nbit=8), "8bit_twos": dict(nbit=8, twos=True),
    "4bit": dict(nbit=4), "4bit_twos": dict(nbit=4, twos=True),
    "2bit_fixed": dict(nbit=2, dynamic=False),
    "2bit_twos_fixed": dict(nbit=2, dynamic=False, twos=True),
    "1bit": dict(nbit=1), "float32": dict(nbit=32),
    "ja98": dict(nbit=2), "ja98_twos": dict(nbit=2, twos=True),
    "caspsr": dict(nbit=8, instrument="CASPSR"),
}


@pytest.mark.parametrize("name,ndim", [
    (name, ndim) for name in UNPACK for ndim in (1, 2)
    if not (name == "caspsr" and ndim == 2)],  # CASPSR is real-sampled
    ids=lambda v: {1: "real", 2: "complex"}.get(v, v))
def test_unpack_plan_matches_jax(name, ndim):
    """``UnpackPlan.unpack``: equal samples and weights, every code kind;
    JA98 with two's complement decodes as offset binary in both."""
    kw = dict(UNPACK[name])
    nbit = kw.pop("nbit")
    plan_kw = dict(twos_complement=kw.pop("twos", False),
                   dynamic_twobit=kw.pop("dynamic", True),
                   ndat_per_weight=64)
    nchan = 1 if name == "caspsr" else 2
    obs_kw = dict(nbit=nbit, nchan=nchan, ndim=ndim,
                  state="ANALYTIC" if ndim == 2 else "NYQUIST", **kw)
    rng = np.random.default_rng(nbit)
    nsamp = 1024 + 40  # not a whole number of JA98 blocks
    nval = nsamp * nchan * 2 * ndim
    if nbit == 32:
        raw = rng.standard_normal(nval).astype(np.float32).view(np.uint8)
    elif name.startswith("ja98"):
        ndig = nchan * 2 * ndim
        codes = np.concatenate([clean_twobit_codes(rng, 1024, ndig, 64),
                                rng.integers(0, 4, (40, ndig))])
        codes[100:300] = 3  # a saturated stretch: weight 0
        raw = pack2(codes)
    else:
        raw = rng.integers(0, 256, nval * nbit // 8, dtype=np.uint8)
    jp = ju.UnpackPlan(make_obs("jax", **obs_kw), **plan_kw)
    tp = tu.UnpackPlan(make_obs("port", **obs_kw), **plan_kw)
    jx, jw = jp.unpack(jnp.asarray(raw))
    tx, tw = tp.unpack(torch.from_numpy(raw))
    assert tx.dtype == (torch.complex64 if ndim == 2 else torch.float32)
    assert np.array_equal(tx.numpy(), _c(jx))
    assert (jw is None) == (tw is None)
    if jw is not None:
        assert np.array_equal(tw.numpy(), np.asarray(jw))
        assert (tw.numpy() == 0).any() and (tw.numpy() == 1).any()


# ------------------------------------------------------------- fold chain


def _rfi_file(tmp_path, ndat=1 << 15, seed=5):
    """``_write_raw``'s noise with a strong tone (narrow-band RFI) in both
    pols."""
    rng = np.random.default_rng(seed)
    t = np.arange(ndat)
    x = rng.normal(0, 10, (ndat, 2)) + 25 * np.cos(0.7 * t)[:, None]
    p = str(tmp_path / "rfi.raw")
    np.clip(np.round(x + 127.5), 0, 255).astype(np.uint8).tofile(p)
    return p


CPLX = dict(state="ANALYTIC", ndim=2)
G = dict(use_megakernel=False)

#: name -> (config over BASE, observation keywords, file maker)
FOLD = {
    "real": (G, {}, None),
    "complex": (G, CPLX, _complex_file),
    "sk": (dict(G, sk_enable=True, sk_m=32, block_parts=8,
                sk_also_unzapped=True), {}, None),
    "rfi": (dict(G, rfi_filter=True, frequency_resolution=64,
                 rfi_median_width=5), {}, _rfi_file),
    "no_fft": (dict(nchan=1, dispersion_measure=0.0), {}, None),
    "no_fft_complex_sk": (dict(nchan=1, dispersion_measure=0.0,
                               sk_enable=True, sk_m=64), CPLX,
                          _complex_file),
    "conv": (dict(G, nchan=1), {}, None),
    "pp_one_pol": (dict(detection="pp"), dict(npol=1), _one_pol_file),
    "subints": (dict(G, subint_seconds=0.004), {}, None),
    "two_pulsars": (dict(G, additional_pulsars=(0.00313,)), {}, None),
    "extras": (dict(G, passband=True, pdmp_stats=True, npol_out=4,
                    fourth_moment=True), {}, None),
    "coherence": (dict(G, detection="coherence"), {}, None),
    "nthpower": (dict(G, npol_out=3), {}, None),
    "small_freq_res": (dict(frequency_resolution=4, dispersion_measure=0.0),
                       {}, None),
    "cyclic": (dict(G, cyclic_nchan=4, sk_enable=True, sk_m=64,
                    block_parts=8), {}, None),
    "cyclic_complex_no_fft": (dict(cyclic_nchan=4, nchan=1,
                                   dispersion_measure=0.0), CPLX,
                              _complex_file),
    "apodized_align": (dict(G, fft_window="tukey", interchannel_align=True,
                            frequency_resolution=128), {}, None),
}


def _fold_pipes(tmp_path, name):
    kw, obs_kw, maker = FOLD[name]
    path = maker(tmp_path) if maker else _write_raw(tmp_path, 1 << 15)
    cfg = dict(BASE, **kw)
    jp = jl.FoldPipeline(raw_source("jax", path, **obs_kw),
                         jl.FoldConfig(**cfg))
    tp = tl.FoldPipeline(raw_source("port", path, **obs_kw),
                         tl.FoldConfig(**cfg), device="cpu")
    return jp, tp


@pytest.mark.parametrize("name", list(FOLD))
def test_fold_general_chain_matches_jax(tmp_path, name):
    jp, tp = _fold_pipes(tmp_path, name)
    assert jp.mega_mode is None and tp.mega_mode is None
    assert (jp.npart, jp.block_in_samples, jp.out_per_block,
            jp.fold_plan.seg_len) == (tp.npart, tp.block_in_samples,
                                      tp.out_per_block, tp.fold_plan.seg_len)
    a, b = jp.run(max_blocks=4), tp.run(max_blocks=4)
    _assert_same(a, b)
    assert b.hits.sum() > 0
    for x, y in zip(a.extra_sources or [], b.extra_sources or []):
        _assert_same(x, y)
        assert x.label == y.label
    assert len(a.extra_sources or []) == len(b.extra_sources or [])
    for k in ("passband", "pdmp_stats"):
        if getattr(a, k) is not None:
            assert _rel(getattr(b, k), getattr(a, k)) < TOL
    assert a.pdmp_nsamp == b.pdmp_nsamp
    if name == "sk":
        assert 0 < tp.zapped_share()["sk"] < 1
    if name == "rfi":
        # the tone is zapped: without the filter the profiles differ
        kw, obs_kw, _ = FOLD[name]
        off = tl.FoldPipeline(tp.source, tl.FoldConfig(**dict(
            BASE, **dict(kw, rfi_filter=False))),
            device="cpu").run(max_blocks=4)
        assert _rel(off.profiles, b.profiles) > 0.1
    if name == "cyclic_complex_no_fft":
        assert _rel(b.cyclic_spectra(), a.cyclic_spectra()) < 2e-4


def test_calibration_on_the_general_chain(tmp_path):
    """Jones calibration at nsub == 1 with the fused engine turned off: the
    JAX package's matrix convolution (``overlap_save_convolve_jones``)."""
    from test_torch_jones import _leaky

    path, cal = _leaky(tmp_path, real=True)
    cfg = dict(BASE, **G, nchan=1, npol_out=4, frequency_resolution=512,
               calibration_path=cal)
    jp = jl.FoldPipeline(raw_source("jax", path, bandwidth=2.0),
                         jl.FoldConfig(**cfg))
    tp = tl.FoldPipeline(raw_source("port", path, bandwidth=2.0),
                         tl.FoldConfig(**cfg), device="cpu")
    assert jp.mega_mode is None and tp.mega_mode is None
    _assert_same(jp.run(max_blocks=3), tp.run(max_blocks=3))


def test_dump_on_the_general_chain(tmp_path):
    files = {}
    for pkg, mod, extra in (("jax", jl, {}), ("port", tl, {"device": "cpu"})):
        files[pkg] = str(tmp_path / f"{pkg}.dump")
        path = _write_raw(tmp_path, 1 << 14)
        mod.FoldPipeline(raw_source(pkg, path), mod.FoldConfig(
            **dict(BASE, **G, dump_path=files[pkg])), **extra).run()
    a, b = (open(files[k], "rb").read() for k in ("jax", "port"))
    hdr = 4096
    assert a[:hdr] == b[:hdr] and len(a) == len(b) > hdr
    x, y = (np.frombuffer(v[hdr:], np.float32) for v in (a, b))
    assert _rel(y, x) < TOL


def test_non_power_of_two_freq_res(tmp_path):
    """freq_res 96: ``MegaPlan.from_filterbank`` returns None in both
    packages, so both choose the general chain; the JAX chain's dense-DFT
    FFTs take powers of two only (``mxfft.py:70``), and the port's
    ``torch.fft`` runs it, folding every output sample."""
    path = _write_raw(tmp_path, 1 << 15)
    cfg = dict(BASE, frequency_resolution=96)
    jp = jl.FoldPipeline(raw_source("jax", path), jl.FoldConfig(**cfg))
    tp = tl.FoldPipeline(raw_source("port", path), tl.FoldConfig(**cfg),
                         device="cpu")
    assert jp.mega_mode is None and tp.mega_mode is None
    with pytest.raises(ValueError, match="power of two"):
        jp.run(max_blocks=1)
    res = tp.run(max_blocks=3)
    assert np.isfinite(res.profiles).all()
    assert (res.hits.sum(axis=(0, 2)) == 3 * tp.out_per_block).all()


#: configurations the JAX package runs fused, with the file maker
FUSED = {
    "full": (dict(), {}, None),
    "full_stokes": (dict(npol_out=4), {}, None),
    "hybrid_sk": (dict(sk_enable=True, sk_m=64, block_parts=4), {}, None),
    "hybrid_rfi": (dict(rfi_filter=True), {}, None),
    "conv": (dict(nchan=1), {}, None),
    "complex": (dict(), CPLX, _complex_file),
    "pp": (dict(detection="pp"), {}, None),
    "cyclic": (dict(cyclic_nchan=4), {}, None),
    "one_pol": (dict(), dict(npol=1), _one_pol_file),
}


@pytest.mark.parametrize("name", list(FUSED))
def test_fused_configs_never_take_the_general_chain(tmp_path, name):
    kw, obs_kw, maker = FUSED[name]
    path = maker(tmp_path) if maker else _write_raw(tmp_path, 1 << 14)
    cfg = dict(BASE, **kw)
    jp = jl.FoldPipeline(raw_source("jax", path, **obs_kw),
                         jl.FoldConfig(**cfg))
    tp = tl.FoldPipeline(raw_source("port", path, **obs_kw),
                         tl.FoldConfig(**cfg), device="cpu")
    assert jp.mega_mode is not None
    assert tp.mega_mode == jp.mega_mode
    assert dataclasses.asdict(tp.mega_plan) == dataclasses.asdict(jp.mega_plan)


# ----------------------------------------------------------- search chain


def _twobit_search_file(tmp_path):
    path = str(tmp_path / "c.raw")
    codes = clean_twobit_codes(np.random.default_rng(3), 1 << 15, 4, 512)
    codes[5000:6000] = 3  # a saturated stretch JA98 excises
    pack2(codes).tofile(path)
    return path


SEARCH = {
    "critical": (dict(), {}, None),
    "critical_complex": (dict(nchan=8), CPLX, _complex_file),
    "ppqq_scrunched": (dict(npol_out=2, dispersion_measure=5.0,
                            tscrunch_factor=2, fscrunch_factor=2), {}, None),
    "coherence_f32": (dict(npol_out=4, dispersion_measure=5.0, nbits=32),
                      {}, None),
    "poln_select_1": (dict(poln_select=1, dispersion_measure=5.0), {}, None),
    "polyphase_complex": (dict(channelizer="polyphase", nchan=8,
                               pfb_ntaps=4), CPLX, _complex_file),
    "polyphase_f32": (dict(channelizer="polyphase", nbits=32), {}, None),
    "ja98": (dict(dispersion_measure=5.0), dict(nbit=2, nchan=2),
             _twobit_search_file),
    "ja98_scrunched": (dict(tscrunch_factor=4, fscrunch_factor=2),
                       dict(nbit=2, nchan=2), _twobit_search_file),
    "ja98_rescale_interval": (dict(rescale_seconds=0.002),
                              dict(nbit=2, nchan=2), _twobit_search_file),
}


@pytest.mark.parametrize("name", list(SEARCH))
def test_search_general_chain_matches_jax(tmp_path, name):
    kw, obs_kw, maker = SEARCH[name]
    path = maker(tmp_path) if maker else _write_raw(tmp_path, 1 << 16)
    cfg = dict(dict(nchan=4, block_parts=2, min_block_samples=1 << 12), **kw)
    jp = jfil.FilPipeline(raw_source("jax", path, **obs_kw),
                          jfil.FilConfig(**cfg))
    tp = tfil.FilPipeline(raw_source("port", path, **obs_kw),
                          tfil.FilConfig(**cfg), device="cpu")
    assert jp.megafil_plan is None and tp.megafil_plan is None
    assert (jp.npart, jp.block_in_samples, jp.stride_in_samples) == \
        (tp.npart, tp.block_in_samples, tp.stride_in_samples)
    assert plain(jp.obs_out) == plain(tp.obs_out)
    out = _run_both(tmp_path, jp, tp)
    assert out["jax"][0] == out["port"][0]
    assert tp._blocks_done == jp._blocks_done >= 2
    nbits = cfg.get("nbits", 8)
    _assert_data_close(_samples(out["jax"][1], nbits),
                       _samples(out["port"][1], nbits), nbits)


def test_digifil_cli_general_chain(tmp_path):
    """digifil with no -D, with -d 4, -P and --channelizer polyphase runs
    (``--threads`` still raises, ``test_torch_search.py``)."""
    from dspsr_tpu_torch.apps import digifil_app
    from dspsr_tpu_torch.io.sigproc import read_sigproc_header
    from test_torch_search import _dada

    raw = _dada(tmp_path, ndat=1 << 15)
    for args, nchans in ((["-F", "8"], 8), (["-F", "4", "-D", "5", "-d",
                                             "4"], 4),
                         (["-F", "4", "-D", "5", "-P", "1"], 4),
                         (["-F", "8", "--channelizer", "polyphase"], 8)):
        out = str(tmp_path / "cli.fil")
        assert digifil_app.main([raw, "-o", out, "--block-samples", "8192",
                                 "--device", "cpu", "-q", *args]) == 0
        items, hdr = read_sigproc_header(out)
        assert int(items["nchans"]) == nchans
        with open(out, "rb") as f:
            assert len(f.read()) > hdr

