"""Polarization calibration (a Jones response mixed into the two pols'
spectra, reference matrix convolution) in the port, on the CPU:

- ``ops.polncal`` (the port's copy) against the JAX package's on
  synthesized ``.npz``, text and database solutions (as
  ``tests/test_polncal.py`` writes them): equal arrays;
- ``MegaConstants.build(jones=)`` and ``convert.jones_from_numpy`` against
  the JAX package's ``MegaConstants.jxr/jxi``: bitwise;
- the Jones front end (``megafil_plain``) against the JAX package's
  ``build_megafil`` with a Jones response (its Pallas kernel in interpret
  mode), at nsub 1 and inside a filterbank, real and complex input,
  detected and voltage output, with the passband tap and a masked scalar
  slot: 2e-5 relative;
- ``FoldPipeline(calibration_path=...)`` against the JAX pipeline on 8-bit
  input (profiles 2e-4 relative, hits exact), and the leakage check of
  ``tests/test_polncal.py``: the calibrated fold's cross-polar power is a
  small fraction of the uncalibrated one's.
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dspsr_tpu.models import load_to_fold as jl
from dspsr_tpu.ops import megakernel as jmk
from dspsr_tpu.ops import polncal as jpc
from dspsr_tpu.ops.filterbank import FilterbankPlan
from dspsr_tpu.ops.response import Response as JResponse

from dspsr_tpu_torch import convert
from dspsr_tpu_torch.models import load_to_fold as tl
from dspsr_tpu_torch.ops import megakernel as tmk
from dspsr_tpu_torch.ops import polncal as tpc
from dspsr_tpu_torch.ops.response import Response as TResponse
from test_torch_hybrid import _assert_results
from test_torch_pipeline import BASE, make_obs, raw_source

torch.set_num_threads(2)

TOL = 2e-5
NPART = 3


def _rel(got, want):
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape
    return np.abs(got - want).max() / np.abs(want).max()


def jones_solution(freqs):
    """A frequency-dependent leaky instrument (``tests/test_polncal.py``):
    J = [[1, eps(f)], [0.1 eps*(f), 1]]."""
    eps = 0.3 * np.exp(2j * np.pi * (freqs - 1398.0) / 8.0)
    j = np.zeros((len(freqs), 2, 2), np.complex128)
    j[:, 0, 0] = j[:, 1, 1] = 1.0
    j[:, 0, 1] = eps
    j[:, 1, 0] = 0.1 * np.conj(eps)
    return j


# --------------------------------------------------------------- polncal


def test_polncal_copy_matches_jax(tmp_path):
    freqs = np.linspace(1398.0, 1402.0, 16)
    j = jones_solution(freqs)
    np.savez(tmp_path / "a.npz", freq=freqs, jones=j)
    np.savez(tmp_path / "b.npz", freq=freqs[::-1], jones=2 * j[::-1])
    rows = np.column_stack([freqs] + [
        arr for a in range(2) for b in range(2)
        for arr in (j[:, a, b].real, j[:, a, b].imag)])
    np.savetxt(tmp_path / "a.txt", rows)
    db = tmp_path / "database.txt"
    db.write_text("dspsr_tpu/cal database\na.npz 55000 55100\n"
                  "b.npz 55200 55400\n")
    for name in ("a.npz", "b.npz", "a.txt"):
        f1, j1 = jpc.load_jones_cal(str(tmp_path / name))
        f2, j2 = tpc.load_jones_cal(str(tmp_path / name))
        assert np.array_equal(f1, f2) and np.array_equal(j1, j2)
    for epoch in (55050.0, 55299.0, 56000.0):
        assert jpc.select_from_database(str(db), epoch) == \
            tpc.select_from_database(str(db), epoch)
    obs = {pkg: make_obs(pkg, bandwidth=4.0, state="ANALYTIC", ndim=2)
           for pkg in ("jax", "port")}
    chirp = np.exp(1j * np.linspace(0, 9, 3 * 64)).reshape(3, 64)
    for path, epoch in ((db, 55299.0), (tmp_path / "a.txt", None)):
        jc = jpc.PolnCalibration.load(str(path), epoch_mjd=epoch)
        tc = tpc.PolnCalibration.load(str(path), epoch_mjd=epoch)
        jr, tr = jc.match(obs["jax"], 3, 64), tc.match(obs["port"], 3, 64)
        assert np.array_equal(jr.phasors, tr.phasors)
        jp = jpc.jones_product(JResponse(chirp, 4, 5), jr)
        tp = tpc.jones_product(TResponse(chirp, 4, 5), tr)
        assert np.array_equal(jp.phasors, tp.phasors)
        assert (jp.impulse_pos, jp.impulse_neg) == \
            (tp.impulse_pos, tp.impulse_neg) == (4, 5)
    with pytest.raises(ValueError, match="epoch"):
        tpc.PolnCalibration.load(str(db))


# ------------------------------------------------------------- constants


def _plan(real=True, nsub=1, freq_res=256, nchan_in=2, **kw):
    fb = FilterbankPlan(real_input=real, nchan_subband=nsub,
                        freq_res=freq_res, nfilt_pos=5, nfilt_neg=6)
    plan = jmk.MegaPlan.from_filterbank(fb, nbin=2, npol=2, nchan_in=nchan_in,
                                        **kw)
    assert plan is not None
    return plan


def _jones(plan, rng):
    shape = (plan.nchan_in, plan.n_fft, 2, 2)
    return rng.normal(size=shape) + 1j * rng.normal(size=shape)


@pytest.mark.parametrize("real", [True, False], ids=["real", "complex"])
@pytest.mark.parametrize("nsub", [1, 4])
def test_constants_and_convert_match_jax(real, nsub):
    plan = _plan(real, nsub, 256 // nsub)
    rng = np.random.default_rng(nsub + real)
    J = _jones(plan, rng)
    jcst = jmk.MegaConstants(plan, None, dtype=np.float32, jones=J)
    tplan = tmk.MegaPlan(**dataclasses.asdict(plan))
    cst = tmk.MegaConstants.build(tplan, None, jones=J).to("cpu")
    assert cst.jones.shape == (2, 4, plan.n_fft, 2)
    assert torch.equal(convert.jones_from_numpy(jcst.jxr, jcst.jxi, tplan,
                                                "cpu"), cst.jones)
    # plane 2a + b of bin k is J[k, a, b], in natural (centred) order
    k = 37
    for a in range(2):
        for b in range(2):
            got = complex(*cst.jones[1, 2 * a + b, k].tolist())
            assert abs(got - J[1, k, a, b]) < 1e-6 * abs(J[1, k, a, b])
    # the chirp slot is ones when the Jones response carries the chirp
    assert torch.equal(cst.gr, torch.ones_like(cst.gr))
    assert not cst.gi.any()


def test_jones_constants_refusals():
    plan = tmk.MegaPlan(**dataclasses.asdict(_plan()))
    rng = np.random.default_rng(0)
    with pytest.raises(ValueError, match="shape"):
        tmk.MegaConstants.build(plan, None,
                                jones=_jones(plan, rng)[:, :-1])
    one = dataclasses.replace(plan, npol=1)
    for mk in (lambda: tmk.MegaConstants.build(one, None,
                                               jones=_jones(plan, rng)),
               lambda: jmk.MegaConstants(dataclasses.replace(_plan(), npol=1),
                                         None, jones=_jones(plan, rng))):
        with pytest.raises(ValueError, match="npol"):
            mk()


# ------------------------------------------------------------- front end


FRONT_CASES = {
    "real_sum": dict(),
    "real_stokes": dict(npol_out=4),
    "real_qq": dict(npol_out=1, detection="qq"),
    "real_filterbank_ppqq": dict(nsub=4, freq_res=64, npol_out=2),
    "complex_coherence": dict(real=False, npol_out=4, detection="coherence"),
    "complex_pp": dict(real=False, npol_out=1, detection="pp"),
    "complex_filterbank_sum": dict(real=False, nsub=4, freq_res=64),
    "real_voltage": dict(output="voltage"),
    "complex_voltage": dict(real=False, output="voltage"),
}


@pytest.mark.parametrize("name", list(FRONT_CASES))
@pytest.mark.parametrize("tap", [False, True], ids=["bare", "masked_tap"])
def test_jones_front_end_matches_pallas(name, tap):
    kw = dict(FRONT_CASES[name])
    output = kw.pop("output", "detected")
    plan = _plan(**kw)
    rng = np.random.default_rng(len(name) + tap)
    raw = rng.integers(0, 256, size=plan.block_ndat(NPART) * plan.nchan_in
                       * 2 * plan.ndim, dtype=np.uint8)
    resp = np.exp(1j * rng.uniform(-3, 3, (plan.nchan_in * plan.nsub,
                                           plan.freq_res)))
    # the chirp times a calibration, as jones_product makes it
    J = _jones(plan, rng) * resp.reshape(plan.nchan_in, -1)[:, :, None, None]
    scale, offset = jmk.unpack_affine(8)
    jcst = jmk.MegaConstants(plan, None, dtype=np.float32,
                             unpack_scale=scale, unpack_offset=offset,
                             jones=J)
    tplan = tmk.MegaPlan(**dataclasses.asdict(plan))
    cst = tmk.MegaConstants.build(tplan, None, scale, offset,
                                  jones=J).to("cpu")
    t = torch.from_numpy(raw)
    if tap:
        mask = (rng.uniform(size=(plan.nchan_in, plan.n_fft)) > 0.1).astype(
            np.float32)
        mr, _ = jmk.permute_response(jnp.asarray(mask), jnp.zeros_like(mask),
                                     plan)
        jresp = (jnp.asarray(jcst.gr) * mr, jnp.asarray(jcst.gi) * mr)
        jdata, jpb = jmk.build_megafil(
            plan, jcst, NPART, interpret=True, output=output, passband=True,
            response_as_args=True)(jnp.asarray(raw), *jresp)
        gr, gi = convert.response_from_numpy([np.asarray(a) for a in jresp],
                                             tplan, "cpu")
        data, pb = tmk.build_megafil(
            tplan, cst, NPART, output=output, passband=True,
            response_as_args=True)(t, gr, gi)
        assert pb.shape == (plan.nchan_in * plan.nsub, 2, plan.freq_res)
        assert _rel(pb.numpy(), np.asarray(jpb)) < TOL
        # the mask zeroes the scalar slot after the mix: those bins' data
        # differ from the bare front end's
        bare = tmk.megafil_plain(tplan, cst, t, NPART, output=output)
        assert _rel(bare.numpy(), data.numpy()) > 1e-3
    else:
        jdata = jmk.build_megafil(plan, jcst, NPART, interpret=True,
                                  output=output)(jnp.asarray(raw))
        data = tmk.build_megafil(tplan, cst, NPART, output=output)(t)
    if output == "voltage":
        jdata = np.asarray(jdata[0]) + 1j * np.asarray(jdata[1])
    assert _rel(data.numpy(), np.asarray(jdata)) < TOL
    # without the mix the same bytes give other numbers
    plain = tmk.MegaConstants.build(tplan, resp, scale, offset).to("cpu")
    other = tmk.megafil_plain(tplan, plain, t, NPART, output=output)
    assert _rel(other.numpy(), np.asarray(jdata)) > 1e-2


def test_jones_on_the_fold_step_raises():
    plan = tmk.MegaPlan(**dataclasses.asdict(_plan(nsub=4, freq_res=64)))
    cst = tmk.MegaConstants.build(
        plan, None, jones=_jones(plan, np.random.default_rng(1))).to("cpu")
    with pytest.raises(NotImplementedError, match="hybrid engine"):
        tmk.build_megastep(plan, cst, NPART)


# ------------------------------------------------------------- the slice


def _leaky(tmp_path, real, nsamp=1 << 16, seed=7):
    """Dual-pol noise with a 5 ms pulse, mixed by a leaky instrument per
    frequency bin and digitized to 8 bits (complex: 2 bytes a pol sample;
    real: 1), and the instrument's solution as ``cal.npz``."""
    rng = np.random.default_rng(seed)
    obs = make_obs("port", bandwidth=2.0, state="NYQUIST" if real
                   else "ANALYTIC", ndim=1 if real else 2)
    if real:
        clean = rng.standard_normal((2, nsamp))
        spec = np.fft.rfft(clean, axis=-1)
        freqs = (obs.centre_frequency - 0.5 * obs.bandwidth
                 + obs.bandwidth * np.fft.rfftfreq(nsamp) * 2)
    else:
        clean = (rng.standard_normal((2, nsamp))
                 + 1j * rng.standard_normal((2, nsamp)))
        spec = np.fft.fft(clean, axis=-1)
        freqs = obs.centre_frequency + obs.bandwidth * np.fft.fftfreq(nsamp)
    cal = np.sort(freqs)
    j = jones_solution(cal)
    jp = np.empty((freqs.size, 2, 2), np.complex128)
    for a in range(2):
        for b in range(2):
            jp[:, a, b] = (np.interp(freqs, cal, j[:, a, b].real)
                           + 1j * np.interp(freqs, cal, j[:, a, b].imag))
    mixed = np.einsum("fab,bf->af", jp, spec)
    x = (np.fft.irfft(mixed, n=nsamp, axis=-1) if real
         else np.fft.ifft(mixed, axis=-1))
    t = np.arange(nsamp) / obs.rate
    x = x * np.where((t % 0.005) < 0.0005, 1.3, 1.0) * 12.0
    parts = [x.real] if real else [x.real, x.imag]
    tfp = np.stack([np.stack(parts, -1)[p] for p in range(2)], 1)  # t, p, d
    q = np.clip(np.round(tfp + 127.5), 0, 255).astype(np.uint8)
    path = tmp_path / "leaky.raw"
    q.tofile(path)
    np.savez(tmp_path / "cal.npz", freq=cal, jones=j)
    return str(path), str(tmp_path / "cal.npz")


def _leak(res):
    """Cross-polar over total power of the folded Stokes profile."""
    prof = res.profiles[0, 0]
    return np.sqrt(prof[1] ** 2 + prof[2] ** 2 + prof[3] ** 2).mean() / \
        prof[0].mean()


@pytest.mark.parametrize("real", [True, False], ids=["real", "complex"])
@pytest.mark.parametrize("dm", [5.0, 0.0], ids=["dedispersed", "cal_only"])
def test_calibration_pipeline_matches_jax(tmp_path, real, dm):
    path, cal = _leaky(tmp_path, real)
    obs_kw = dict(bandwidth=2.0) if real else dict(
        bandwidth=2.0, state="ANALYTIC", ndim=2)
    cfg = dict(BASE, nchan=1, npol_out=4, dispersion_measure=dm,
               frequency_resolution=512, calibration_path=cal)
    jp = jl.FoldPipeline(raw_source("jax", path, **obs_kw),
                         jl.FoldConfig(**cfg))
    tp = tl.FoldPipeline(raw_source("port", path, **obs_kw),
                         tl.FoldConfig(**cfg), device="cpu")
    assert jp.mega_mode == tp.mega_mode == "hybrid"
    assert dataclasses.asdict(tp.mega_plan) == \
        dataclasses.asdict(jp.mega_plan)
    assert tp.jones is not None and tp.constants.jones is not None
    _assert_results(jp.run(max_blocks=3), tp.run(max_blocks=3))
    path_ops = [op["op"] for op in tp.signal_path()]
    assert "PolnCalibration" in path_ops and "Convolution" in path_ops


@pytest.mark.parametrize("real", [True, False], ids=["real", "complex"])
def test_calibration_removes_leakage(tmp_path, real):
    """The port's calibrated fold of the whole file (8 bins over 2^16
    samples: the noise in Q, U and V is ~1% of I) has a small fraction of
    the uncalibrated fold's cross-polar power."""
    path, cal = _leaky(tmp_path, real)
    obs_kw = dict(bandwidth=2.0) if real else dict(
        bandwidth=2.0, state="ANALYTIC", ndim=2)
    cfg = dict(BASE, nchan=1, npol_out=4, nbin=8, frequency_resolution=512,
               block_parts=8)
    leak = [_leak(tl.FoldPipeline(raw_source("port", path, **obs_kw),
                                  tl.FoldConfig(**c), device="cpu").run())
            for c in (cfg, dict(cfg, calibration_path=cal))]
    assert leak[1] < 0.25 * leak[0]
    assert leak[1] < 0.05


def test_calibration_in_a_filterbank_raises(tmp_path):
    path, cal = _leaky(tmp_path, False, nsamp=1 << 12)
    with pytest.raises(NotImplementedError, match="filterbank"):
        tl.FoldPipeline(raw_source("port", path, state="ANALYTIC", ndim=2),
                        tl.FoldConfig(**dict(BASE, calibration_path=cal)),
                        device="cpu")
