"""The port's phase-locked filterbank (``ops/phase_locked.py``, plain
PyTorch, ``device="cpu"``) against the JAX package's
(``dspsr_tpu/ops/phase_locked.py``), on the cases of ``tests/test_plfb.py``
and through both ``dspsr -G`` CLIs: spectra within 2e-4 of the largest
magnitude (float32 FFTs in both, pocketfft against the JAX package's DFT
matmuls), hits and the window walk exact, and the tone in its channel.
"""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from dspsr_tpu.ops import phase_locked as jpl
from dspsr_tpu.timing.mjd import MJD as JMJD
from dspsr_tpu.timing.polyco import FixedPeriodPredictor as JFixed

from dspsr_tpu_torch.ops import phase_locked as tpl
from dspsr_tpu_torch.timing.mjd import MJD
from dspsr_tpu_torch.timing.polyco import FixedPeriodPredictor

torch.set_num_threads(2)


def close(got, want, tol=2e-4):
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape
    assert np.abs(got - want).max() <= tol * np.abs(want).max()


def test_window_plan_fixed_period():
    """Boundaries every period/nbin seconds, bins cycling, and the same
    walk as the JAX package's."""
    rate, period, nbin = 10000.0, 0.1, 8
    plan = tpl.PLFPlan(nchan=16, nbin=nbin)
    t0 = MJD.from_mjd(55000.0)
    starts, bins = tpl.window_plan(FixedPeriodPredictor(period, t0), t0,
                                   rate, 4000, plan)
    jt0 = JMJD.from_mjd(55000.0)
    js, jb = jpl.window_plan(JFixed(period, jt0), jt0, rate, 4000,
                             jpl.PLFPlan(nchan=16, nbin=nbin))
    assert np.array_equal(starts, js) and np.array_equal(bins, jb)
    assert len(starts) > 20
    assert np.all((np.diff(bins) % nbin) == 1)
    assert np.all(np.abs(np.diff(starts) - 125) <= 1)


@pytest.mark.parametrize("npol_out", [1, 2, 4])
def test_plf_fold_matches_jax(rng, npol_out):
    nwin, nchan_in, npol_in, nchan, nbin = 12, 2, 2, 16, 4
    windows = rng.normal(size=(nwin, nchan_in, npol_in, 2 * nchan)
                         ).astype(np.float32)
    bins = rng.integers(0, nbin, size=nwin).astype(np.int32)
    s0 = np.zeros((nchan_in * nchan, npol_out, nbin), np.float32)
    h0 = np.zeros(nbin, np.float32)
    s_t, h_t = tpl.plf_fold_block(
        torch.from_numpy(s0), torch.from_numpy(h0),
        torch.from_numpy(windows), torch.from_numpy(bins),
        tpl.PLFPlan(nchan=nchan, nbin=nbin, npol_out=npol_out))
    s_j, h_j = jpl.plf_fold_block(
        jnp.asarray(s0), jnp.asarray(h0), jnp.asarray(windows),
        jnp.asarray(bins),
        jpl.PLFPlan(nchan=nchan, nbin=nbin, npol_out=npol_out))
    close(s_t, s_j)
    assert np.array_equal(h_t.numpy(), np.asarray(h_j))
    s_n, h_n = tpl.plf_fold_numpy(
        s0, h0, windows, bins,
        tpl.PLFPlan(nchan=nchan, nbin=nbin, npol_out=npol_out))
    np.testing.assert_allclose(s_t.numpy(), s_n, rtol=2e-4, atol=2e-4)
    assert np.array_equal(h_t.numpy(), h_n)


def test_plf_fold_analytic(rng):
    nwin, nchan_in, npol_in, nchan, nbin = 6, 1, 2, 32, 4
    wr, wi = (rng.normal(size=(nwin, nchan_in, npol_in, nchan)
                         ).astype(np.float32) for _ in range(2))
    bins = rng.integers(0, nbin, size=nwin).astype(np.int32)
    s0 = np.zeros((nchan_in * nchan, 4, nbin), np.float32)
    h0 = np.zeros(nbin, np.float32)
    w = torch.complex(torch.from_numpy(wr), torch.from_numpy(wi))
    s_t, h_t = tpl.plf_fold_block(
        torch.from_numpy(s0), torch.from_numpy(h0), w,
        torch.from_numpy(bins),
        tpl.PLFPlan(nchan=nchan, nbin=nbin, npol_out=4, real_input=False))
    s_j, h_j = jpl.plf_fold_block(
        jnp.asarray(s0), jnp.asarray(h0),
        (jnp.asarray(wr), jnp.asarray(wi)), jnp.asarray(bins),
        jpl.PLFPlan(nchan=nchan, nbin=nbin, npol_out=4, real_input=False))
    close(s_t, s_j)
    assert np.array_equal(h_t.numpy(), np.asarray(h_j))
    s_n, _ = tpl.plf_fold_numpy(
        s0, h0, wr + 1j * wi, bins,
        tpl.PLFPlan(nchan=nchan, nbin=nbin, npol_out=4, real_input=False))
    np.testing.assert_allclose(s_t.numpy(), s_n, rtol=2e-4, atol=2e-4)


@pytest.mark.parametrize("complex_input", [False, True],
                         ids=["real", "complex"])
def test_extract_windows_matches_jax(rng, complex_input):
    x = rng.normal(size=(2, 2, 500)).astype(np.float32)
    if complex_input:
        x = (x + 1j * rng.normal(size=x.shape)).astype(np.complex64)
    starts = np.array([0, 17, 100, 468], np.int64)
    got = tpl.extract_windows(torch.from_numpy(x), torch.from_numpy(starts),
                              32)
    assert np.array_equal(got.numpy(), jpl.extract_windows(x, starts, 32))


def _tone(tmp_path, pkg):
    """``test_plfb.py``'s tone (1 kHz in a 4 kHz band, both pols) as a raw
    file read through package ``pkg``'s RawFileSource."""
    from test_torch_pipeline import PKGS

    src, obs, mjd = PKGS[pkg]
    rate, nsamp = 8000.0, 60000
    path = tmp_path / "tone.raw"
    if not path.exists():
        t = np.arange(nsamp) / rate
        tone = np.cos(2 * np.pi * 1000.0 * t) * 20
        raw2 = np.stack([tone, tone], axis=1).reshape(-1)
        (np.clip(np.round(raw2), -127, 127).astype(np.int64) + 128).astype(
            np.uint8).tofile(path)
    o = obs.Observation(
        nchan=1, npol=2, ndim=1, nbit=8, centre_frequency=1000.0,
        bandwidth=4.0 / 1000, rate=rate,
        start_time=mjd.MJD.from_mjd(55000.0), state=obs.Signal.NYQUIST,
        source="TONE", ndat=nsamp)
    return src.RawFileSource(str(path), o)


@pytest.mark.parametrize("npol_out", [1, 4])
def test_phase_locked_fold_end_to_end(tmp_path, npol_out):
    """The tone lands in channel 4 in every phase bin, hits are balanced,
    and spectra and hits equal the JAX package's."""
    src = _tone(tmp_path, "port")
    jsrc = _tone(tmp_path, "jax")
    res = tpl.phase_locked_fold(
        src, FixedPeriodPredictor(0.25, src.obs.start_time), nbin=8,
        nchan=16, npol_out=npol_out, block_samples=16384, device="cpu")
    jres = jpl.phase_locked_fold(
        jsrc, JFixed(0.25, jsrc.obs.start_time), nbin=8, nchan=16,
        npol_out=npol_out, block_samples=16384)
    close(res.spectra, jres.spectra)
    assert np.array_equal(res.hits, jres.hits)
    assert res.hits.sum() > 0
    assert np.all(res.normalized().argmax(axis=0)[0] == 4)
    assert res.hits.max() - res.hits.min() <= 2


def test_suggest_nchan():
    assert tpl.suggest_nchan(1.0, 8192.0, 8) == 1024
    assert tpl.suggest_nchan(0.1, 10000.0, 8) == 64
    for args in ((1.0, 8192.0, 8), (0.1, 10000.0, 8), (0.37, 2e6, 64)):
        assert tpl.suggest_nchan(*args) == jpl.suggest_nchan(*args)


@pytest.mark.parametrize("extra", [
    ["-G", "8", "--plfb-chan", "16"],
    ["-G", "8", "-d", "2", "-T", "2.5"],
], ids=["chan16", "auto_chan_ppqq_total"])
def test_cli_plfb_matches_jax(tmp_path, extra):
    """``dspsr -G``: the port's npz (``--device cpu``) equals the JAX
    CLI's: spectra within 2e-4, hits and the geometry exact."""
    from dspsr_tpu.apps import dspsr_app as japp

    from dspsr_tpu_torch.apps import dspsr_app as tapp

    src = _tone(tmp_path, "port")
    hdr = ["--header", "FREQ=1000", "BW=0.004", "NCHAN=1", "NPOL=2",
           "NDIM=1", "NBIT=8", "TSAMP=125", "UTC_START=2010-04-13-02:05:45",
           "SOURCE=TONE"]
    outs = []
    for tag, main, dev in (("j", japp.main, []),
                           ("t", tapp.main, ["--device", "cpu"])):
        out = str(tmp_path / f"{tag}_plfb.npz")
        assert main([src.path, *hdr, "-c", "0.25", *extra, "-O", out, "-q",
                     *dev]) == 0
        outs.append(np.load(out))
    a, b = outs
    assert set(a.files) == set(b.files)
    close(b["spectra"], a["spectra"])
    for k in a.files:
        if k != "spectra":
            assert np.array_equal(a[k], b[k]), k
    nchan = int(b["nchan"])
    prof = b["spectra"] / np.maximum(b["hits"], 1)[None, None, :]
    assert np.all(prof[:, 0].argmax(axis=0) == nchan // 4)
