"""The port's lag-domain spectrometry (``ops/autocorrelation.py``), geometric
delays (``ops/geometric.py``) and measured FFT lengths
(``utils/optimalfft.py``, ``utils/fftbench.py``, ``FoldPipeline(
use_fft_bench=True)``) against the JAX package's, on the CPU: the cases of
``tests/test_extras.py`` (``TestAutocorrelation``, ``TestACFilterbank``,
``TestOptimalFFT``) and ``tests/test_geometric.py``, each run on the port
and, from the same numpy inputs, compared with the JAX function.

Tolerances: lag products and their means 1e-5 of the largest magnitude
(float32 in both, summed in other orders); where a float32 FFT is on the
path 2e-4; the geometric delays (the same numpy code) exactly.  The FFT
cost tables are given to both benches from one file, so no test asserts a
measured time.
"""

import json
import math

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dspsr_tpu.ops import autocorrelation as jac
from dspsr_tpu.ops import geometric as jgeo

from dspsr_tpu_torch.ops import autocorrelation as tac
from dspsr_tpu_torch.ops import geometric as tgeo

torch.set_num_threads(2)


def both_sc(c):
    """A complex numpy array as the JAX package's split-complex float32
    pair and as the port's complex64 tensor."""
    c = np.asarray(c, np.complex64)
    return ((jnp.asarray(c.real), jnp.asarray(c.imag)),
            torch.from_numpy(c.copy()))


def close(got: torch.Tensor, want, tol: float) -> float:
    """Largest difference of ``got`` (complex or real tensor) from the JAX
    result ``want`` (split-complex pair or array) over its largest
    magnitude; asserts it is within ``tol``."""
    if isinstance(want, tuple):
        want = np.asarray(want[0]) + 1j * np.asarray(want[1])
    got = got.numpy()
    want = np.asarray(want)
    assert got.shape == want.shape
    err = float(np.abs(got - want).max() / np.abs(want).max())
    assert err <= tol, err
    return err


class TestAutocorrelation:
    def test_tone_spectrum(self):
        nlag, n, f = 17, 8192, 0.125
        x = np.exp(2j * np.pi * f * np.arange(n))[None, None, :]
        jx, tx = both_sc(x)
        acf = tac.autocorrelation(tx, nlag)
        close(acf, jac.autocorrelation(jx, nlag), 1e-5)
        spec = tac.acf_spectra(acf)[0, 0]
        np.testing.assert_allclose(
            spec, jac.acf_spectra(jac.autocorrelation(jx, nlag))[0, 0],
            rtol=0, atol=1e-5 * np.abs(spec).max())
        nfull = 2 * (nlag - 1)
        assert spec.argmax() == int(round((f + 0.5) * nfull))
        np.testing.assert_allclose(acf.abs().numpy()[0, 0], 1.0, atol=1e-5)

    def test_acf_filterbank_time_resolved(self, rng):
        n = 4096
        x = rng.standard_normal(n) + 1j * rng.standard_normal(n)
        x[: n // 2] *= 10.0  # louder first half
        jx, tx = both_sc(x[None, None, :])
        out = tac.acf_filterbank(tx, 5, 2)
        close(out, jac.acf_filterbank(jx, 5, 2), 1e-5)
        assert out.shape == (1, 1, 5, 2)
        p = out.real.numpy()[0, 0, 0]  # lag-0 power of each block
        assert p[0] > 50 * p[1]


class TestACFilterbank:
    def _signal(self, n=4096, seed=3):
        rng = np.random.default_rng(seed)
        c = rng.standard_normal((1, 1, n)) + 1j * rng.standard_normal(
            (1, 1, n))
        c += 3.0 * np.exp(2j * np.pi * 0.19 * np.arange(n))
        return c

    @pytest.mark.parametrize("window", [False, True],
                             ids=["plain", "window"])
    def test_psd_matches_jax_and_numpy(self, window):
        c = self._signal()
        nchan, nlag = 64, 32
        ngood = nchan - nlag
        jx, tx = both_sc(c)
        win = np.hanning(ngood).astype(np.float32) if window else None
        got = tac.ac_filterbank(tx, nchan, nlag, window=(
            torch.from_numpy(win) if window else None))
        want = jac.ac_filterbank(jx, nchan, nlag, window=(
            jnp.asarray(win) if window else None))
        close(got, want, 2e-4)
        assert float(got.imag.abs().max()) == 0.0
        nwin = c.shape[-1] // ngood
        ref = np.empty((1, 1, nwin, nchan))
        for w in range(nwin):
            seg = np.zeros(nchan, np.complex128)
            seg[:ngood] = c[0, 0, w * ngood:(w + 1) * ngood] * (
                win if window else 1.0)
            ref[0, 0, w] = np.abs(np.fft.fft(seg)) ** 2
        np.testing.assert_allclose(got.real.numpy(), ref, rtol=2e-3,
                                   atol=1e-2)

    def test_acf_is_noncyclic(self):
        c = self._signal()
        nchan, nlag = 64, 32
        ngood = nchan - nlag
        jx, tx = both_sc(c)
        got = tac.ac_filterbank(tx, nchan, nlag, form_acf=True)
        close(got, jac.ac_filterbank(jx, nchan, nlag, form_acf=True), 2e-4)
        assert got.shape[-1] == nlag
        seg = c[0, 0, :ngood]
        for lag in (0, 5, 17):
            direct = np.sum(seg[lag:] * np.conj(seg[:ngood - lag]))
            v = complex(got[0, 0, 0, lag])
            assert abs(v - direct) / max(abs(direct), 1e-9) < 5e-3


# ------------------------------------------------------------- geometric


GEOMS = [
    (np.array([[0.0, 0, 0], [1000.0, 0, 0]]), 0.0, 0.0),
    (np.array([[0.0, 0, 0], [0.0, 1000.0, 0]]), 0.0, 0.0),
    (np.array([[0.0, 0, 0], [2000.0, -500.0, 300.0]]), 0.3, -0.7),
    (np.array([[0.0, 0, 0], [15000.0, 0, 0]]), 0.0, 0.0),
]


@pytest.mark.parametrize("b,h,d", GEOMS, ids=["X", "Y", "XYZ", "long"])
def test_geometric_matches_jax(b, h, d):
    """Delays, rates, integer delays and responses equal the JAX copy's."""
    g, jg = tgeo.GeometricDelay(b, h, d), jgeo.GeometricDelay(b, h, d)
    assert np.array_equal(g.delays_seconds(), jg.delays_seconds())
    assert np.array_equal(g.delay_rate(), jg.delay_rate())
    assert g.get_delay(0, 1, 1e6) == jg.get_delay(0, 1, 1e6)
    for a, w in zip(g.response(2, 64, 1400.0, 8.0),
                    jg.response(2, 64, 1400.0, 8.0)):
        assert np.array_equal(a, w)
    assert np.array_equal(tgeo.source_unit_vector(h, d),
                          jgeo.source_unit_vector(h, d))


def test_zenith_meridian_geometry():
    g = tgeo.GeometricDelay(GEOMS[0][0])
    tau = g.delays_seconds()
    assert tau[0] == 0.0
    assert tau[1] == pytest.approx(1000.0 / tgeo.C_M_PER_S)
    g2 = tgeo.GeometricDelay(GEOMS[1][0])
    assert g2.delays_seconds()[1] == pytest.approx(0.0, abs=1e-18)


def test_delay_rate_matches_numeric_derivative():
    b, h, d = GEOMS[2]
    eps = 1e-6
    gp = tgeo.GeometricDelay(b, h + eps, d)
    gm = tgeo.GeometricDelay(b, h - eps, d)
    num = (gp.delays_seconds() - gm.delays_seconds()) / (2 * eps) \
        * tgeo.OMEGA_EARTH
    np.testing.assert_allclose(tgeo.GeometricDelay(b, h, d).delay_rate(),
                               num, rtol=1e-6, atol=1e-22)


def test_integer_delay_and_response_phase():
    rate = 1e6
    g = tgeo.GeometricDelay(np.array([[0.0, 0, 0], [3000.0, 0, 0]]))
    tau = g.delays_seconds()[1]
    assert g.get_delay(0, 1, rate) == round(tau * rate)
    rr, ri = g.response(nchan=2, nfft=64, centre_frequency=1400.0,
                        bandwidth=8.0)
    assert rr.shape == (2, 2, 64)
    np.testing.assert_allclose(rr[0], 1.0, atol=1e-7)
    np.testing.assert_allclose(ri[0], 0.0, atol=1e-7)
    ph = np.unwrap(np.arctan2(ri[1, 0], rr[1, 0]))
    df = (8.0 / 2 / 64) * 1e6
    slope = (ph[-1] - ph[0]) / (len(ph) - 1)
    assert math.remainder(slope + 2 * math.pi * df * tau,
                          2 * math.pi) == pytest.approx(0.0, abs=1e-3)


def test_response_shifts_a_tone():
    """The response, applied to a tone's spectrum on the port's FFT,
    delays it by tau and stops the fringe."""
    from dspsr_tpu_torch.ops import fft

    n, rate, cf, bw = 4096, 1e6, 100.0, 1.0
    g = tgeo.GeometricDelay(GEOMS[3][0])
    tau = g.delays_seconds()[1]
    t = np.arange(n) / rate
    f_off = 12345.0
    x = torch.from_numpy(np.exp(2j * np.pi * f_off * t).astype(np.complex64))
    rr, ri = g.response(1, n, cf, bw)
    resp = torch.from_numpy((rr[1, 0] + 1j * ri[1, 0]).astype(np.complex64))
    y = fft.ifft(fft.fft(x) * fft.ifftshift(resp)).numpy()
    expect = np.exp(2j * np.pi * f_off * (t - tau)) * np.exp(
        -2j * np.pi * (cf * 1e6) * tau)
    m = slice(100, n - 100)
    assert np.abs(y[m] - expect[m]).max() < 2e-3


# ------------------------------------------------- measured FFT lengths


def cost_table(path, best: int, nmax: int = 1 << 26) -> dict:
    """Write an FFT cost table (the JAX package's JSON format, ``{"N":
    seconds}``, every power of two from 16 to ``nmax``) whose cost per
    useful sample is least at ``best`` for small smears; returns it."""
    table = {}
    n = 16
    while n <= nmax:
        table[n] = n * 1e-9 * (1 + 4 * abs(math.log2(n / best)))
        n *= 2
    path.parent.mkdir(parents=True, exist_ok=True)
    path.write_text(json.dumps({str(k): v for k, v in table.items()}))
    return table


@pytest.fixture
def tables(tmp_path, monkeypatch):
    """Point both packages' FFT benches at empty cache directories; returns
    a function that writes one cost table into both."""
    import dspsr_tpu.utils.optimalfft as joff

    import dspsr_tpu_torch.utils.optimalfft as toff

    jdir, tdir = tmp_path / "jax", tmp_path / "port"
    monkeypatch.setattr(joff, "_CACHE_DIR", str(jdir))
    monkeypatch.setattr(toff, "_CACHE_DIR", tdir)

    def write(best):
        cost_table(jdir / "fftbench_cpu.json", best)
        return cost_table(port_table(), best)
    return write


def port_table(device="cpu"):
    """Where the port's default ``FFTBench`` on ``device`` keeps its cost
    table (the file name holds the bench's method)."""
    from dspsr_tpu_torch.utils.optimalfft import FFTBench

    return FFTBench(device, cache=False)._cache_path


def test_best_ndat_covers_smear_and_caches(tables):
    """The port's bench times ``torch.fft`` on the CPU, caches the table
    keyed by the device, and a second bench reads it (test_extras.py
    ``TestOptimalFFT``)."""
    from dspsr_tpu_torch.utils.optimalfft import FFTBench, OptimalFFT

    bench = FFTBench("cpu", batch=2, trials=1)
    opt = OptimalFFT(bench)
    n = opt.get_best_ndat(nfilt_tot=100, max_nfft=1 << 14)
    assert n > 100 and (n & (n - 1)) == 0
    assert bench._cache_path.name == "fftbench_cpu_min4194304_batch2.json"
    assert bench._cache_path.exists()
    assert FFTBench("cpu", trials=1)._table == {}  # another method
    bench2 = FFTBench("cpu", batch=2, trials=1)
    assert bench2._table == bench._table and bench2._table
    assert opt.compute_cost(n, 100) > 0


@pytest.mark.parametrize("nfilt", [0, 5, 100, 300, 5000])
@pytest.mark.parametrize("best", [64, 1024, 8192])
def test_best_ndat_matches_jax(tables, nfilt, best):
    """With one cost table given to both, the port and the JAX package
    choose the same length (no timing: every length is in the table)."""
    import dspsr_tpu.utils.optimalfft as joff

    from dspsr_tpu_torch.utils.optimalfft import FFTBench, OptimalFFT

    tables(best)
    for sub in (1, 4):
        got = OptimalFFT(FFTBench("cpu")).get_best_ndat(nfilt, sub)
        want = joff.OptimalFFT(joff.FFTBench()).get_best_ndat(nfilt, sub)
        assert got == want


def test_cache_is_keyed_by_device(tables, monkeypatch):
    """A card's table and the CPU's are different files: a length measured
    on one never chooses for the other."""
    import dspsr_tpu_torch.utils.optimalfft as toff

    monkeypatch.setattr(torch.cuda, "get_device_name",
                        lambda d=None: "NVIDIA H100 80GB HBM3")
    assert toff.device_key(torch.device("cuda")) == \
        "cuda-NVIDIA_H100_80GB_HBM3"
    assert toff.device_key(torch.device("cpu")) == "cpu"
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError):
            toff.FFTBench()


def reference_route(monkeypatch):
    """Run the JAX fold pipeline's full fused step through its float64
    ``mega_reference`` (``test_torch_multipass._reference_step``), for the
    JAX CLI too: its Pallas kernel in interpret mode rounds ``phi0 + dphi
    * i`` once (an FMA) and, where this period lands a sample exactly on a
    turn, moves it from bin 0 to the last bin against its own reference
    (``test_torch_multipass.py::test_pallas_step_rounds_phase_once``).
    The reference takes no sub-integration bounds."""
    from dspsr_tpu.models import load_to_fold as jl

    from test_torch_multipass import _reference_step

    class Reference(jl.FoldPipeline):
        def _construct(self):
            super()._construct()
            if self.mega_mode == "full":
                self._megastep = _reference_step(self)
    monkeypatch.setattr(jl, "FoldPipeline", Reference)
    return Reference


@pytest.mark.parametrize("kw", [
    dict(nchan=4, dispersion_measure=30.0),
    dict(nchan=4, dispersion_measure=5.0, sk_enable=True, sk_m=64),
    dict(nchan=1, dispersion_measure=30.0),
], ids=["full", "hybrid", "conv"])
@pytest.mark.parametrize("best", [128, 256, 512])
def test_fold_pipeline_fft_bench_matches_jax(tmp_path, tables, monkeypatch,
                                            kw, best):
    """``FoldPipeline(use_fft_bench=True)`` no longer raises: with one cost
    table given to both packages, the port and the JAX pipeline choose the
    same FFT length and the same engine, and fold alike (the full engine
    against the JAX step's ``mega_reference``: ``reference_route``)."""
    from dspsr_tpu.models import load_to_fold as jl

    from dspsr_tpu_torch.models import load_to_fold as tl
    from test_megakernel import _write_raw
    from test_torch_pipeline import _assert_same, raw_source

    tables(best)
    path = _write_raw(tmp_path, 1 << 16)
    cfg = dict(folding_period=0.005, nbin=32, block_parts=2,
               min_block_samples=0, digitizer_stats=False,
               use_fft_bench=True, **kw)
    jp = reference_route(monkeypatch)(raw_source("jax", path),
                                      jl.FoldConfig(**cfg))
    tp = tl.FoldPipeline(raw_source("port", path), tl.FoldConfig(**cfg),
                         device="cpu")
    assert tp.mega_mode == jp.mega_mode
    if kw["nchan"] > 1:
        assert tp.fb_plan.freq_res == jp.fb_plan.freq_res
    else:
        assert tp.conv_plan.n_fft == jp.conv_plan.n_fft
    _assert_same(jp.run(), tp.run())


def test_fftbench_cli(capsys):
    """``python -m dspsr_tpu_torch.utils.fftbench --device cpu`` prints a
    row per length with a positive time."""
    from dspsr_tpu_torch.utils import fftbench

    assert fftbench.main(["--nfft", "64", "256", "--nchan", "1", "4",
                          "--batch", "2", "--trials", "1",
                          "--device", "cpu"]) == 0
    rows = capsys.readouterr().out.strip().splitlines()[1:]
    assert len(rows) == 4
    assert all(float(r.split()[2]) > 0 for r in rows)
