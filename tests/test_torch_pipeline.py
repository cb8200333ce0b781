"""The port's FoldPipeline (device="cpu", plain fused step) against the JAX
package's FoldPipeline on the CPU (Pallas kernel in interpret mode), on the
``tests/test_megakernel.py`` setup: real-sampled 8-bit dual-pol bytes at
2 MHz, 4 channels, 32 bins.  Profiles agree to 2e-4 relative (the tolerance
of ``tests/test_megakernel.py:183``), hits exactly.

Each side reads through its own package's ``Source`` and ``Observation``,
built from the same arguments (``_src``): the port keeps its own copies of
those classes, so the two are different types that compare by value
(``plain``).
"""

import dataclasses
import enum

import numpy as np
import pytest
import torch

import dspsr_tpu.io.sources as jsrc
import dspsr_tpu.observation as jobs
import dspsr_tpu.timing.mjd as jmjd
from dspsr_tpu.models import load_to_fold as jl

import dspsr_tpu_torch.io.sources as tsrc
import dspsr_tpu_torch.observation as tobs
import dspsr_tpu_torch.timing.mjd as tmjd
from dspsr_tpu_torch.models import load_to_fold as tl
from test_megakernel import RATE, _write_raw

torch.set_num_threads(2)

BASE = dict(folding_period=0.005, dispersion_measure=5.0, nchan=4, nbin=32,
            block_parts=2, min_block_samples=0, digitizer_stats=False)

#: each package's (sources, observation, mjd) modules
PKGS = {"jax": (jsrc, jobs, jmjd), "port": (tsrc, tobs, tmjd)}


def make_obs(pkg, state="NYQUIST", **kw):
    """``test_megakernel._obs()`` (2 MHz, 1 channel, 2 pols, 8-bit real)
    built from package ``pkg``'s own classes; ``state`` names a Signal."""
    _, obs, mjd = PKGS[pkg]
    return obs.Observation(
        nchan=1, npol=2, ndim=1, nbit=8, centre_frequency=1400.0,
        bandwidth=-2.0, rate=RATE,
        start_time=mjd.MJD.from_utc("2010-04-13-02:05:45"),
        state=obs.Signal[state], source="FAKE", telescope="PKS",
        instrument="RAW").replace(**kw)


def raw_source(pkg, path, **obs_kw):
    """Package ``pkg``'s RawFileSource over ``path``."""
    return PKGS[pkg][0].RawFileSource(path, make_obs(pkg, **obs_kw))


def dummy_source(pkg, **obs_kw):
    """Package ``pkg``'s DummySource of endless noise bytes."""
    return PKGS[pkg][0].DummySource(make_obs(
        pkg, **dict(dict(instrument="DUMMY", ndat=1 << 40), **obs_kw)))


def plain(x):
    """``x`` with every dataclass as (class name, fields) and every enum as
    its value, recursively: equal across the two packages' copies of a
    class when the values are."""
    if dataclasses.is_dataclass(x) and not isinstance(x, type):
        return (type(x).__name__,) + tuple(
            (f.name, plain(getattr(x, f.name)))
            for f in dataclasses.fields(x))
    if isinstance(x, enum.Enum):
        return x.value
    if isinstance(x, (list, tuple)):
        return type(x)(plain(v) for v in x)
    if isinstance(x, dict):
        return {k: plain(v) for k, v in x.items()}
    return x


def _both(src_fn, max_blocks=None, **kw):
    cfg = dict(BASE, **kw)
    jpipe = jl.FoldPipeline(src_fn("jax"), jl.FoldConfig(**cfg))
    tpipe = tl.FoldPipeline(src_fn("port"), tl.FoldConfig(**cfg),
                            device="cpu")
    assert jpipe.mega_mode == tpipe.mega_mode == "full"
    return (jpipe.run(max_blocks=max_blocks),
            tpipe.run(max_blocks=max_blocks), tpipe)


def _assert_same(a, b):
    assert a.profiles.shape == b.profiles.shape
    assert np.abs(b.profiles - a.profiles).max() / \
        np.abs(a.profiles).max() < 2e-4
    assert np.array_equal(a.hits, b.hits)
    assert plain(a.epochs) == plain(b.epochs)
    assert np.array_equal(a.integration_length, b.integration_length)
    assert plain(a.obs) == plain(b.obs)
    assert a.signal_path == b.signal_path
    assert (a.nbin, a.folding_period, a.dispersion_measure) == \
        (b.nbin, b.folding_period, b.dispersion_measure)


@pytest.mark.parametrize("kw", [
    dict(), dict(subint_seconds=0.004), dict(subint_turns=1),
    dict(interchannel_align=True, frequency_resolution=128),
    dict(seek_seconds=0.001, reference_phase=0.25, twos_complement=True)],
    ids=["whole", "subints", "turns", "align", "seek_phase_twos"])
def test_pipeline_matches_jax(tmp_path, kw):
    path = _write_raw(tmp_path, 1 << 15)
    a, b, pipe = _both(lambda pkg: raw_source(pkg, path), **kw)
    _assert_same(a, b)
    if "subint_seconds" in kw or "subint_turns" in kw:
        assert b.profiles.shape[0] >= 2
    assert b.hits.sum() > 0


def test_dummy_source_several_blocks():
    a, b, pipe = _both(dummy_source, max_blocks=4,
                       digitizer_stats=True, npol_out=4)
    _assert_same(a, b)
    assert np.array_equal(a.digitizer_counts, b.digitizer_counts)
    assert b.hits[0, 0].sum() == 4 * pipe.out_per_block


def test_pulse_recovery_matches_jax(tmp_path):
    period = 0.005
    path = _write_raw(tmp_path, 1 << 15, pulse_period=period)
    a, b, _ = _both(lambda pkg: raw_source(pkg, path),
                    folding_period=period)
    for res in (a, b):
        prof = res.normalized()[0, :, 0, :]
        snr = (prof.max(axis=1) - prof.mean(axis=1)) / prof.std(axis=1)
        assert (snr > 1.5).all()
    assert np.array_equal(np.argmax(a.normalized()[0, :, 0], axis=1),
                          np.argmax(b.normalized()[0, :, 0], axis=1))
    assert np.array_equal(np.argmax(a.dedispersed()[0, :, 0], axis=1),
                          np.argmax(b.dedispersed()[0, :, 0], axis=1))


@pytest.mark.parametrize("ext", [".npz", ".sf"])
def test_save_archive(tmp_path, ext):
    from dspsr_tpu_torch.io.archive import save_archive

    path = _write_raw(tmp_path, 1 << 15)
    res = tl.FoldPipeline(raw_source("port", path),
                          tl.FoldConfig(**BASE), device="cpu").run()
    out = tmp_path / f"fold{ext}"
    save_archive(str(out), res)
    assert out.stat().st_size > 0
    if ext == ".npz":
        with np.load(out, allow_pickle=True) as z:
            arrays = [z[k] for k in z.files
                      if z[k].shape == res.profiles.shape]
        assert any(np.array_equal(x, res.profiles) for x in arrays)


# nsub == 1 with DM > 0 (the convolution) and calibration at nsub == 1 run
# since the nsub == 1 slice (tests/test_torch_conv.py,
# tests/test_torch_jones.py); the apodization window (fft_window) since the
# sub-byte slice; use_megakernel=False and nsub == 1 with no FFT stage (DM
# 0, no calibration) on the general chain since the general-chain slice
# (more in tests/test_torch_general.py).  Those cases hold the port against
# the JAX pipeline.  Calibration inside a filterbank and use_fft_bench still
# raise; the RFI filter with no FFT stage raises in both packages, and so
# does cyclic folding of a real stream with no FFT stage (the JAX package
# on its first block).
@pytest.mark.parametrize("kw", [
    dict(cyclic_nchan=4, nchan=1, dispersion_measure=0.0),
    dict(calibration_path="cal.txt"),
    dict(use_megakernel=False), dict(use_fft_bench=True),
    dict(fft_window="hanning"), dict(nchan=1, dispersion_measure=0.0),
    dict(sk_enable=True, cyclic_nchan=4, nchan=1, dispersion_measure=0.0),
    dict(rfi_filter=True, nchan=1, dispersion_measure=0.0),
], ids=lambda kw: "-".join(k for k in kw if k != "dispersion_measure"))
def test_unsupported_config_raises(tmp_path, kw):
    cfg = dict(BASE, **kw)
    if "fft_window" in kw:
        path = _write_raw(tmp_path, 1 << 15)
        a, b, _ = _both(lambda pkg: raw_source(pkg, path), **kw)
        _assert_same(a, b)
        return
    if "use_megakernel" in kw or kw == dict(nchan=1, dispersion_measure=0.0):
        path = _write_raw(tmp_path, 1 << 15)
        jpipe = jl.FoldPipeline(raw_source("jax", path), jl.FoldConfig(**cfg))
        tpipe = tl.FoldPipeline(raw_source("port", path),
                                tl.FoldConfig(**cfg), device="cpu")
        assert jpipe.mega_mode is None and tpipe.mega_mode is None
        a, b = jpipe.run(), tpipe.run()
        _assert_same(a, b)
        assert b.hits.sum() > 0
        return
    path = _write_raw(tmp_path, 1 << 12)
    if "cyclic_nchan" in kw:
        with pytest.raises(ValueError, match="complex voltages"):
            tl.FoldPipeline(raw_source("port", path), tl.FoldConfig(**cfg),
                            device="cpu")
        with pytest.raises(ValueError):
            jl.FoldPipeline(raw_source("jax", path),
                            jl.FoldConfig(**cfg)).run(max_blocks=1)
        return
    if "rfi_filter" in kw:
        for mod, extra in ((jl, {}), (tl, {"device": "cpu"})):
            with pytest.raises(NotImplementedError, match="-F"):
                mod.FoldPipeline(raw_source("jax" if mod is jl else "port",
                                            path), mod.FoldConfig(**cfg),
                                 **extra)
        return
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        tl.FoldPipeline(raw_source("port", path), tl.FoldConfig(**cfg),
                        device="cpu")


@pytest.mark.parametrize("obs_kw", [
    dict(nbit=2, nchan=2), dict(nbit=4), dict(instrument="CASPSR", nbit=4),
    dict(ndim=2, state="ANALYTIC", nbit=4)], ids=["2bit", "4bit", "caspsr",
                                                  "complex"])
def test_unsupported_input_raises(tmp_path, obs_kw):
    """Inputs once refused here: 2-bit (JA98 levels and excision), 4-bit
    and complex 4-bit codes now run and match the JAX pipeline (more in
    ``test_torch_twobit.py``, ``test_torch_subbyte.py``); the CASPSR
    layout at 4 bits raises the same ``ValueError`` in both packages."""
    if obs_kw.get("instrument") == "CASPSR":
        path = _write_raw(tmp_path, 1 << 12)
        for pkg, mod in (("jax", jl), ("port", tl)):
            extra = {"device": "cpu"} if pkg == "port" else {}
            with pytest.raises(ValueError, match="CASPSR"):
                mod.FoldPipeline(raw_source(pkg, path, **obs_kw),
                                 mod.FoldConfig(**BASE), **extra)
        return
    rng = np.random.default_rng(obs_kw["nbit"])
    path = str(tmp_path / "in.raw")
    cfg = {}
    if obs_kw["nbit"] == 2:
        # JA98: every 16-sample block clean, so no window is excised by
        # chance; the blocks divide the row (row_len 32 here)
        from test_torch_twobit import clean_twobit_codes, pack2

        cfg = dict(ndat_per_weight=16, frequency_resolution=128)
        pack2(clean_twobit_codes(rng, 1 << 14, 4, 16)).tofile(path)
    else:
        rng.integers(0, 256, 1 << 15, dtype=np.uint8).tofile(path)
    a, b, pipe = _both(lambda pkg: raw_source(pkg, path, **obs_kw),
                       **dict(cfg, folding_period=0.00513))
    _assert_same(a, b)
    assert pipe.mega_plan.nbit == obs_kw["nbit"] and b.hits.sum() > 0


def test_cuda_without_card_raises(tmp_path):
    path = _write_raw(tmp_path, 1 << 12)
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="cuda"):
        tl.FoldPipeline(raw_source("port", path), tl.FoldConfig(**BASE))


def test_failed_build_raises(tmp_path, monkeypatch):
    """A kernel build that fails raises; nothing falls back."""
    from dspsr_tpu_torch.kernels import build

    monkeypatch.setattr(build, "BUILD_DIR", tmp_path)
    with monkeypatch.context() as m:
        m.setattr(build, "nvcc_path", lambda: "false")
        with pytest.raises(RuntimeError, match="nvcc failed"):
            build.build("megastep")
    assert not list(tmp_path.iterdir())
    with monkeypatch.context() as m:
        m.setattr(build.shutil, "which", lambda _: None)
        m.setattr(build.os.path, "exists", lambda _: False)
        with pytest.raises(RuntimeError, match="nvcc not found"):
            build.build("megastep")
