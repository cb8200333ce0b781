"""The port's FoldPipeline (device="cpu", plain fused step) against the JAX
package's FoldPipeline on the CPU (Pallas kernel in interpret mode), on the
``tests/test_megakernel.py`` setup: real-sampled 8-bit dual-pol bytes at
2 MHz, 4 channels, 32 bins.  Profiles agree to 2e-4 relative (the tolerance
of ``tests/test_megakernel.py:183``), hits exactly.
"""

import numpy as np
import pytest
import torch

from dspsr_tpu.io.sources import DummySource, RawFileSource
from dspsr_tpu.models import load_to_fold as jl
from dspsr_tpu.observation import Signal

from dspsr_tpu_torch.models import load_to_fold as tl
from test_megakernel import _obs, _write_raw

torch.set_num_threads(2)

BASE = dict(folding_period=0.005, dispersion_measure=5.0, nchan=4, nbin=32,
            block_parts=2, min_block_samples=0, digitizer_stats=False)


def _both(src_fn, max_blocks=None, **kw):
    cfg = dict(BASE, **kw)
    jpipe = jl.FoldPipeline(src_fn(), jl.FoldConfig(**cfg))
    tpipe = tl.FoldPipeline(src_fn(), tl.FoldConfig(**cfg), device="cpu")
    assert jpipe.mega_mode == tpipe.mega_mode == "full"
    return (jpipe.run(max_blocks=max_blocks),
            tpipe.run(max_blocks=max_blocks), tpipe)


def _assert_same(a, b):
    assert a.profiles.shape == b.profiles.shape
    assert np.abs(b.profiles - a.profiles).max() / \
        np.abs(a.profiles).max() < 2e-4
    assert np.array_equal(a.hits, b.hits)
    assert a.epochs == b.epochs
    assert np.array_equal(a.integration_length, b.integration_length)
    assert a.obs == b.obs
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
    a, b, pipe = _both(lambda: RawFileSource(path, _obs()), **kw)
    _assert_same(a, b)
    if "subint_seconds" in kw or "subint_turns" in kw:
        assert b.profiles.shape[0] >= 2
    assert b.hits.sum() > 0


def test_dummy_source_several_blocks():
    obs = _obs().replace(instrument="DUMMY", ndat=1 << 40)
    a, b, pipe = _both(lambda: DummySource(obs), max_blocks=4,
                       digitizer_stats=True, npol_out=4)
    _assert_same(a, b)
    assert np.array_equal(a.digitizer_counts, b.digitizer_counts)
    assert b.hits[0, 0].sum() == 4 * pipe.out_per_block


def test_pulse_recovery_matches_jax(tmp_path):
    period = 0.005
    path = _write_raw(tmp_path, 1 << 15, pulse_period=period)
    a, b, _ = _both(lambda: RawFileSource(path, _obs()),
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
    from dspsr_tpu.io.archive import save_archive

    path = _write_raw(tmp_path, 1 << 15)
    res = tl.FoldPipeline(RawFileSource(path, _obs()),
                          tl.FoldConfig(**BASE), device="cpu").run()
    out = tmp_path / f"fold{ext}"
    save_archive(str(out), res)
    assert out.stat().st_size > 0
    if ext == ".npz":
        with np.load(out, allow_pickle=True) as z:
            arrays = [z[k] for k in z.files
                      if z[k].shape == res.profiles.shape]
        assert any(np.array_equal(x, res.profiles) for x in arrays)


@pytest.mark.parametrize("kw", [
    dict(sk_enable=True), dict(rfi_filter=True), dict(cyclic_nchan=4),
    dict(additional_pulsars=(0.004,)), dict(passband=True),
    dict(pdmp_stats=True), dict(npol_out=3), dict(use_megakernel=False),
    dict(fft_window="hanning"), dict(nchan=1),
], ids=lambda kw: next(iter(kw)))
def test_unsupported_config_raises(tmp_path, kw):
    path = _write_raw(tmp_path, 1 << 12)
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        tl.FoldPipeline(RawFileSource(path, _obs()),
                        tl.FoldConfig(**dict(BASE, **kw)), device="cpu")


@pytest.mark.parametrize("obs_kw", [
    dict(nbit=2, nchan=2), dict(nbit=4), dict(instrument="CASPSR"),
    dict(ndim=2, state=Signal.ANALYTIC)], ids=["2bit", "4bit", "caspsr",
                                               "complex"])
def test_unsupported_input_raises(tmp_path, obs_kw):
    path = _write_raw(tmp_path, 1 << 12)
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        tl.FoldPipeline(RawFileSource(path, _obs().replace(**obs_kw)),
                        tl.FoldConfig(**BASE), device="cpu")


def test_cuda_without_card_raises(tmp_path):
    path = _write_raw(tmp_path, 1 << 12)
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="cuda"):
        tl.FoldPipeline(RawFileSource(path, _obs()), tl.FoldConfig(**BASE))


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
