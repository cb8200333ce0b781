"""The port's search pipeline (``FilPipeline(device="cpu")``, plain front
end) against the JAX package's ``FilPipeline`` on the CPU (its fused front
end in interpret mode), over several blocks of real-sampled 8-bit dual-pol
bytes at 2 MHz (the ``tests/test_megakernel.py`` input), 4 channels.

The rule for digitized samples is the reference's own between its two
engines (``tests/test_search.py:441-445``): the rescale sums are taken in
another order, so a sample may round the other way at a tie: max diff 1,
at least 99% exact.  Float32 output agrees to 2e-4 relative
(``tests/test_search.py:401``).  Geometry, output observation and the
SIGPROC header are equal.  Each side reads through its own package's
``Source`` and ``Observation`` (``test_torch_pipeline.raw_source``).
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dspsr_tpu.io.sigproc import read_sigproc_header
from dspsr_tpu.models import load_to_fil as jl
from dspsr_tpu.observation import Signal as JSignal
from dspsr_tpu.ops import rescale as jr
from dspsr_tpu.ops import scrunch as js

from dspsr_tpu_torch import convert
from dspsr_tpu_torch.models import load_to_fil as tl
from dspsr_tpu_torch.ops import rescale as tr
from dspsr_tpu_torch.observation import Signal as TSignal
from dspsr_tpu_torch.ops import scrunch as ts
from test_megakernel import _obs, _write_raw
from test_torch_pipeline import make_obs, plain, raw_source

torch.set_num_threads(2)

BASE = dict(nchan=4, block_parts=2, min_block_samples=0)
D = dict(dispersion_measure=5.0)


def _samples(payload: bytes, nbits: int) -> np.ndarray:
    """Digitized samples of a packed payload (MSB first below 8 bits)."""
    b = np.frombuffer(payload, np.uint8)
    if nbits == 32:
        return b.view(np.float32)
    if nbits == 8:
        return b.astype(np.int64)
    per = 8 // nbits
    shifts = np.arange(per - 1, -1, -1) * nbits
    return ((b[:, None] >> shifts) & ((1 << nbits) - 1)).reshape(-1).astype(
        np.int64)


def _assert_data_close(a: np.ndarray, b: np.ndarray, nbits: int) -> None:
    assert a.shape == b.shape and a.size > 0
    if nbits == 32:
        assert np.abs(a - b).max() / np.abs(a).max() < 2e-4
        return
    diff = np.abs(a - b)
    assert diff.max() <= 1
    assert (diff == 0).mean() >= 0.99


def _pipes(path, **kw):
    cfg = dict(BASE, **kw)
    jp = jl.FilPipeline(raw_source("jax", path), jl.FilConfig(**cfg))
    tp = tl.FilPipeline(raw_source("port", path), tl.FilConfig(**cfg),
                        device="cpu")
    assert jp.megafil_plan is not None
    return jp, tp


def _run_both(tmp_path, jp, tp, **run_kw):
    out = {}
    for tag, pipe in (("jax", jp), ("port", tp)):
        p = str(tmp_path / f"{tag}.fil")
        pipe.run(p, **run_kw)
        _, hdr = read_sigproc_header(p)
        with open(p, "rb") as f:
            blob = f.read()
        out[tag] = (blob[:hdr], blob[hdr:])
    return out


def _assert_same_geometry(jp, tp):
    assert dataclasses.asdict(jp.megafil_plan) == \
        dataclasses.asdict(tp.megafil_plan)
    assert (jp.npart, jp.block_in_samples, jp.stride_in_samples) == \
        (tp.npart, tp.block_in_samples, tp.stride_in_samples)
    assert plain(jp.obs_out) == plain(tp.obs_out)


@pytest.mark.parametrize("kw", [
    dict(D), dict(D, interchannel_align=True, frequency_resolution=128),
    dict(D, tscrunch_factor=4), dict(D, fscrunch_factor=2),
    dict(D, rescale_constant=True), dict(D, scale_factor=0.5),
    dict(D, twos_complement=True), dict(frequency_resolution=64),
    dict(D, nbits=1), dict(D, nbits=2, tscrunch_factor=4),
    dict(D, nbits=4, fscrunch_factor=2), dict(D, nbits=32),
], ids=lambda kw: "-".join(f"{k}={v}" for k, v in kw.items()))
def test_pipeline_matches_jax(tmp_path, kw):
    path = _write_raw(tmp_path, 1 << 16)
    jp, tp = _pipes(path, **kw)
    _assert_same_geometry(jp, tp)
    out = _run_both(tmp_path, jp, tp)
    assert out["jax"][0] == out["port"][0]
    nbits = kw.get("nbits", 8)
    block_bytes = len(out["port"][1]) // tp._blocks_done
    assert tp._blocks_done == jp._blocks_done >= 3
    assert len(out["port"][1]) == tp._blocks_done * block_bytes
    _assert_data_close(_samples(out["jax"][1], nbits),
                       _samples(out["port"][1], nbits), nbits)


def test_rescale_interval_matches_jax(tmp_path):
    """-I: scales held between interval updates, every update mode met."""
    path = _write_raw(tmp_path, 1 << 16)
    probe = tl.FilPipeline(raw_source("port", path),
                           tl.FilConfig(**BASE, **D), device="cpu")
    out_per_block = probe.npart * probe.megafil_plan.nkeep
    seconds = 2.5 * out_per_block / probe.obs_out.rate
    jp, tp = _pipes(path, rescale_seconds=seconds, **D)
    modes = []
    step = tp._step

    def spy(state, mean, inv, raw, mode="cumulative"):
        modes.append(mode)
        return step(state, mean, inv, raw, mode)

    tp._step = spy
    out = _run_both(tmp_path, jp, tp)
    assert {"cumulative", "acc_hold", "acc_update"} <= set(modes)
    assert out["jax"][0] == out["port"][0]
    _assert_data_close(_samples(out["jax"][1], 8),
                       _samples(out["port"][1], 8), 8)


def test_max_blocks_and_total_seconds(tmp_path):
    path = _write_raw(tmp_path, 1 << 16)
    jp, tp = _pipes(path, **D)
    out = _run_both(tmp_path, jp, tp, max_blocks=2)
    assert tp._blocks_done == jp._blocks_done == 2
    _assert_data_close(_samples(out["jax"][1], 8),
                       _samples(out["port"][1], 8), 8)
    seconds = 1.5 * tp.block_in_samples / tp.obs_in.rate
    jp, tp = _pipes(path, **D)
    out = _run_both(tmp_path, jp, tp, total_seconds=seconds)
    assert tp._blocks_done == jp._blocks_done == 1


def _dada(tmp_path, ndat=1 << 16, seed=3):
    from dspsr_tpu.io.dada import format_ascii_header, header_from_observation

    rng = np.random.default_rng(seed)
    q = np.clip(np.round(rng.normal(0, 10, (ndat, 2)) + 127.5), 0,
                255).astype(np.uint8)
    p = tmp_path / "in.dada"
    with open(p, "wb") as f:
        f.write(format_ascii_header(header_from_observation(
            _obs().replace(instrument="DUMMY"))))
        f.write(q.tobytes())
    return str(p)


def test_load_to_fil_on_dada(tmp_path):
    path = _dada(tmp_path)
    cfg = dict(BASE, **D)
    jl.load_to_fil(path, str(tmp_path / "j.fil"), jl.FilConfig(**cfg))
    obs = tl.load_to_fil(path, str(tmp_path / "t.fil"), tl.FilConfig(**cfg),
                         device="cpu")
    assert obs.nchan == 4 and obs.nbit == 8
    _, hdr = read_sigproc_header(str(tmp_path / "t.fil"))
    a, b = ((tmp_path / n).read_bytes() for n in ("j.fil", "t.fil"))
    assert a[:hdr] == b[:hdr]
    _assert_data_close(_samples(a[hdr:], 8), _samples(b[hdr:], 8), 8)


def test_psrfits_through_load_to_fits(tmp_path):
    path = _dada(tmp_path)
    cfg = dict(BASE, **D)
    jl.load_to_fits(path, str(tmp_path / "j.sf"), jl.FilConfig(**cfg))
    tl.load_to_fits(path, str(tmp_path / "t.sf"), tl.FilConfig(**cfg),
                    device="cpu")
    a = np.fromfile(tmp_path / "j.sf", np.uint8).astype(np.int64)
    b = np.fromfile(tmp_path / "t.sf", np.uint8).astype(np.int64)
    assert a.size == b.size > 0
    # headers and row metadata are equal; data bytes within the 1-LSB rule
    diff = np.abs(a - b)
    assert diff.max() <= 1 and (diff == 0).mean() >= 0.99


def test_digifil_cli(tmp_path):
    from dspsr_tpu_torch.apps import digifil_app

    path = _dada(tmp_path)
    out = str(tmp_path / "cli.fil")
    assert digifil_app.main([path, "-o", out, "-F", "4", "-D", "5", "-t",
                             "2", "--block-parts", "2", "--block-samples",
                             "0", "--device", "cpu", "-q"]) == 0
    ref = str(tmp_path / "ref.fil")
    tl.load_to_fil(path, ref, tl.FilConfig(**BASE, **D, tscrunch_factor=2),
                   device="cpu")
    assert (tmp_path / "cli.fil").read_bytes() == \
        (tmp_path / "ref.fil").read_bytes()
    items, _ = read_sigproc_header(out)
    assert int(items["nchans"]) == 4 and int(items["nbits"]) == 8
    # --threads N: time shards (once refused, naming ROADMAP item 10), the
    # JAX app's bytes within the 1-LSB rule
    from dspsr_tpu.apps import digifil_app as jdigifil

    args = [path, "-F", "4", "-D", "5", "--block-parts", "2",
            "--block-samples", "0", "-c", "--threads", "2", "-q"]
    assert digifil_app.main(args + ["-o", out, "--device", "cpu"]) == 0
    jout = str(tmp_path / "jcli.fil")
    assert jdigifil.main(args + ["-o", jout]) == 0
    _, hdr = read_sigproc_header(out)
    a = np.fromfile(jout, np.uint8)[hdr:].astype(np.int64)
    b = np.fromfile(out, np.uint8)[hdr:].astype(np.int64)
    assert a.size == b.size > 0
    _assert_data_close(a, b, 8)


@pytest.mark.parametrize("nbits", [1, 2, 4, 8, 32])
def test_digitize_matches_jax(nbits):
    rng = np.random.default_rng(nbits)
    y = rng.standard_normal((4, 2, 256)).astype(np.float32) * 1.5
    mean, scale = tl.FilConfig(nbits=nbits).digi_params()
    want = np.asarray(jl.digitize(jnp.asarray(y), nbits, mean, scale))
    got = tl.digitize(torch.from_numpy(y), nbits, mean, scale).numpy()
    assert got.dtype == np.uint8
    assert np.array_equal(got, want)


@pytest.mark.parametrize("mode", ["cumulative", "hold", "acc_hold",
                                  "acc_update"])
def test_step_modes_match_jax(tmp_path, mode):
    """One block through each Rescale mode, from the state the first block
    left: the same state, levels and bytes."""
    path = _write_raw(tmp_path, 1 << 16)
    jp, tp = _pipes(path, **D)
    raw0 = jp.source.read_samples(0, jp.block_in_samples)
    raw1 = jp.source.read_samples(jp.stride_in_samples, jp.block_in_samples)
    js0 = (jp._rescale_state, jp._mean, jp._inv)
    ts0 = (tp._rescale_state, tp._mean, tp._inv)
    *jst, _ = jp._step(*js0, jnp.asarray(raw0), mode="cumulative")
    *tst, _ = tp._step(*ts0, torch.from_numpy(raw0), mode="cumulative")
    *jst, jpk = jp._step(*jst, jnp.asarray(raw1), mode=mode)
    *tst, tpk = tp._step(*tst, torch.from_numpy(raw1), mode=mode)
    for a, b in zip(_flat(jst), _flat(tst)):
        np.testing.assert_allclose(b, a, rtol=2e-5)
    _assert_data_close(np.asarray(jpk).astype(np.int64),
                       tpk.numpy().astype(np.int64), 8)


def _flat(st):
    """(RescaleState, mean, inv) as five numpy arrays."""
    state, mean, inv = st
    return [np.asarray(a) for a in (*state, mean, inv)]


@pytest.mark.parametrize("weights", [False, True])
@pytest.mark.parametrize("freeze", [False, True])
def test_rescale_ops_match_jax(freeze, weights):
    rng = np.random.default_rng(5)
    x = (rng.standard_normal((3, 2, 512)) * 4 + 9).astype(np.float32)
    w = (rng.uniform(size=(3, 512)) > 0.2).astype(np.float32) \
        if weights else None
    st0 = rng.uniform(100, 200, (3, 2)).astype(np.float32)
    jst = jr.RescaleState(jnp.asarray(st0), jnp.asarray(st0 * 9),
                          jnp.asarray(st0 * 97))
    tst = tr.RescaleState(*(torch.tensor(np.asarray(a)) for a in jst))
    jst1, jy = jr.rescale_block(jst, jnp.asarray(x), freeze=freeze,
                                weights=None if w is None else jnp.asarray(w))
    tst1, ty = tr.rescale_block(tst, torch.from_numpy(x), freeze=freeze,
                                weights=None if w is None
                                else torch.from_numpy(w))
    for a, b in zip(jst1, tst1):
        np.testing.assert_allclose(b.numpy(), np.asarray(a), rtol=1e-6)
    np.testing.assert_allclose(ty.numpy(), np.asarray(jy), rtol=1e-4,
                               atol=1e-5)
    np.testing.assert_allclose(tr.bandpass_from_state(tst1).numpy(),
                               np.asarray(jr.bandpass_from_state(jst1)),
                               rtol=1e-6)


def test_scrunch_ops_match_jax():
    rng = np.random.default_rng(9)
    x = rng.standard_normal((8, 4, 37)).astype(np.float32)
    t = torch.from_numpy(x)
    for jf, tf, args in ((js.tscrunch, ts.tscrunch, (4,)),
                         (js.fscrunch, ts.fscrunch, (3,)),
                         (js.tscrunch, ts.tscrunch, (1,)),
                         (js.pscrunch, ts.pscrunch, ())):
        np.testing.assert_allclose(tf(t, *args).numpy(),
                                   np.asarray(jf(jnp.asarray(x), *args)),
                                   rtol=1e-6, atol=1e-6)
    for state in ("STOKES", "PPQQ"):
        np.testing.assert_allclose(
            ts.pscrunch_state(t, TSignal[state]).numpy(),
            np.asarray(js.pscrunch_state(jnp.asarray(x), JSignal[state])),
            rtol=1e-6)
    jo, to = _obs(), make_obs("port")
    assert plain(ts.update_observation_tscrunch(to, 4)) == \
        plain(js.update_observation_tscrunch(jo, 4))
    assert plain(ts.update_observation_fscrunch(to.replace(nchan=8), 2)) == \
        plain(js.update_observation_fscrunch(jo.replace(nchan=8), 2))


class _Skip:
    """A source whose sample 0 is ``skip`` samples into another."""

    def __init__(self, src, skip):
        self.src, self.skip, self.obs = src, skip, src.obs
        self.total_samples = src.total_samples - skip

    def read_samples(self, start, n):
        return self.src.read_samples(start + self.skip, n)


def test_resume_from_jax_rescale_state(tmp_path):
    """A port pipeline carried on from the JAX pipeline's levels after
    block 1 writes block 2's bytes (convert.rescale_state_from_numpy)."""
    path = _write_raw(tmp_path, 1 << 16)
    cfg = dict(BASE, **D)
    jp2 = jl.FilPipeline(raw_source("jax", path), jl.FilConfig(**cfg))
    jp2.run(str(tmp_path / "j2.fil"), max_blocks=2)
    jp1 = jl.FilPipeline(raw_source("jax", path), jl.FilConfig(**cfg))
    jp1.run(str(tmp_path / "j1.fil"), max_blocks=1)

    skip = jp1.stride_in_samples
    tp = tl.FilPipeline(_Skip(raw_source("port", path), skip),
                        tl.FilConfig(**cfg), device="cpu")
    assert tp.npart == jp1.npart
    state, mean, inv = convert.rescale_state_from_numpy(
        jp1._rescale_state, jp1._mean, jp1._inv, "cpu")
    assert isinstance(state, tr.RescaleState)
    assert all(a.dtype == torch.float32 for a in (*state, mean, inv))
    tp._rescale_state, tp._mean, tp._inv = state, mean, inv
    tp._blocks_done = jp1._blocks_done
    tp.run(str(tmp_path / "t.fil"), max_blocks=1)

    _, hdr = read_sigproc_header(str(tmp_path / "j2.fil"))
    j2 = (tmp_path / "j2.fil").read_bytes()[hdr:]
    t1 = (tmp_path / "t.fil").read_bytes()[hdr:]
    assert len(j2) == 2 * len(t1)
    _assert_data_close(_samples(j2[len(t1):], 8), _samples(t1, 8), 8)


def _general_pipes(path, obs_kw=None, **kw):
    """Both packages' FilPipeline on ``path`` on their general chain."""
    cfg = dict(BASE, **kw)
    obs_kw = obs_kw or {}
    jp = jl.FilPipeline(raw_source("jax", path, **obs_kw), jl.FilConfig(**cfg))
    tp = tl.FilPipeline(raw_source("port", path, **obs_kw),
                        tl.FilConfig(**cfg), device="cpu")
    assert jp.megafil_plan is None and tp.megafil_plan is None
    assert (jp.npart, jp.block_in_samples, jp.stride_in_samples) == \
        (tp.npart, tp.block_in_samples, tp.stride_in_samples)
    assert plain(jp.obs_out) == plain(tp.obs_out)
    return jp, tp


@pytest.mark.parametrize("kw", [
    dict(channelizer="polyphase"), dict(npol_out=2), dict(npol_out=4),
    dict(poln_select=0), dict(dispersion_measure=0.0)],
    ids=lambda kw: "-".join(f"{k}={v}" for k, v in kw.items()))
def test_xla_chain_configs_raise(tmp_path, kw):
    """The configurations the JAX package runs on its XLA chain, once
    refused here, run on the port's general chain and match it:
    polyphase, -d 2/4, -P and freq_res == 1 (no -D); more in
    ``test_torch_general.py``."""
    path = _write_raw(tmp_path, 1 << 16)
    cfg = {**D, **kw}
    if kw.get("channelizer") == "polyphase":
        cfg["dispersion_measure"] = 0.0
    jp, tp = _general_pipes(path, min_block_samples=1 << 13, **cfg)
    out = _run_both(tmp_path, jp, tp)
    assert out["jax"][0] == out["port"][0]
    assert tp._blocks_done == jp._blocks_done >= 3
    _assert_data_close(_samples(out["jax"][1], 8),
                       _samples(out["port"][1], 8), 8)


@pytest.mark.parametrize("obs_kw", [
    dict(nbit=2, nchan=2), dict(nbit=4),
    dict(ndim=2, state="ANALYTIC", nbit=4)], ids=["2bit", "4bit", "complex"])
def test_unported_input_raises(tmp_path, obs_kw):
    """Inputs once refused here run and match the JAX pipeline: 2-bit with
    JA98 levels on the general chain (codes whose clean blocks JA98 keeps,
    with a saturated stretch it excises), 4-bit real or complex on the
    fused front end (more in ``test_torch_subbyte.py``)."""
    if obs_kw["nbit"] == 2:
        from test_torch_twobit import clean_twobit_codes, pack2

        path = str(tmp_path / "c.raw")
        codes = clean_twobit_codes(np.random.default_rng(3), 1 << 15, 4, 512)
        codes[5000:6000] = 3
        pack2(codes).tofile(path)
        jp, tp = _general_pipes(path, obs_kw, min_block_samples=8192, **D)
        out = _run_both(tmp_path, jp, tp)
        assert out["jax"][0] == out["port"][0]
        a = _samples(out["jax"][1], 8)
        _assert_data_close(a, _samples(out["port"][1], 8), 8)
        # the excised stretch is levelled to zero (127.5 rounds to 128)
        assert 0 < (a == 128).mean() < 0.5
        return
    path = str(tmp_path / "in.raw")
    np.random.default_rng(5).integers(0, 256, 1 << 16,
                                      dtype=np.uint8).tofile(path)
    jp = jl.FilPipeline(raw_source("jax", path, **obs_kw),
                        jl.FilConfig(**BASE, **D))
    tp = tl.FilPipeline(raw_source("port", path, **obs_kw),
                        tl.FilConfig(**BASE, **D), device="cpu")
    assert jp.megafil_plan is not None
    _assert_same_geometry(jp, tp)
    out = _run_both(tmp_path, jp, tp)
    assert out["jax"][0] == out["port"][0]
    _assert_data_close(_samples(out["jax"][1], 8),
                       _samples(out["port"][1], 8), 8)


def test_align_without_dm_raises(tmp_path):
    path = _write_raw(tmp_path, 1 << 12)
    with pytest.raises(ValueError, match="-K"):
        tl.FilPipeline(raw_source("port", path),
                       tl.FilConfig(**BASE, frequency_resolution=64,
                                    interchannel_align=True), device="cpu")


def test_cuda_without_card_raises(tmp_path):
    path = _write_raw(tmp_path, 1 << 12)
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="cuda"):
        tl.FilPipeline(raw_source("port", path), tl.FilConfig(**BASE, **D))
