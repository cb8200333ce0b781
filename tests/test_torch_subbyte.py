"""Fixed-level 1/2/4-bit codes (offset binary, and two's complement at 2
and 4 bits), float32 samples and the apodization window in the port
against the JAX package on the CPU.

- the plain fused step (``megastep_plain``, float64) against the JAX
  package's ``mega_reference`` to 2e-5 relative, hits exact; one case of
  each kind against the Pallas kernel in interpret mode;
- the plain front end (``megafil_plain``), detected and voltage, with the
  weights output (ones), against ``build_megafil`` in interpret mode;
- ``convert.constants_from_numpy`` carries the JAX window (``apod``);
- ``FoldPipeline(device="cpu")`` against the JAX ``FoldPipeline`` on a
  Mark5B stream (fixed-level 2-bit, read by each package's own reader), a
  1-bit and a float32 stream, profiles to 2e-4 relative and hits exact;
- ``FilPipeline`` against JAX on fixed-level 2-bit, 1-bit and float32
  input, bytes within 1 LSB and at least 99% exact
  (``test_torch_search.py``'s rule).

The 4-bit and apodized pipelines are ``test_torch_pipeline.py``'s.
"""

import numpy as np
import pytest
import torch

from dspsr_tpu_torch import convert
from dspsr_tpu_torch.ops import megakernel as tmk
from test_torch_pipeline import PKGS, make_obs
from test_torch_twobit import (
    NPART, assert_same, close, close_front, jax_cst, pallas_front,
    pallas_step, port_cst, port_front, port_step, reference_step, run_both,
    setup, tplan_of)

torch.set_num_threads(2)

#: (setup keywords, id) of every fixed-level, float and windowed case
KINDS = [
    (dict(nbit=1), "1bit"), (dict(nbit=2), "2bit"), (dict(nbit=4), "4bit"),
    (dict(nbit=2, twos=True), "2bit-twos"),
    (dict(nbit=4, twos=True), "4bit-twos"),
    (dict(nbit=4, real=False), "4bit-complex"),
    (dict(nbit=2, real=False, twos=True), "2bit-complex-twos"),
    (dict(nbit=1, nchan_in=2, npol_out=4), "1bit-2chan-stokes"),
    (dict(nbit=32), "float32"), (dict(nbit=32, real=False), "float32-complex"),
    (dict(window="hanning"), "hanning"),
    (dict(window="hanning", real=False), "hanning-complex"),
    (dict(nbit=2, npw=16, real=False, window="welch",
          rfi=[(4 * t, 4 * t + 4) for t in range(40, 60)]),
     "ja98-welch"),
    (dict(nbit=4, window="tukey", npol_out=2), "4bit-tukey-ppqq"),
]


@pytest.mark.parametrize("kw", [k for k, _ in KINDS],
                         ids=[i for _, i in KINDS])
def test_step_matches_reference(kw):
    args = setup(seed=sum(map(ord, str(kw))), **kw)
    close(port_step(*args), reference_step(*args))


@pytest.mark.parametrize("kw", [
    dict(nbit=4, twos=True), dict(nbit=32, real=False),
    dict(nbit=1, window="hanning")], ids=["4bit-twos", "float32", "window"])
def test_step_matches_pallas_interpret(kw):
    args = setup(seed=3, **kw)
    close(port_step(*args, dtype=torch.float32), pallas_step(*args))


@pytest.mark.parametrize("kw,output", [
    (dict(nbit=2, twos=True), "detected"), (dict(nbit=4), "voltage"),
    (dict(nbit=32, real=False), "detected"),
    (dict(nbit=1, window="hanning"), "voltage"),
    (dict(window="hanning", real=False, npol_out=4), "detected")],
    ids=["2bit-twos", "4bit-voltage", "float32-complex", "1bit-window-voltage",
         "window-complex-stokes"])
def test_front_end_matches_pallas_interpret(kw, output):
    args = setup(seed=5, **kw)
    got = port_front(*args, output=output)
    close_front(got, pallas_front(*args, output=output))
    assert got[1].min() == got[1].max() == 1


def test_window_through_convert():
    """The JAX constants' ``apod [R1, row_len]`` is the flat window."""
    args = setup(nbit=4, window="hanning", seed=7)
    plan, resp, win = args[0], args[3], args[6]
    jc = jax_cst(plan, resp, win, np.float32)
    cst = convert.constants_from_numpy(
        {"gr": jc.gr, "gi": jc.gi, "apod": jc.apod}, plan, "cpu")
    assert torch.equal(cst.window, port_cst(plan, resp, win).window)
    close(port_step(*args, cst=cst), reference_step(*args))


def test_constants_check_window_length():
    plan = setup(nbit=4)[0]
    with pytest.raises(ValueError, match="nsamp_fft"):
        tmk.MegaConstants.build(tplan_of(plan), None,
                                window=np.ones(plan.nsamp_fft // 2))


def test_raw_size_counts_bits():
    """A block's raw bytes are ``block_ndat * nchan * npol * ndim * nbit /
    8``; the step refuses another size."""
    for nbit in (1, 2, 4, 8, 32):
        plan = tplan_of(setup(nbit=nbit)[0])
        assert tmk.raw_nbytes(plan, NPART) == (
            plan.block_ndat(NPART) * plan.npol * nbit // 8)
    args = setup(nbit=4, seed=1)
    plan, traw = tplan_of(args[0]), torch.from_numpy(args[2])
    step = tmk.build_megastep(plan, port_cst(args[0], args[3]), NPART)
    with pytest.raises((ValueError, RuntimeError)):
        step(torch.zeros(1, 1, plan.nsub, plan.nbin),
             torch.zeros(1, plan.nbin), traw[:-1],
             torch.from_numpy(args[4]), torch.from_numpy(args[5]))


# ---- pipelines ----


FOLD = dict(folding_period=0.0513, nbin=32, block_parts=2,
            min_block_samples=0, digitizer_stats=True)


def test_mark5b_fold_matches_jax(tmp_path):
    """Fixed-level 2-bit Mark5B (no JA98: the instrument keeps the
    BitTable levels), each package reading the file with its own reader."""
    from test_formats import make_mark5b

    path = str(tmp_path / "t.m5b")
    make_mark5b(path, nframes=16)
    a, b, tp = run_both(
        lambda pkg: PKGS[pkg][0].open_source(path), "full",
        **dict(FOLD, dispersion_measure=0.0, nchan=16,
               frequency_resolution=64))
    assert tp.unpack_plan.twobit is None and tp.mega_plan.nbit == 2
    assert_same(a, b)
    assert b.hits.sum() > 0


def _write(tmp_path, nbytes, seed, dtype=np.uint8):
    rng = np.random.default_rng(seed)
    path = str(tmp_path / "in.raw")
    if dtype == np.float32:
        rng.normal(0, 5, nbytes // 4).astype(np.float32).tofile(path)
    else:
        rng.integers(0, 256, nbytes, dtype=np.uint8).tofile(path)
    return path


@pytest.mark.parametrize("obs_kw,cfg", [
    (dict(nbit=1, nchan=4), dict(dispersion_measure=5.0, nchan=16,
                                 frequency_resolution=64)),
    (dict(nbit=32, ndim=2, state="ANALYTIC", nchan=2),
     dict(dispersion_measure=5.0, nchan=8, npol_out=2,
          frequency_resolution=64)),
], ids=["1bit", "float32-complex"])
def test_fold_matches_jax(tmp_path, obs_kw, cfg):
    path = _write(tmp_path, 1 << 16, 17,
                  np.float32 if obs_kw["nbit"] == 32 else np.uint8)
    a, b, tp = run_both(lambda pkg: PKGS[pkg][0].RawFileSource(
        path, make_obs(pkg, **obs_kw)), "full", **dict(FOLD, **cfg))
    assert_same(a, b)
    assert b.hits.sum() > 0


@pytest.mark.parametrize("obs_kw,kw", [
    (dict(nbit=2, nchan=2), dict(dynamic_twobit=False)),
    (dict(nbit=2, nchan=2), dict(dynamic_twobit=False, twos_complement=True)),
    (dict(nbit=1, nchan=4), {}),
    (dict(nbit=32, ndim=2, state="ANALYTIC"), dict(nbits=32)),
], ids=["2bit-fixed", "2bit-twos", "1bit", "float32-complex"])
def test_search_matches_jax(tmp_path, obs_kw, kw):
    from dspsr_tpu.io.sigproc import read_sigproc_header
    from dspsr_tpu.models import load_to_fil as jl
    from dspsr_tpu_torch.models import load_to_fil as tl
    from test_torch_search import _assert_data_close, _samples

    path = _write(tmp_path, 1 << 16, 23,
                  np.float32 if obs_kw["nbit"] == 32 else np.uint8)
    cfg = dict(nchan=4 * obs_kw.get("nchan", 1), block_parts=2,
               min_block_samples=0, dispersion_measure=5.0,
               frequency_resolution=64, **kw)
    out = {}
    for tag, mod in (("jax", jl), ("port", tl)):
        src = PKGS[tag][0].RawFileSource(path, make_obs(tag, **obs_kw))
        extra = {} if tag == "jax" else dict(device="cpu")
        pipe = mod.FilPipeline(src, mod.FilConfig(**cfg), **extra)
        if tag == "jax":
            assert pipe.megafil_plan is not None
        p = str(tmp_path / f"{tag}.fil")
        pipe.run(p)
        _, hdr = read_sigproc_header(p)
        blob = open(p, "rb").read()
        out[tag] = (blob[:hdr], blob[hdr:])
    assert out["jax"][0] == out["port"][0]
    nbits = kw.get("nbits", 8)
    _assert_data_close(_samples(out["jax"][1], nbits),
                       _samples(out["port"][1], nbits), nbits)
