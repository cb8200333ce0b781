"""The port's plain search front end (``megafil_plain``, CPU) against the
JAX package's ``build_megafil`` detected output (its Pallas kernel in
interpret mode), at the front-end test geometry of
``tests/test_megakernel.py::_front_setup`` (nsub 4, freq_res 64, 3 windows,
nfilt 5/6).  The tolerance is the reference's own for its front end: 2e-5
relative (``tests/test_megakernel.py:817``).

Also: the step's CPU dispatch, constants carried from JAX, the CUDA
wrapper's refusal of CPU tensors, the traced Jones planes of the
channel-sharded step (the passband and the traced chirp are in
``test_torch_hybrid.py``, the voltage output in ``test_torch_cyclic.py``,
the Jones mix in ``test_torch_jones.py``, nsub == 1 in
``test_torch_conv.py``), and the kernel build's tracking of shared
headers.
"""

import dataclasses
import shutil

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dspsr_tpu.ops import megakernel as jmk
from dspsr_tpu.ops.filterbank import FilterbankPlan

from dspsr_tpu_torch import convert
from dspsr_tpu_torch.ops import megakernel as tmk

torch.set_num_threads(2)

NSUB, FREQ_RES, NPART = 4, 64, 3
TOL = 2e-5


def _setup(nsub=NSUB, freq_res=FREQ_RES, npol=2, nchan_in=1, seed=7, **kw):
    """``_front_setup``'s geometry with the subbands, resolution, input
    pols, input channels and plan keywords as parameters."""
    rng = np.random.default_rng(seed)
    fb = FilterbankPlan(real_input=True, nchan_subband=nsub,
                        freq_res=freq_res, nfilt_pos=5, nfilt_neg=6)
    plan = jmk.MegaPlan.from_filterbank(fb, nbin=2, npol=npol,
                                        nchan_in=nchan_in, **kw)
    assert plan is not None
    raw = rng.integers(0, 256, size=plan.block_ndat(NPART) * nchan_in * npol,
                       dtype=np.uint8)
    resp = np.exp(1j * rng.uniform(-3, 3, (nchan_in * nsub, freq_res)))
    return plan, raw, resp


def _tplan(plan):
    return tmk.MegaPlan(**dataclasses.asdict(plan))


def _port_cst(plan, resp):
    scale, offset = tmk.unpack_affine(8, plan.twos_complement)
    return tmk.MegaConstants.build(_tplan(plan), resp, scale, offset).to(
        "cpu")


def _port(plan, raw, resp, dtype=torch.float64, cst=None):
    cst = _port_cst(plan, resp) if cst is None else cst
    return tmk.megafil_plain(_tplan(plan), cst, torch.from_numpy(raw), NPART,
                             dtype=dtype).numpy()


def _pallas(plan, raw, resp):
    scale, offset = jmk.unpack_affine(8, plan.twos_complement)
    cst = jmk.MegaConstants(plan, resp, dtype=np.float32,
                            unpack_scale=scale, unpack_offset=offset)
    step = jmk.build_megafil(plan, cst, NPART, interpret=True)
    return np.asarray(step(jnp.asarray(raw)))


def _close(got, want, tol=TOL):
    assert got.shape == want.shape
    assert np.abs(got - want).max() / np.abs(want).max() < tol


@pytest.mark.parametrize("kw", [
    dict(), dict(npol=1), dict(twos_complement=True), dict(nchan_in=2),
    dict(npol=1, nchan_in=2), dict(detection="pp", npol_out=1),
    dict(npol_out=2), dict(npol_out=4), dict(npol_out=4,
                                              detection="coherence"),
    dict(nsub=1, freq_res=256),
], ids=lambda kw: "-".join(f"{k}={v}" for k, v in kw.items()) or "sum")
def test_plain_matches_pallas_interpret(kw):
    plan, raw, resp = _setup(seed=sum(map(ord, str(kw))), **kw)
    got = _port(plan, raw, resp)
    assert got.shape == (plan.nchan_in * plan.nsub, plan.nplane,
                         NPART * plan.nkeep)
    _close(got, _pallas(plan, raw, resp))


def test_step_on_cpu_is_the_plain_version():
    plan, raw, resp = _setup()
    cst = _port_cst(plan, resp)
    step = tmk.build_megafil(_tplan(plan), cst, NPART)
    got = step(torch.from_numpy(raw))
    assert got.dtype == torch.float32
    assert torch.equal(got, tmk.megafil_plain(
        _tplan(plan), cst, torch.from_numpy(raw), NPART))


def test_jax_constants_through_convert():
    plan, raw, resp = _setup()
    scale, offset = jmk.unpack_affine(8)
    jcst = jmk.MegaConstants(plan, resp, dtype=np.float32,
                             unpack_scale=scale, unpack_offset=offset)
    cst = convert.constants_from_numpy({"gr": jcst.gr, "gi": jcst.gi},
                                       plan, "cpu")
    _close(_port(plan, raw, resp, cst=cst), _pallas(plan, raw, resp))


def test_plain_front_end_is_shared():
    """The fold step's plain version folds exactly what the search front
    end's plain version emits (one front end under both)."""
    plan, raw, resp = _setup()
    cst = _port_cst(plan, resp)
    tplan = dataclasses.replace(_tplan(plan), nbin=8)
    d = tmk.megafil_plain(tplan, cst, torch.from_numpy(raw), NPART,
                          dtype=torch.float64)
    phi0 = torch.zeros(NPART)
    dphi = torch.full((NPART,), 0.25 / tplan.nkeep)
    prof, hits = tmk.megastep_plain(
        tplan, cst, torch.zeros(1, 1, NSUB, 8, dtype=torch.float64),
        torch.zeros(1, 8, dtype=torch.float64), torch.from_numpy(raw),
        phi0, dphi)
    bins = tmk.fold_bins(tplan, phi0, dphi).reshape(-1)
    want = torch.zeros(NSUB, 8, dtype=torch.float64).index_add_(
        1, bins, d[:, 0])
    assert torch.allclose(prof[0, 0], want, rtol=1e-12)


def test_cuda_wrapper_refuses_cpu_tensors():
    from dspsr_tpu_torch.kernels.megafil import megafil_cuda

    plan, raw, resp = _setup()
    with pytest.raises(ValueError, match="CUDA"):
        megafil_cuda(_tplan(plan), _port_cst(plan, resp),
                     torch.from_numpy(raw), NPART)


@pytest.mark.parametrize("kw", [
    dict(output="voltage", jones_as_args=True), dict(jones_as_args=True),
    dict(output="voltage", passband=True, jones_as_args=True),
    dict(jones_as_args=True, response_as_args=True)],
    ids=lambda kw: "-".join(kw))
def test_uncovered_keywords_raise(kw):
    """The traced Jones planes (``jones_as_args``, the channel-sharded
    step's) once raised here; they are ported.  Each keyword set builds,
    and its step with the Jones response handed in on the call (and the
    chirp, with ``response_as_args``) matches the JAX package's
    ``build_megafil`` with the same keywords (Pallas in interpret mode,
    its permuted ``jxr``/``jxi`` planes) at 2e-5, and the step with the
    same response in its constants."""
    plan, raw, resp = _setup()
    rng = np.random.default_rng(len(kw))
    shape = (plan.nchan_in, plan.n_fft, 2, 2)
    J = rng.normal(size=shape) + 1j * rng.normal(size=shape)
    scale, offset = jmk.unpack_affine(8)
    jcst = jmk.MegaConstants(plan, None, dtype=np.float32,
                             unpack_scale=scale, unpack_offset=offset,
                             jones=J)
    jargs = [jnp.asarray(jcst.gr), jnp.asarray(jcst.gi)] \
        if kw.get("response_as_args") else []
    jout = jmk.build_megafil(plan, jcst, NPART, interpret=True, **kw)(
        jnp.asarray(raw), *jargs, jnp.asarray(jcst.jxr),
        jnp.asarray(jcst.jxi))
    tplan = _tplan(plan)
    bare = tmk.MegaConstants.build(tplan, None, scale, offset).to("cpu")
    jones = convert.jones_from_numpy(jcst.jxr, jcst.jxi, tplan, "cpu")
    targs = [bare.gr, bare.gi] if kw.get("response_as_args") else []
    t = torch.from_numpy(raw)
    tout = tmk.build_megafil(tplan, bare, NPART, **kw)(t, *targs, jones)
    held = tmk.build_megafil(
        tplan, dataclasses.replace(bare, jones=jones), NPART,
        **{k: v for k, v in kw.items() if not k.endswith("_as_args")})(t)
    if not kw.get("passband"):
        jout, tout, held = (jout,), (tout,), (held,)
    if kw.get("output") == "voltage":
        jout = (np.asarray(jout[0][0]) + 1j * np.asarray(jout[0][1]),
                *jout[1:])
    assert len(tout) == len(jout) == len(held)
    for got, want, same in zip(tout, jout, held):
        _close(got.numpy(), np.asarray(want))
        assert torch.equal(got, same)


def test_uncovered_plans_raise():
    plan, raw, resp = _setup(npol_out=4, fourth_moment=True)
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        tmk.build_megafil(_tplan(plan), None, NPART)
    plan, raw, resp = _setup()
    # Jones constants build (the front end mixes them in); the fused fold
    # step refuses them, as the JAX package never runs them there
    cst = tmk.MegaConstants.build(_tplan(plan), resp,
                                  jones=np.ones((1, NSUB * FREQ_RES, 2, 2)))
    with pytest.raises(NotImplementedError, match="Queue 2 item 1"):
        tmk.build_megastep(_tplan(plan), cst, NPART)
    with pytest.raises(ValueError, match="output mode"):
        tmk.build_megafil(_tplan(plan), None, NPART, output="spectra")


def test_library_path_tracks_shared_header(tmp_path, monkeypatch):
    """A kernel library is named by its source AND the csrc headers it
    includes: editing the shared header renames both libraries, editing one
    source renames only its own."""
    from dspsr_tpu_torch.kernels import build

    src = tmp_path / "csrc"
    shutil.copytree(build._SRC_DIR, src)
    monkeypatch.setattr(build, "_SRC_DIR", src)
    before = {n: build.library_path(n) for n in ("megastep", "megafil")}
    assert before["megastep"] != before["megafil"]
    header = src / "mega_common.cuh"
    header.write_text(header.read_text() + "\n// edited\n")
    after = {n: build.library_path(n) for n in ("megastep", "megafil")}
    assert all(after[n] != before[n] for n in after)
    cu = src / "megafil.cu"
    cu.write_text(cu.read_text() + "\n// edited\n")
    assert build.library_path("megafil") != after["megafil"]
    assert build.library_path("megastep") == after["megastep"]
