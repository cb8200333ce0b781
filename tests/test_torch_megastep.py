"""The port's plain fused step (``megastep_plain``, CPU) against the JAX
package's float64 ``mega_reference`` and its Pallas kernel in interpret
mode, at the test geometry of ``tests/test_megakernel.py``.

Tolerances are the reference's own (``tests/test_megakernel.py:80-81,
102-103``): profiles to 2e-5 relative, hits exactly.
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dspsr_tpu.ops import megakernel as jmk
from dspsr_tpu.ops.filterbank import FilterbankPlan

from dspsr_tpu_torch import convert
from dspsr_tpu_torch.ops import megakernel as tmk

torch.set_num_threads(2)

NSUB, FREQ_RES, NPOL, NBIN, NPART = 4, 64, 2, 32, 3
TOL = 2e-5


def _setup(nchan_in=1, seed=0, **kw):
    rng = np.random.default_rng(seed)
    fb = FilterbankPlan(real_input=True, nchan_subband=NSUB,
                        freq_res=FREQ_RES, nfilt_pos=5, nfilt_neg=6)
    plan = jmk.MegaPlan.from_filterbank(fb, nbin=NBIN, npol=NPOL,
                                        nchan_in=nchan_in, **kw)
    raw = rng.integers(0, 256, size=plan.block_ndat(NPART) * nchan_in * NPOL,
                       dtype=np.uint8)
    resp = np.exp(1j * rng.uniform(-3, 3, (nchan_in * NSUB, FREQ_RES)))
    phi0 = rng.uniform(0, 1, NPART).astype(np.float32)
    dphi = np.full(NPART, 0.013, np.float32)
    return plan, raw, resp, phi0, dphi


def _port(plan, raw, resp, phi0, dphi, bounds=None, cst=None):
    tplan = tmk.MegaPlan(**dataclasses.asdict(plan))
    if cst is None:
        scale, offset = tmk.unpack_affine(8, plan.twos_complement)
        cst = tmk.MegaConstants.build(tplan, resp, scale, offset).to("cpu")
    p, h = tmk.megastep_plain(
        tplan, cst,
        torch.zeros(plan.nchan_in, plan.nplane, NSUB, NBIN),
        torch.zeros(plan.nchan_in, NBIN), torch.from_numpy(raw),
        torch.from_numpy(phi0), torch.from_numpy(dphi), bounds)
    return p.numpy(), h.numpy()


def _reference(plan, raw, resp, phi0, dphi):
    scale, offset = jmk.unpack_affine(8, plan.twos_complement)
    cst = jmk.MegaConstants(plan, resp, dtype=np.float64,
                            unpack_scale=scale, unpack_offset=offset)
    return jmk.mega_reference(raw, plan, cst, phi0.astype(np.float64),
                              dphi.astype(np.float64), NPART)


def _pallas(plan, raw, resp, phi0, dphi, bounds=None):
    scale, offset = jmk.unpack_affine(8, plan.twos_complement)
    cst = jmk.MegaConstants(plan, resp, dtype=np.float32,
                            unpack_scale=scale, unpack_offset=offset)
    step = jmk.build_megastep(plan, cst, NPART, interpret=True)
    extra = () if bounds is None else (jnp.asarray(bounds, jnp.float32),)
    p, h = step(jnp.zeros((plan.nchan_in, plan.nplane, NSUB, NBIN)),
                jnp.zeros((plan.nchan_in, NBIN)), jnp.asarray(raw),
                jnp.asarray(phi0), jnp.asarray(dphi), *extra)
    return np.asarray(p), np.asarray(h)


def _close(got, want):
    (pg, hg), (pw, hw) = got, want
    assert pg.shape == pw.shape and hg.shape == hw.shape
    assert np.abs(pg - pw).max() / np.abs(pw).max() < TOL
    assert np.abs(hg - hw).max() == 0


@pytest.mark.parametrize("kw", [
    dict(npol_out=1), dict(npol_out=2), dict(npol_out=4),
    dict(npol_out=4, detection="coherence"),
    dict(npol_out=1, detection="pp"), dict(npol_out=1, detection="qq"),
    dict(npol_out=4, fourth_moment=True),
    dict(npol_out=1, twos_complement=True),
    dict(npol_out=4, nchan_in=2),
], ids=lambda kw: "-".join(f"{k}={v}" for k, v in kw.items()))
def test_plain_matches_reference(kw):
    args = _setup(seed=sum(map(ord, str(kw))), **kw)
    _close(_port(*args), _reference(*args))


def test_plain_matches_pallas_interpret():
    args = _setup(npol_out=4, detection="coherence")
    _close(_port(*args), _pallas(*args))


@pytest.mark.parametrize("bounds", [(7, 70), (40, 41), (0, 96)])
def test_bounds_match_pallas_interpret(bounds):
    """Sample-exact sub-integration bounds, cutting windows, against the
    Pallas kernel (the float64 reference has no bounds)."""
    args = _setup(npol_out=2)
    got = _port(*args, bounds=bounds)
    _close(got, _pallas(*args, bounds=bounds))
    assert got[1].sum() == bounds[1] - bounds[0]


def test_jax_constants_through_convert():
    plan, raw, resp, phi0, dphi = _setup(npol_out=1)
    scale, offset = jmk.unpack_affine(8)
    jcst = jmk.MegaConstants(plan, resp, dtype=np.float32,
                             unpack_scale=scale, unpack_offset=offset)
    cst = convert.constants_from_numpy({"gr": jcst.gr, "gi": jcst.gi},
                                       plan, "cpu")
    _close(_port(plan, raw, resp, phi0, dphi, cst=cst),
           _reference(plan, raw, resp, phi0, dphi))


def test_step_carries_and_dispatches_on_cpu():
    """build_megastep's step on CPU tensors is the plain step, and adds to
    the carried accumulators (fed from JAX state by convert)."""
    plan, raw, resp, phi0, dphi = _setup(npol_out=1)
    tplan = tmk.MegaPlan(**dataclasses.asdict(plan))
    cst = tmk.MegaConstants.build(tplan, resp, *tmk.unpack_affine(8)).to(
        "cpu")
    rng = np.random.default_rng(3)
    prof0 = rng.uniform(0, 1, (1, 1, NSUB, NBIN))
    hits0 = rng.integers(0, 100, (1, NBIN)).astype(np.float64)
    p0, h0 = convert.accumulators_from_numpy(prof0, hits0, "cpu")
    assert p0.dtype == h0.dtype == torch.float32
    step = tmk.build_megastep(tplan, cst, NPART)
    p, h = step(p0, h0, torch.from_numpy(raw), torch.from_numpy(phi0),
                torch.from_numpy(dphi))
    pb, hb = _port(plan, raw, resp, phi0, dphi)
    assert np.allclose(p.numpy(), prof0.astype(np.float32) + pb, rtol=1e-6)
    assert np.array_equal(h.numpy(), hits0.astype(np.float32) + hb)
    with pytest.raises(ValueError):
        step(p0, h0, torch.from_numpy(raw), torch.from_numpy(phi0[:2]),
             torch.from_numpy(dphi[:2]))


def test_cuda_wrapper_refuses_cpu_tensors():
    from dspsr_tpu_torch.kernels.megastep import megastep_cuda

    plan, raw, resp, phi0, dphi = _setup(npol_out=1)
    tplan = tmk.MegaPlan(**dataclasses.asdict(plan))
    cst = tmk.MegaConstants.build(tplan, resp).to("cpu")
    with pytest.raises(ValueError, match="CUDA"):
        megastep_cuda(tplan, cst, torch.zeros(1, 1, NSUB, NBIN),
                      torch.zeros(1, NBIN), torch.from_numpy(raw),
                      torch.from_numpy(phi0), torch.from_numpy(dphi))


@pytest.mark.parametrize("kw,cst_kw", [
    (dict(nbit=2, ndat_per_weight=16, real_input=False), {}),
    (dict(nbit=4), {}),
    (dict(real_input=False), {}),
    (dict(), dict(window=np.ones(2 * NSUB * FREQ_RES))),
    (dict(), dict(jones=np.ones((1, NSUB * FREQ_RES, 2, 2)))),
])
def test_uncovered_plans_raise(kw, cst_kw):
    real = kw.pop("real_input", True)
    fb = FilterbankPlan(real_input=real, nchan_subband=NSUB,
                        freq_res=FREQ_RES, nfilt_pos=5, nfilt_neg=6)
    plan = tmk.MegaPlan.from_filterbank(fb, nbin=NBIN, npol=NPOL, **kw)
    with pytest.raises(NotImplementedError):
        tmk.MegaConstants.build(plan, None, **cst_kw)
    if not cst_kw:
        with pytest.raises(NotImplementedError):
            tmk.build_megastep(plan, None, NPART)
