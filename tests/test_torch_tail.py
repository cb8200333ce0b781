"""The hybrid fold engine's tail ops in the port against the JAX package's,
on the same numpy arrays made from a seed:

- ``median_filter_freq``: bit-identical (the same min/max network);
- ``sk_mask``: masks equal for the cell, time-scrunched and
  frequency-scrunched rounds and a channel range.  The sums are taken in
  another order, so a cell may fall the other way when its statistic sits on
  a threshold: a differing cell passes only if its statistic (float64) lies
  within 1e-5 relative of the threshold it crossed;
- ``fold_block``: profiles within 1e-5 relative, hits identical;
- ``detect``, ``fourth_moment`` and the conversion of detected front planes
  to each state: 1e-6 relative.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dspsr_tpu.observation import Signal as JSignal
from dspsr_tpu.ops import detection as jdet
from dspsr_tpu.ops import fold as jfold
from dspsr_tpu.ops import fourth_moment as jfm
from dspsr_tpu.ops import rfifilter as jrfi
from dspsr_tpu.ops import spectral_kurtosis as jsk

from dspsr_tpu_torch.observation import Signal as TSignal
from dspsr_tpu_torch.ops import detection as tdet
from dspsr_tpu_torch.ops import fold as tfold
from dspsr_tpu_torch.ops import fourth_moment as tfm
from dspsr_tpu_torch.ops import rfifilter as trfi
from dspsr_tpu_torch.ops import spectral_kurtosis as tsk

torch.set_num_threads(2)

STATES = ["INTENSITY", "PPQQ", "PP", "QQ", "NTHPOWER", "COHERENCE", "STOKES"]


def _rel(got, want):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert got.shape == want.shape
    return np.abs(got - want).max() / np.abs(want).max()


@pytest.mark.parametrize("width", [3, 21])
@pytest.mark.parametrize("ties", [False, True], ids=["float", "ties"])
def test_median_filter_bit_identical(width, ties):
    rng = np.random.default_rng(width)
    x = rng.exponential(1.0, (3, 2, 517)).astype(np.float32)
    if ties:
        x = np.round(x * 4).astype(np.float32)
    want = np.asarray(jrfi.median_filter_freq(jnp.asarray(x), width))
    got = trfi.median_filter_freq(torch.from_numpy(x), width).numpy()
    assert np.array_equal(got.view(np.uint32), want.view(np.uint32))
    with pytest.raises(ValueError, match="odd"):
        trfi.median_filter_freq(torch.from_numpy(x), 4)


def _power(seed, nchan=6, npol=2, ndat=64 * 40):
    """Exponential power (Gaussian voltages) with interference: a channel
    whose power steps up mid-block, impulsive bursts in a few cells and one
    silent cell."""
    rng = np.random.default_rng(seed)
    p = rng.exponential(1.0, (nchan, npol, ndat)).astype(np.float32)
    p[2, :, ndat // 2:] *= 1.8
    for c, t in ((0, 5), (4, 17), (5, 30)):
        p[c, :, t * 64:t * 64 + 8] *= 40.0
    p[1, 1, 64 * 9:64 * 10] = 1.0
    return p


def _sk_stat(p, fscr=False):
    """float64 SK statistic of each cell ``[..., M]`` of ``p`` (pooled over
    the channels, axis 0, with ``fscr``)."""
    p = p.astype(np.float64)
    M = p.shape[-1]
    s1, s2 = p.sum(-1), (p * p).sum(-1)
    if fscr:
        nd = p.shape[0]
        s1, s2, M = s1.sum(0), s2.sum(0), M * nd
    return (M + 1) / (M - 1) * (M * s2 / s1 ** 2 - 1)


def _assert_masks_agree(got, want, p, plan, nblk):
    """Equal masks, or each differing cell on a threshold to 1e-5."""
    diff = np.argwhere(got != want)
    if not len(diff):
        return
    M = plan.M
    cells = p[:, :, :nblk * M].reshape(p.shape[0], p.shape[1], nblk, M)
    edges = [*plan.thresholds()]
    if plan.detect_tscr:
        edges += [*plan.thresholds(M * nblk)]
    if plan.detect_fscr:
        one = np.sqrt(4.0 / (M * p.shape[0]))
        edges += [1 - plan.std_devs * one, 1 + plan.std_devs * one]
    for c, b in diff:
        stats = np.concatenate([
            _sk_stat(cells[c, :, b]),
            _sk_stat(cells[c].reshape(p.shape[1], -1)),
            _sk_stat(cells[:, :, b], fscr=True)])
        near = min(abs(s - e) / abs(e) for s in stats for e in edges)
        assert near < 1e-5, f"cell ({c}, {b}) differs {near:.2e} from a " \
            "threshold"


@pytest.mark.parametrize("kw", [
    dict(), dict(detect_tscr=False, detect_fscr=False),
    dict(detect_cell=False, detect_fscr=False),
    dict(detect_cell=False, detect_tscr=False),
    dict(chan_start=1, chan_end=4), dict(chan_start=3), dict(std_devs=2)],
    ids=["all", "cell", "tscr", "fscr", "range", "from3", "2sigma"])
def test_sk_mask_matches_jax(kw):
    p = _power(len(kw))
    nblk = p.shape[-1] // 64
    jplan = jsk.SKPlan(64, **kw)
    tplan = tsk.SKPlan(64, **kw)
    want = np.asarray(jsk.sk_mask(jnp.asarray(p), jplan, nblk))
    got = tsk.sk_mask(torch.from_numpy(p), tplan, nblk).numpy()
    assert got.dtype == np.float32 and got.shape == want.shape
    _assert_masks_agree(got, want, p, jplan, nblk)
    assert (got == 0).any() and (got == 1).any()
    np.testing.assert_array_equal(
        tsk.expand_mask(torch.from_numpy(got), 64).numpy(),
        np.asarray(jsk.expand_mask(jnp.asarray(got), 64)))
    # SK ~ 1 is M S2 / S1^2 - 1 in float32: the sums' order shows at 1e-6
    x = p[:, :, :64 * 3].reshape(6, 2, 3, 64)
    np.testing.assert_allclose(
        tsk.sk_estimate(torch.from_numpy(x), 64).numpy(),
        np.asarray(jsk.sk_estimate(jnp.asarray(x), 64)), rtol=1e-5)


def test_sk_mask_sharded_raises():
    p = torch.ones(2, 2, 128)
    with pytest.raises(NotImplementedError, match="item 10"):
        tsk.sk_mask(p, tsk.SKPlan(64), 2, axis_name="chan", nchan_total=4)


@pytest.mark.parametrize("nbin,seg", [(32, 64), (1024, 250)])
def test_fold_block_matches_jax(nbin, seg):
    rng = np.random.default_rng(nbin)
    nchan, npol, nseg = 3, 2, 5
    ndat = nseg * seg + 7  # a tail past the last whole segment
    x = rng.normal(1, 1, (nchan, npol, ndat)).astype(np.float32)
    w = (rng.uniform(size=(nchan, ndat)) > 0.2).astype(np.float32)
    phi0 = rng.uniform(0, 1, nseg).astype(np.float32)
    dphi = np.full(nseg, 3.3 / seg, np.float32)
    prof0 = rng.normal(0, 1, (nchan, npol, nbin)).astype(np.float32)
    hits0 = rng.integers(0, 5, (nchan, nbin)).astype(np.float32)
    jplan = jfold.FoldPlan(nbin, seg)
    want = jfold.fold_block(jnp.asarray(prof0), jnp.asarray(hits0),
                            jnp.asarray(x[:, :, :nseg * seg]),
                            jnp.asarray(w[:, :nseg * seg]),
                            jnp.asarray(phi0), jnp.asarray(dphi), jplan)
    got = tfold.fold_block(*(torch.from_numpy(a) for a in
                             (prof0, hits0, x, w, phi0, dphi)),
                           tfold.FoldPlan(nbin, seg))
    assert _rel(got[0].numpy(), want[0]) < 1e-5
    assert np.array_equal(got[1].numpy(), np.asarray(want[1]))
    bins = tfold.compute_bins(torch.from_numpy(phi0), torch.from_numpy(dphi),
                              seg, nbin).numpy()
    assert np.array_equal(bins, np.asarray(jfold.compute_bins(
        jnp.asarray(phi0), jnp.asarray(dphi), seg, nbin=nbin)))


def _voltages(seed, npol=2):
    rng = np.random.default_rng(seed)
    return tuple(rng.normal(0, 1, (3, npol, 200)).astype(np.float32)
                 for _ in range(2))


@pytest.mark.parametrize("state", STATES)
def test_detect_matches_jax(state):
    re, im = _voltages(len(state))
    want = jdet.detect((jnp.asarray(re), jnp.asarray(im)), JSignal[state])
    got = tdet.detect((torch.from_numpy(re), torch.from_numpy(im)),
                      TSignal[state])
    assert _rel(got.numpy(), want) < 1e-6
    real = tdet.detect(torch.from_numpy(re), TSignal[state])
    assert _rel(real.numpy(), jdet.detect(jnp.asarray(re),
                                          JSignal[state])) < 1e-6


@pytest.mark.parametrize("state", STATES)
def test_front_planes_to_state(state):
    """The conversion of the hybrid front end's planes (PP+QQ, PP/QQ, or
    coherence) to each state against the JAX package's detection of the
    voltages the planes came from."""
    re, im = _voltages(7)
    y = (jnp.asarray(re), jnp.asarray(im))
    front_np = {"INTENSITY": 1, "NTHPOWER": 1}.get(state, 2)
    if state in ("COHERENCE", "STOKES"):
        front_np = 4
    planes = {1: jdet.detect_intensity, 2: jdet.detect_ppqq,
              4: jdet.detect_coherence}[front_np](y)
    planes = torch.tensor(np.asarray(planes))
    got = tdet.from_front_planes(planes, TSignal[state], front_np)
    assert _rel(got.numpy(), jdet.detect(y, JSignal[state])) < 1e-6
    if front_np == 1:
        return
    # SK's Intensity/NthPower run on the PPQQ planes too
    for st in ("INTENSITY", "NTHPOWER"):
        got = tdet.from_front_planes(planes, TSignal[st], front_np)
        assert _rel(got.numpy(), jdet.detect(y, JSignal[st])) < 1e-6


def test_fourth_moment_matches_jax():
    s = np.random.default_rng(4).normal(0, 1, (3, 4, 100)).astype(np.float32)
    want = jfm.fourth_moment(jnp.asarray(s))
    got = tfm.fourth_moment(torch.from_numpy(s))
    assert got.shape == (3, 14, 100)
    assert _rel(got.numpy(), want) < 1e-6
    assert tfm.PAIRS == jfm.PAIRS
