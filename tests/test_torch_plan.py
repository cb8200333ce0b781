"""The port's host-side plan layer against the JAX package's, exactly.

MegaPlan fields, the chirp the port keeps (bitwise, after undoing the JAX
package's [k1, k2] permutation), FilterbankPlan, FoldPlan, choose_nbin,
compute_anchors, unpack_affine, window_weight_spans and the device noise
generator.  Each side builds its Observation, Source and predictor from its
own package's classes, with the same arguments.
"""

import dataclasses

import numpy as np
import pytest
import torch

from dspsr_tpu.io.sources import device_noise_bytes as jax_noise
from dspsr_tpu.ops import filterbank as jfb
from dspsr_tpu.ops import fold as jfold
from dspsr_tpu.ops import megakernel as jmk
from dspsr_tpu.timing.polyco import FixedPeriodPredictor

from dspsr_tpu_torch import convert
from dspsr_tpu_torch.io.sources import device_noise_bytes
from dspsr_tpu_torch.timing import polyco as tpolyco
from dspsr_tpu_torch.ops import filterbank as tfb
from dspsr_tpu_torch.ops import fold as tfold
from dspsr_tpu_torch.ops import megakernel as tmk
from test_torch_pipeline import PKGS, plain

torch.set_num_threads(2)

NSUB, FREQ_RES, NPOL, NBIN = 4, 64, 2, 32


def _flagship_obs(pkg="jax"):
    """The flagship input's Observation, from package ``pkg``'s classes."""
    _, obs, mjd = PKGS[pkg]
    return obs.Observation(
        nchan=1, npol=2, ndim=1, nbit=8, centre_frequency=1382.0,
        bandwidth=-400.0, rate=800e6,
        start_time=mjd.MJD.from_utc("2010-04-13-02:05:45"),
        state=obs.Signal.NYQUIST, source="J0437-4715", telescope="PKS",
        instrument="DUMMY").replace(ndat=1 << 40)


def _flagship_source(pkg="jax"):
    return PKGS[pkg][0].DummySource(_flagship_obs(pkg))


FLAGSHIP = dict(folding_period=0.00575745, dispersion_measure=2.64,
                nchan=64, nbin=1024, block_parts=8, npol_out=1,
                min_block_samples=1 << 25)


@pytest.fixture(scope="module")
def flagship():
    """Both packages' pipelines built from the flagship configuration."""
    from dspsr_tpu.models.load_to_fold import FoldConfig, FoldPipeline
    from dspsr_tpu_torch.models import load_to_fold as tl

    jpipe = FoldPipeline(_flagship_source(), FoldConfig(**FLAGSHIP))
    tpipe = tl.FoldPipeline(_flagship_source("port"),
                            tl.FoldConfig(**FLAGSHIP), device="cpu")
    return jpipe, tpipe


def _geometry(name):
    """(JAX MegaPlan, natural-order response) for a named geometry."""
    rng = np.random.default_rng(1)
    if name == "flagship":
        from dspsr_tpu.models.load_to_fold import FoldConfig, FoldPipeline

        pipe = FoldPipeline(_flagship_source(), FoldConfig(**FLAGSHIP))
        return pipe.mega_plan, pipe.kernel.phasors
    nchan_in = 2 if name == "two_channel" else 1
    fb = jfb.FilterbankPlan(real_input=True, nchan_subband=NSUB,
                            freq_res=FREQ_RES, nfilt_pos=5, nfilt_neg=6)
    plan = jmk.MegaPlan.from_filterbank(fb, nbin=NBIN, npol=NPOL,
                                        npol_out=4, nchan_in=nchan_in)
    resp = np.exp(1j * rng.uniform(-3, 3, (nchan_in * NSUB, FREQ_RES)))
    return plan, resp


@pytest.mark.parametrize("name", ["test", "two_channel", "flagship"])
def test_megaplan_fields(name):
    jplan, _ = _geometry(name)
    fb = tfb.FilterbankPlan(real_input=jplan.real_input,
                            nchan_subband=jplan.nsub,
                            freq_res=jplan.freq_res,
                            nfilt_pos=jplan.nfilt_pos,
                            nfilt_neg=jplan.nfilt_neg)
    tplan = tmk.MegaPlan.from_filterbank(
        fb, jplan.nbin, jplan.npol, jplan.npol_out, jplan.nbit,
        nchan_in=jplan.nchan_in)
    assert dataclasses.asdict(tplan) == dataclasses.asdict(jplan)
    for prop in ("n_fft", "R2", "q", "nkeep", "row_len", "nsamp_step",
                 "step_rows", "nplane", "nsamp_fft"):
        assert getattr(tplan, prop) == getattr(jplan, prop), prop
    assert tplan.block_ndat(75) == jplan.block_ndat(75)


@pytest.mark.parametrize("name", ["test", "two_channel", "flagship"])
def test_chirp_bitwise_and_convert(name):
    jplan, resp = _geometry(name)
    tplan = tmk.MegaPlan(**dataclasses.asdict(jplan))
    scale, offset = jmk.unpack_affine(8)
    jcst = jmk.MegaConstants(jplan, resp, dtype=np.float32,
                             unpack_scale=scale, unpack_offset=offset)
    tcst = tmk.MegaConstants.build(tplan, resp, scale, offset)
    n = jplan.nchan_in
    for jarr, tarr in ((jcst.gr, tcst.gr), (jcst.gi, tcst.gi)):
        # documented re-layout: [nchan, k1, k2] -> natural k = k2*R1 + k1
        natural = np.ascontiguousarray(jarr.transpose(0, 2, 1)).reshape(
            n, jplan.n_fft)
        assert tarr.dtype == np.float32 and tarr.shape == natural.shape
        assert np.array_equal(tarr.view(np.uint32), natural.view(np.uint32))
    conv = convert.constants_from_numpy(
        {"gr": jcst.gr, "gi": jcst.gi, "unpack_scale": jcst.unpack_scale,
         "unpack_offset": jcst.unpack_offset}, tplan, "cpu")
    own = tcst.to("cpu")
    assert torch.equal(conv.gr, own.gr) and torch.equal(conv.gi, own.gi)
    assert (conv.unpack_scale, conv.unpack_offset) == \
        (own.unpack_scale, own.unpack_offset) == (scale, offset)


def test_flagship_pipeline_geometry(flagship):
    jpipe, tpipe = flagship
    assert jpipe.mega_mode == tpipe.mega_mode == "full"
    assert dataclasses.asdict(tpipe.mega_plan) == \
        dataclasses.asdict(jpipe.mega_plan)
    assert dataclasses.asdict(tpipe.fb_plan) == \
        dataclasses.asdict(jpipe.fb_plan)
    for attr in ("npart", "block_in_samples", "stride_in_samples",
                 "out_per_block", "nbin", "dm", "folding_period"):
        assert getattr(tpipe, attr) == getattr(jpipe, attr), attr
    assert tpipe.fold_plan == tfold.FoldPlan(jpipe.fold_plan.nbin,
                                             jpipe.fold_plan.seg_len)
    assert plain(tpipe.obs_out) == plain(jpipe.obs_out)
    assert (tpipe.mega_plan.nsub, tpipe.mega_plan.freq_res,
            tpipe.mega_plan.R1, tpipe.npart, tpipe.out_per_block) == \
        (64, 4096, 512, 75, 264000)


@pytest.mark.parametrize("real_input,nsub,freq_res,nfp,nfn", [
    (True, 4, 64, 5, 6), (True, 64, 4096, 281, 290), (False, 8, 256, 3, 9)])
def test_filterbank_plan(real_input, nsub, freq_res, nfp, nfn):
    j = jfb.FilterbankPlan(real_input, nsub, freq_res, nfp, nfn)
    t = tfb.FilterbankPlan(real_input, nsub, freq_res, nfp, nfn)
    for prop in ("n_fft", "nfilt_tot", "nsamp_fft", "nsamp_overlap",
                 "nsamp_step", "nkeep"):
        assert getattr(t, prop) == getattr(j, prop), prop
    for ndat in (0, 100, 1 << 20, 33865728):
        assert t.npart(ndat) == j.npart(ndat)
    assert t.block_ndat(75) == j.block_ndat(75)
    assert plain(tfb.update_observation(_flagship_obs("port"), t)) == \
        plain(jfb.update_observation(_flagship_obs(), j))


@pytest.mark.parametrize("period,tsamp,req", [
    (0.00575745, 1.6e-7, 0), (0.089, 1e-6, 0), (0.005, 1e-3, 0),
    (0.00575745, 1.6e-7, 512)])
def test_choose_nbin(period, tsamp, req):
    assert tfold.choose_nbin(period, tsamp, req) == \
        jfold.choose_nbin(period, tsamp, req)


@pytest.mark.parametrize("offset_s,seg", [(0.0, 3520), (1234.5678, 32)])
def test_compute_anchors_bitwise(offset_s, seg):
    args = []
    for pkg, fp in (("jax", FixedPeriodPredictor),
                    ("port", tpolyco.FixedPeriodPredictor)):
        t0 = _flagship_obs(pkg).start_time
        args.append((fp(0.00575745, t0 + 0.37), t0 + offset_s))
    a = jfold.compute_anchors(*args[0], 1.6e-7, 75 * seg, seg)
    b = tfold.compute_anchors(*args[1], 1.6e-7, 75 * seg, seg)
    for x, y in zip(a, b):
        assert x.dtype == y.dtype == np.float32
        assert np.array_equal(x.view(np.uint32), y.view(np.uint32))


@pytest.mark.parametrize("nbit", [1, 2, 4, 8, 32])
@pytest.mark.parametrize("twos", [False, True])
def test_unpack_affine(nbit, twos):
    if twos and nbit in (1, 32):
        if nbit == 1:
            with pytest.raises(NotImplementedError):
                jmk.unpack_affine(nbit, twos)
            with pytest.raises(NotImplementedError):
                tmk.unpack_affine(nbit, twos)
            return
    assert tmk.unpack_affine(nbit, twos) == jmk.unpack_affine(nbit, twos)


def test_window_weight_spans():
    fb = jfb.FilterbankPlan(real_input=False, nchan_subband=NSUB,
                            freq_res=FREQ_RES, nfilt_pos=5, nfilt_neg=6)
    jplan = jmk.MegaPlan.from_filterbank(fb, nbin=NBIN, npol=NPOL, nbit=2,
                                         ndat_per_weight=16)
    tplan = tmk.MegaPlan(**dataclasses.asdict(jplan))
    assert tplan.npw == 16
    assert tmk.window_weight_spans(tplan, 5) == \
        jmk.window_weight_spans(jplan, 5)


@pytest.mark.parametrize("start", [0, 98765, 4294967296 - 300])
def test_device_noise_bytes(start):
    n = 1000
    want = np.asarray(jax_noise(start, n))
    got = device_noise_bytes(start, n, "cpu")
    assert got.dtype == torch.uint8
    assert np.array_equal(got.numpy(), want)
