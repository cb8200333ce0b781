"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

Builds the hand-written kernels from the sources in this checkout (one
nvcc per source, all at once), holds each against its plain PyTorch version
on the card, drives the port's main paths on the flagship input (DUMMY
8-bit dual-pol real input at 800 Msamp/s, DM 2.64, 64 channels) for a few
blocks each, checks the results, and prints timings:

- the fold path (``mega_real_8bit``: 1024 bins, kernel ``megastep``);
- the search path (``megafil_search``: the digifil workflow to an 8-bit
  SIGPROC file, kernel ``megafil``);
- the hybrid fold engine (``hybrid_sk``: in-stream spectral kurtosis with
  1024-sample cells; ``hybrid_rfi``: the spectral RFI filter): kernel
  ``megafil`` with the passband tap and the chirp handed in per block, then
  the fold tail in plain PyTorch.

Imports nothing of JAX or of the JAX package (an import hook refuses both).
Exits non-zero on any failure, or when no CUDA device is present.  The last
line of standard output is ``{"ok": true, "device": {...}}``.
"""

from __future__ import annotations

import json
import math
import os
import re
import subprocess
import sys
import tempfile
import time
import importlib.abc
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import torch


class _Refuse(importlib.abc.MetaPathFinder):
    """Refuses any import of jax or of the JAX package (dspsr_tpu)."""

    def find_spec(self, name, path=None, target=None):
        if name.split(".")[0] in ("jax", "dspsr_tpu"):
            raise ImportError(f"chip_smoke imported {name}")
        return None


sys.meta_path.insert(0, _Refuse())

#: the card's peaks (H100 SXM data sheet): device-memory bytes/s and
#: float32 operations/s outside the tensor cores
HBM_BYTES_S = 3.35e12
F32_OPS_S = 67e12

TOL_SMALL = 2e-5  # relative, kernel (f32) against plain (f64), test geometry
TOL_FLAGSHIP = 1e-4  # relative, kernel against plain, both f32, 2^19 windows
# the pallas_call of build_megastep and of build_megafil
REPLACES = {"megastep": "dspsr_tpu/ops/megakernel.py:1054",
            "megafil": "dspsr_tpu/ops/megakernel.py:1439"}


def check(ok: bool, msg: str) -> None:
    if not ok:
        raise RuntimeError(f"check failed: {msg}")


def card_facts() -> str:
    check(torch.cuda.is_available(), "torch.cuda.is_available() is False")
    print(f"torch {torch.__version__} cuda {torch.version.cuda} "
          f"python {sys.version.split()[0]}", flush=True)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True, check=True)
    card = smi.stdout.strip().splitlines()[0]
    print(card, flush=True)
    from dspsr_tpu_torch.kernels.build import nvcc_path

    nvcc = subprocess.run([nvcc_path(), "--version"], capture_output=True,
                          text=True, check=True).stdout.strip().splitlines()
    print(f"nvcc: {nvcc[-1]}", flush=True)
    return card


def flagship_obs():
    from dspsr_tpu_torch.models.load_to_fold import MJD, Observation, Signal

    return Observation(
        nchan=1, npol=2, ndim=1, nbit=8, centre_frequency=1382.0,
        bandwidth=-400.0, rate=800e6,
        start_time=MJD.from_utc("2010-04-13-02:05:45"),
        state=Signal.NYQUIST, source="J0437-4715", telescope="PKS",
        instrument="DUMMY").replace(ndat=1 << 40)


def flagship_cfg(**kw):
    from dspsr_tpu_torch.models.load_to_fold import FoldConfig

    # mega_real_8bit, with J0437-4715's period in place of its polyco
    return FoldConfig(folding_period=0.00575745, dispersion_measure=2.64,
                      nchan=64, nbin=1024, block_parts=8, npol_out=1,
                      min_block_samples=1 << 25, **kw)


def search_cfg():
    from dspsr_tpu_torch.models.load_to_fil import FilConfig

    # megafil_search (bench.py:445-446)
    return FilConfig(nchan=64, dispersion_measure=2.64, nbits=8,
                     min_block_samples=1 << 25, block_parts=8)


def rel_err(a: torch.Tensor, b: torch.Tensor) -> float:
    a, b = a.double(), b.double()
    return float((a - b).abs().max() / b.abs().max())


def small_checks() -> None:
    """Kernel (f32) against plain (f64) at the test geometry, every
    detection branch, two input channels, two's complement and bounds."""
    from dspsr_tpu_torch.ops.filterbank import FilterbankPlan
    from dspsr_tpu_torch.ops.megakernel import (
        MegaConstants, MegaPlan, build_megastep, megastep_plain,
        unpack_affine)

    nsub, freq_res, npol, nbin, npart = 4, 64, 2, 32, 3
    fb = FilterbankPlan(real_input=True, nchan_subband=nsub,
                        freq_res=freq_res, nfilt_pos=5, nfilt_neg=6)
    cases = [
        dict(npol_out=1), dict(npol_out=2), dict(npol_out=4),
        dict(npol_out=4, detection="coherence"),
        dict(npol_out=4, fourth_moment=True),
        dict(npol_out=1, detection="pp"), dict(npol_out=1, detection="qq"),
        dict(npol_out=1, twos_complement=True),
        dict(npol_out=4, nchan_in=2),
    ]
    rng = np.random.default_rng(0)
    for kw in cases:
        plan = MegaPlan.from_filterbank(fb, nbin=nbin, npol=npol, **kw)
        nci = plan.nchan_in
        raw = torch.from_numpy(rng.integers(
            0, 256, plan.block_ndat(npart) * nci * npol, dtype=np.uint8))
        resp = np.exp(1j * rng.uniform(-3, 3, (nci * nsub, freq_res)))
        phi0 = torch.from_numpy(rng.uniform(0, 1, npart).astype(np.float32))
        dphi = torch.full((npart,), 0.013, dtype=torch.float32)
        scale, offset = unpack_affine(8, plan.twos_complement)
        cst = MegaConstants.build(plan, resp, scale, offset).to("cuda")
        step = build_megastep(plan, cst, npart)
        args = [raw.cuda(), phi0.cuda(), dphi.cuda()]
        for bounds in (None, (7, 70)):
            shp = (nci, plan.nplane, nsub, nbin)
            pk, hk = step(torch.zeros(shp, device="cuda"),
                          torch.zeros(nci, nbin, device="cuda"), *args,
                          bounds)
            pp, hp = megastep_plain(
                plan, cst, torch.zeros(shp, dtype=torch.float64,
                                       device="cuda"),
                torch.zeros(nci, nbin, dtype=torch.float64, device="cuda"),
                *args, bounds)
            torch.cuda.synchronize()
            err = rel_err(pk, pp)
            hdiff = float((hk.double() - hp).abs().max())
            print(f"small {kw} bounds={bounds}: rel err {err:.3e}, "
                  f"hits diff {hdiff}", flush=True)
            check(bool(torch.isfinite(pk).all()), f"finite profiles {kw}")
            check(err < TOL_SMALL, f"small geometry {kw}: {err} >= "
                  f"{TOL_SMALL}")
            check(hdiff == 0, f"small geometry hits {kw}")
            check(float(hk.sum()) > 0, f"hits folded {kw}")


def unequal_raw(plan, npart: int, rng) -> torch.Tensor:
    """Raw TFP bytes whose pol a spans the codes 0-255 and pol b only
    127/128: pol b's power is ~1/22000 of pol a's."""
    shape = (plan.block_ndat(npart), plan.nchan_in, plan.npol)
    raw = rng.integers(0, 256, shape, dtype=np.uint8)
    raw[..., 1] = rng.integers(127, 129, shape[:2], dtype=np.uint8)
    return torch.from_numpy(raw.reshape(-1)).cuda()


def per_plane_err(got: torch.Tensor, want: torch.Tensor, axis: int) -> list:
    """rel_err of each plane (index on ``axis``) against its own maximum."""
    return [rel_err(got.select(axis, p), want.select(axis, p))
            for p in range(got.shape[axis])]


def small_unequal() -> None:
    """Both kernels (f32) against plain (f64) with pols of very unequal
    power and PPQQ detection, each plane judged against its own maximum:
    catches precision lost where the two pols share one transform."""
    from dspsr_tpu_torch.ops.filterbank import FilterbankPlan
    from dspsr_tpu_torch.ops.megakernel import (
        MegaConstants, MegaPlan, build_megafil, build_megastep,
        megafil_plain, megastep_plain, unpack_affine)

    nsub, freq_res, npart, nbin = 4, 64, 3, 32
    fb = FilterbankPlan(real_input=True, nchan_subband=nsub,
                        freq_res=freq_res, nfilt_pos=5, nfilt_neg=6)
    rng = np.random.default_rng(2)
    plan = MegaPlan.from_filterbank(fb, nbin=nbin, npol=2, npol_out=2)
    raw = unequal_raw(plan, npart, rng)
    resp = np.exp(1j * rng.uniform(-3, 3, (nsub, freq_res)))
    cst = MegaConstants.build(plan, resp, *unpack_affine(8)).to("cuda")
    phi0 = torch.from_numpy(rng.uniform(0, 1, npart).astype(np.float32)).cuda()
    dphi = torch.full((npart,), 0.013, dtype=torch.float32, device="cuda")
    shp = (1, plan.nplane, nsub, nbin)
    pk, hk = build_megastep(plan, cst, npart)(
        torch.zeros(shp, device="cuda"), torch.zeros(1, nbin, device="cuda"),
        raw, phi0, dphi)
    pp, hp = megastep_plain(
        plan, cst, torch.zeros(shp, dtype=torch.float64, device="cuda"),
        torch.zeros(1, nbin, dtype=torch.float64, device="cuda"), raw, phi0,
        dphi)
    got = build_megafil(plan, cst, npart)(raw)
    want = megafil_plain(plan, cst, raw, npart, dtype=torch.float64)
    torch.cuda.synchronize()
    fold_errs = per_plane_err(pk, pp, 1)
    fil_errs = per_plane_err(got, want, 1)
    power = [float(want[:, p].mean()) for p in range(2)]
    print(f"small unequal pols (PPQQ, plane means {power[0]:.4g} / "
          f"{power[1]:.4g}): megastep rel err per plane "
          f"{', '.join(f'{e:.3e}' for e in fold_errs)}; megafil "
          f"{', '.join(f'{e:.3e}' for e in fil_errs)}", flush=True)
    check(bool(torch.isfinite(pk).all() and torch.isfinite(got).all()),
          "finite unequal-power outputs")
    check(max(fold_errs + fil_errs) < TOL_SMALL,
          f"unequal pols: {fold_errs} {fil_errs} >= {TOL_SMALL}")
    check(float((hk.double() - hp).abs().max()) == 0, "unequal pols hits")


def cuda_ms(fn, reps: int) -> float:
    """Mean milliseconds of ``fn()`` on the card (CUDA events)."""
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    stop.record()
    stop.synchronize()
    return start.elapsed_time(stop) / reps


def flagship_block(card: str) -> dict:
    """One flagship block: kernel against plain (both f32) on device
    noise, then both timed."""
    from dspsr_tpu_torch.io.sources import DummySource, device_noise_bytes
    from dspsr_tpu_torch.models.load_to_fold import FoldPipeline
    from dspsr_tpu_torch.ops.fold import compute_anchors
    from dspsr_tpu_torch.ops.megakernel import megastep_plain

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    pipe = FoldPipeline(DummySource(flagship_obs()), flagship_cfg(),
                        device="cuda")
    plan = pipe.mega_plan
    nbytes = pipe.block_in_samples * 2
    raw = device_noise_bytes(0, nbytes, "cuda")
    phi0, dphi = compute_anchors(pipe.predictor, pipe.output_start_time(0),
                                 1.0 / pipe.obs_out.rate,
                                 pipe.out_per_block, plan.nkeep)
    phi0 = torch.from_numpy(phi0).cuda()
    dphi = torch.from_numpy(dphi).cuda()
    prof0 = torch.zeros(1, plan.nplane, plan.nsub, plan.nbin, device="cuda")
    hits0 = torch.zeros(1, plan.nbin, device="cuda")
    pk, hk = pipe._megastep(prof0, hits0, raw, phi0, dphi)
    pp, hp = megastep_plain(plan, pipe.constants, prof0, hits0, raw, phi0,
                            dphi)
    torch.cuda.synchronize()
    err = rel_err(pk, pp)
    abs_err = float((pk - pp).abs().max())
    hdiff = float((hk - hp).abs().max())
    print(f"flagship block: rel err {err:.3e} (abs {abs_err:.3e}), hits "
          f"diff {hdiff}, hits sum {float(hk.sum())}", flush=True)
    check(bool(torch.isfinite(pk).all()), "finite flagship profiles")
    check(err < TOL_FLAGSHIP, f"flagship rel err {err} >= {TOL_FLAGSHIP}")
    check(hdiff == 0, "flagship hits differ")
    check(float(hk.sum()) == plan.nkeep * pipe.npart, "flagship hit total")

    kernel_ms = cuda_ms(
        lambda: pipe._megastep(prof0, hits0, raw, phi0, dphi), 10)
    plain_ms = cuda_ms(
        lambda: megastep_plain(plan, pipe.constants, prof0, hits0, raw,
                               phi0, dphi), 3)
    sky_ms = pipe.stride_in_samples / pipe.obs_in.rate * 1e3
    print(f"kernel per flagship block: {kernel_ms:.3f} ms; plain: "
          f"{plain_ms:.3f} ms; block = {sky_ms:.2f} ms of sky [{card}]",
          flush=True)
    kernel_breakdown(lambda: pipe._megastep(prof0, hits0, raw, phi0, dphi),
                     card)
    from dspsr_tpu_torch.ops.megakernel import fold_pols

    nf = len(fold_pols(plan))
    nbytes = (raw.numel() + 8 * pipe.constants.gr.numel()
              + 8 * (prof0.numel() + hits0.numel()) + 8 * phi0.numel())
    return dict(max_abs_err=abs_err, ms=kernel_ms, plain_ms=plain_ms,
                **bound_of(nbytes, front_ops(plan, pipe.npart, nf, nf)),
                library_ms=None)


def kernel_breakdown(fn, card: str, reps: int = 5, label: str = "",
                     others: bool = False) -> dict:
    """Device time of each of the step's kernels (torch.profiler: the mean
    over the launches it recorded, with their count), and the step's peak
    device memory; returns the mean milliseconds of each ``mega*`` kernel.
    With ``others``, the device time per call of every other kernel (the
    plain PyTorch tail) is summed and printed too."""
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    peak_mb = (torch.cuda.max_memory_allocated() - base) / 2**20
    parts, times, rest, nrest = [], {}, 0.0, 0
    for ev in prof.key_averages():
        us = getattr(ev, "device_time_total", None)
        if us is None:
            us = getattr(ev, "cuda_time_total", 0)
        m = re.search(r"\b(mega\w*)(<[^>]*>)?(?:\(|$)", ev.key)
        if m and us > 0:
            name = f"{m.group(1)}{m.group(2) or ''}"
            times[name] = us / ev.count / 1e3
            parts.append(f"{name} {times[name]:.3f} ms (x{ev.count})")
        elif us > 0 and not ev.key.startswith(("aten::", "cuda",
                                                 "ProfilerStep")):
            # device kernels only: op-level events would count their
            # kernels twice
            rest += us / reps / 1e3
            nrest += ev.count
    if others:
        parts.append(f"other kernels {rest:.3f} ms ({nrest // reps} a call)")
    print(f"kernel breakdown per block{label}: "
          f"{'; '.join(parts) or 'no device time'}; step scratch + outputs "
          f"{peak_mb:.0f} MiB [{card}]", flush=True)
    return times


def main_path(card: str) -> int:
    """The port's main path at the flagship size; returns the megastep
    launches of the first (unsplit) run."""
    from dspsr_tpu_torch import launch_counts, reset_launch_counts
    from dspsr_tpu_torch.io.sources import DummySource
    from dspsr_tpu_torch.models.load_to_fold import FoldPipeline

    nblocks = 3
    reset_launch_counts()
    pipe = FoldPipeline(DummySource(flagship_obs()), flagship_cfg(),
                        device="cuda")

    def forbidden(*args, **kwargs):
        raise RuntimeError("torch.fft/torch.matmul called on the main path")

    # the main path must run the kernel, never the plain step's library calls
    saved = (torch.fft.rfft, torch.fft.ifft, torch.matmul)
    torch.fft.rfft = torch.fft.ifft = torch.matmul = forbidden
    try:
        t0 = time.perf_counter()
        res = pipe.run(max_blocks=nblocks)
        wall = time.perf_counter() - t0
    finally:
        torch.fft.rfft, torch.fft.ifft, torch.matmul = saved
    launches = launch_counts()["megastep"]
    check(pipe.mega_mode == "full", "mega_mode is not full")
    check(launches == nblocks, f"megastep launched {launches} times")
    check(res.profiles.shape == (1, 64, 1, 1024),
          f"profiles shape {res.profiles.shape}")
    check(bool(np.isfinite(res.profiles).all()), "non-finite profiles")
    per_chan = res.hits.sum(axis=(0, 2))
    check(bool((per_chan == nblocks * pipe.out_per_block).all()),
          f"hits per channel {per_chan[:4]} != {nblocks} x "
          f"{pipe.out_per_block}")
    prof = res.normalized()[0, :, 0, :]
    check(bool((prof.std(axis=1) > 0).all()), "flat profiles")
    msps = nblocks * pipe.stride_in_samples / wall / 1e6
    print(f"main path: {nblocks} blocks, {launches} megastep launches, "
          f"hits/chan {int(per_chan[0])}; host-fed incl. first-block "
          f"warm-up {msps:.1f} Msamp/s [{card}]", flush=True)

    # sub-integrations whose boundary falls mid-block (60 ms divisions,
    # 42.24 ms blocks): boundary blocks fold once per span with bounds
    reset_launch_counts()
    pipe = FoldPipeline(DummySource(flagship_obs()),
                        flagship_cfg(subint_seconds=0.06), device="cuda")
    res = pipe.run(max_blocks=nblocks)
    split = launch_counts()["megastep"]
    nsub = res.profiles.shape[0]
    per_chan = res.hits.sum(axis=(0, 2))
    print(f"subints: {nsub} sub-integrations, {split} megastep launches, "
          f"lengths {res.integration_length.round(6).tolist()} s",
          flush=True)
    check(nsub == 3 and split == 5, "expected 3 subints from 5 launches")
    check(bool((per_chan == nblocks * pipe.out_per_block).all()),
          "subint hits do not add up to the folded samples")
    for k in range(nsub):
        want = res.integration_length[k] * pipe.obs_out.rate
        check(abs(res.hits[k, 0].sum() - want) < 0.5,
              f"subint {k} hits != its samples")
    return launches


def pipeline_rates(card: str) -> None:
    """Host-fed and device-fed rates of the flagship pipeline (warm)."""
    from dspsr_tpu_torch.io.sources import DummySource, device_noise_bytes
    from dspsr_tpu_torch.models.load_to_fold import FoldPipeline
    from dspsr_tpu_torch.ops.fold import compute_anchors

    nblocks = 3
    pipe = FoldPipeline(DummySource(flagship_obs()), flagship_cfg(),
                        device="cuda")
    t0 = time.perf_counter()
    pipe.run(max_blocks=nblocks)
    wall = time.perf_counter() - t0
    host_msps = nblocks * pipe.stride_in_samples / wall / 1e6

    plan = pipe.mega_plan
    nbytes = pipe.block_in_samples * 2
    prof = torch.zeros(1, plan.nplane, plan.nsub, plan.nbin, device="cuda")
    hits = torch.zeros(1, plan.nbin, device="cuda")

    def block(b):
        phi0, dphi = compute_anchors(
            pipe.predictor, pipe.output_start_time(b * pipe.stride_in_samples),
            1.0 / pipe.obs_out.rate, pipe.out_per_block, plan.nkeep)
        raw = device_noise_bytes(b * nbytes, nbytes, "cuda")
        return pipe._megastep(prof, hits, raw, pipe.to_device(phi0),
                              pipe.to_device(dphi))

    block(0)
    nb = 6
    it = iter(range(1, nb + 1))
    ms = cuda_ms(lambda: block(next(it)), nb)
    dev_msps = pipe.stride_in_samples / (ms * 1e-3) / 1e6
    print(f"pipeline host-fed (DummySource bytes, pinned copy): "
          f"{host_msps:.1f} Msamp/s; device-fed (device_noise_bytes): "
          f"{dev_msps:.1f} Msamp/s; real time is 800 Msamp/s [{card}]",
          flush=True)


def small_checks_megafil() -> None:
    """Search front-end kernel (f32) against plain (f64) at the test
    geometry: two input pols (DET_SUM), one (DET_ONE), PP/QQ, PPQQ, Stokes,
    two's complement and two input channels."""
    from dspsr_tpu_torch.ops.filterbank import FilterbankPlan
    from dspsr_tpu_torch.ops.megakernel import (
        MegaConstants, MegaPlan, build_megafil, megafil_plain, unpack_affine)

    nsub, freq_res, npart = 4, 64, 3
    fb = FilterbankPlan(real_input=True, nchan_subband=nsub,
                        freq_res=freq_res, nfilt_pos=5, nfilt_neg=6)
    cases = [
        dict(npol=2), dict(npol=1), dict(npol=2, detection="pp"),
        dict(npol=2, detection="qq"), dict(npol=2, npol_out=2),
        dict(npol=2, npol_out=4), dict(npol=2, twos_complement=True),
        dict(npol=2, nchan_in=2), dict(npol=1, nchan_in=2),
    ]
    rng = np.random.default_rng(1)
    for kw in cases:
        plan = MegaPlan.from_filterbank(fb, nbin=2, **kw)
        nci, npol = plan.nchan_in, plan.npol
        raw = torch.from_numpy(rng.integers(
            0, 256, plan.block_ndat(npart) * nci * npol,
            dtype=np.uint8)).cuda()
        resp = np.exp(1j * rng.uniform(-3, 3, (nci * nsub, freq_res)))
        scale, offset = unpack_affine(8, plan.twos_complement)
        cst = MegaConstants.build(plan, resp, scale, offset).to("cuda")
        got = build_megafil(plan, cst, npart)(raw)
        want = megafil_plain(plan, cst, raw, npart, dtype=torch.float64)
        torch.cuda.synchronize()
        err = rel_err(got, want)
        print(f"small megafil {kw}: rel err {err:.3e}", flush=True)
        check(got.shape == want.shape, f"megafil shape {kw}")
        check(bool(torch.isfinite(got).all()), f"finite megafil {kw}")
        check(err < TOL_SMALL, f"small megafil {kw}: {err} >= {TOL_SMALL}")


def search_block(card: str) -> dict:
    """One flagship search block: the megafil kernel against plain (both
    f32) on device noise, then both timed."""
    from dspsr_tpu_torch.io.sources import DummySource, device_noise_bytes
    from dspsr_tpu_torch.models.load_to_fil import FilPipeline
    from dspsr_tpu_torch.ops.megakernel import megafil_plain

    pipe = FilPipeline(DummySource(flagship_obs()), search_cfg(),
                       device="cuda")
    plan = pipe.megafil_plan
    raw = device_noise_bytes(0, pipe.block_in_samples * 2, "cuda")
    got = pipe._megafil(raw)
    want = megafil_plain(plan, pipe.constants, raw, pipe.npart)
    torch.cuda.synchronize()
    err = rel_err(got, want)
    abs_err = float((got - want).abs().max())
    print(f"flagship search block: plan nsub {plan.nsub} freq_res "
          f"{plan.freq_res} R1 {plan.R1} R2 {plan.R2} nkeep {plan.nkeep}, "
          f"npart {pipe.npart}; output {tuple(got.shape)}; rel err "
          f"{err:.3e} (abs {abs_err:.3e})", flush=True)
    check(tuple(got.shape) == (64, 1, pipe.npart * plan.nkeep),
          f"search block shape {tuple(got.shape)}")
    check(bool(torch.isfinite(got).all()), "finite search block")
    check(err < TOL_FLAGSHIP, f"search block rel err {err} >= "
          f"{TOL_FLAGSHIP}")
    kernel_ms = cuda_ms(lambda: pipe._megafil(raw), 10)
    plain_ms = cuda_ms(
        lambda: megafil_plain(plan, pipe.constants, raw, pipe.npart), 3)
    sky_ms = pipe.stride_in_samples / pipe.obs_in.rate * 1e3
    print(f"megafil kernel per flagship search block: {kernel_ms:.3f} ms; "
          f"plain: {plain_ms:.3f} ms; block = {sky_ms:.2f} ms of sky "
          f"[{card}]", flush=True)
    kernel_breakdown(lambda: pipe._megafil(raw), card)
    from dspsr_tpu_torch.ops.megakernel import fold_pols

    nf = len(fold_pols(plan))
    nbytes = raw.numel() + 8 * pipe.constants.gr.numel() + 4 * got.numel()
    return dict(max_abs_err=abs_err, ms=kernel_ms, plain_ms=plain_ms,
                **bound_of(nbytes, front_ops(plan, pipe.npart, nf, nf)),
                library_ms=None)


def search_path(card: str) -> int:
    """The port's search main path at the megafil_search width, through
    ``FilPipeline.run`` to a SIGPROC file; returns the megafil launches."""
    from dspsr_tpu_torch import launch_counts, reset_launch_counts
    from dspsr_tpu_torch.io.sources import DummySource
    from dspsr_tpu_torch.io.sigproc import read_sigproc_header
    from dspsr_tpu_torch.models.load_to_fil import FilPipeline

    nblocks = 3
    block_bytes = 16_896_000  # 64 chans x 264,000 samples x 8 bits
    with tempfile.TemporaryDirectory() as tmp:
        out = os.path.join(tmp, "search.fil")
        reset_launch_counts()
        pipe = FilPipeline(DummySource(flagship_obs()), search_cfg(),
                           device="cuda")

        def forbidden(*args, **kwargs):
            raise RuntimeError("torch.fft/torch.matmul called on the main "
                               "path")

        saved = (torch.fft.rfft, torch.fft.ifft, torch.matmul)
        torch.fft.rfft = torch.fft.ifft = torch.matmul = forbidden
        try:
            t0 = time.perf_counter()
            pipe.run(out, max_blocks=nblocks)
            wall = time.perf_counter() - t0
        finally:
            torch.fft.rfft, torch.fft.ifft, torch.matmul = saved
        counts = launch_counts()
        items, hdr = read_sigproc_header(out)
        size = os.path.getsize(out)
        data = np.fromfile(out, np.uint8, offset=hdr)
    check(counts["megafil"] == nblocks,
          f"megafil launched {counts['megafil']} times")
    check(counts["megastep"] == 0,
          f"megastep launched {counts['megastep']} times")
    check(size == hdr + nblocks * block_bytes,
          f"file size {size} != {hdr} + {nblocks} x {block_bytes}")
    check(int(items["nchans"]) == 64 and int(items["nbits"]) == 8,
          f"header nchans {items['nchans']} nbits {items['nbits']}")
    check(abs(items["tsamp"] * 6.25e6 - 1.0) < 1e-12,
          f"header tsamp {items['tsamp']} != 1/6.25 MHz")
    # detected noise levelled to mean 0, sigma 1 and digitized at 127.5 +
    # 32 z: a Gamma(2) intensity, clipped at 255 (0.4%), gives mean 127.39
    # and standard deviation 31.49 counts
    mean, std = float(data.mean()), float(data.std())
    clipped = float((data == 255).mean())
    print(f"search path: {nblocks} blocks, {counts['megafil']} megafil and "
          f"{counts['megastep']} megastep launches; file {size} B (header "
          f"{hdr}); nchans {items['nchans']} nbits {items['nbits']} tsamp "
          f"{items['tsamp']}; bytes mean {mean:.4f} std {std:.4f} at 255 "
          f"{clipped:.5f}; host-fed incl. first-block warm-up "
          f"{nblocks * pipe.stride_in_samples / wall / 1e6:.1f} Msamp/s "
          f"[{card}]", flush=True)
    check(126.5 < mean < 128.5, f"byte mean {mean} outside (126.5, 128.5)")
    check(30.0 < std < 33.0, f"byte std {std} outside (30, 33)")
    check(clipped < 0.01, f"{clipped} of the bytes clipped at 255")
    return counts["megafil"]


def search_rates(card: str) -> None:
    """Host-fed and device-fed rates of the search pipeline (warm)."""
    from dspsr_tpu_torch.io.sources import DummySource, device_noise_bytes
    from dspsr_tpu_torch.io.sigproc import SigProcWriter
    from dspsr_tpu_torch.models.load_to_fil import FilPipeline

    nblocks = 3
    pipe = FilPipeline(DummySource(flagship_obs()), search_cfg(),
                       device="cuda")
    with tempfile.TemporaryDirectory() as tmp:
        with SigProcWriter(os.path.join(tmp, "r.fil"), pipe.obs_out,
                           8) as out:
            pipe.run_writer(out, max_blocks=1)  # warm-up
            t0 = time.perf_counter()
            pipe.run_writer(out, max_blocks=nblocks)
            wall = time.perf_counter() - t0
    host_msps = nblocks * pipe.stride_in_samples / wall / 1e6

    nbytes = pipe.block_in_samples * 2
    state = (pipe._rescale_state, pipe._mean, pipe._inv)

    def block(b):
        raw = device_noise_bytes(b * nbytes, nbytes, "cuda")
        *_, packed = pipe._step(*state, raw, "cumulative")
        return packed.cpu()

    block(0)
    nb = 6
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for b in range(1, nb + 1):
        block(b)
    wall = time.perf_counter() - t0
    dev_msps = nb * pipe.stride_in_samples / wall / 1e6
    print(f"search pipeline host-fed (DummySource bytes, pinned copy, "
          f"SIGPROC write): {host_msps:.1f} Msamp/s; device-fed "
          f"(device_noise_bytes, step, rescale, digitize, bytes to host): "
          f"{dev_msps:.1f} Msamp/s; real time is 800 Msamp/s [{card}]",
          flush=True)


def front_ops(plan, npart: int, nfwd: int, nstore: int) -> float:
    """float32 operations of the fused front end over one block: per window
    and input channel the packed forward FFT of 2N points (5 L log2 L for
    L = 2N), the pol separation, passband and chirp (16 a bin for each pol
    kept), each kept pol's nsub inverse FFTs of freq_res points, and the
    detection (4 a kept sample and plane).  ``nfwd`` pols are transformed,
    ``nstore`` of them inverted."""
    L, M = 2 * plan.n_fft, plan.freq_res
    per = (5 * L * math.log2(L) + 16 * plan.n_fft * max(nfwd, nstore)
           + nstore * plan.nsub * 5 * M * math.log2(M)
           + 4 * plan.nsub * plan.nkeep * plan.nplane)
    return plan.nchan_in * npart * per


def bound_of(nbytes: float, ops: float) -> dict:
    """The least time the card could take (ms): the larger of the bytes at
    the device-memory rate and the operations at the float32 rate."""
    tb, to = nbytes / HBM_BYTES_S * 1e3, ops / F32_OPS_S * 1e3
    return dict(bound_ms=max(tb, to),
                bound_by="bytes" if tb >= to else "operations")


def masked_chirp(cst, rng) -> tuple:
    """The constants' chirp times a random 0/1 mask (10% zapped)."""
    m = torch.from_numpy(
        (rng.uniform(size=tuple(cst.gr.shape)) > 0.1).astype(np.float32))
    m = m.to(cst.gr.device)
    return cst.gr * m, cst.gi * m


def small_checks_hybrid() -> None:
    """The hybrid front end's kernel variants (passband tap, chirp handed
    in: chirp times a random mask) against the plain version (f64) at the
    test geometry: data and passband within TOL_SMALL.  PP and QQ transform
    both pols for the tap and keep one."""
    from dspsr_tpu_torch.ops.filterbank import FilterbankPlan
    from dspsr_tpu_torch.ops.megakernel import (
        MegaConstants, MegaPlan, build_megafil, megafil_plain, unpack_affine)

    nsub, freq_res, npart = 4, 64, 3
    fb = FilterbankPlan(real_input=True, nchan_subband=nsub,
                        freq_res=freq_res, nfilt_pos=5, nfilt_neg=6)
    cases = [
        dict(npol=2), dict(npol=2, detection="pp"),
        dict(npol=2, detection="qq"), dict(npol=2, npol_out=2),
        dict(npol=2, npol_out=4, detection="coherence"), dict(npol=1),
        dict(npol=2, nchan_in=2), dict(npol=2, twos_complement=True),
    ]
    rng = np.random.default_rng(4)
    for kw in cases:
        plan = MegaPlan.from_filterbank(fb, nbin=2, **kw)
        nci, npol = plan.nchan_in, plan.npol
        raw = torch.from_numpy(rng.integers(
            0, 256, plan.block_ndat(npart) * nci * npol,
            dtype=np.uint8)).cuda()
        resp = np.exp(1j * rng.uniform(-3, 3, (nci * nsub, freq_res)))
        scale, offset = unpack_affine(8, plan.twos_complement)
        cst = MegaConstants.build(plan, resp, scale, offset).to("cuda")
        gr, gi = masked_chirp(cst, rng)
        data, w, pb = build_megafil(plan, cst, npart, passband=True,
                                    return_weights=True,
                                    response_as_args=True)(raw, gr, gi)
        want, wpb = megafil_plain(plan, cst, raw, npart, torch.float64,
                                  passband=True, gr=gr.double(),
                                  gi=gi.double())
        torch.cuda.synchronize()
        err, perr = rel_err(data, want), rel_err(pb, wpb)
        print(f"small hybrid megafil {kw}: rel err data {err:.3e}, "
              f"passband {perr:.3e}", flush=True)
        check(data.shape == want.shape and pb.shape == wpb.shape,
              f"hybrid megafil shapes {kw}")
        check(pb.shape == (nci * nsub, npol, freq_res), f"passband {kw}")
        check(bool(torch.isfinite(data).all() and torch.isfinite(pb).all()),
              f"finite hybrid megafil {kw}")
        check(max(err, perr) < TOL_SMALL,
              f"small hybrid megafil {kw}: {err}, {perr} >= {TOL_SMALL}")
        check(bool((w == 1).all()) and w.shape == (nci, npart),
              f"weights {kw}")


def hybrid_pipe(**kw):
    from dspsr_tpu_torch.io.sources import DummySource
    from dspsr_tpu_torch.models.load_to_fold import FoldPipeline

    pipe = FoldPipeline(DummySource(flagship_obs()), flagship_cfg(**kw),
                        device="cuda")
    check(pipe.mega_mode == "hybrid", f"mega_mode {pipe.mega_mode} for {kw}")
    return pipe


HYBRID_SK = dict(sk_enable=True, sk_m=1024)  # bench.py:464-467
HYBRID_RFI = dict(rfi_filter=True)  # bench.py:472-474


def hybrid_block(card: str) -> dict:
    """One flagship block of the hybrid RFI front end (passband tap, the
    chirp times a random mask handed in) against the plain version (both
    f32) on device noise, both timed; then what the tap costs: megafil with
    and without it."""
    from dspsr_tpu_torch.io.sources import device_noise_bytes
    from dspsr_tpu_torch.ops.megakernel import build_megafil, megafil_plain

    pipe = hybrid_pipe(**HYBRID_RFI)
    plan, cst = pipe.front_plan, pipe.constants
    raw = device_noise_bytes(0, pipe.block_in_samples * 2, "cuda")
    gr, gi = masked_chirp(cst, np.random.default_rng(6))
    data, _, pb = pipe._front(raw, gr, gi)
    want, wpb = megafil_plain(plan, cst, raw, pipe.npart, passband=True,
                              gr=gr, gi=gi)
    torch.cuda.synchronize()
    err, perr = rel_err(data, want), rel_err(pb, wpb)
    abs_err = float((data - want).abs().max())
    print(f"flagship hybrid block (passband, masked chirp): output "
          f"{tuple(data.shape)}, passband {tuple(pb.shape)}; rel err data "
          f"{err:.3e} (abs {abs_err:.3e}), passband {perr:.3e} (abs "
          f"{float((pb - wpb).abs().max()):.3e})", flush=True)
    check(bool(torch.isfinite(data).all() and torch.isfinite(pb).all()),
          "finite flagship hybrid block")
    check(max(err, perr) < TOL_FLAGSHIP,
          f"flagship hybrid rel err {err}, {perr} >= {TOL_FLAGSHIP}")

    plain = build_megafil(plan, cst, pipe.npart)
    tap_ms = cuda_ms(lambda: pipe._front(raw, gr, gi), 10)
    bare_ms = cuda_ms(lambda: plain(raw), 10)
    print(f"megafil per flagship block (Intensity): with the passband tap "
          f"and the chirp handed in {tap_ms:.3f} ms, without "
          f"{bare_ms:.3f} ms [{card}]", flush=True)
    with_tap = kernel_breakdown(lambda: pipe._front(raw, gr, gi), card,
                                label=" (megafil, passband tap)")
    without = kernel_breakdown(lambda: plain(raw), card,
                               label=" (megafil, no tap)")
    f2 = [k for k in with_tap if k.startswith("mega_fwd2")]
    for k in f2:
        if k in without:
            print(f"tap cost in {k}: {with_tap[k] - without[k]:.3f} ms a "
                  f"flagship block ({without[k]:.3f} -> {with_tap[k]:.3f}) "
                  f"[{card}]", flush=True)
    return dict(err=abs_err)


def hybrid_path(card: str) -> int:
    """``hybrid_sk`` and ``hybrid_rfi`` at the flagship width, 3 blocks
    each through ``FoldPipeline.run`` with torch.fft and torch.matmul
    disabled; returns the megafil launches of both runs."""
    from dspsr_tpu_torch import launch_counts, reset_launch_counts

    nblocks = 3
    total = 0
    for name, kw, want in (("hybrid_sk", HYBRID_SK, nblocks),
                           ("hybrid_rfi", HYBRID_RFI, nblocks + 1)):
        pipe = hybrid_pipe(**kw)

        def forbidden(*args, **kwargs):
            raise RuntimeError("torch.fft/torch.matmul called on the main "
                               "path")

        saved = (torch.fft.rfft, torch.fft.ifft, torch.matmul)
        reset_launch_counts()
        torch.fft.rfft = torch.fft.ifft = torch.matmul = forbidden
        try:
            t0 = time.perf_counter()
            res = pipe.run(max_blocks=nblocks)
            wall = time.perf_counter() - t0
        finally:
            torch.fft.rfft, torch.fft.ifft, torch.matmul = saved
        counts = launch_counts()
        total += counts["megafil"]
        check(counts["megafil"] == want,
              f"{name}: megafil launched {counts['megafil']} times, not "
              f"{want}")
        check(counts["megastep"] == 0, f"{name}: megastep launched")
        check(res.profiles.shape == (1, 64, 1, 1024),
              f"{name} profiles shape {res.profiles.shape}")
        check(bool(np.isfinite(res.profiles).all()), f"{name} non-finite")
        per_chan = res.hits.sum(axis=(0, 2))
        check(bool((per_chan > 0).all()
                   and (per_chan <= nblocks * pipe.out_per_block).all()),
              f"{name} hits per channel {per_chan[:4]}")
        prof = res.normalized()[0, :, 0, :]
        check(bool((prof.std(axis=1) > 0).all()), f"{name} flat profiles")
        share = pipe.zapped_share()
        print(f"{name}: {nblocks} blocks, {counts['megafil']} megafil "
              f"launches; hits/chan min {int(per_chan.min())} max "
              f"{int(per_chan.max())} of {nblocks * pipe.out_per_block}; "
              f"zapped: SK cells {share['sk']}, RFI bins {share['rfi']}; "
              f"host-fed incl. first-block warm-up "
              f"{nblocks * pipe.stride_in_samples / wall / 1e6:.1f} Msamp/s "
              f"[{card}]", flush=True)
    return total


def hybrid_rates(card: str) -> None:
    """Device-fed rate of ``hybrid_sk`` and ``hybrid_rfi`` (device noise
    bytes through the front end and the tail, warm) with a breakdown of the
    kernels' time per block."""
    from dspsr_tpu_torch.io.sources import device_noise_bytes
    from dspsr_tpu_torch.ops.fold import compute_anchors

    for name, kw in (("hybrid_sk", HYBRID_SK), ("hybrid_rfi", HYBRID_RFI)):
        pipe = hybrid_pipe(**kw)
        nbytes = pipe.block_in_samples * 2
        phi0, dphi = (torch.from_numpy(a).cuda() for a in compute_anchors(
            pipe.predictor, pipe.output_start_time(0),
            1.0 / pipe.obs_out.rate, pipe.out_per_block, pipe.mega_plan.nkeep))
        if pipe._rfi_resp is not None:
            pipe._rfi_primed = True

        def step(raw):
            d, w, wp, _ = pipe._hybrid_block(raw)
            pipe._profiles, pipe._hits = pipe._fold_tail_d(
                pipe._profiles, pipe._hits, d, w, wp, phi0, dphi)

        def block(b):
            step(device_noise_bytes(b * nbytes, nbytes, "cuda"))

        block(0)
        nb = 6
        it = iter(range(1, nb + 1))
        ms = cuda_ms(lambda: block(next(it)), nb)
        msps = pipe.stride_in_samples / (ms * 1e-3) / 1e6
        raw0 = device_noise_bytes(0, nbytes, "cuda")
        step_ms = cuda_ms(lambda: step(raw0), nb)
        print(f"{name} device-fed (device_noise_bytes, front end + tail): "
              f"{ms:.3f} ms a block, {msps:.1f} Msamp/s; front end + tail "
              f"alone {step_ms:.3f} ms; real time is 800 Msamp/s [{card}]",
              flush=True)
        kernel_breakdown(lambda: step(raw0), card,
                         label=f" ({name}, front end + tail)", others=True)


def build_all() -> None:
    """Build both kernels at once (one nvcc each) and print ptxas lines."""
    from dspsr_tpu_torch.kernels.build import build

    with ThreadPoolExecutor(2) as pool:
        futs = {n: pool.submit(build, n, True)
                for n in ("megastep", "megafil")}
        results = {n: f.result() for n, f in futs.items()}
    for name, (path, log, secs) in results.items():
        print(f"built {path.name} in {secs:.1f} s", flush=True)
        kernel = "?"
        for line in log.splitlines():
            m = re.search(r"entry function '.*?(mega\w+?)"
                          r"(?:I((?:Li\d+E)+)EEv|E)", line)
            if m:
                args = re.findall(r"Li(\d+)E", m.group(2) or "")
                kernel = m.group(1) + (f"<{', '.join(args)}>" if args else "")
            elif "registers" in line or "spill" in line or "error" in line:
                print(f"  ptxas {kernel}: {line.strip()}", flush=True)


def main() -> None:
    card = card_facts()
    build_all()
    small_checks()
    small_checks_megafil()
    small_checks_hybrid()
    small_unequal()
    flag = flagship_block(card)
    launches = main_path(card)
    pipeline_rates(card)
    search = search_block(card)
    search_launches = search_path(card)
    search_rates(card)
    hybrid = hybrid_block(card)
    search["max_abs_err"] = max(search["max_abs_err"], hybrid["err"])
    hybrid_launches = hybrid_path(card)
    hybrid_rates(card)
    print(json.dumps({"kernels": [
        {"name": "megastep", "route": "cuda",
         "source": "dspsr_tpu_torch/csrc/megastep.cu",
         "replaces": REPLACES["megastep"], "launches": launches, **flag},
        {"name": "megafil", "route": "cuda",
         "source": "dspsr_tpu_torch/csrc/megafil.cu",
         "replaces": REPLACES["megafil"],
         "launches": search_launches + hybrid_launches, **search}]}),
          flush=True)
    print(card, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
