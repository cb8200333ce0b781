"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

Builds the hand-written kernels from the sources in this checkout, holds
each against its plain PyTorch version on the card, drives the port's fold
main path (the flagship ``mega_real_8bit`` configuration: DUMMY 8-bit
dual-pol real input at 800 Msamp/s, DM 2.64, 64 channels, 1024 bins) for a
few blocks, checks the result, and prints timings.  Exits non-zero on any
failure, or when no CUDA device is present.  The last line of standard
output is ``{"ok": true, "device": {...}}``.
"""

from __future__ import annotations

import json
import subprocess
import sys
import time

import numpy as np
import torch

TOL_SMALL = 2e-5  # relative, kernel (f32) against plain (f64), test geometry
TOL_FLAGSHIP = 1e-4  # relative, kernel against plain, both f32, 2^19 windows
REPLACES = "dspsr_tpu/ops/megakernel.py:1054"  # build_megastep's pallas_call


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
    return dict(max_abs_err=abs_err, ms=kernel_ms, plain_ms=plain_ms)


def kernel_breakdown(fn, card: str, reps: int = 3) -> None:
    """Device time of each of the step's kernels (torch.profiler), and the
    step's peak device memory."""
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    peak_mb = (torch.cuda.max_memory_allocated() - base) / 2**20
    parts = []
    for ev in prof.key_averages():
        us = getattr(ev, "device_time_total", None)
        if us is None:
            us = getattr(ev, "cuda_time_total", 0)
        if "mega_" in ev.key and us > 0:
            name = ev.key[ev.key.index("mega_"):].split("(")[0]
            parts.append(f"{name} {us / reps / 1e3:.3f} ms")
    print(f"kernel breakdown per block: {'; '.join(parts) or 'no device time'}"
          f"; step scratch + outputs {peak_mb:.0f} MiB [{card}]", flush=True)


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


def main() -> None:
    card = card_facts()
    from dspsr_tpu_torch.kernels.build import build

    path, log, secs = build("megastep", verbose=True)
    print(f"built {path.name} in {secs:.1f} s", flush=True)
    for line in log.splitlines():
        if "registers" in line or "spill" in line or "error" in line:
            print(f"  ptxas: {line.strip()}", flush=True)
    small_checks()
    flag = flagship_block(card)
    launches = main_path(card)
    pipeline_rates(card)
    print(json.dumps({"kernels": [{
        "name": "megastep", "route": "cuda",
        "source": "dspsr_tpu_torch/csrc/megastep.cu",
        "replaces": REPLACES, "launches": launches, **flag}]}), flush=True)
    print(card, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
