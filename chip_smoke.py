"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

Builds the hand-written kernels from the sources in this checkout (one
nvcc per source, all at once), holds each against its plain PyTorch version
on the card (real, complex and CASPSR variants), drives the port's main
paths on the flagship input (DUMMY 8-bit dual-pol real input at 800
Msamp/s, DM 2.64, 64 channels) for a few blocks each, checks the results,
and prints timings:

- the fold path (``mega_real_8bit``: 1024 bins, kernel ``megastep``);
- the same fold on complex (analytic) input at 400 Msamp/s
  (``mega_analytic_8bit``) and on CASPSR-layout bytes (INSTRUMENT=CASPSR);
- the search path (``megafil_search``: the digifil workflow to an 8-bit
  SIGPROC file, kernel ``megafil``), on real and on complex input;
- the hybrid fold engine (``hybrid_sk``: in-stream spectral kurtosis with
  1024-sample cells; ``hybrid_rfi``: the spectral RFI filter): kernel
  ``megafil`` with the passband tap and the chirp handed in per block, then
  the fold tail in plain PyTorch;
- cyclic spectroscopy (``hybrid_cyclic``: 64 cyclic channels, 33 lags, 132
  fold planes a channel, half-size blocks of 38 windows): kernel ``megafil``
  with its voltage output, then the lag-product fold in plain PyTorch;
- the nsub == 1 convolution (``hybrid_conv32``: 32 complex 8-bit channels
  at 12.5 Msamp/s, DM 71, freq_res 2^19, dspsr without ``-F``): kernel
  ``megafil`` with its multi-pass inverse, then the fold tail; and the same
  cell with polarization calibration (a Jones response, Stokes);
- JA98 2-bit input (``mega_guppi_2bit``: 32 complex 2-bit channels at 12.5
  Msamp/s, DM 71, 2048 channels, 256-sample excision blocks): kernel
  ``megastep`` after its JA98 pre-pass, on bytes made on the card whose
  clean blocks JA98 keeps, with saturated stretches that it excises.

- the flagship band at the DMs of J1713+0747 (15.99: ``mega_j1713``,
  ``search_j1713``) and J0613-0200 (38.78: ``mega_j0613``,
  ``search_j0613``, and ``mega_analytic_j0613`` on complex input), where
  freq_res (32768, 131072) is past one CTA's inverse: both kernels with
  the multi-pass inverse at nsub 64 (the fold in its second pass), and at
  J0613-0200 for real input the long row pass.

Every unpack variant of both kernels (JA98, fixed-level 1/2/4-bit, float32,
apodization windows) is held against plain at the test geometry first, and
so are the multi-pass inverse at nsub > 1 (forced, with the fold in its
pass B), the long row pass (forced) and the fold's external window
weights.

Then the general chain, which runs where neither fused kernel can and
launches neither: the flagship fold with ``use_megakernel=False``
(``xla_general``) and with in-stream SK (``xla_sk_weights``), each one block
against the same chain on the CPU from the same bytes, 3 blocks through
``FoldPipeline.run`` and the rates; and digifil on the flagship input with
no DM (``freq_res == 1``, 3 blocks to a SIGPROC file) and with Coherence
output at DM 2.64, bytes against the CPU.  Every fused phase runs with
``torch.fft`` and ``torch.matmul`` disabled, which also catches a fused
configuration that takes the general chain by mistake.

Then the port's command-line tools as a user runs them (``cli_phase``): a
DADA file of 3 flagship blocks through ``dspsr`` (``apps/dspsr_app.py``:
the flagship fold on ``megastep``, ``--skz`` on ``megafil``, and
``--fft-bench``, each against ``FoldPipeline`` on the same file and config
with its launches), ``dspsr -G`` (the phase-locked filterbank) and the
``digistat`` and ``passband`` tools on the card against the CPU.

Then the live rings (``live_phase``, ``io/hostio.py``): the same file pushed
by a separate writer process into a psrdada-style SysV hdu and folded live
(``megastep``, with and without the host's byte counts), searched live from
a POSIX ring sized to ``/dev/shm`` (``megafil``), decimated live
(``apps/decimator_app.py``, the general chain), folded through
``PrefetchSource``, each against the same bytes read from the file, and the
live fold's archive read back through ``libcfitsio`` where it is present.

Imports nothing of JAX or of the JAX package (an import hook refuses both).
Exits non-zero on any failure, or when no CUDA device is present.  The last
line of standard output is ``{"ok": true, "device": {...}}``.
"""

from __future__ import annotations

import contextlib
import dataclasses
import io
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


#: the input variants: real-sampled TFP (the flagship), complex (analytic)
#: TFP, real-sampled in the CASPSR byte layout
KINDS = ("real", "complex", "caspsr")


def flagship_obs(kind: str = "real"):
    """The flagship input (``bench.py:373-385``); ``complex`` is
    ``mega_analytic_8bit``'s (``bench.py:420``: the same band, complex at
    400 Msamp/s), ``caspsr`` the flagship with INSTRUMENT=CASPSR (8-bit two's
    complement in the CASPSR byte layout)."""
    from dspsr_tpu_torch.models.load_to_fold import MJD, Observation, Signal

    cplx = kind == "complex"
    return Observation(
        nchan=1, npol=2, ndim=2 if cplx else 1, nbit=8,
        centre_frequency=1382.0, bandwidth=-400.0,
        rate=400e6 if cplx else 800e6,
        start_time=MJD.from_utc("2010-04-13-02:05:45"),
        state=Signal.ANALYTIC if cplx else Signal.NYQUIST,
        source="J0437-4715", telescope="PKS",
        instrument="CASPSR" if kind == "caspsr" else "DUMMY").replace(
            ndat=1 << 40)


def block_samples(kind: str) -> int:
    """``min_block_samples`` of the flagship cells: 2^25, halved for
    complex input (``bench.py:475-479``), which gives the same 75 windows
    and 42.24 ms of sky a block."""
    return 1 << (24 if kind == "complex" else 25)


#: the flagship's DM (J0437-4715)
FLAGSHIP_DM = 2.64


def flagship_cfg(kind: str = "real", dm: float = FLAGSHIP_DM, **kw):
    from dspsr_tpu_torch.models.load_to_fold import FoldConfig

    # mega_real_8bit, with J0437-4715's period in place of its polyco (at
    # every DM: the phase model only places the samples)
    kw = dict(dict(min_block_samples=block_samples(kind)), **kw)
    return FoldConfig(folding_period=0.00575745, dispersion_measure=dm,
                      nchan=64, nbin=1024, block_parts=8, npol_out=1, **kw)


def search_cfg(kind: str = "real", dm: float = FLAGSHIP_DM):
    from dspsr_tpu_torch.models.load_to_fil import FilConfig

    # megafil_search (bench.py:445-446)
    return FilConfig(nchan=64, dispersion_measure=dm, nbits=8,
                     min_block_samples=block_samples(kind), block_parts=8)


#: the flagship band (and its complex form) at the DMs of two millisecond
#: pulsars that timing arrays time there, past one CTA's inverse: name ->
#: (input kind, DM).  J1713+0747 (DM 15.99): freq_res 32768, R1 1024, R2
#: 2048, q 32; J0613-0200 (DM 38.78): freq_res 131072, R2 8192, q 128,
#: where real input takes the long row pass.
DM_FOLD = {"mega_j1713": ("real", 15.99), "mega_j0613": ("real", 38.78),
           "mega_analytic_j0613": ("complex", 38.78)}
DM_SEARCH = {"search_j1713": ("real", 15.99), "search_j0613": ("real", 38.78)}


def rel_err(a: torch.Tensor, b: torch.Tensor) -> float:
    """Largest difference over the largest magnitude of ``b`` (complex
    tensors as their (re, im) pairs)."""
    a, b = (torch.view_as_real(x) if x.is_complex() else x for x in (a, b))
    a, b = a.double(), b.double()
    return float((a - b).abs().max() / b.abs().max())


class NoLibraryFFT:
    """Within the block, ``torch.fft`` (rfft, fft, ifft, fftshift) and
    ``torch.matmul`` raise: the main path must run the kernels, never the
    plain step's library calls."""

    NAMES = ((torch.fft, "rfft"), (torch.fft, "fft"), (torch.fft, "ifft"),
             (torch.fft, "fftshift"), (torch, "matmul"))

    def __enter__(self):
        def forbidden(*args, **kwargs):
            raise RuntimeError("torch.fft/torch.matmul called on the main "
                               "path")

        self.saved = [getattr(m, n) for m, n in self.NAMES]
        for m, n in self.NAMES:
            setattr(m, n, forbidden)
        return self

    def __exit__(self, *exc):
        for (m, n), f in zip(self.NAMES, self.saved):
            setattr(m, n, f)
        return False


def small_plan(kind: str, nbin: int, nsub: int = 4, freq_res: int = 64,
               nfilt: tuple = (5, 6), **kw):
    """The test geometry (nsub 4, freq_res 64, nfilt 5/6 before rounding)
    for ``kind``, or None where the variant does not exist (CASPSR is one
    input channel)."""
    from dspsr_tpu_torch.ops.filterbank import FilterbankPlan
    from dspsr_tpu_torch.ops.megakernel import MegaPlan

    if kind == "caspsr":
        if kw.get("nchan_in", 1) > 1:
            return None
        kw["interleave"] = "caspsr"
    fb = FilterbankPlan(real_input=kind != "complex", nchan_subband=nsub,
                        freq_res=freq_res, nfilt_pos=nfilt[0],
                        nfilt_neg=nfilt[1])
    return MegaPlan.from_filterbank(fb, nbin=nbin, **kw)


def small_raw(plan, npart: int, rng) -> torch.Tensor:
    """Random bytes of one block of ``plan`` on the card."""
    n = plan.block_ndat(npart) * plan.nchan_in * plan.npol * plan.ndim
    return torch.from_numpy(rng.integers(0, 256, n, dtype=np.uint8)).cuda()


def small_checks(kind: str = "real") -> None:
    """Kernel (f32) against plain (f64) at the test geometry, every
    detection branch, two input channels, two's complement and bounds, with
    a random-phase chirp (a wrong bin order cannot pass)."""
    from dspsr_tpu_torch.ops.megakernel import (
        MegaConstants, build_megastep, megastep_plain, unpack_affine)

    nsub, freq_res, npol, nbin, npart = 4, 64, 2, 32, 3
    cases = [
        dict(npol_out=1), dict(npol_out=2), dict(npol_out=4),
        dict(npol_out=4, detection="coherence"),
        dict(npol_out=4, fourth_moment=True),
        dict(npol_out=1, detection="pp"), dict(npol_out=1, detection="qq"),
        dict(npol_out=1, twos_complement=True),
        dict(npol_out=4, nchan_in=2),
    ]
    if kind != "real":
        cases.append(dict(npol_out=1, npol=1))
    rng = np.random.default_rng(0)
    for kw in cases:
        kw = dict(dict(npol=npol), **kw)
        plan = small_plan(kind, nbin, **kw)
        if plan is None:
            continue
        nci = plan.nchan_in
        raw = small_raw(plan, npart, rng)
        resp = np.exp(1j * rng.uniform(-3, 3, (nci * nsub, freq_res)))
        phi0 = torch.from_numpy(rng.uniform(0, 1, npart).astype(np.float32))
        dphi = torch.full((npart,), 0.013, dtype=torch.float32)
        scale, offset = unpack_affine(8, plan.twos_complement)
        cst = MegaConstants.build(plan, resp, scale, offset).to("cuda")
        step = build_megastep(plan, cst, npart)
        args = [raw, phi0.cuda(), dphi.cuda()]
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
            print(f"small {kind} {kw} bounds={bounds}: rel err {err:.3e}, "
                  f"hits diff {hdiff}", flush=True)
            check(bool(torch.isfinite(pk).all()), f"finite profiles {kw}")
            check(err < TOL_SMALL, f"small geometry {kind} {kw}: {err} >= "
                  f"{TOL_SMALL}")
            check(hdiff == 0, f"small geometry hits {kind} {kw}")
            check(float(hk.sum()) > 0, f"hits folded {kind} {kw}")


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


def dm_phases(card: str) -> dict:
    """The flagship band at J1713+0747's and J0613-0200's DMs
    (``DM_FOLD``, ``DM_SEARCH``), where the inverse is past one CTA: for
    each, one block against plain with each kernel's time and the passes'
    bounds, 3 blocks through the pipeline (launches counted), and the
    device-fed rate.  Returns the launches and largest errors."""
    out = dict(megastep=0, megafil=0, err_megastep=0.0, err_megafil=0.0)
    for name, (kind, dm) in DM_FOLD.items():
        st = flagship_block(card, kind, dm, name)
        out["megastep"] += main_path(card, kind, dm, name)
        pipeline_rates(card, kind, dm, host=False)
        out["err_megastep"] = max(out["err_megastep"], st["max_abs_err"])
    for name, (kind, dm) in DM_SEARCH.items():
        st = search_block(card, kind, dm, name)
        out["megafil"] += search_path(card, kind, dm, name)
        search_rates(card, kind, dm, host=False)
        out["err_megafil"] = max(out["err_megafil"], st["max_abs_err"])
    return out


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


def block_bytes(pipe) -> int:
    """Raw bytes of one block of ``pipe``."""
    obs = pipe.obs_in
    return (pipe.block_in_samples * obs.nchan * obs.npol * obs.ndim
            * obs.nbit // 8)


def step_against_plain(pipe, raw: torch.Tensor, tag: str,
                       label: str) -> tuple:
    """``pipe``'s fused step (``megastep``; ``mega_mode`` full) on the
    first block's bytes
    ``raw`` against ``megastep_plain`` on the same inputs (both f32):
    profiles within TOL_FLAGSHIP of their largest value, hits exact, every
    kept sample counted; prints ``label`` with the errors.  Returns the
    step's arguments ``(profiles, hits, raw, phi0, dphi)`` and the largest
    absolute error."""
    from dspsr_tpu_torch.ops.fold import compute_anchors
    from dspsr_tpu_torch.ops.megakernel import megastep_plain

    plan = pipe.mega_plan
    phi0, dphi = compute_anchors(pipe.predictor, pipe.output_start_time(0),
                                 1.0 / pipe.obs_out.rate,
                                 pipe.out_per_block, plan.nkeep)
    phi0 = torch.from_numpy(phi0).cuda()
    dphi = torch.from_numpy(dphi).cuda()
    prof0 = torch.zeros(1, plan.nplane, plan.nsub, plan.nbin, device="cuda")
    hits0 = torch.zeros(1, plan.nbin, device="cuda")
    args = (prof0, hits0, raw, phi0, dphi)
    pk, hk = pipe._megastep(*args)
    pp, hp = megastep_plain(plan, pipe.constants, *args)
    torch.cuda.synchronize()
    err = rel_err(pk, pp)
    abs_err = float((pk - pp).abs().max())
    hdiff = float((hk - hp).abs().max())
    print(f"{label}: rel err {err:.3e} (abs {abs_err:.3e}), hits "
          f"diff {hdiff}, hits sum {float(hk.sum())}", flush=True)
    check(bool(torch.isfinite(pk).all()), f"finite {tag} profiles")
    check(err < TOL_FLAGSHIP, f"{tag} rel err {err} >= {TOL_FLAGSHIP}")
    check(hdiff == 0, f"{tag} hits differ")
    check(float(hk.sum()) == plan.nkeep * pipe.npart, f"{tag} hit total")
    return args, abs_err


def flagship_block(card: str, kind: str = "real", dm: float = FLAGSHIP_DM,
                   name: str = "flagship") -> dict:
    """One flagship block of ``kind`` at ``dm``: kernel against plain (both
    f32) on device noise, then both timed, with each kernel's time and, on
    the multi-pass inverse and the long row pass, each pass's bound."""
    from dspsr_tpu_torch.io.sources import DummySource, device_noise_bytes
    from dspsr_tpu_torch.models.load_to_fold import FoldPipeline
    from dspsr_tpu_torch.ops.megakernel import fold_pols, megastep_plain

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    pipe = FoldPipeline(DummySource(flagship_obs(kind)),
                        flagship_cfg(kind, dm), device="cuda")
    plan = pipe.mega_plan
    check(pipe.mega_mode == "full", f"{name}: mega_mode {pipe.mega_mode}")
    check(plan.real_input == (kind != "complex")
          and plan.interleave == ("caspsr" if kind == "caspsr" else "tfp"),
          f"flagship {kind} plan {plan}")
    raw = device_noise_bytes(0, block_bytes(pipe), "cuda")
    args, abs_err = step_against_plain(
        pipe, raw, f"{name} {kind}",
        f"{name} {kind} block (DM {dm}: nsub {plan.nsub} freq_res "
        f"{plan.freq_res} R1 {plan.R1} R2 {plan.R2} q {plan.q}, npart "
        f"{pipe.npart}, raw {raw.numel()} B)")
    prof0, hits0, _, phi0, _ = args

    kernel_ms = cuda_ms(lambda: pipe._megastep(*args), 10)
    plain_ms = cuda_ms(
        lambda: megastep_plain(plan, pipe.constants, *args), 3)
    sky_ms = pipe.stride_in_samples / pipe.obs_in.rate * 1e3
    nf = len(fold_pols(plan))
    nbytes = (raw.numel() + 8 * pipe.constants.gr.numel()
              + 8 * (prof0.numel() + hits0.numel()) + 8 * phi0.numel())
    bound = bound_of(nbytes, front_ops(plan, pipe.npart, nf, nf))
    print(f"kernel per {name} {kind} block: {kernel_ms:.3f} ms; plain: "
          f"{plain_ms:.3f} ms; bound {bound['bound_ms']:.4f} ms "
          f"({bound['bound_by']}); block = {sky_ms:.2f} ms of sky [{card}]",
          flush=True)
    times = kernel_breakdown(lambda: pipe._megastep(*args), card,
                             label=f" ({name} {kind} fold)")
    out_bytes = 8 * (prof0.numel() + hits0.numel())
    pass_bounds(card, name, plan, pipe.npart, nf, out_bytes, times)
    one_cta = name not in DM_FOLD
    print_passes(card, f"{name} {kind}", plan, pipe.npart, nf, raw.numel(),
                 times, "mega_invfold" if one_cta else None, out_bytes)
    if one_cta:
        print_attributes(f"{name} {kind}", plan, nf, fold=True)
    return dict(max_abs_err=abs_err, ms=kernel_ms, plain_ms=plain_ms,
                **bound, library_ms=None)


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
    parts, times, rest, nrest, other = [], {}, 0.0, 0, []
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
            other.append((us / reps / 1e3, ev.count // reps, ev.key[:60]))
    if others:
        top = "; ".join(f"{ms:.3f} ms x{n} {key}"
                        for ms, n, key in sorted(other, reverse=True)[:3])
        parts.append(f"other kernels {rest:.3f} ms ({nrest // reps} a call; "
                     f"largest: {top})")
    print(f"kernel breakdown per block{label}: "
          f"{'; '.join(parts) or 'no device time'}; step scratch + outputs "
          f"{peak_mb:.0f} MiB [{card}]", flush=True)
    return times


def main_path(card: str, kind: str = "real", dm: float = FLAGSHIP_DM,
              name: str = "main path") -> int:
    """The port's fold main path at the flagship size on ``kind`` input at
    ``dm``; returns the megastep launches of the first (unsplit) run.  For
    the flagship's real input it then checks sub-integrations whose
    boundaries fall mid-block."""
    from dspsr_tpu_torch import launch_counts, reset_launch_counts
    from dspsr_tpu_torch.io.sources import DummySource
    from dspsr_tpu_torch.models.load_to_fold import FoldPipeline

    nblocks = 3
    pipe = FoldPipeline(DummySource(flagship_obs(kind)),
                        flagship_cfg(kind, dm), device="cuda")
    reset_launch_counts()
    with NoLibraryFFT():
        t0 = time.perf_counter()
        res = pipe.run(max_blocks=nblocks)
        wall = time.perf_counter() - t0
    launches = launch_counts()["megastep"]
    check(pipe.mega_mode == "full", f"{kind}: mega_mode is not full")
    check(launches == nblocks, f"{kind}: megastep launched {launches} times")
    check(res.profiles.shape == (1, 64, 1, 1024),
          f"{kind}: profiles shape {res.profiles.shape}")
    check(bool(np.isfinite(res.profiles).all()), f"{kind}: non-finite")
    per_chan = res.hits.sum(axis=(0, 2))
    check(bool((per_chan == nblocks * pipe.out_per_block).all()),
          f"{kind}: hits per channel {per_chan[:4]} != {nblocks} x "
          f"{pipe.out_per_block}")
    prof = res.normalized()[0, :, 0, :]
    check(bool((prof.std(axis=1) > 0).all()), f"{kind}: flat profiles")
    msps = nblocks * pipe.stride_in_samples / wall / 1e6
    print(f"{name} ({kind}, {pipe.mega_plan.interleave}, DM {dm}, "
          f"{pipe.obs_in.rate / 1e6:.0f} Msamp/s): {nblocks} blocks, "
          f"{launches} megastep launches, hits/chan {int(per_chan[0])}; "
          f"host-fed incl. first-block warm-up {msps:.1f} Msamp/s, "
          f"{msps / (pipe.obs_in.rate / 1e6):.4f} x real time [{card}]",
          flush=True)
    if kind != "real" or dm != FLAGSHIP_DM:
        return launches

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


def pipeline_rates(card: str, kind: str = "real", dm: float = FLAGSHIP_DM,
                   host: bool = True) -> None:
    """Host-fed (unless not ``host``) and device-fed rates of the flagship
    fold pipeline at ``dm`` (warm), in Msamp/s and as a real-time factor
    (seconds of sky per second)."""
    from dspsr_tpu_torch.io.sources import DummySource, device_noise_bytes
    from dspsr_tpu_torch.models.load_to_fold import FoldPipeline
    from dspsr_tpu_torch.ops.fold import compute_anchors

    nblocks = 3
    pipe = FoldPipeline(DummySource(flagship_obs(kind)),
                        flagship_cfg(kind, dm), device="cuda")
    host_msps = 0.0
    if host:
        t0 = time.perf_counter()
        pipe.run(max_blocks=nblocks)
        wall = time.perf_counter() - t0
        host_msps = nblocks * pipe.stride_in_samples / wall / 1e6

    plan = pipe.mega_plan
    nbytes = block_bytes(pipe)
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
    rt = pipe.obs_in.rate / 1e6  # the recording rate, Msamp/s
    host_text = (f"host-fed (DummySource bytes, pinned copy): "
                 f"{host_msps:.1f} Msamp/s ({host_msps / rt:.4f} x real "
                 f"time); " if host else "")
    print(f"pipeline ({kind}, DM {dm}) {host_text}"
          f"device-fed (device_noise_bytes): {ms:.3f} ms a block, "
          f"{dev_msps:.1f} Msamp/s ({dev_msps / rt:.3f} x real time); real "
          f"time is {rt:.0f} Msamp/s [{card}]", flush=True)


def small_checks_megafil(kind: str = "real") -> None:
    """Search front-end kernel (f32) against plain (f64) at the test
    geometry: two input pols (DET_SUM), one (DET_ONE), PP/QQ, PPQQ, Stokes,
    two's complement and two input channels."""
    from dspsr_tpu_torch.ops.megakernel import (
        MegaConstants, build_megafil, megafil_plain, unpack_affine)

    nsub, freq_res, npart = 4, 64, 3
    cases = [
        dict(npol=2), dict(npol=1), dict(npol=2, detection="pp"),
        dict(npol=2, detection="qq"), dict(npol=2, npol_out=2),
        dict(npol=2, npol_out=4), dict(npol=2, twos_complement=True),
        dict(npol=2, nchan_in=2), dict(npol=1, nchan_in=2),
    ]
    if kind != "real":
        cases.append(dict(npol=2, npol_out=4, detection="coherence"))
    rng = np.random.default_rng(1)
    for kw in cases:
        plan = small_plan(kind, 2, **kw)
        if plan is None:
            continue
        nci = plan.nchan_in
        raw = small_raw(plan, npart, rng)
        resp = np.exp(1j * rng.uniform(-3, 3, (nci * nsub, freq_res)))
        scale, offset = unpack_affine(8, plan.twos_complement)
        cst = MegaConstants.build(plan, resp, scale, offset).to("cuda")
        got = build_megafil(plan, cst, npart)(raw)
        want = megafil_plain(plan, cst, raw, npart, dtype=torch.float64)
        torch.cuda.synchronize()
        err = rel_err(got, want)
        print(f"small megafil {kind} {kw}: rel err {err:.3e}", flush=True)
        check(got.shape == want.shape, f"megafil shape {kind} {kw}")
        check(bool(torch.isfinite(got).all()), f"finite megafil {kind} {kw}")
        check(err < TOL_SMALL, f"small megafil {kind} {kw}: {err} >= "
              f"{TOL_SMALL}")
    small_checks_voltage(kind)


def small_checks_voltage(kind: str = "real") -> None:
    """The voltage output (``megafil_invvolt``) against the plain version
    (f64) at the test geometry: two pols, one, two input channels, two's
    complement; bare, with the passband tap, and with a masked chirp handed
    in (with the tap)."""
    from dspsr_tpu_torch.ops.megakernel import (
        MegaConstants, build_megafil, megafil_plain, unpack_affine)

    nsub, freq_res, npart = 4, 64, 3
    cases = [dict(npol=2), dict(npol=1), dict(npol=2, nchan_in=2),
             dict(npol=2, twos_complement=True)]
    rng = np.random.default_rng(8)
    for kw in cases:
        plan = small_plan(kind, 2, **kw)
        if plan is None:
            continue
        nci, npol = plan.nchan_in, plan.npol
        raw = small_raw(plan, npart, rng)
        resp = np.exp(1j * rng.uniform(-3, 3, (nci * nsub, freq_res)))
        scale, offset = unpack_affine(8, plan.twos_complement)
        cst = MegaConstants.build(plan, resp, scale, offset).to("cuda")
        gr, gi = masked_chirp(cst, rng)
        for variant in ("bare", "passband", "masked chirp"):
            tap = variant != "bare"
            args = (gr, gi) if variant == "masked chirp" else ()
            out = build_megafil(plan, cst, npart, output="voltage",
                                passband=tap,
                                response_as_args=bool(args))(raw, *args)
            got, pb = out if tap else (out, None)
            want = megafil_plain(
                plan, cst, raw, npart, torch.float64, passband=tap,
                gr=args[0].double() if args else None,
                gi=args[1].double() if args else None, output="voltage")
            want, wpb = want if tap else (want, None)
            torch.cuda.synchronize()
            err = rel_err(got, want)
            perr = rel_err(pb, wpb) if tap else 0.0
            print(f"small megafil voltage {kind} {kw} {variant}: rel err "
                  f"{err:.3e}, passband {perr:.3e}", flush=True)
            check(got.dtype == torch.complex64
                  and got.shape == (nci * nsub, npol, npart * plan.nkeep),
                  f"voltage shape {kind} {kw} {variant}")
            check(bool(torch.isfinite(torch.view_as_real(got)).all()),
                  f"finite voltage {kind} {kw} {variant}")
            check(max(err, perr) < TOL_SMALL,
                  f"small voltage {kind} {kw} {variant}: {err}, {perr} >= "
                  f"{TOL_SMALL}")


def search_block(card: str, kind: str = "real", dm: float = FLAGSHIP_DM,
                 name: str = "flagship") -> dict:
    """One flagship search block of ``kind`` at ``dm``: the megafil kernel
    against plain (both f32) on device noise, then both timed."""
    from dspsr_tpu_torch.io.sources import DummySource, device_noise_bytes
    from dspsr_tpu_torch.models.load_to_fil import FilPipeline
    from dspsr_tpu_torch.ops.megakernel import fold_pols, megafil_plain

    pipe = FilPipeline(DummySource(flagship_obs(kind)), search_cfg(kind, dm),
                       device="cuda")
    plan = pipe.megafil_plan
    check(plan is not None, f"{name}: no fused search plan")
    raw = device_noise_bytes(0, block_bytes(pipe), "cuda")
    got = pipe._megafil(raw)
    want = megafil_plain(plan, pipe.constants, raw, pipe.npart)
    torch.cuda.synchronize()
    err = rel_err(got, want)
    abs_err = float((got - want).abs().max())
    print(f"{name} {kind} search block (DM {dm}): plan nsub {plan.nsub} "
          f"freq_res {plan.freq_res} R1 {plan.R1} R2 {plan.R2} nkeep "
          f"{plan.nkeep}, "
          f"npart {pipe.npart}; output {tuple(got.shape)}; rel err "
          f"{err:.3e} (abs {abs_err:.3e})", flush=True)
    check(tuple(got.shape) == (64, 1, pipe.npart * plan.nkeep),
          f"search block shape {tuple(got.shape)}")
    check(bool(torch.isfinite(got).all()), f"finite {kind} search block")
    check(err < TOL_FLAGSHIP, f"{kind} search block rel err {err} >= "
          f"{TOL_FLAGSHIP}")
    kernel_ms = cuda_ms(lambda: pipe._megafil(raw), 10)
    plain_ms = cuda_ms(
        lambda: megafil_plain(plan, pipe.constants, raw, pipe.npart), 3)
    sky_ms = pipe.stride_in_samples / pipe.obs_in.rate * 1e3
    nf = len(fold_pols(plan))
    nbytes = raw.numel() + 8 * pipe.constants.gr.numel() + 4 * got.numel()
    bound = bound_of(nbytes, front_ops(plan, pipe.npart, nf, nf))
    print(f"megafil kernel per {name} {kind} search block: "
          f"{kernel_ms:.3f} ms; plain: {plain_ms:.3f} ms; bound "
          f"{bound['bound_ms']:.4f} ms ({bound['bound_by']}); block = "
          f"{sky_ms:.2f} ms of sky [{card}]", flush=True)
    times = kernel_breakdown(lambda: pipe._megafil(raw), card,
                             label=f" ({name} {kind} search)")
    pass_bounds(card, name, plan, pipe.npart, nf, 4 * got.numel(), times)
    print_passes(card, f"{name} {kind} search", plan, pipe.npart, nf,
                 raw.numel(), times,
                 None if name in DM_SEARCH else "megafil_invdet",
                 4 * got.numel())
    return dict(max_abs_err=abs_err, ms=kernel_ms, plain_ms=plain_ms,
                **bound, library_ms=None)


def search_path(card: str, kind: str = "real", dm: float = FLAGSHIP_DM,
                name: str = "search path") -> int:
    """The port's search main path at the megafil_search width on ``kind``
    input at ``dm``, through ``FilPipeline.run`` to a SIGPROC file; returns
    the megafil launches."""
    from dspsr_tpu_torch import launch_counts, reset_launch_counts
    from dspsr_tpu_torch.io.sources import DummySource
    from dspsr_tpu_torch.io.sigproc import read_sigproc_header
    from dspsr_tpu_torch.models.load_to_fil import FilPipeline

    nblocks = 3
    with tempfile.TemporaryDirectory() as tmp:
        out = os.path.join(tmp, "search.fil")
        pipe = FilPipeline(DummySource(flagship_obs(kind)),
                           search_cfg(kind, dm), device="cuda")
        # 64 chans x the block's output samples x 8 bits (16,896,000 B at
        # the flagship's DM)
        file_block = 64 * pipe.npart * pipe.megafil_plan.nkeep
        reset_launch_counts()
        with NoLibraryFFT():
            t0 = time.perf_counter()
            pipe.run(out, max_blocks=nblocks)
            wall = time.perf_counter() - t0
        counts = launch_counts()
        items, hdr = read_sigproc_header(out)
        size = os.path.getsize(out)
        data = np.fromfile(out, np.uint8, offset=hdr)
    check(counts["megafil"] == nblocks,
          f"{kind}: megafil launched {counts['megafil']} times")
    check(counts["megastep"] == 0,
          f"{kind}: megastep launched {counts['megastep']} times")
    check(size == hdr + nblocks * file_block,
          f"{kind}: file size {size} != {hdr} + {nblocks} x {file_block}")
    check(int(items["nchans"]) == 64 and int(items["nbits"]) == 8,
          f"header nchans {items['nchans']} nbits {items['nbits']}")
    check(abs(items["tsamp"] * 6.25e6 - 1.0) < 1e-12,
          f"header tsamp {items['tsamp']} != 1/6.25 MHz")
    # detected noise levelled to mean 0, sigma 1 and digitized at 127.5 +
    # 32 z: a Gamma(2) intensity, clipped at 255 (0.4%), gives mean 127.39
    # and standard deviation 31.49 counts (two pols of complex Gaussian
    # voltages, for real and for complex input alike)
    mean, std = float(data.mean()), float(data.std())
    clipped = float((data == 255).mean())
    msps = nblocks * pipe.stride_in_samples / wall / 1e6
    print(f"{name} ({kind}, DM {dm}): {nblocks} blocks, {counts['megafil']} "
          f"megafil and {counts['megastep']} megastep launches; file {size} "
          f"B (header {hdr}); nchans {items['nchans']} nbits "
          f"{items['nbits']} tsamp {items['tsamp']}; bytes mean {mean:.4f} "
          f"std {std:.4f} at 255 {clipped:.5f}; host-fed incl. first-block "
          f"warm-up {msps:.1f} Msamp/s, "
          f"{msps / (pipe.obs_in.rate / 1e6):.4f} x real time [{card}]",
          flush=True)
    check(126.5 < mean < 128.5, f"byte mean {mean} outside (126.5, 128.5)")
    check(30.0 < std < 33.0, f"byte std {std} outside (30, 33)")
    check(clipped < 0.01, f"{clipped} of the bytes clipped at 255")
    return counts["megafil"]


def search_rates(card: str, kind: str = "real", dm: float = FLAGSHIP_DM,
                 host: bool = True) -> None:
    """Host-fed (unless not ``host``) and device-fed rates of the search
    pipeline at ``dm`` (warm)."""
    from dspsr_tpu_torch.io.sources import DummySource
    from dspsr_tpu_torch.io.sigproc import SigProcWriter
    from dspsr_tpu_torch.models.load_to_fil import FilPipeline

    nblocks = 3
    pipe = FilPipeline(DummySource(flagship_obs(kind)), search_cfg(kind, dm),
                       device="cuda")
    host_msps = 0.0
    if host:
        with tempfile.TemporaryDirectory() as tmp:
            with SigProcWriter(os.path.join(tmp, "r.fil"), pipe.obs_out,
                               8) as out:
                pipe.run_writer(out, max_blocks=1)  # warm-up
                t0 = time.perf_counter()
                pipe.run_writer(out, max_blocks=nblocks)
                wall = time.perf_counter() - t0
        host_msps = nblocks * pipe.stride_in_samples / wall / 1e6
    dev_msps = search_device_fed(pipe)
    rt = pipe.obs_in.rate / 1e6  # the recording rate, Msamp/s
    host_text = (f"host-fed (DummySource bytes, pinned copy, SIGPROC "
                 f"write): {host_msps:.1f} Msamp/s ({host_msps / rt:.4f} x "
                 f"real time); " if host else "")
    print(f"search pipeline ({kind}, DM {dm}) {host_text}device-fed "
          f"(device_noise_bytes, step, rescale, digitize, bytes to host): "
          f"{dev_msps:.1f} Msamp/s ({dev_msps / rt:.3f} x real time); real "
          f"time is {rt:.0f} Msamp/s [{card}]", flush=True)


def front_ops(plan, npart: int, nfwd: int, nstore: int) -> float:
    """float32 operations of the fused front end over one block: per window
    and input channel the forward FFTs (real input: one packed transform of
    L = 2N points; complex input: one of N points per transformed pol; 5 L
    log2 L each), the pol separation, passband and chirp (16 a bin for each
    pol kept), each kept pol's nsub inverse FFTs of freq_res points, and the
    detection (4 a kept sample and plane).  ``nfwd`` pols are transformed,
    ``nstore`` of them inverted."""
    N, M = plan.n_fft, plan.freq_res
    fwd = (5 * 2 * N * math.log2(2 * N) if plan.real_input
           else nfwd * 5 * N * math.log2(N))
    per = (fwd + 16 * N * max(nfwd, nstore)
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


def small_checks_hybrid(kind: str = "real") -> None:
    """The hybrid front end's kernel variants (passband tap, chirp handed
    in: chirp times a random mask) against the plain version (f64) at the
    test geometry: data and passband within TOL_SMALL.  PP and QQ transform
    both pols for the tap and keep one."""
    from dspsr_tpu_torch.ops.megakernel import (
        MegaConstants, build_megafil, megafil_plain, unpack_affine)

    nsub, freq_res, npart = 4, 64, 3
    cases = [
        dict(npol=2), dict(npol=2, detection="pp"),
        dict(npol=2, detection="qq"), dict(npol=2, npol_out=2),
        dict(npol=2, npol_out=4, detection="coherence"), dict(npol=1),
        dict(npol=2, nchan_in=2), dict(npol=2, twos_complement=True),
    ]
    rng = np.random.default_rng(4)
    for kw in cases:
        plan = small_plan(kind, 2, **kw)
        if plan is None:
            continue
        nci, npol = plan.nchan_in, plan.npol
        raw = small_raw(plan, npart, rng)
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
        print(f"small hybrid megafil {kind} {kw}: rel err data {err:.3e}, "
              f"passband {perr:.3e}", flush=True)
        check(data.shape == want.shape and pb.shape == wpb.shape,
              f"hybrid megafil shapes {kind} {kw}")
        check(pb.shape == (nci * nsub, npol, freq_res),
              f"passband {kind} {kw}")
        check(bool(torch.isfinite(data).all() and torch.isfinite(pb).all()),
              f"finite hybrid megafil {kind} {kw}")
        check(max(err, perr) < TOL_SMALL,
              f"small hybrid megafil {kind} {kw}: {err}, {perr} >= "
              f"{TOL_SMALL}")
        check(bool((w == 1).all()) and w.shape == (nci, npart),
              f"weights {kind} {kw}")


def hybrid_pipe(**kw):
    from dspsr_tpu_torch.io.sources import DummySource
    from dspsr_tpu_torch.models.load_to_fold import FoldPipeline

    pipe = FoldPipeline(DummySource(flagship_obs()), flagship_cfg(**kw),
                        device="cuda")
    check(pipe.mega_mode == "hybrid", f"mega_mode {pipe.mega_mode} for {kw}")
    return pipe


HYBRID_SK = dict(sk_enable=True, sk_m=1024)  # bench.py:464-467
HYBRID_RFI = dict(rfi_filter=True)  # bench.py:472-474
# bench.py:486-493: 64 cyclic channels, half-size blocks
HYBRID_CYCLIC = dict(cyclic_nchan=64, min_block_samples=1 << 24)


def hybrid_block(card: str) -> dict:
    """One flagship block of the hybrid RFI front end (passband tap, the
    chirp times a random mask handed in) against the plain version (both
    f32) on device noise, both timed; then what the tap costs: megafil with
    and without it."""
    from dspsr_tpu_torch.io.sources import device_noise_bytes
    from dspsr_tpu_torch.ops.megakernel import build_megafil, megafil_plain

    pipe = hybrid_pipe(**HYBRID_RFI)
    plan, cst = pipe.front_plan, pipe.constants
    raw = device_noise_bytes(0, block_bytes(pipe), "cuda")
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
        reset_launch_counts()
        with NoLibraryFFT():
            t0 = time.perf_counter()
            res = pipe.run(max_blocks=nblocks)
            wall = time.perf_counter() - t0
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
        nbytes = block_bytes(pipe)
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


def cyclic_anchors(pipe, block: int = 0):
    """Phase anchors of block ``block`` of ``pipe`` on the card, over the
    output samples padded to whole segments (as ``FoldPipeline.run``)."""
    from dspsr_tpu_torch.ops.fold import compute_anchors

    seg = pipe.fold_plan.seg_len
    return (torch.from_numpy(a).cuda() for a in compute_anchors(
        pipe.predictor,
        pipe.output_start_time(block * pipe.stride_in_samples),
        1.0 / pipe.obs_out.rate, -(-pipe.out_per_block // seg) * seg, seg))


def lag_fold_cost(pipe) -> dict:
    """The lag fold's bound per block: per (channel, pol, lag, sample) a
    complex product (6 operations) and the weighted fold of its two planes
    (4); bytes: the voltage, the weights and the anchors read once, the
    profiles and hits read and written once."""
    nchan, npol = pipe.obs_out.nchan, pipe.obs_stream.npol
    nlag, n = pipe.cyclic_plan.nlag, pipe.out_per_block
    ops = nchan * npol * nlag * n * (6 + 4)
    nbytes = (8 * nchan * npol * (n + nlag - 1) + 4 * nchan * n
              + 2 * 4 * nchan * (npol * nlag * 2 + 1) * pipe.nbin)
    return dict(ops=ops, nbytes=nbytes, **bound_of(nbytes, ops))


def cyclic_block(card: str) -> dict:
    """One ``hybrid_cyclic`` block: the voltage kernel against the plain
    front end (both f32) on device noise, both timed, beside the bound of
    the front end and of the voltage inverse alone; then the block's fold
    as the main path runs it (kernel, chunked lag fold) against the plain
    voltage folded as whole lag planes."""
    from dspsr_tpu_torch.io.sources import device_noise_bytes
    from dspsr_tpu_torch.ops.cyclic import lag_planes
    from dspsr_tpu_torch.ops.fold import fold_block
    from dspsr_tpu_torch.ops.megakernel import megafil_plain

    pipe = hybrid_pipe(**HYBRID_CYCLIC)
    plan, cst, npart = pipe.front_plan, pipe.constants, pipe.npart
    nlag, nchan = pipe.cyclic_plan.nlag, pipe.obs_out.nchan
    check((npart, nlag, pipe.obs_out.npol, pipe.out_per_block)
          == (38, 33, 132, 133728),
          f"hybrid_cyclic geometry {npart} {nlag} {pipe.obs_out.npol} "
          f"{pipe.out_per_block}")
    raw = device_noise_bytes(0, block_bytes(pipe), "cuda")
    got = pipe._front(raw)[0]
    want = megafil_plain(plan, cst, raw, npart, output="voltage")
    torch.cuda.synchronize()
    err = rel_err(got, want)
    abs_err = float((torch.view_as_real(got)
                     - torch.view_as_real(want)).abs().max())
    print(f"flagship cyclic block (voltage, nlag {nlag}, npart {npart}, "
          f"raw {raw.numel()} B): output {tuple(got.shape)} {got.dtype}; "
          f"rel err {err:.3e} (abs {abs_err:.3e})", flush=True)
    check(got.dtype == torch.complex64
          and tuple(got.shape) == (nchan, 2, npart * plan.nkeep),
          f"cyclic voltage {got.dtype} {tuple(got.shape)}")
    check(bool(torch.isfinite(torch.view_as_real(got)).all()),
          "finite cyclic voltage")
    check(err < TOL_FLAGSHIP, f"cyclic voltage rel err {err} >= "
          f"{TOL_FLAGSHIP}")

    kernel_ms = cuda_ms(lambda: pipe._front(raw), 10)
    plain_ms = cuda_ms(
        lambda: megafil_plain(plan, cst, raw, npart, output="voltage"), 3)
    nbytes = raw.numel() + 8 * cst.gr.numel() + 8 * got.numel()
    bound = bound_of(nbytes, front_ops(plan, npart, 2, 2))
    times = kernel_breakdown(lambda: pipe._front(raw), card,
                             label=" (megafil, voltage)")
    # the voltage inverse alone: reads both pols' spectra, writes the
    # voltage; nsub inverse FFTs a window and pol, one scale a sample
    M = plan.freq_res
    inv = bound_of(2 * npart * plan.n_fft * 8 + 8 * got.numel(),
                   2 * npart * plan.nsub * (5 * M * math.log2(M)
                                            + 2 * plan.nkeep))
    inv["bytes"] = 2 * npart * plan.n_fft * 8 + 8 * got.numel()
    inv_ms = pass_ms(times, "megafil_invvolt", "cyclic block")
    print(f"megafil (voltage) per cyclic block: {kernel_ms:.3f} ms; plain: "
          f"{plain_ms:.3f} ms; bound {bound['bound_ms']:.4f} ms "
          f"({bound['bound_by']}); "
          f"{pass_line('megafil_invvolt', inv_ms, inv)} [{card}]",
          flush=True)

    phi0, dphi = cyclic_anchors(pipe)
    prof0 = torch.zeros(nchan, pipe.obs_out.npol, pipe.nbin, device="cuda")
    hits0 = torch.zeros(nchan, pipe.nbin, device="cuda")
    d, w, wp, _ = pipe._hybrid_block(raw)
    pk, hk = pipe._fold_tail_d(prof0, hits0, d, w, wp, phi0, dphi)
    planes = lag_planes(want, nlag)
    pp, hp = fold_block(prof0, hits0, planes, w, phi0, dphi, pipe.fold_plan)
    torch.cuda.synchronize()
    del planes
    ferr = rel_err(pk, pp)
    hdiff = float((hk - hp).abs().max())
    print(f"cyclic block fold (kernel + chunked lag fold against plain "
          f"voltage + whole lag planes): profiles {tuple(pk.shape)}, rel err "
          f"{ferr:.3e}, hits diff {hdiff}, hits sum {float(hk.sum())}",
          flush=True)
    check(bool(torch.isfinite(pk).all()), "finite cyclic block profiles")
    check(ferr < TOL_FLAGSHIP, f"cyclic fold rel err {ferr} >= "
          f"{TOL_FLAGSHIP}")
    check(hdiff == 0 and float(hk.sum()) == nchan * pipe.out_per_block,
          "cyclic block hits")
    return dict(err=abs_err, ms=kernel_ms, plain_ms=plain_ms, **bound)


def cyclic_path(card: str) -> int:
    """``hybrid_cyclic`` at the flagship width, 3 blocks through
    ``FoldPipeline.run`` with torch.fft and torch.matmul disabled; checks
    the lag planes and the cyclic spectra; returns the megafil launches."""
    from dspsr_tpu_torch import launch_counts, reset_launch_counts

    nblocks = 3
    pipe = hybrid_pipe(**HYBRID_CYCLIC)
    nlag, nchan = pipe.cyclic_plan.nlag, pipe.obs_out.nchan
    reset_launch_counts()
    with NoLibraryFFT():
        t0 = time.perf_counter()
        res = pipe.run(max_blocks=nblocks)
        wall = time.perf_counter() - t0
    counts = launch_counts()
    check(counts["megafil"] == nblocks,
          f"hybrid_cyclic: megafil launched {counts['megafil']} times")
    check(counts["megastep"] == 0, "hybrid_cyclic: megastep launched")
    check(res.profiles.shape == (1, nchan, 2 * nlag * 2, 1024),
          f"hybrid_cyclic profiles shape {res.profiles.shape}")
    check(bool(np.isfinite(res.profiles).all()), "hybrid_cyclic non-finite")
    per_chan = res.hits.sum(axis=(0, 2))
    check(bool((per_chan == nblocks * pipe.out_per_block).all()),
          f"hybrid_cyclic hits per channel {per_chan[:4]}")
    lags = res.normalized()[0].reshape(nchan, 2, nlag, 2, 1024)
    power = lags[:, :, 0, 0]
    check(bool((power > 0).all()), "lag 0 is not a power")
    check(float(np.abs(lags[:, :, 0, 1]).max()) <= 1e-5 * float(power.max()),
          "lag 0 has an imaginary part")
    spec = res.cyclic_spectra()
    check(spec.shape == (1, nchan, 2, 1024, pipe.config.cyclic_nchan)
          and bool(np.isfinite(spec).all()), f"cyclic spectra {spec.shape}")
    # the mean over the cyclic channels of each spectrum is its lag 0
    sp_err = float(np.abs(spec[0].mean(-1) - power).max() / power.max())
    check(sp_err < 1e-9, f"cyclic spectra against lag 0: {sp_err}")
    msps = nblocks * pipe.stride_in_samples / wall / 1e6
    print(f"hybrid_cyclic: {nblocks} blocks, {counts['megafil']} megafil "
          f"launches; profiles {res.profiles.shape}, hits/chan "
          f"{int(per_chan[0])}; cyclic spectra {spec.shape}, mean over "
          f"channels against lag 0 {sp_err:.2e}; host-fed incl. first-block "
          f"warm-up {msps:.1f} Msamp/s, {msps / 800:.4f} x real time "
          f"[{card}]", flush=True)
    return counts["megafil"]


def cyclic_rates(card: str) -> None:
    """Device-fed rate of ``hybrid_cyclic`` (device noise bytes through the
    front end and the lag-fold tail, warm), the front end and the tail
    each alone, peak device memory, and the kernels a block."""
    from dspsr_tpu_torch.io.sources import device_noise_bytes

    pipe = hybrid_pipe(**HYBRID_CYCLIC)
    nbytes = block_bytes(pipe)
    phi0, dphi = cyclic_anchors(pipe)

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
    raw0 = device_noise_bytes(0, nbytes, "cuda")
    step_ms = cuda_ms(lambda: step(raw0), nb)
    front_ms = cuda_ms(lambda: pipe._front(raw0), nb)
    d, w, wp, _ = pipe._hybrid_block(raw0)
    tail_ms = cuda_ms(lambda: pipe._fold_tail_d(
        pipe._profiles, pipe._hits, d, w, wp, phi0, dphi), nb)
    del d, w, wp
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    step(raw0)
    torch.cuda.synchronize()
    peak_mb = (torch.cuda.max_memory_allocated() - base) / 2**20
    msps = pipe.stride_in_samples / (ms * 1e-3) / 1e6
    cost = lag_fold_cost(pipe)
    print(f"hybrid_cyclic device-fed (device_noise_bytes, front end + tail): "
          f"{ms:.3f} ms a block ({pipe.stride_in_samples / 800e3:.2f} ms of "
          f"sky), {msps:.1f} Msamp/s, {msps / 800:.3f} x real time; front "
          f"end + tail alone {step_ms:.3f} ms: front end {front_ms:.3f} ms, "
          f"lag-fold tail {tail_ms:.3f} ms (bound {cost['bound_ms']:.4f} ms, "
          f"{cost['bound_by']}: {cost['ops'] / 1e9:.2f} GFLOP, "
          f"{cost['nbytes'] / 1e6:.0f} MB); peak device memory of a step "
          f"{peak_mb:.0f} MiB; real time is 800 Msamp/s [{card}]", flush=True)
    kernel_breakdown(lambda: step(raw0), card,
                     label=" (hybrid_cyclic, front end + tail)", others=True)


# --------------------------------------------------------------------------
# the nsub == 1 convolution (hybrid_conv32) and Jones calibration
# --------------------------------------------------------------------------

def leaky_jones(n: int, nchan: int) -> np.ndarray:
    """A leaky instrument's inverse, varying across the band: complex
    ``[nchan, n, 2, 2]`` (random-phase diagonal, 30% cross terms)."""
    f = np.linspace(0, 1, n)
    eps = 0.3 * np.exp(2j * np.pi * (f + np.arange(nchan)[:, None] / nchan))
    j = np.empty((nchan, n, 2, 2), np.complex128)
    j[..., 0, 0] = np.exp(1j * 3 * f)
    j[..., 1, 1] = 0.9 * np.exp(-2j * f)
    j[..., 0, 1] = eps
    j[..., 1, 0] = -0.1j * np.conj(eps)
    return j


def small_checks_conv(kind: str = "real") -> None:
    """The multi-pass inverse (``mega_inva``/``megafil_invb``, forced at
    nsub 1 and freq_res 2^12-2^13, where one CTA would do) and the Jones
    mix (on the one-CTA and the multi-pass inverse) against the float64
    plain version at TOL_SMALL: one and two pols, Intensity, PPQQ, QQ,
    Stokes and coherence, voltage; bare and with the passband tap and a
    masked chirp."""
    from dspsr_tpu_torch.ops.megakernel import (
        MegaConstants, build_megafil, megafil_plain, unpack_affine)

    npart = 3
    cases = [
        (dict(npol=2), "detected", 4096), (dict(npol=1), "detected", 4096),
        (dict(npol=2, npol_out=2), "detected", 8192),
        (dict(npol=2, detection="qq"), "detected", 4096),
        (dict(npol=2, npol_out=4), "detected", 4096),
        (dict(npol=2, npol_out=4, detection="coherence"), "detected", 4096),
        (dict(npol=2, nchan_in=2), "detected", 4096),
        (dict(npol=2), "voltage", 4096), (dict(npol=1), "voltage", 8192),
    ]
    jones_cases = [(dict(npol=2), "detected"),
                   (dict(npol=2, npol_out=4), "detected"),
                   (dict(npol=2, nchan_in=2), "voltage")]
    rng = np.random.default_rng(9)
    runs = [(kw, out, fr, False, "multipass") for kw, out, fr in cases]
    runs += [(kw, out, 4096, True, inv) for kw, out in jones_cases
             for inv in ("auto", "multipass")]
    for kw, output, freq_res, jones, inverse in runs:
        plan = small_plan(kind, 2, nsub=1, freq_res=freq_res, **kw)
        if plan is None:
            continue
        nci = plan.nchan_in
        raw = small_raw(plan, npart, rng)
        resp = np.exp(1j * rng.uniform(-3, 3, (nci, freq_res)))
        J = leaky_jones(plan.n_fft, nci) * resp[:, :, None, None] \
            if jones else None
        scale, offset = unpack_affine(8, plan.twos_complement)
        cst = MegaConstants.build(plan, None if jones else resp, scale,
                                  offset, jones=J).to("cuda")
        gr, gi = masked_chirp(cst, rng)
        for variant in ("bare", "masked tap"):
            tap = variant != "bare"
            args = (gr, gi) if tap else ()
            out = build_megafil(plan, cst, npart, output=output,
                                passband=tap, response_as_args=tap,
                                inverse=inverse)(raw, *args)
            got, pb = out if tap else (out, None)
            want = megafil_plain(
                plan, cst, raw, npart, torch.float64, passband=tap,
                gr=gr.double() if tap else None,
                gi=gi.double() if tap else None, output=output)
            want, wpb = want if tap else (want, None)
            torch.cuda.synchronize()
            err = rel_err(got, want)
            perr = rel_err(pb, wpb) if tap else 0.0
            what = (f"small conv {kind} {kw} {output} M={freq_res} "
                    f"{'jones ' if jones else ''}{inverse} {variant}")
            print(f"{what}: rel err {err:.3e}, passband {perr:.3e}",
                  flush=True)
            check(got.shape == want.shape, f"{what}: shape")
            check(bool(torch.isfinite(torch.view_as_real(got) if
                                      got.is_complex() else got).all()),
                  f"{what}: finite")
            check(max(err, perr) < TOL_SMALL,
                  f"{what}: {err}, {perr} >= {TOL_SMALL}")
    small_checks_tiles(kind, rng)


#: geometries of the pass-tile checks, (nsub, freq_res, nfilt): R1 8 and 16
#: (below pass A's 16-column tile; R1 8 only without a filter, where a
#: window keeps all 8q of its samples), q 1, 2, 8, 16, 32 and 512, nsub 1,
#: 4 and 64: (R1, q) = (8, 2), (8, 8), (32, 1), (16, 16), (128, 32),
#: (128, 2), (512, 512)
TILE_GEOMS = ((4, 16, (0, 0)), (1, 64, (0, 0)), (64, 32, (5, 6)),
              (1, 256, (5, 6)), (4, 4096, (5, 6)), (64, 256, (5, 6)),
              (1, 1 << 18, (5, 6)))


def small_checks_tiles(kind: str, rng) -> None:
    """The multi-pass inverse forced at ``TILE_GEOMS``, each kernel (f32)
    against its plain version (f64) at TOL_SMALL: ``megafil`` (pass A's
    column tiles and ring of stages, ``megafil_invb``'s tiles of 4 rows,
    and of 8 for Stokes) with Intensity, PPQQ and Stokes detected and the
    voltage (its (-1)^t sign where the plan flips), with at nsub 1 the
    Jones mix at npol_out 2 and 4; ``megastep`` (pass A, then the fold in
    pass B), hits exact."""
    from dspsr_tpu_torch.kernels.megafil import megafil_cuda
    from dspsr_tpu_torch.ops.megakernel import (
        MegaConstants, megafil_plain, unpack_affine, voltage_sign_flips)

    npart, nbin = 3, 32
    for nsub, freq_res, nfilt in TILE_GEOMS:
        def consts(plan, jones=False):
            nci = plan.nchan_in
            resp = np.exp(1j * rng.uniform(-3, 3, (nci * nsub, freq_res)))
            J = (leaky_jones(plan.n_fft, nci) * resp.reshape(nci, -1)[
                :, :, None, None] if jones else None)
            scale, offset = unpack_affine(8, plan.twos_complement)
            return MegaConstants.build(plan, None if jones else resp, scale,
                                       offset, jones=J).to("cuda")

        runs = [(dict(npol=2), "detected", False),
                (dict(npol=2, npol_out=2), "detected", False),
                (dict(npol=2, npol_out=4), "detected", False),
                (dict(npol=2), "voltage", False)]
        if nsub == 1:
            runs += [(dict(npol=2, npol_out=2), "detected", True),
                     (dict(npol=2, npol_out=4), "detected", True)]
        for kw, output, jones in runs:
            plan = small_plan(kind, 2, nsub=nsub, freq_res=freq_res,
                              nfilt=nfilt, **kw)
            if plan is None:
                continue
            cst, raw = consts(plan, jones), small_raw(plan, npart, rng)
            got = megafil_cuda(plan, cst, raw, npart, output=output,
                               inverse="multipass")
            want = megafil_plain(plan, cst, raw, npart, torch.float64,
                                 output=output)
            torch.cuda.synchronize()
            err = rel_err(got, want)
            flip = output == "voltage" and voltage_sign_flips(plan)
            what = (f"small tiles front {kind} nsub {nsub} M={freq_res} R1 "
                    f"{plan.R1} q {plan.q} {kw} {output}"
                    f"{' flip' if flip else ''}{' jones' if jones else ''}")
            print(f"{what}: rel err {err:.3e}", flush=True)
            check(got.shape == want.shape and err < TOL_SMALL,
                  f"{what}: {err} >= {TOL_SMALL}")
        plan = small_plan(kind, nbin, nsub=nsub, freq_res=freq_res,
                          nfilt=nfilt, npol=2)
        cst, raw = consts(plan), small_raw(plan, npart, rng)
        err, hdiff, hsum = fold_against_plain(plan, cst, raw, npart, nbin,
                                              rng, inverse="multipass")
        what = (f"small tiles fold {kind} nsub {nsub} M={freq_res} R1 "
                f"{plan.R1} q {plan.q}")
        print(f"{what}: rel err {err:.3e}, hits diff {hdiff}", flush=True)
        check(err < TOL_SMALL and hdiff == 0 and hsum > 0,
              f"{what}: {err} >= {TOL_SMALL} or hits {hdiff} {hsum}")


#: geometries of the forced multi-pass checks: (nsub, freq_res), q 4 (the
#: test geometry: pass A in registers), 32 and 64 (pass A through shared
#: memory, as at the flagship band's DMs)
MULTIPASS_GEOMS = ((4, 64), (2, 2048), (2, 16384))


def fold_against_plain(plan, cst, raw, npart, nbin, rng, bounds=None,
                       weights=None, **step_kw) -> tuple:
    """The fold step (f32, ``megastep_cuda(**step_kw)``: ``inverse`` and
    ``row_pass`` force its passes) against its plain version (f64) on one
    block: (rel err, hits diff, hits sum)."""
    from dspsr_tpu_torch.kernels.megastep import megastep_cuda
    from dspsr_tpu_torch.ops.megakernel import megastep_plain

    nci, nsub = plan.nchan_in, plan.nsub
    phi0 = torch.from_numpy(rng.uniform(0, 1, npart).astype(np.float32)).cuda()
    dphi = torch.full((npart,), 0.013 * 64 / plan.freq_res,
                      dtype=torch.float32, device="cuda")
    shp = (nci, plan.nplane, nsub, nbin)
    pk, hk = megastep_cuda(
        plan, cst, torch.zeros(shp, device="cuda"),
        torch.zeros(nci, nbin, device="cuda"), raw, phi0, dphi, bounds,
        weights=weights, **step_kw)
    pp, hp = megastep_plain(
        plan, cst, torch.zeros(shp, dtype=torch.float64, device="cuda"),
        torch.zeros(nci, nbin, dtype=torch.float64, device="cuda"), raw,
        phi0, dphi, bounds, weights=weights)
    torch.cuda.synchronize()
    check(bool(torch.isfinite(pk).all()), f"finite profiles {step_kw}")
    return (rel_err(pk, pp), float((hk.double() - hp).abs().max()),
            float(hk.sum()))


def small_checks_multipass() -> dict:
    """The multi-pass inverse at nsub > 1, forced where one CTA would do,
    the long row pass forced at small R2, and the external weights, each
    kernel (f32) against its plain version (f64) within TOL_SMALL, hits
    exact:

    - ``megastep`` (the fold in pass B) for real, complex and CASPSR input
      at q 4, 32 and 64:
      Intensity, coherence, fourth moments, PP, two input channels, bounds;
      JA98 2-bit input with an excised window;
    - ``megafil`` (``megafil_invb``): Intensity, PPQQ and Stokes detected,
      the voltage (the cyclic front end at nsub > 1) bare and with the
      passband tap and a masked chirp, the Jones mix;
    - the long row pass (``mega_rowfft``, ``mega_rowpair``), real TFP and
      CASPSR, both kernels, with the one-CTA and the multi-pass inverse;
    - ``external_weights`` (a mask and fractional weights) on the one-CTA
      fold and both multi-pass folds.

    Returns each kernel's largest error."""
    from dspsr_tpu_torch.kernels.megafil import megafil_cuda
    from dspsr_tpu_torch.ops.megakernel import (
        MegaConstants, megafil_plain, unpack_affine)

    npart, nbin = 3, 32
    rng = np.random.default_rng(21)
    worst = {"megastep": 0.0, "megafil": 0.0}

    def consts(plan, jones=False):
        nci = plan.nchan_in
        resp = np.exp(1j * rng.uniform(-3, 3, (nci * plan.nsub,
                                               plan.freq_res)))
        J = (leaky_jones(plan.n_fft, nci) * resp.reshape(nci, -1)[
            :, :, None, None] if jones else None)
        scale, offset = unpack_affine(8, plan.twos_complement)
        return MegaConstants.build(plan, None if jones else resp, scale,
                                   offset, jones=J).to("cuda")

    def fold(what, plan, cst, raw, **kw):
        err, hdiff, hsum = fold_against_plain(plan, cst, raw, npart, nbin,
                                              rng, **kw)
        print(f"{what}: rel err {err:.3e}, hits diff {hdiff}", flush=True)
        check(err < TOL_SMALL and hdiff == 0 and hsum > 0,
              f"{what}: {err} >= {TOL_SMALL} or hits {hdiff} {hsum}")
        worst["megastep"] = max(worst["megastep"], err)

    def front(what, plan, cst, raw, output="detected", tap=False, **kw):
        args = masked_chirp(cst, rng) if tap else ()
        out = megafil_cuda(plan, cst, raw, npart, passband=tap,
                           gr=args[0] if tap else None,
                           gi=args[1] if tap else None, output=output, **kw)
        got, pb = out if tap else (out, None)
        want = megafil_plain(
            plan, cst, raw, npart, torch.float64, passband=tap,
            gr=args[0].double() if tap else None,
            gi=args[1].double() if tap else None, output=output)
        want, wpb = want if tap else (want, None)
        torch.cuda.synchronize()
        err = max(rel_err(got, want), rel_err(pb, wpb) if tap else 0.0)
        print(f"{what}: rel err {err:.3e}", flush=True)
        check(got.shape == want.shape and err < TOL_SMALL,
              f"{what}: {err} >= {TOL_SMALL}")
        worst["megafil"] = max(worst["megafil"], err)

    fold_cases = [dict(npol_out=1), dict(npol_out=4, detection="coherence"),
                  dict(npol_out=4, fourth_moment=True),
                  dict(npol_out=1, detection="pp"),
                  dict(npol_out=2, nchan_in=2)]
    fil_cases = [(dict(npol_out=1), "detected", False),
                 (dict(npol_out=2), "detected", True),
                 (dict(npol_out=4), "detected", False),
                 (dict(npol_out=1), "voltage", False),
                 (dict(npol_out=1, nchan_in=2), "voltage", True)]
    for kind in KINDS:
        for nsub, freq_res in MULTIPASS_GEOMS:
            for kw in fold_cases:
                plan = small_plan(kind, nbin, nsub=nsub, freq_res=freq_res,
                                  npol=2, **kw)
                if plan is None:
                    continue
                cst, raw = consts(plan), small_raw(plan, npart, rng)
                for bounds in (None, (7, 70)):
                    fold(f"small multipass fold {kind} nsub {nsub} "
                         f"M={freq_res} q {plan.q} {kw} bounds={bounds}",
                         plan, cst, raw, bounds=bounds, inverse="multipass")
            for kw, output, tap in fil_cases:
                plan = small_plan(kind, 2, nsub=nsub, freq_res=freq_res,
                                  npol=2, **kw)
                if plan is None:
                    continue
                front(f"small multipass front {kind} nsub {nsub} "
                      f"M={freq_res} {kw} {output} tap={tap}", plan,
                      consts(plan), small_raw(plan, npart, rng), output,
                      tap, inverse="multipass")
        plan = small_plan(kind, 2, npol=2, npol_out=4)
        front(f"small multipass front {kind} Jones Stokes", plan,
              consts(plan, jones=True), small_raw(plan, npart, rng),
              inverse="multipass")
    # JA98 2-bit input: the excised window folds nothing
    for kind in ("real", "complex"):
        plan, cst, raw = unpack_case(kind, dict(nbit=2, ndat_per_weight=16),
                                     None, npart, rng)
        fold(f"small multipass fold {kind} JA98", plan, cst, raw,
             inverse="multipass")
    # the long row pass, forced where mega_fwd2 fits
    for kind in ("real", "caspsr"):
        for kw in (dict(npol_out=4), dict(npol_out=1, detection="qq")):
            plan = small_plan(kind, nbin, npol=2, **kw)
            cst, raw = consts(plan), small_raw(plan, npart, rng)
            for inverse in ("auto", "multipass"):
                fold(f"small long rows fold {kind} {kw} {inverse}", plan,
                     cst, raw, row_pass="long", inverse=inverse)
                front(f"small long rows front {kind} {kw} {inverse}", plan,
                      cst, raw, tap=True, row_pass="long", inverse=inverse)
            front(f"small long rows voltage {kind} {kw}", plan, cst, raw,
                  output="voltage", row_pass="long")
    # external window weights, multiplying the fold's samples and hits
    for kind in ("real", "complex"):
        plan = small_plan(kind, nbin, npol=2, npol_out=2)
        cst, raw = consts(plan), small_raw(plan, npart, rng)
        for w in ([1.0, 0.0, 1.0], [0.5, 1.0, 0.25]):
            weights = torch.tensor([w], dtype=torch.float32, device="cuda")
            for inverse in ("auto", "multipass"):
                fold(f"small external weights {kind} {w} {inverse}", plan,
                     cst, raw, weights=weights, inverse=inverse)
    return worst


def conv32_obs():
    """hybrid_conv32's input (``bench.py:438``): 32 complex 8-bit dual-pol
    channels at 12.5 Msamp/s, -400 MHz at 1382 MHz."""
    from dspsr_tpu_torch.models.load_to_fold import MJD, Observation, Signal

    return Observation(
        nchan=32, npol=2, ndim=2, nbit=8, centre_frequency=1382.0,
        bandwidth=-400.0, rate=12.5e6,
        start_time=MJD.from_utc("2010-04-13-02:05:45"),
        state=Signal.ANALYTIC, source="J0437-4715", telescope="PKS",
        instrument="DUMMY").replace(ndat=1 << 40)


def conv32_cfg(**kw):
    """hybrid_conv32's configuration (``bench.py:439-442``: the flagship
    config with 32 channels, DM 71, freq_res 2^19, 4 windows a block;
    J0437's period), with ``kw`` replaced."""
    from dspsr_tpu_torch.models.load_to_fold import FoldConfig

    return FoldConfig(**dict(dict(
        folding_period=0.00575745, dispersion_measure=71.0, nchan=32,
        nbin=1024, npol_out=1, frequency_resolution=1 << 19, block_parts=4,
        min_block_samples=0), **kw))


def conv32_pipe(**kw):
    """hybrid_conv32 (:func:`conv32_cfg`) through ``FoldPipeline`` on the
    card."""
    from dspsr_tpu_torch.io.sources import DummySource
    from dspsr_tpu_torch.models.load_to_fold import FoldPipeline

    pipe = FoldPipeline(DummySource(conv32_obs()), conv32_cfg(**kw),
                        device="cuda")
    p = pipe.mega_plan
    check(pipe.mega_mode == "hybrid" and pipe.fb_plan is None
          and (p.nsub, p.R1, p.R2, p.nkeep, pipe.npart,
               pipe.block_in_samples)
          == (1, 1024, 512, 462848, 4, 1912832),
          f"hybrid_conv32 geometry {p} npart {pipe.npart}")
    return pipe


def multipass_bounds(plan, npart: int, nout: int, out_bytes: int,
                     jones: bool) -> dict:
    """Bounds of the multi-pass inverse's passes over one block: pass A
    reads the stored spectra (and the Jones planes) and writes nout windows
    of N points, nout R1*nsub FFTs of q points a window and a twiddle; pass
    B reads them and writes the output (or the folded profile), nout R2
    FFTs of R1 points a window."""
    N, R1, q = plan.n_fft, plan.R1, plan.q
    seqs = plan.nchan_in * npart * nout
    nin = 2 if jones else nout
    a_bytes = (8 * plan.nchan_in * npart * N * (nin + nout)
               + (8 * 4 * plan.nchan_in * N if jones else 0))
    a_ops = seqs * (5 * N * math.log2(q) + 6 * N
                    + (16 * N if jones else 0))
    b_ops = seqs * 5 * N * math.log2(R1)
    b_bytes = 8 * plan.nchan_in * npart * N * nout + out_bytes
    return {"A": dict(bound_of(a_bytes, a_ops), bytes=a_bytes),
            "B": dict(bound_of(b_bytes, b_ops), bytes=b_bytes)}


def print_attributes(tag: str, plan, nout: int, fold: bool = False,
                     jones: bool = False) -> dict:
    """Print the registers and local bytes a thread (spills and stack,
    ``cudaFuncGetAttributes``) of the inverse's kernels for ``plan``: the
    fold's (``fold``: ``mega_invfold``, or ``mega_inva`` and
    ``mega_invbfold``), or the multi-pass search front end's ``mega_inva``
    and ``megafil_invb`` (nout pols, the Jones mix when ``jones``)."""
    from dspsr_tpu_torch.kernels import megafil as kfil
    from dspsr_tpu_torch.kernels import megastep as kstep

    attrs = (kstep.inverse_attributes(plan) if fold
             else kfil.multipass_attributes(plan, nout, jones))
    print(f"{tag} inverse kernels: " + "; ".join(
        f"{k} {a['regs']} registers, {a['local_bytes']} B local a thread "
        f"(blocks of at most {a['max_threads']})" for k, a in attrs.items()),
        flush=True)
    return attrs


def pass_line(name: str, ms: float, bound: dict) -> str:
    """``name``'s time beside its bytes (``bound["bytes"]``), their rate and
    its bound (:func:`multipass_bounds`)."""
    nb = bound["bytes"]
    return (f"{name} {ms:.3f} ms for {nb / 1e6:.0f} MB "
            f"({nb / (ms * 1e-3) / 1e12:.2f} TB/s; bound "
            f"{bound['bound_ms']:.4f} ms, {bound['bound_by']})")


def row_bounds(plan, npart: int, nstore: int) -> dict:
    """Bounds of the long row pass over one block (real input, 2N-point
    windows): mega_rowfft reads and writes every row once, an R1 FFTs of
    row_len points a window; mega_rowpair reads the rows and the chirp and
    writes nstore spectra of N bins, 16 operations a bin and pol."""
    N2, c = 2 * plan.n_fft, plan.nchan_in * npart
    return {"rowfft": bound_of(2 * 8 * c * N2,
                               c * 5 * N2 * math.log2(plan.row_len)),
            "rowpair": bound_of(8 * c * N2 + 8 * c * nstore * plan.n_fft
                                + 8 * plan.nchan_in * plan.n_fft,
                                16 * c * nstore * plan.n_fft)}


def pass_ms(times: dict, name: str, tag: str) -> float:
    """The time of kernel ``name`` (any template arguments) in ``times``
    (from :func:`kernel_breakdown`); fails when the step did not run it."""
    ms = next((v for k, v in times.items() if k.split("<")[0] == name),
              None)
    check(ms is not None, f"{tag}: {name} missing from {sorted(times)}")
    return ms


def traced_kernels(fn) -> list:
    """The kernels one call of ``fn`` launches on the card, as the
    profiler's trace records them: name, grid, block, registers a thread,
    shared memory a block (bytes) and microseconds of each."""
    from torch.profiler import ProfilerActivity, profile

    kernels = []
    for _ in range(3):  # a trace has come back without its kernels
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            fn()
            torch.cuda.synchronize()
        with tempfile.TemporaryDirectory() as tmp:
            path = os.path.join(tmp, "trace.json")
            prof.export_chrome_trace(path)
            with open(path) as f:
                events = json.load(f).get("traceEvents", [])
        kernels = [dict(name=ev.get("name", "?"),
                        grid=ev["args"].get("grid"),
                        block=ev["args"].get("block"),
                        regs=ev["args"].get("registers per thread"),
                        smem=ev["args"].get("shared memory"),
                        us=ev.get("dur"))
                   for ev in events if ev.get("cat") == "kernel"]
        if kernels:
            break
    return kernels


def row_library_ms(plan, npart: int, reps: int = 5) -> tuple:
    """Mean milliseconds of ``torch.fft.fft`` over the stage-1 rows of one
    real block (``[nchan_in * npart * R1, row_len]`` complex64 noise made
    on the card): the one library call that computes ``mega_rowfft``'s
    function, timed as its yardstick and used nowhere in the port; and the
    shape of the kernels it launches (:func:`traced_kernels`), which shows
    what the card rewards on these rows."""
    x = torch.randn(plan.nchan_in * npart * plan.R1, plan.row_len,
                    dtype=torch.complex64, device="cuda")
    torch.fft.fft(x, dim=-1)
    ms = cuda_ms(lambda: torch.fft.fft(x, dim=-1), reps)
    shape = traced_kernels(lambda: torch.fft.fft(x, dim=-1))
    del x
    return ms, shape


def pass_bounds(card: str, name: str, plan, npart: int, nout: int,
                out_bytes: int, times: dict) -> None:
    """Print the multi-pass inverse's and the long row pass's kernel times
    (``times``, from :func:`kernel_breakdown`) against their bounds, and
    for the long row pass the library call of its FFT
    (:func:`row_library_ms`): the DM phases (``DM_FOLD``, ``DM_SEARCH``)
    must have run the multi-pass inverse, and real input at R2 = 8192 the
    long row pass; the other blocks must have run neither."""
    multipass = name in DM_FOLD or name in DM_SEARCH
    rows = multipass and plan.real_input and plan.R2 == 8192
    ran = {k.split("<")[0] for k in times}
    check(("mega_inva" in ran) == multipass
          and ("mega_rowfft" in ran) == rows,
          f"{name}: passes {sorted(ran)}")
    parts = []
    if multipass:
        mb = multipass_bounds(plan, npart, nout, out_bytes, False)
        pass_b = "mega_invbfold" if name in DM_FOLD else "megafil_invb"
        parts += [pass_line("pass A mega_inva", pass_ms(times, "mega_inva",
                                                        name), mb["A"]),
                  pass_line(f"pass B {pass_b}", pass_ms(times, pass_b, name),
                            mb["B"])]
        print_attributes(name, plan, nout, fold=name in DM_FOLD)
    if rows:
        parts += [f"{k} {pass_ms(times, 'mega_' + k, name):.3f} ms (bound "
                  f"{v['bound_ms']:.4f} ms, {v['bound_by']})"
                  for k, v in row_bounds(plan, npart, nout).items()]
        lib_ms, shape = row_library_ms(plan, npart)
        parts.append(f"torch.fft.fft of the same rows (library yardstick "
                     f"of mega_rowfft) {lib_ms:.3f} ms")
        print(f"{name} yardstick torch.fft.fft kernels: " + ("; ".join(
            f"{k['name'][:48]} grid {k['grid']} block {k['block']}, "
            f"{k['regs']} registers, {k['smem']} B shared, {k['us']} us"
            for k in shape) or "none in the profiler's trace"), flush=True)
        print_row_attributes(name, plan, name in DM_FOLD)
    if parts:
        print(f"{name} passes per block: {'; '.join(parts)} [{card}]",
              flush=True)


def print_row_attributes(tag: str, plan, fold: bool) -> dict:
    """Print the long row pass's ``mega_rowfft`` (as the fold step's
    library, or the search front end's, built it): registers and local
    bytes a thread, its cluster and how many clusters the card holds at
    once; fails unless it spills nothing and runs two CTAs a row."""
    from dspsr_tpu_torch.kernels.megastep import row_attributes

    a = row_attributes(plan, "megastep" if fold else "megafil")
    print(f"{tag} mega_rowfft: {a['regs']} registers, {a['local_bytes']} B "
          f"local a thread (blocks of at most {a['max_threads']}), clusters "
          f"of {a['cluster']} CTAs, {a['clusters_at_once']} clusters at once",
          flush=True)
    check(a["local_bytes"] == 0 and a["cluster"] == 2,
          f"{tag} mega_rowfft attributes {a}")
    return a


def inverse_bound(plan, npart: int, nout: int, out_bytes: int) -> dict:
    """The one-CTA inverse's bound over one block (``mega_invfold``,
    ``megafil_invdet``): it reads nout stored spectra of N bins a window and
    writes ``out_bytes``, nout nsub FFTs of freq_res points a window."""
    seqs = plan.nchan_in * npart * nout
    nbytes = 8 * seqs * plan.n_fft + out_bytes
    ops = seqs * 5 * plan.n_fft * math.log2(plan.freq_res)
    return dict(bound_of(nbytes, ops), bytes=nbytes)


def fold_times(card: str) -> None:
    """The blocks whose fold runs ``mega_invfold`` or ``mega_invbfold``
    (the flagship real, complex and CASPSR, ``mega_guppi_2bit`` and the
    ``DM_FOLD`` cells), each checked against plain and timed pass by pass
    by its block function: for comparing two trees, or the variants of one,
    in one call."""
    for kind in KINDS:
        flagship_block(card, kind)
    guppi2_block(card)
    for name, (kind, dm) in DM_FOLD.items():
        flagship_block(card, kind, dm, name)


def forward_passes(plan, npart: int, nfwd: int, nstore: int,
                   raw_bytes: int) -> dict:
    """The bytes each pass of the forward half must move over one block
    (each input read once, each output written once): the pre-pass
    (``mega_ftp``/``mega_ftpw`` on multi-channel TFP, ``mega_ja98`` for
    JA98 codes: the raw codes in; the channel-transposed copy, the JA98
    counts and block weights out), ``mega_fwd1`` (the copy, or the raw
    codes, and the JA98 counts in; ``cbuf`` out) and the row pass (``cbuf``
    and the chirp in, the ``nstore`` kept spectra out); ``"fused"`` is
    ``mega_fwd1`` with its pre-pass as one function: raw codes (and counts)
    in, ``cbuf`` out.  ``nfwd`` pols are transformed."""
    from dspsr_tpu_torch.kernels.megastep import CLUSTER_R2, ftp_nbytes

    nci, N = plan.nchan_in, plan.n_fft
    nseq = 1 if plan.real_input else nfwd
    cbuf = 8 * nci * nseq * npart * plan.R1 * plan.row_len
    spectra = 8 * nci * nstore * npart * N
    copy = ftp_nbytes(plan, npart)
    counts = 0
    out = {}
    if plan.npw:
        nw = plan.block_ndat(npart) // plan.npw
        counts = 2 * nci * plan.npol * plan.ndim * nw
        out["mega_ja98"] = raw_bytes + counts + 4 * nci * nw + copy
    elif copy:
        widen = plan.npol * plan.ndim * plan.nbit < 8
        out["mega_ftpw" if widen else "mega_ftp"] = raw_bytes + copy
    out["mega_fwd1"] = (copy or raw_bytes) + counts + cbuf
    row = ("mega_fwd2" if plan.real_input else
           "mega_fwd2cc" if plan.R2 >= CLUSTER_R2 else "mega_fwd2c")
    out[row] = cbuf + spectra + 8 * nci * N
    out["fused"] = raw_bytes + counts + cbuf
    return out


def print_passes(card: str, tag: str, plan, npart: int, nf: int,
                 raw_bytes: int, times: dict, inverse: str | None = None,
                 out_bytes: int = 0) -> dict:
    """Print every pass of a step's forward half (``times`` from
    :func:`kernel_breakdown`) against its bytes and bound
    (:func:`pass_line`), and the one-CTA inverse ``inverse`` where given
    (:func:`inverse_bound`, ``out_bytes`` written): ``mega_polpow`` (real
    input, two pols: the codes in, the pol energies out), the pre-pass and
    ``mega_fwd1`` (:func:`forward_passes`; R1-point FFTs of every column),
    after a pre-pass also the two as one function (raw codes in, ``cbuf``
    out), and the row pass (row_len-point FFTs of every row and 16
    operations a kept bin and pol; where the long row pass ran, its two
    kernels as that one function, and each against its own bound in
    :func:`pass_bounds`).  Fails when the step did not run one of them.
    Returns each pass's milliseconds (``"fused"``: ``mega_fwd1`` with its
    pre-pass)."""
    ran = {k.split("<")[0] for k in times}
    passes = forward_passes(plan, npart, nf, nf, raw_bytes)
    nseq = 1 if plan.real_input else nf
    cols = plan.nchan_in * nseq * npart * plan.R1 * plan.row_len
    fwd1_ops = 5 * cols * math.log2(plan.R1)
    row_ops = (5 * cols * math.log2(plan.row_len)
               + 16 * plan.nchan_in * npart * nf * plan.n_fft)
    bounds = {}
    if plan.real_input and nf == 2:
        nb = raw_bytes + 8 * plan.nchan_in * npart
        bounds["mega_polpow"] = dict(bound_of(nb, 0), bytes=nb)
    long_rows = ("mega_rowfft", "mega_rowpair")
    for name, nb in passes.items():
        if name == "fused":
            continue
        if name == "mega_fwd2" and long_rows[0] in ran:
            name = " + ".join(long_rows)
        ops = (fwd1_ops if name == "mega_fwd1"
               else row_ops if name.startswith(("mega_fwd2", "mega_row"))
               else 0)
        bounds[name] = dict(bound_of(nb, ops), bytes=nb)
    if inverse:
        bounds[inverse] = inverse_bound(plan, npart, nf, out_bytes)
    ms = {name: sum(pass_ms(times, n, tag) for n in name.split(" + "))
          for name in bounds}
    parts = [pass_line(name, ms[name], b) for name, b in bounds.items()]
    pre = [n for n in ("mega_ftp", "mega_ftpw", "mega_ja98") if n in ms]
    ms["fused"] = sum(ms[n] for n in pre) + ms["mega_fwd1"]
    if pre:
        nb = passes["fused"]
        parts.append(pass_line("mega_fwd1 with its pre-pass", ms["fused"],
                               dict(bound_of(nb, fwd1_ops), bytes=nb)))
    print(f"{tag} passes per block: {'; '.join(parts)} [{card}]",
          flush=True)
    return ms


def conv32_block(card: str, jones_path: str | None = None) -> dict:
    """One hybrid_conv32 block (with ``jones_path``: calibrated, Stokes):
    the front end's kernel against its plain version (both f32) on device
    noise, then the block's fold against the plain data folded, hits exact;
    the forward passes, pass A, pass B and the tail timed against their
    bounds."""
    from dspsr_tpu_torch.io.sources import device_noise_bytes
    from dspsr_tpu_torch.ops.detection import from_front_planes
    from dspsr_tpu_torch.ops.fold import fold_block
    from dspsr_tpu_torch.ops.megakernel import megafil_plain

    kw = dict(calibration_path=jones_path, npol_out=4) if jones_path else {}
    tag = "hybrid_conv32" + (" + Jones" if jones_path else "")
    pipe = conv32_pipe(**kw)
    plan, cst, npart = pipe.front_plan, pipe.constants, pipe.npart
    check((cst.jones is not None) == bool(jones_path), f"{tag}: jones")
    raw = device_noise_bytes(0, block_bytes(pipe), "cuda")
    got = pipe._front(raw)[0]
    want = megafil_plain(plan, cst, raw, npart)
    torch.cuda.synchronize()
    err = rel_err(got, want)
    abs_err = float((got - want).abs().max())
    print(f"{tag} block (nsub 1, R1 {plan.R1} R2 {plan.R2}, nkeep "
          f"{plan.nkeep}, npart {npart}, raw {raw.numel()} B): output "
          f"{tuple(got.shape)}; rel err {err:.3e} (abs {abs_err:.3e})",
          flush=True)
    check(bool(torch.isfinite(got).all()), f"{tag}: finite front end")
    check(err < TOL_FLAGSHIP, f"{tag}: rel err {err} >= {TOL_FLAGSHIP}")

    phi0, dphi = cyclic_anchors(pipe)
    nchan, npol = pipe.obs_out.nchan, pipe.obs_out.npol
    prof0 = torch.zeros(nchan, npol, pipe.nbin, device="cuda")
    hits0 = torch.zeros(nchan, pipe.nbin, device="cuda")
    d, w, wp, _ = pipe._hybrid_block(raw)
    pk, hk = pipe._fold_tail_d(prof0, hits0, d, w, wp, phi0, dphi)
    dp = from_front_planes(want, pipe.det_state, plan.npol_out)
    pp, hp = fold_block(prof0, hits0, dp, w, phi0, dphi, pipe.fold_plan)
    torch.cuda.synchronize()
    ferr, hdiff = rel_err(pk, pp), float((hk - hp).abs().max())
    print(f"{tag} block fold: profiles {tuple(pk.shape)}, rel err "
          f"{ferr:.3e}, hits diff {hdiff}, hits sum {float(hk.sum())}",
          flush=True)
    check(ferr < TOL_FLAGSHIP and hdiff == 0
          and float(hk.sum()) == nchan * pipe.out_per_block,
          f"{tag}: block fold {ferr} {hdiff}")

    kernel_ms = cuda_ms(lambda: pipe._front(raw), 5)
    plain_ms = cuda_ms(lambda: megafil_plain(plan, cst, raw, npart), 2)
    tail_ms = cuda_ms(lambda: pipe._fold_tail_d(prof0, hits0, d, w, wp,
                                                phi0, dphi), 5)
    times = kernel_breakdown(lambda: pipe._front(raw), card,
                             label=f" ({tag} front end)")
    nbytes = (raw.numel() + 8 * cst.gr.numel() + 4 * got.numel()
              + (4 * cst.jones.numel() if jones_path else 0))
    bound = bound_of(nbytes, front_ops(plan, npart, 2, 2))
    mb = multipass_bounds(plan, npart, 2, 4 * got.numel(), bool(jones_path))
    fwd = print_passes(card, tag, plan, npart, 2, raw.numel(), times)
    fwd = fwd["fused"] + sum(v for k, v in times.items()
                             if k.startswith("mega_fwd2"))
    ms_a = pass_ms(times, "mega_inva", tag)
    ms_b = pass_ms(times, "megafil_invb", tag)
    print_attributes(tag, plan, 2, jones=bool(jones_path))
    sky_ms = pipe.stride_in_samples / pipe.obs_in.rate * 1e3
    print(f"{tag} per block ({sky_ms:.2f} ms of sky): front end "
          f"{kernel_ms:.3f} ms (bound {bound['bound_ms']:.4f} ms, "
          f"{bound['bound_by']}; plain {plain_ms:.3f} ms): forward passes "
          f"{fwd:.3f} ms, {pass_line('pass A', ms_a, mb['A'])}, "
          f"{pass_line('pass B', ms_b, mb['B'])}; tail {tail_ms:.3f} ms "
          f"[{card}]", flush=True)
    return dict(max_abs_err=abs_err, ms=kernel_ms, plain_ms=plain_ms,
                **bound, library_ms=None)


def conv32_path(card: str) -> int:
    """hybrid_conv32 at full width, 3 blocks through ``FoldPipeline.run``
    with torch.fft and torch.matmul disabled; returns the megafil
    launches."""
    from dspsr_tpu_torch import launch_counts, reset_launch_counts

    nblocks = 3
    pipe = conv32_pipe()
    reset_launch_counts()
    with NoLibraryFFT():
        t0 = time.perf_counter()
        res = pipe.run(max_blocks=nblocks)
        wall = time.perf_counter() - t0
    counts = launch_counts()
    check(counts["megafil"] == nblocks,
          f"hybrid_conv32: megafil launched {counts['megafil']} times")
    check(counts["megastep"] == 0, "hybrid_conv32: megastep launched")
    check(res.profiles.shape == (1, pipe.obs_out.nchan, 1, pipe.nbin),
          f"hybrid_conv32 profiles shape {res.profiles.shape}")
    check(bool(np.isfinite(res.profiles).all()), "hybrid_conv32 non-finite")
    per_chan = res.hits.sum(axis=(0, 2))
    check(bool((per_chan == nblocks * pipe.out_per_block).all()),
          f"hybrid_conv32 hits per channel {per_chan[:4]}")
    prof = res.normalized()[0, :, 0, :]
    check(bool((prof.std(axis=1) > 0).all()), "hybrid_conv32 flat profiles")
    check([op["op"] for op in res.signal_path][2:4]
          == ["Dedispersion", "Convolution"], "hybrid_conv32 signal path")
    msps = nblocks * pipe.stride_in_samples / wall / 1e6
    print(f"hybrid_conv32: {nblocks} blocks, {counts['megafil']} megafil "
          f"launches, hits/chan {int(per_chan[0])}; host-fed incl. "
          f"first-block warm-up {msps:.2f} Msamp/s, "
          f"{msps / (pipe.obs_in.rate / 1e6):.4f} x real time [{card}]",
          flush=True)
    return counts["megafil"]


def conv32_rates(card: str) -> None:
    """Device-fed rate of hybrid_conv32 (device noise bytes through the
    front end and the tail, warm) against 12.5 Msamp/s a channel, the
    host-fed rate (DummySource bytes, warm), and peak device memory."""
    from dspsr_tpu_torch.io.sources import device_noise_bytes

    pipe = conv32_pipe()
    nbytes = block_bytes(pipe)
    phi0, dphi = cyclic_anchors(pipe)

    def step(raw):
        d, w, wp, _ = pipe._hybrid_block(raw)
        pipe._profiles, pipe._hits = pipe._fold_tail_d(
            pipe._profiles, pipe._hits, d, w, wp, phi0, dphi)

    def block(b):
        step(device_noise_bytes(b * nbytes, nbytes, "cuda"))

    block(0)
    nb = 4
    it = iter(range(1, nb + 1))
    ms = cuda_ms(lambda: block(next(it)), nb)
    raw0 = device_noise_bytes(0, nbytes, "cuda")
    step_ms = cuda_ms(lambda: step(raw0), nb)
    noise_ms = cuda_ms(lambda: device_noise_bytes(0, nbytes, "cuda"), 2)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    step(raw0)
    torch.cuda.synchronize()
    peak_mb = (torch.cuda.max_memory_allocated() - base) / 2**20
    pipe.run(max_blocks=1)  # warm-up of the host-fed path
    t0 = time.perf_counter()
    pipe.run(max_blocks=1, seek_seconds=pipe.stride_in_samples
             / pipe.obs_in.rate)
    host = pipe.stride_in_samples / (time.perf_counter() - t0) / 1e6
    msps = pipe.stride_in_samples / (ms * 1e-3) / 1e6
    rt = pipe.obs_in.rate / 1e6  # the recording rate, Msamp/s a channel
    print(f"hybrid_conv32 device-fed (device_noise_bytes, front end + tail): "
          f"{ms:.3f} ms a block ({pipe.stride_in_samples / rt / 1e3:.2f} ms "
          f"of sky), {msps:.1f} Msamp/s a channel, {msps / rt:.3f} x real "
          f"time; front end + tail alone {step_ms:.3f} ms; the noise "
          f"generator {noise_ms:.3f} ms; host-fed (DummySource bytes, warm) "
          f"{host:.2f} Msamp/s, {host / rt:.4f} x real time; peak device "
          f"memory of a step {peak_mb:.0f} MiB; real time is {rt:g} Msamp/s "
          f"[{card}]", flush=True)
    kernel_breakdown(lambda: step(raw0), card,
                     label=" (hybrid_conv32, front end + tail)", others=True)


def conv32_jones(card: str) -> dict:
    """hybrid_conv32 with polarization calibration (``npol_out=4``, a
    calibration ``.npz`` written to a temporary directory): one block held
    against plain (``conv32_block``), then the leakage check of
    ``tests/test_hybrid.py:169-204`` on the card: device noise mixed by a
    leaky instrument J and digitized again folds with small cross-polar
    power once calibrated, and large without."""
    from dspsr_tpu_torch.io.sources import device_noise_bytes

    J = np.array([[1.0, 0.35 + 0.1j], [-0.2j, 0.9]], np.complex128)
    with tempfile.TemporaryDirectory() as tmp:
        cal = os.path.join(tmp, "cal.npz")
        freqs = np.linspace(1100.0, 1700.0, 16)
        np.savez(cal, freq=freqs, jones=np.broadcast_to(J, (16, 2, 2)))
        stats = conv32_block(card, jones_path=cal)
        leak = {}
        for tag, path in (("calibrated", cal), ("uncalibrated", None)):
            pipe = conv32_pipe(npol_out=4, **(
                dict(calibration_path=path) if path else {}))
            nchan = pipe.obs_in.nchan
            x = device_noise_bytes(0, block_bytes(pipe), "cuda").view(
                -1, nchan, 2, 2).float()
            z = torch.complex(x[..., 0] - 127.5, x[..., 1] - 127.5)
            y = torch.einsum("ab,tcb->tca", torch.from_numpy(J).to(
                torch.complex64).cuda(), z) * 0.5
            raw = torch.stack([y.real, y.imag], -1).add(127.5).round().clamp(
                0, 255).to(torch.uint8).reshape(-1)
            del x, z, y
            phi0, dphi = cyclic_anchors(pipe)
            prof0 = torch.zeros(nchan, 4, pipe.nbin, device="cuda")
            hits0 = torch.zeros(nchan, pipe.nbin, device="cuda")
            d, w, wp, _ = pipe._hybrid_block(raw)
            pk, _ = pipe._fold_tail_d(prof0, hits0, d, w, wp, phi0, dphi)
            s = pk.double().sum(0)  # Stokes [4, nbin], all channels
            leak[tag] = float((s[1] ** 2 + s[2] ** 2 + s[3] ** 2).sqrt()
                              .mean() / s[0].mean())
    print(f"hybrid_conv32 + Jones leakage (|Q,U,V| / I of the block's "
          f"fold): calibrated {leak['calibrated']:.4f}, uncalibrated "
          f"{leak['uncalibrated']:.4f}", flush=True)
    check(leak["calibrated"] < 0.05
          and leak["calibrated"] < 0.25 * leak["uncalibrated"],
          f"hybrid_conv32 Jones leakage {leak}")
    return stats


# ---- the unpack variants and mega_guppi_2bit (JA98 2-bit) ----

_M32 = 0xFFFFFFFF


def _mix(x: torch.Tensor) -> torch.Tensor:
    """A 32-bit multiply-xorshift hash of int64 ``x`` (its low 32 bits)."""
    h = ((x & _M32) * 2654435761) & _M32
    h = h ^ (h >> 15)
    h = (h * 0x846CA68B) & _M32
    return h ^ (h >> 13)


def ja98_bytes(t0: int, ndat: int, ndig: int, npw: int, stretches=(),
               seed: int = 0, device="cuda") -> torch.Tensor:
    """2-bit JA98 bytes of time samples ``[t0, t0 + ndat)`` of ``ndig``
    digitizers (TFP order, four codes a byte, the first in the top bits;
    ``t0`` a multiple of ``npw``), made on the card.  Every ``npw``-sample
    block of every digitizer holds exactly ``round(2 npw / 3)`` low codes
    (171 of 256: inside the JA98 keep range, 148-194), at the positions m
    with ``(m a + b) mod npw < 171``, ``a`` odd and ``b`` hashed from the
    block and digitizer, and a hashed sign; so no clean block is excised.
    ``stretches`` lists ``(digs, start, stop)``: digitizers ``digs`` hold
    code 3 (saturated) over samples ``[start, stop)``."""
    check(t0 % npw == 0 and ndat % npw == 0 and ndig * npw % 4 == 0,
          f"ja98_bytes({t0}, {ndat}, {ndig}, {npw})")
    nlow = round(2 * npw / 3)
    out = torch.empty(ndat * ndig // 4, dtype=torch.uint8, device=device)
    i64, i32 = torch.int64, torch.int32
    d = torch.arange(ndig, device=device, dtype=i64)
    m = torch.arange(npw, device=device, dtype=i32)[None, :, None]
    gidx, shift = d // 32, (d % 32).to(i32)
    ngrp = (ndig + 31) // 32
    weights = torch.tensor([64, 16, 4, 1], device=device, dtype=i32)
    nblk = ndat // npw
    per = max(1, (1 << 25) // (npw * ndig))  # blocks a chunk
    for k0 in range(0, nblk, per):
        nb = min(per, nblk - k0)
        blk = torch.arange(t0 // npw + k0, t0 // npw + k0 + nb, device=device,
                           dtype=i64)[:, None]
        key = (blk * ndig + d) * 4 + seed
        a = ((_mix(key) | 1) & (npw - 1)).to(i32)[:, None, :]
        b = (_mix(key + 1) & (npw - 1)).to(i32)[:, None, :]
        low = ((m * a + b) & (npw - 1)) < nlow  # [nb, npw, ndig]
        t = blk * npw + torch.arange(npw, device=device, dtype=i64)
        grp = torch.arange(ngrp, device=device, dtype=i64)
        h = _mix((t[..., None] * ngrp + grp) * 4 + 2 + seed).to(i32)
        sgn = (h[..., gidx] >> shift) & 1
        codes = torch.where(low, sgn + 1, sgn * 3).reshape(nb * npw, ndig)
        c0 = t0 + k0 * npw
        for digs, s0, s1 in stretches:
            lo, hi = max(s0 - c0, 0), min(s1 - c0, nb * npw)
            if lo < hi:
                codes[lo:hi, list(digs)] = 3
        out[k0 * npw * ndig // 4:(k0 + nb) * npw * ndig // 4] = (
            codes.reshape(-1, 4) * weights).sum(1).to(torch.uint8)
    return out


#: the unpack variants held against plain at the test geometry: (input
#: kind, plan keywords, apodization window)
UNPACK_CASES = [
    ("real", dict(nbit=2, ndat_per_weight=16), None),
    ("complex", dict(nbit=2, ndat_per_weight=16), None),
    ("complex", dict(nbit=2, ndat_per_weight=16, nchan_in=2, npol_out=2),
     None),
    ("real", dict(nbit=1), None), ("real", dict(nbit=2), None),
    ("real", dict(nbit=4), None), ("complex", dict(nbit=4), None),
    ("real", dict(nbit=2, twos_complement=True), None),
    ("complex", dict(nbit=2, twos_complement=True), None),
    ("real", dict(nbit=4, twos_complement=True, npol_out=4), None),
    ("complex", dict(nbit=4, twos_complement=True, nchan_in=2), None),
    ("complex", dict(nbit=1, nchan_in=2, npol_out=4), None),
    ("real", dict(nbit=32), None), ("complex", dict(nbit=32), None),
    ("real", dict(), "hanning"), ("complex", dict(npol_out=2), "hanning"),
    ("real", dict(nbit=4), "tukey"),
    ("complex", dict(nbit=2, ndat_per_weight=16), "welch"),
]


def unpack_case(kind, kw, window, npart, rng):
    """Plan, constants (on the card) and one block of raw bytes (on the
    card) of an UNPACK_CASES entry at the test geometry; JA98 bytes
    saturate the first digitizer over samples 8-40, so window 0 of channel
    0 is excised and the rest kept."""
    from dspsr_tpu_torch.ops.apodization import WindowType, build_window
    from dspsr_tpu_torch.ops.megakernel import (
        MegaConstants, raw_nbytes, unpack_affine)

    plan = small_plan(kind, 32, npol=2, **kw)
    nci, nsub, freq_res = plan.nchan_in, plan.nsub, plan.freq_res
    resp = np.exp(1j * rng.uniform(-3, 3, (nci * nsub, freq_res)))
    win = (build_window(WindowType(window), plan.nsamp_fft) if window
           else None)
    if plan.npw:
        scale, offset = 1.0, 0.0
    else:
        scale, offset = unpack_affine(plan.nbit, plan.twos_complement)
    cst = MegaConstants.build(plan, resp, scale, offset, window=win).to(
        "cuda")
    ndig = nci * plan.npol * plan.ndim
    if plan.npw:
        raw = ja98_bytes(0, plan.block_ndat(npart), ndig, plan.npw,
                         stretches=[((0,), 8, 40)], seed=int(rng.integers(
                             1 << 20)))
    elif plan.nbit == 32:
        x = rng.normal(0, 20, plan.block_ndat(npart) * ndig)
        raw = torch.from_numpy(x.astype(np.float32).view(np.uint8)).cuda()
    else:
        raw = torch.from_numpy(rng.integers(
            0, 256, raw_nbytes(plan, npart), dtype=np.uint8)).cuda()
    return plan, cst, raw


#: the channel-transposing pre-pass (multi-channel TFP input): every code
#: kind at 2, 3 and 32 complex channels, with an apodization window, and
#: at 2 real channels
FTP_KINDS = [dict(), dict(twos_complement=True), dict(nbit=1), dict(nbit=2),
             dict(nbit=4), dict(nbit=2, twos_complement=True),
             dict(nbit=4, twos_complement=True),
             dict(nbit=2, ndat_per_weight=16), dict(nbit=32)]
FTP_CASES = ([("complex", dict(nchan_in=n, **kw), None)
              for n in (2, 3, 32) for kw in FTP_KINDS]
             + [("complex", dict(nchan_in=n, nbit=4), "hanning")
                for n in (2, 3, 32)]
             + [("real", dict(nchan_in=2, **kw), None) for kw in FTP_KINDS]
             + [("real", dict(nchan_in=2), "tukey")])


def ja98_extras_plain(plan, cst, raw: torch.Tensor, codes: torch.Tensor,
                      nlow: torch.Tensor) -> tuple:
    """The JA98 pre-pass's block weights and channel-transposed copy,
    plain: the least ``weight[nlow]`` over each channel's digitizers
    ``[nchan_in, nweights]``, and the copy's bytes of each channel
    ``[nchan_in, T * unit]`` (its samples' 4 codes in one byte where they
    fill one, else a byte a code; None for one channel), from the block's
    ``raw`` bytes, its ``codes [nchan_in, npol, ndim, T]`` and the plain
    ``nlow``."""
    nci, npd = plan.nchan_in, plan.npol * plan.ndim
    wblk = cst.twobit[2][nlow].reshape(nci, npd, -1).amin(1)
    if nci == 1:
        return wblk, None
    T = codes.shape[-1]
    if npd == 4:
        return wblk, raw.reshape(T, nci).t().contiguous()
    return wblk, codes.reshape(nci, npd, T).transpose(1, 2).reshape(nci, -1)


def ja98_against_plain(what: str, plan, cst, raw: torch.Tensor, npart: int,
                       codes: torch.Tensor) -> tuple:
    """The JA98 pre-pass alone (``ja98_cuda(full=True)``) against plain on
    one block, bit for bit: nlow, window weights, block weights and (with
    nchan_in > 1) the channel-transposed copy the forward half reads.
    Returns the plain nlow and window weights."""
    from dspsr_tpu_torch.kernels.megastep import ja98_cuda
    from dspsr_tpu_torch.ops.megakernel import twobit_plain

    nlow, wwin, wblk, copy = ja98_cuda(plan, cst, raw, npart, full=True)
    pn, pw = twobit_plain(plan, cst, codes, npart)
    pb, pc = ja98_extras_plain(plan, cst, raw, codes, pn)
    torch.cuda.synchronize()
    check(bool(torch.equal(nlow.long(), pn)), f"{what}: nlow")
    check(bool(torch.equal(wwin, pw)), f"{what}: window weights")
    check(bool(torch.equal(wblk, pb)), f"{what}: block weights")
    check((copy is None) == (pc is None)
          and (pc is None or bool(torch.equal(copy[:, :pc.shape[1]], pc))),
          f"{what}: transposed copy")
    return pn, pw


def small_checks_unpack(cases=None) -> None:
    """Both kernels (f32) against their plain versions (f64) at the test
    geometry on every unpack variant (JA98 real and complex, fixed-level
    1/2/4-bit plain and two's complement, float32, apodization windows;
    ``cases``, default UNPACK_CASES): the fold step within TOL_SMALL with
    hits exact, the front end's detected and voltage outputs within
    TOL_SMALL with its weights exactly equal, and the JA98 pre-pass's nlow,
    window and block weights and transposed copy exactly equal
    (:func:`ja98_against_plain`)."""
    from dspsr_tpu_torch.ops.megakernel import (
        build_megafil, build_megastep, bytes_to_codes, megafil_plain,
        megastep_plain)

    npart, nbin = 3, 32
    rng = np.random.default_rng(12)
    phi0 = torch.from_numpy(rng.uniform(0, 1, npart).astype(np.float32)).cuda()
    dphi = torch.full((npart,), 0.013, dtype=torch.float32, device="cuda")
    for kind, kw, window in UNPACK_CASES if cases is None else cases:
        plan, cst, raw = unpack_case(kind, kw, window, npart, rng)
        nci, nsub = plan.nchan_in, plan.nsub
        what = f"small unpack {kind} {kw} window={window}"
        shp = (nci, plan.nplane, nsub, nbin)
        pk, hk = build_megastep(plan, cst, npart)(
            torch.zeros(shp, device="cuda"),
            torch.zeros(nci, nbin, device="cuda"), raw, phi0, dphi)
        pp, hp = megastep_plain(
            plan, cst, torch.zeros(shp, dtype=torch.float64, device="cuda"),
            torch.zeros(nci, nbin, dtype=torch.float64, device="cuda"), raw,
            phi0, dphi)
        errs = [rel_err(pk, pp)]
        hdiff = float((hk.double() - hp).abs().max())
        wdiff = 0.0
        for output in ("detected", "voltage"):
            got, w = build_megafil(plan, cst, npart, output=output,
                                   return_weights=True)(raw)
            want, ww = megafil_plain(plan, cst, raw, npart, torch.float64,
                                     output=output, return_weights=True)
            errs.append(rel_err(got, want))
            wdiff = max(wdiff, float((w - ww).abs().max()))
            check(got.shape == want.shape, f"{what}: {output} shape")
        torch.cuda.synchronize()
        extra = ""
        if plan.npw:
            codes = bytes_to_codes(raw, 2).reshape(
                -1, nci, plan.npol, plan.ndim).permute(1, 2, 3, 0)
            _, pw = ja98_against_plain(what, plan, cst, raw, npart, codes)
            check(float(pw[0, 0]) == 0 and float(pw.sum()) == pw.numel() - 1,
                  f"{what}: excised windows {pw.tolist()}")
            extra = f", window weights {pw.tolist()}"
        print(f"{what}: rel err step {errs[0]:.3e}, front detected "
              f"{errs[1]:.3e}, voltage {errs[2]:.3e}; hits diff {hdiff}, "
              f"weights diff {wdiff}{extra}", flush=True)
        check(bool(torch.isfinite(pk).all()), f"{what}: finite")
        check(max(errs) < TOL_SMALL, f"{what}: {errs} >= {TOL_SMALL}")
        check(hdiff == 0 and wdiff == 0, f"{what}: hits or weights differ")
        check(float(hk.sum()) > 0, f"{what}: hits folded")


def cluster_plan(R2: int, **kw):
    """A complex plan of R1 = 8 and rows of R2 points (N = 8 R2, freq_res
    512, nsub N / 512, no overlap): the row pass's tile below CLUSTER_R2,
    its clusters from there."""
    from dspsr_tpu_torch.ops.megakernel import MegaPlan

    return MegaPlan(nsub=8 * R2 // 512, freq_res=512, R1=8, nfilt_pos=0,
                    nfilt_neg=0, nbin=32, npol=2, real_input=False, **kw)


def small_checks_cluster() -> None:
    """The complex row pass at R1 = 8 and R2 = 2048 (the row tile), 4096
    and 8192 (clusters of 4 one-row CTAs) against plain (f64) within
    TOL_SMALL: the search front end with the passband tap, a masked chirp
    handed in and each store mask (PP keeps pol a, QQ pol b, PPQQ both),
    and the fold step."""
    from dspsr_tpu_torch.kernels.megastep import CLUSTER_R2
    from dspsr_tpu_torch.ops.megakernel import (
        MegaConstants, build_megafil, build_megastep, megafil_plain,
        megastep_plain)

    npart = 2
    rng = np.random.default_rng(14)
    phi0 = torch.from_numpy(rng.uniform(0, 1, npart).astype(np.float32)).cuda()
    dphi = torch.full((npart,), 0.013, dtype=torch.float32, device="cuda")
    for R2 in (2048, 4096, 8192):
        for store, kw in ((1, dict(detection="pp")),
                          (2, dict(detection="qq")), (3, dict(npol_out=2))):
            plan = cluster_plan(R2, **kw)
            check(plan.R1 == 8 and plan.R2 == R2, f"cluster plan {R2}")
            raw = small_raw(plan, npart, rng)
            resp = np.exp(1j * rng.uniform(-3, 3, (plan.nsub,
                                                   plan.freq_res)))
            cst = MegaConstants.build(plan, resp, 1.0, -127.5).to("cuda")
            gr, gi = masked_chirp(cst, rng)
            data, pb = build_megafil(plan, cst, npart, passband=True,
                                     response_as_args=True)(raw, gr, gi)
            want, wpb = megafil_plain(plan, cst, raw, npart, torch.float64,
                                      passband=True, gr=gr.double(),
                                      gi=gi.double())
            shp = (1, plan.nplane, plan.nsub, plan.nbin)
            pk, hk = build_megastep(plan, cst, npart)(
                torch.zeros(shp, device="cuda"),
                torch.zeros(1, plan.nbin, device="cuda"), raw, phi0, dphi)
            pp, hp = megastep_plain(
                plan, cst, torch.zeros(shp, dtype=torch.float64,
                                       device="cuda"),
                torch.zeros(1, plan.nbin, dtype=torch.float64,
                            device="cuda"), raw, phi0, dphi)
            torch.cuda.synchronize()
            errs = (rel_err(data, want), rel_err(pb, wpb), rel_err(pk, pp))
            hdiff = float((hk.double() - hp).abs().max())
            form = "clusters" if R2 >= CLUSTER_R2 else "row tile"
            print(f"small cluster R2 {R2} ({form}) store {store} {kw}: rel "
                  f"err data {errs[0]:.3e}, passband {errs[1]:.3e}, fold "
                  f"{errs[2]:.3e}; hits diff {hdiff}", flush=True)
            check(data.shape == want.shape and pb.shape == wpb.shape,
                  f"cluster R2 {R2} store {store}: shapes")
            check(bool(torch.isfinite(data).all() and torch.isfinite(pb).all()
                       and torch.isfinite(pk).all()),
                  f"cluster R2 {R2} store {store}: finite")
            check(max(errs) < TOL_SMALL,
                  f"cluster R2 {R2} store {store}: {errs} >= {TOL_SMALL}")
            check(hdiff == 0 and float(hk.sum()) > 0,
                  f"cluster R2 {R2} store {store}: hits")


def guppi2_obs():
    """mega_guppi_2bit's input (``bench.py:422-428``): 32 complex 2-bit
    dual-pol channels at 12.5 Msamp/s, -400 MHz at 1382 MHz."""
    from dspsr_tpu_torch.models.load_to_fold import MJD, Observation, Signal

    return Observation(
        nchan=32, npol=2, ndim=2, nbit=2, centre_frequency=1382.0,
        bandwidth=-400.0, rate=12.5e6,
        start_time=MJD.from_utc("2010-04-13-02:05:45"),
        state=Signal.ANALYTIC, source="J0437-4715", telescope="PKS",
        instrument="DUMMY").replace(ndat=1 << 40)


#: saturated stretches of the mega_guppi_2bit checks: (input channel,
#: digitizers of the channel (pol * 2 + dim), first sample, end), whole
#: 256-sample blocks, in blocks 0, 1 and 2 of the stream
GUPPI2_STRETCHES = [(5, (0,), 262144, 266240), (20, (0, 1, 2, 3), 3 << 20,
                                                (3 << 20) + 1024),
                    (31, (3,), 4194304, 4194304 + 512), (0, (1,), 0, 256)]


def guppi2_stretches():
    """GUPPI2_STRETCHES as ``ja98_bytes`` takes them (digitizer indices
    over all channels)."""
    return [([c * 4 + d for d in digs], a, b)
            for c, digs, a, b in GUPPI2_STRETCHES]


def guppi2_source():
    """A ``Source`` of mega_guppi_2bit's JA98 bytes (``ja98_bytes`` with
    GUPPI2_STRETCHES), made on the card and handed over as host bytes."""
    from dspsr_tpu_torch.io.sources import Source

    class Ja98Source(Source):
        def __init__(self):
            self.obs = guppi2_obs()

        @property
        def total_samples(self) -> int:
            return self.obs.ndat

        def read_samples(self, start: int, nsamp: int) -> np.ndarray:
            return ja98_bytes(start, nsamp, 128, 256,
                              guppi2_stretches()).cpu().numpy()

    return Ja98Source()


def guppi2_cfg():
    """mega_guppi_2bit's configuration (``bench.py:429-431, 496-497``): the
    flagship config with 2048 channels (64 a coarse channel), DM 71,
    freq_res 2048, ndat_per_weight 256, 16 windows a block, 1024 bins at
    J0437's period."""
    from dspsr_tpu_torch.models.load_to_fold import FoldConfig

    return FoldConfig(folding_period=0.00575745, dispersion_measure=71.0,
                      nchan=2048, nbin=1024, npol_out=1,
                      frequency_resolution=2048, ndat_per_weight=256,
                      block_parts=16, min_block_samples=0)


def guppi2_pipe():
    """mega_guppi_2bit (:func:`guppi2_cfg`) through ``FoldPipeline`` on the
    card."""
    from dspsr_tpu_torch.models.load_to_fold import FoldPipeline

    pipe = FoldPipeline(guppi2_source(), guppi2_cfg(), device="cuda")
    p = pipe.mega_plan
    check(pipe.mega_mode == "full"
          and (p.nsub, p.R1, p.R2, p.q, p.npw, p.nkeep, pipe.npart,
               pipe.block_in_samples, pipe.stride_in_samples)
          == (64, 512, 256, 4, 256, 2016, 16, 2066432, 2064384),
          f"mega_guppi_2bit geometry {p} npart {pipe.npart}")
    return pipe


def guppi2_expected_weights(pipe, block: int) -> np.ndarray:
    """The window weights [32, npart] that GUPPI2_STRETCHES give block
    ``block``: 0 where a window's samples meet a stretch of its channel."""
    p = pipe.mega_plan
    s0 = block * pipe.stride_in_samples
    w = np.ones((32, pipe.npart), np.float32)
    for c, _, a, b in GUPPI2_STRETCHES:
        for k in range(pipe.npart):
            lo = s0 + k * p.nsamp_step
            if a < lo + p.nsamp_fft and b > lo:
                w[c, k] = 0.0
    return w


def guppi2_block(card: str) -> dict:
    """One mega_guppi_2bit block at full width on JA98 bytes made on the
    card: the fold kernel against its plain version (both f32) within
    TOL_FLAGSHIP, hits exact; the pre-pass's nlow and window weights
    against plain, and the excised windows against those the stretches
    give; then each pass against its bytes and the step against its
    bound."""
    from dspsr_tpu_torch.ops.megakernel import bytes_to_codes, megastep_plain

    pipe = guppi2_pipe()
    plan, cst, npart = pipe.mega_plan, pipe.constants, pipe.npart
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    raw = ja98_bytes(0, pipe.block_in_samples, 128, 256, guppi2_stretches())
    torch.cuda.synchronize()
    gen_s = time.perf_counter() - t0
    check(raw.numel() == block_bytes(pipe), "mega_guppi_2bit raw size")
    phi0, dphi = cyclic_anchors(pipe)
    prof0 = torch.zeros(32, 1, plan.nsub, plan.nbin, device="cuda")
    hits0 = torch.zeros(32, plan.nbin, device="cuda")
    pk, hk = pipe._megastep(prof0, hits0, raw, phi0, dphi)
    pp, hp = megastep_plain(plan, cst, prof0, hits0, raw, phi0, dphi)
    codes = bytes_to_codes(raw, 2).reshape(-1, 32, 2, 2).permute(1, 2, 3, 0)
    # nlow, window and block weights and the transposed copy, bit for bit
    pn, pw = ja98_against_plain("mega_guppi_2bit", plan, cst, raw, npart,
                                codes)
    del codes
    torch.cuda.synchronize()
    err = rel_err(pk, pp)
    abs_err = float((pk - pp).abs().max())
    hdiff = float((hk - hp).abs().max())
    want_w = guppi2_expected_weights(pipe, 0)
    excised = int((pw == 0).sum())
    print(f"mega_guppi_2bit block (nsub {plan.nsub} R1 {plan.R1} R2 "
          f"{plan.R2} npw {plan.npw}, npart {npart}, raw {raw.numel()} B "
          f"made in {gen_s * 1e3:.1f} ms): rel err {err:.3e} (abs "
          f"{abs_err:.3e}), hits diff {hdiff}; excised windows {excised} "
          f"(kernel and plain equal, from the stretches "
          f"{int((want_w == 0).sum())}); nlow range "
          f"{int(pn.min())}-{int(pn.max())}", flush=True)
    check(bool(torch.isfinite(pk).all()), "mega_guppi_2bit finite")
    check(err < TOL_FLAGSHIP, f"mega_guppi_2bit rel err {err} >= "
          f"{TOL_FLAGSHIP}")
    check(hdiff == 0, "mega_guppi_2bit hits differ")
    check(np.array_equal(pw.cpu().numpy(), want_w) and 0 < excised,
          "mega_guppi_2bit excised windows")
    per_chan = hk.sum(1).cpu().numpy()
    check(np.array_equal(per_chan, want_w.sum(1) * plan.nkeep),
          "mega_guppi_2bit hits per channel")

    kernel_ms = cuda_ms(lambda: pipe._megastep(prof0, hits0, raw, phi0,
                                               dphi), 10)
    plain_ms = cuda_ms(lambda: megastep_plain(plan, cst, prof0, hits0, raw,
                                              phi0, dphi), 2)
    times = kernel_breakdown(
        lambda: pipe._megastep(prof0, hits0, raw, phi0, dphi), card,
        label=" (mega_guppi_2bit fold)")
    nbytes = (raw.numel() + 8 * cst.gr.numel() + 4 * cst.twobit.numel()
              + 8 * (prof0.numel() + hits0.numel()) + 8 * phi0.numel())
    bound = bound_of(nbytes, front_ops(plan, npart, 2, 2))
    out_bytes = 8 * (prof0.numel() + hits0.numel())
    print_passes(card, "mega_guppi_2bit", plan, npart, 2, raw.numel(), times,
                 "mega_invfold", out_bytes)
    print_attributes("mega_guppi_2bit", plan, 2, fold=True)
    # each pass's own bytes, the fold's inverse reading the spectra
    total = (sum(v for k, v in forward_passes(plan, npart, 2, 2,
                                              raw.numel()).items()
                 if k != "fused")
             + inverse_bound(plan, npart, 2, out_bytes)["bytes"])
    sky_ms = pipe.stride_in_samples / pipe.obs_in.rate * 1e3
    print(f"mega_guppi_2bit step per block ({sky_ms:.2f} ms of sky): "
          f"{kernel_ms:.3f} ms (bound {bound['bound_ms']:.4f} ms, "
          f"{bound['bound_by']}; passes {total / HBM_BYTES_S * 1e3:.3f} ms "
          f"at 3.35 TB/s); plain {plain_ms:.3f} ms [{card}]", flush=True)
    return dict(max_abs_err=abs_err, ms=kernel_ms, plain_ms=plain_ms,
                **bound, library_ms=None)


def guppi2_path(card: str) -> int:
    """mega_guppi_2bit at full width, 3 blocks through ``FoldPipeline.run``
    on ``guppi2_source`` with torch.fft and torch.matmul disabled: the full
    engine, 3 megastep and 3 JA98 pre-pass launches, no megafil; finite,
    not flat profiles, and per-channel hits short by the windows the
    stretches excise.  Returns the megastep launches."""
    from dspsr_tpu_torch import launch_counts, reset_launch_counts

    nblocks = 3
    pipe = guppi2_pipe()
    reset_launch_counts()
    with NoLibraryFFT():
        t0 = time.perf_counter()
        res = pipe.run(max_blocks=nblocks)
        wall = time.perf_counter() - t0
    counts = launch_counts()
    check(counts["megastep"] == nblocks and counts["mega_ja98"] == nblocks,
          f"mega_guppi_2bit launches {counts}")
    check(counts["megafil"] == 0, "mega_guppi_2bit: megafil launched")
    check(res.profiles.shape == (1, 2048, 1, pipe.nbin),
          f"mega_guppi_2bit profiles shape {res.profiles.shape}")
    check(bool(np.isfinite(res.profiles).all()), "mega_guppi_2bit non-finite")
    prof = res.normalized()[0, :, 0, :]
    check(bool((prof.std(axis=1) > 0).all()), "mega_guppi_2bit flat profiles")
    per_chan = res.hits.sum(axis=(0, 2))[::64]  # one output channel each
    want = sum(guppi2_expected_weights(pipe, b).sum(1)
               for b in range(nblocks)) * pipe.mega_plan.nkeep
    full = nblocks * pipe.out_per_block
    short = {c: int(full - per_chan[c]) for c in range(32)
             if per_chan[c] != full}
    check(np.array_equal(per_chan, want), f"mega_guppi_2bit hits per "
          f"channel {per_chan.tolist()} != {want.tolist()}")
    check(sorted(short) == sorted({c for c, *_ in GUPPI2_STRETCHES}),
          f"mega_guppi_2bit channels short of hits {short}")
    msps = nblocks * pipe.stride_in_samples / wall / 1e6
    print(f"mega_guppi_2bit: {nblocks} blocks, {counts['megastep']} megastep "
          f"and {counts['mega_ja98']} mega_ja98 launches; hits short by "
          f"channel {short} of {full}; host-fed (bytes made on the card, "
          f"through the host) incl. first-block warm-up {msps:.2f} Msamp/s "
          f"a channel, {msps / (pipe.obs_in.rate / 1e6):.4f} x real time "
          f"[{card}]", flush=True)
    return counts["megastep"]


def guppi2_rates(card: str) -> None:
    """Device-fed rate of mega_guppi_2bit (JA98 bytes made on the card,
    then the fold step, warm) against 12.5 Msamp/s a channel, with the
    generator's time and the step's time apart, and peak device memory."""
    pipe = guppi2_pipe()
    plan = pipe.mega_plan
    nbytes = block_bytes(pipe)
    phi0, dphi = cyclic_anchors(pipe)
    prof = torch.zeros(32, 1, plan.nsub, plan.nbin, device="cuda")
    hits = torch.zeros(32, plan.nbin, device="cuda")

    def make(b):
        s = b * pipe.stride_in_samples
        return ja98_bytes(s, pipe.block_in_samples, 128, 256,
                          guppi2_stretches())

    def block(b):
        return pipe._megastep(prof, hits, make(b), phi0, dphi)

    block(0)
    nb = 4
    it = iter(range(1, nb + 1))
    ms = cuda_ms(lambda: block(next(it)), nb)
    raw0 = make(0)
    check(raw0.numel() == nbytes, "mega_guppi_2bit block bytes")
    step_ms = cuda_ms(lambda: pipe._megastep(prof, hits, raw0, phi0, dphi),
                      nb)
    gen_ms = cuda_ms(lambda: make(0), 2)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    pipe._megastep(prof, hits, raw0, phi0, dphi)
    torch.cuda.synchronize()
    peak_mb = (torch.cuda.max_memory_allocated() - base) / 2**20
    msps = pipe.stride_in_samples / (ms * 1e-3) / 1e6
    step_msps = pipe.stride_in_samples / (step_ms * 1e-3) / 1e6
    rt = pipe.obs_in.rate / 1e6  # the recording rate, Msamp/s a channel
    print(f"mega_guppi_2bit device-fed (ja98_bytes on the card, then the "
          f"step): {ms:.3f} ms a block ({pipe.stride_in_samples / rt / 1e3:.2f}"
          f" ms of sky), {msps:.1f} Msamp/s a channel, {msps / rt:.3f} x real"
          f" time; the generator {gen_ms:.3f} ms, the step alone "
          f"{step_ms:.3f} ms ({step_msps:.1f} Msamp/s a channel, "
          f"{step_msps / rt:.2f} x real time); peak device memory of a step "
          f"{peak_mb:.0f} MiB; real time is {rt:g} Msamp/s [{card}]",
          flush=True)


# --------------------------------------------------------------------------
# the general chain (no fused kernel): xla_general, xla_sk_weights, and the
# search configurations neither fused kernel takes


#: bench.py:456-460 and 500-504, at the flagship's own block (bench.py cut
#: them to 2^23 and 2^23 samples for the TPU's memory; the card needs no cut)
GENERAL = {"xla_general": {},
           "xla_sk_weights": dict(sk_enable=True, sk_m=1024)}
FUSED_KERNELS = ("megastep", "megafil", "mega_ja98")


def general_pipe(name: str, device: str = "cuda"):
    from dspsr_tpu_torch.io.sources import DummySource
    from dspsr_tpu_torch.models.load_to_fold import FoldPipeline

    pipe = FoldPipeline(DummySource(flagship_obs()), flagship_cfg(
        use_megakernel=False, **GENERAL[name]), device=device)
    check(pipe.mega_mode is None, f"{name}: mega_mode {pipe.mega_mode}")
    return pipe


def general_fold(pipe, raw, phi0, dphi, weights=None):
    """One block of ``pipe`` through the general chain and the fold into
    zeroed accumulators: ``(profiles, hits, weights)``; ``weights``, when
    given, replace the block's own fold weights."""
    d, w, wp, _ = pipe._general_block(raw)
    w = w if weights is None else weights.to(w.device)
    p, h = pipe._fold_tail_d(torch.zeros_like(pipe._profiles),
                             torch.zeros_like(pipe._hits), d, w, wp, phi0,
                             dphi)
    return p, h, w


def no_fused_launches(name: str) -> None:
    from dspsr_tpu_torch import launch_counts

    counts = launch_counts()
    check(all(counts[k] == 0 for k in FUSED_KERNELS),
          f"{name}: fused kernels launched on the general chain: {counts}")


def general_block(card: str, name: str) -> None:
    """One flagship block of the general chain on the card against the same
    chain on the CPU from the same bytes: no fused launch, profiles within
    TOL_FLAGSHIP, hits exact.  SK masks are taken on each device from its
    own power; a cell on the threshold can flip between the two FFTs, so
    the cells that differ are counted, and the profiles are also compared
    with the card's weights on both sides."""
    from dspsr_tpu_torch import reset_launch_counts
    from dspsr_tpu_torch.io.sources import device_noise_bytes

    pipe = general_pipe(name)
    raw = device_noise_bytes(0, block_bytes(pipe), "cuda")
    phi0, dphi = cyclic_anchors(pipe)
    reset_launch_counts()
    pk, hk, wk = general_fold(pipe, raw, phi0, dphi)
    torch.cuda.synchronize()
    no_fused_launches(name)
    cpipe = general_pipe(name, device="cpu")
    t0 = time.perf_counter()
    pc, hc, wc = general_fold(cpipe, raw.cpu(), phi0.cpu(), dphi.cpu())
    cpu_s = time.perf_counter() - t0
    ps, hs, _ = general_fold(cpipe, raw.cpu(), phi0.cpu(), dphi.cpu(),
                             weights=wk)
    wdiff = int((wk.cpu() != wc).sum())
    err, err_same = rel_err(pk.cpu(), pc), rel_err(pk.cpu(), ps)
    hdiff = int((hk.cpu() != hc).sum())
    fb = pipe.fb_plan
    print(f"{name} block: general chain, nsub {fb.nchan_subband} freq_res "
          f"{fb.freq_res} nkeep {fb.nkeep}, npart {pipe.npart}, "
          f"{pipe.block_in_samples} samples a block ({raw.numel()} B), "
          f"{pipe.out_per_block} outputs a channel, anchors every "
          f"{pipe.fold_plan.seg_len}; card against CPU ({cpu_s:.2f} s): "
          f"profiles rel err {err:.3e} (with the card's weights "
          f"{err_same:.3e}), hit bins differing {hdiff} of {hk.numel()}, "
          f"weights differing {wdiff} of {wk.numel()} samples; hits sum "
          f"{float(hk.sum())}", flush=True)
    check(bool(torch.isfinite(pk).all()), f"{name}: non-finite profiles")
    check(err_same < TOL_FLAGSHIP and bool((hk.cpu() == hs).all()),
          f"{name}: card against CPU with the same weights: {err_same}")
    # without SK the weights are the same on both devices by construction
    check(wdiff <= (pipe.sk_plan.M * 8 if pipe.sk_plan else 0),
          f"{name}: {wdiff} weights differ")
    if wdiff == 0:
        check(err < TOL_FLAGSHIP and hdiff == 0,
              f"{name}: card against CPU {err}, {hdiff} hit bins")
    if pipe.sk_plan is None:
        check(float(hk.sum()) == 64 * pipe.out_per_block,
              f"{name}: hit total {float(hk.sum())}")


def general_path(card: str, name: str) -> None:
    """3 flagship blocks of the general chain through ``FoldPipeline.run``:
    no fused launch, finite and not flat profiles, every output sample
    folded (fewer with SK)."""
    from dspsr_tpu_torch import reset_launch_counts

    nblocks = 3
    pipe = general_pipe(name)
    reset_launch_counts()
    t0 = time.perf_counter()
    res = pipe.run(max_blocks=nblocks)
    wall = time.perf_counter() - t0
    no_fused_launches(name)
    check(res.profiles.shape == (1, 64, 1, 1024),
          f"{name} profiles shape {res.profiles.shape}")
    check(bool(np.isfinite(res.profiles).all()), f"{name} non-finite")
    per_chan = res.hits.sum(axis=(0, 2))
    full = nblocks * pipe.out_per_block
    if pipe.sk_plan is None:
        check(bool((per_chan == full).all()), f"{name} hits {per_chan[:4]}")
    else:
        check(bool((per_chan > 0).all() and (per_chan <= full).all()),
              f"{name} hits {per_chan[:4]}")
    prof = res.normalized()[0, :, 0, :]
    check(bool((prof.std(axis=1) > 0).all()), f"{name} flat profiles")
    msps = nblocks * pipe.stride_in_samples / wall / 1e6
    print(f"{name} path: {nblocks} blocks, no fused launch; hits/chan min "
          f"{int(per_chan.min())} max {int(per_chan.max())} of {full}; SK "
          f"cells zapped {pipe.zapped_share()['sk']}; host-fed incl. "
          f"first-block warm-up {msps:.1f} Msamp/s, {msps / 800:.4f} x real "
          f"time [{card}]", flush=True)


def general_rates(card: str, name: str) -> None:
    """Device-fed rate of the general chain (device noise bytes, then the
    chain and the fold, warm), the step alone with CUDA events, its largest
    kernels by torch.profiler and its peak device memory."""
    from dspsr_tpu_torch.io.sources import device_noise_bytes

    pipe = general_pipe(name)
    nbytes = block_bytes(pipe)
    phi0, dphi = cyclic_anchors(pipe)

    def step(raw):
        d, w, wp, _ = pipe._general_block(raw)
        pipe._profiles, pipe._hits = pipe._fold_tail_d(
            pipe._profiles, pipe._hits, d, w, wp, phi0, dphi)

    def block(b):
        step(device_noise_bytes(b * nbytes, nbytes, "cuda"))

    block(0)
    nb = 6
    it = iter(range(1, nb + 1))
    ms = cuda_ms(lambda: block(next(it)), nb)
    raw0 = device_noise_bytes(0, nbytes, "cuda")
    step_ms = cuda_ms(lambda: step(raw0), nb)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    step(raw0)
    torch.cuda.synchronize()
    peak_mb = (torch.cuda.max_memory_allocated() - base) / 2**20
    msps = pipe.stride_in_samples / (ms * 1e-3) / 1e6
    step_msps = pipe.stride_in_samples / (step_ms * 1e-3) / 1e6
    print(f"{name} device-fed (device_noise_bytes, general chain + fold): "
          f"{ms:.3f} ms a block ({pipe.stride_in_samples / 800e3:.2f} ms of "
          f"sky), {msps:.1f} Msamp/s, {msps / 800:.3f} x real time; the step "
          f"alone {step_ms:.3f} ms ({step_msps / 800:.3f} x real time); "
          f"peak device memory of a step {peak_mb:.0f} MiB; real time is 800 "
          f"Msamp/s [{card}]", flush=True)
    kernel_breakdown(lambda: step(raw0), card, label=f" ({name})",
                     others=True)


def search_device_fed(pipe, nb: int = 6) -> float:
    """Device-fed Msamp/s of a search pipeline (device noise bytes, the
    step, rescale, digitize, bytes to host; warm, host clock)."""
    from dspsr_tpu_torch.io.sources import device_noise_bytes

    nbytes = block_bytes(pipe)
    state = (pipe._rescale_state, pipe._mean, pipe._inv)

    def block(b):
        raw = device_noise_bytes(b * nbytes, nbytes, "cuda")
        *_, packed = pipe._step(*state, raw, "cumulative")
        return packed.cpu()

    block(0)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for b in range(1, nb + 1):
        block(b)
    wall = time.perf_counter() - t0
    return nb * pipe.stride_in_samples / wall / 1e6


#: digifil on the flagship input with no -D (freq_res == 1: the plain
#: critically sampled search filterbank), and at DM 2.64 with Coherence
#: output (-d 4); neither runs on the fused front end
GENERAL_SEARCH = {"search_nodm": dict(dispersion_measure=0.0),
                  "search_coherence": dict(npol_out=4)}


def general_search(card: str) -> None:
    """Each ``GENERAL_SEARCH`` cell: one block's bytes on the card against
    the CPU from the same bytes (within 1 LSB, at least 99% exact) and the
    device-fed rate; ``search_nodm`` also writes 3 blocks to a SIGPROC file
    through ``FilPipeline.run``.  No fused launch."""
    import dataclasses

    from dspsr_tpu_torch import reset_launch_counts
    from dspsr_tpu_torch.io.sigproc import read_sigproc_header
    from dspsr_tpu_torch.io.sources import DummySource, device_noise_bytes
    from dspsr_tpu_torch.models.load_to_fil import FilPipeline

    for name, kw in GENERAL_SEARCH.items():
        cfg = dataclasses.replace(search_cfg(), **kw)
        pipe, cpipe = (FilPipeline(DummySource(flagship_obs()), cfg,
                                   device=dev) for dev in ("cuda", "cpu"))
        check(pipe.megafil_plan is None, f"{name}: fused front end chosen")
        o = pipe.obs_out
        raw = device_noise_bytes(0, block_bytes(pipe), "cuda")
        reset_launch_counts()
        got = pipe._step(pipe._rescale_state, pipe._mean, pipe._inv, raw,
                         "cumulative")[-1].cpu().numpy()
        no_fused_launches(name)
        t0 = time.perf_counter()
        want = cpipe._step(cpipe._rescale_state, cpipe._mean, cpipe._inv,
                           raw.cpu(), "cumulative")[-1].numpy()
        cpu_s = time.perf_counter() - t0
        check(got.size == want.size == o.nchan * o.npol * pipe.npart
              * pipe.fb_plan.nkeep, f"{name}: block bytes {got.size}")
        mx, exact = close_bytes(f"{name} against the CPU", got, want)
        nout = got.size // (o.nchan * o.npol)
        print(f"{name} block: freq_res {pipe.fb_plan.freq_res}, npart "
              f"{pipe.npart}, {pipe.block_in_samples} samples a block, "
              f"{o.nchan} chans x {o.npol} pols x {nout} samples; card "
              f"against CPU ({cpu_s:.2f} s): max diff {mx} LSB, "
              f"{exact:.6f} exact; bytes mean {float(got.mean()):.4f} std "
              f"{float(got.std()):.4f}", flush=True)
        if name == "search_nodm":
            nblocks = 3
            with tempfile.TemporaryDirectory() as tmp:
                out = os.path.join(tmp, "nodm.fil")
                reset_launch_counts()
                t0 = time.perf_counter()
                pipe.run(out, max_blocks=nblocks)
                wall = time.perf_counter() - t0
                no_fused_launches(name)
                items, hdr = read_sigproc_header(out)
                size = os.path.getsize(out)
            check(size == hdr + nblocks * got.size,
                  f"{name}: file {size} != {hdr} + {nblocks} x {got.size}")
            check(int(items["nchans"]) == 64 and int(items["nbits"]) == 8,
                  f"{name}: header {items}")
            host = nblocks * pipe.stride_in_samples / wall / 1e6
            print(f"{name} path: {nblocks} blocks to {size} B (header {hdr}),"
                  f" nchans {items['nchans']} tsamp {items['tsamp']}, no "
                  f"fused launch; host-fed incl. first-block warm-up "
                  f"{host:.1f} Msamp/s, {host / 800:.4f} x real time "
                  f"[{card}]", flush=True)
        msps = search_device_fed(pipe)
        step_ms = cuda_ms(lambda: pipe._step(
            pipe._rescale_state, pipe._mean, pipe._inv, raw, "cumulative"), 6)
        sky_ms = pipe.stride_in_samples / 800e3
        print(f"{name} device-fed (device_noise_bytes, step, rescale, "
              f"digitize, bytes to host): {msps:.1f} Msamp/s "
              f"({msps / 800:.3f} x real time); the step alone (CUDA "
              f"events, no copy to the host) {step_ms:.3f} ms a block of "
              f"{sky_ms:.2f} ms of sky ({sky_ms / step_ms:.3f} x real time) "
              f"[{card}]", flush=True)
        kernel_breakdown(lambda: pipe._step(
            pipe._rescale_state, pipe._mean, pipe._inv, raw, "cumulative"),
            card, label=f" ({name})", others=True)


# ---- the dspsr CLI and the diagnostics tools, driven as a user runs them ----

#: ``dspsr`` on the flagship input as a user asks for it
#: (``mega_real_8bit``): ``-U 134.217728`` MB is ``min_block_samples``
#: 2^25, so the argv gives ``flagship_cfg()`` exactly
CLI_FOLD = ["-F", "64:D", "-D", "2.64", "-c", "0.00575745", "-b", "1024",
            "--block-parts", "8"]
CLI_MB = "134.217728"


def write_dada(path: str, obs, nsamp: int, device) -> None:
    """A DADA file of ``nsamp`` samples of ``obs`` from
    ``device_noise_bytes`` (made on ``device`` in 64 MB pieces)."""
    from dspsr_tpu_torch.io.dada import (format_ascii_header,
                                         header_from_observation)
    from dspsr_tpu_torch.io.sources import device_noise_bytes

    nbytes = int(nsamp * obs.nbytes_per_sample)
    with open(path, "wb") as f:
        f.write(format_ascii_header(header_from_observation(obs)))
        for s in range(0, nbytes, 1 << 26):
            f.write(device_noise_bytes(s, min(1 << 26, nbytes - s),
                                       device).cpu().numpy().tobytes())


def run_cli(main, argv, guard: bool):
    """``main(argv)`` (a CLI's entry point) with its standard output and
    error captured, inside ``NoLibraryFFT`` when ``guard``: (stdout,
    stderr, wall seconds).  Fails unless it returns 0."""
    out, err = io.StringIO(), io.StringIO()
    with contextlib.ExitStack() as stack:
        if guard:
            stack.enter_context(NoLibraryFFT())
        stack.enter_context(contextlib.redirect_stdout(out))
        stack.enter_context(contextlib.redirect_stderr(err))
        t0 = time.perf_counter()
        rc = main(argv)
        wall = time.perf_counter() - t0
    check(rc == 0, f"{argv[:1]} {argv[1:4]}...: exit {rc}: "
          f"{err.getvalue()[-400:]}")
    return out.getvalue(), err.getvalue(), wall


NUMBER = re.compile(r"[-+]?\d+\.?\d*(?:[eE][-+]?\d+)?")


def same_printed(a: str, b: str, rel: float) -> None:
    """Two tools' outputs alike but for their numbers: integers equal,
    floats within ``rel`` relative or one unit of their printed last
    digit."""
    check(NUMBER.sub("#", a) == NUMBER.sub("#", b), "printed text differs")
    for x, y in zip(NUMBER.findall(a), NUMBER.findall(b)):
        if "." not in x and "e" not in x.lower():
            check(x == y, f"printed count {x} != {y}")
            continue
        step = 10.0 ** -len(x.split(".")[1].split("e")[0])
        check(abs(float(x) - float(y)) <= rel * max(abs(float(x)),
                                                    abs(float(y)))
              + 1.0001 * step, f"printed {x} != {y}")


def same_archive(name: str, got: dict, want, tol: float) -> float:
    """A CLI's npz (``load_archive``) against the API's ``FoldResult``:
    profiles within ``tol`` of the largest magnitude, hits exact; returns
    the relative difference."""
    check(got["profiles"].shape == want.profiles.shape,
          f"{name}: shape {got['profiles'].shape} != "
          f"{want.profiles.shape}")
    err = float(np.abs(got["profiles"] - want.profiles).max()
                / np.abs(want.profiles).max())
    check(bool(np.isfinite(got["profiles"]).all()), f"{name}: non-finite")
    check(err < tol, f"{name}: CLI against API {err} >= {tol}")
    check(bool(np.array_equal(got["hits"], want.hits)),
          f"{name}: hits differ from the API run's")
    return err


def host_stages(path: str, pipe, card: str) -> None:
    """What the host does for one block of ``pipe`` from the file at
    ``path``, each stage timed alone (the second of two runs): the read,
    the digitizer byte counts and the copy to the device."""
    from dspsr_tpu_torch.io.sources import open_source

    src = open_source(path)
    for _ in range(2):
        t0 = time.perf_counter()
        raw = src.read_samples(0, pipe.block_in_samples)
        t1 = time.perf_counter()
        np.bincount(raw, minlength=256)
        t2 = time.perf_counter()
        pipe.to_device(raw)
        if pipe.device.type == "cuda":
            torch.cuda.synchronize()
        t3 = time.perf_counter()
    print(f"cli host stages of one block ({raw.nbytes / 1e6:.1f} MB): read "
          f"{(t1 - t0) * 1e3:.1f} ms, digitizer byte counts (np.bincount) "
          f"{(t2 - t1) * 1e3:.1f} ms, pinned copy to the device "
          f"{(t3 - t2) * 1e3:.1f} ms [{card}]", flush=True)


def cli_phase(card: str) -> dict:
    """The port's ``dspsr`` CLI (``apps/dspsr_app.py``) and diagnostics
    tools on a DADA file of the flagship input, as a user runs them: the
    flagship fold (``megastep`` once a block, ``mega_mode`` full), ``--skz``
    (``megafil``) and ``--fft-bench``, each against ``FoldPipeline`` on
    the same file and ``FoldConfig``, and the fused step at the length
    ``--fft-bench`` chose against its plain version; ``-G`` (the
    phase-locked filterbank), ``digistat`` and ``passband`` on the card
    against the CPU; ``-t 2`` where two cards are visible.  Returns the
    kernels' launches of the CLI runs."""
    from dspsr_tpu_torch import launch_counts, reset_launch_counts
    from dspsr_tpu_torch.apps import diagnostics, dspsr_app
    from dspsr_tpu_torch.io.archive import load_archive
    from dspsr_tpu_torch.io.sources import DummySource, open_source
    from dspsr_tpu_torch.models.load_to_fold import FoldPipeline
    from dspsr_tpu_torch.ops.megakernel import megastep_plain
    from dspsr_tpu_torch.unpack.unpackers import digitizer_histogram
    from dspsr_tpu_torch.utils.optimalfft import FFTBench

    device, other, nblocks = "cuda", "cpu", 3
    base = CLI_FOLD + ["-U", CLI_MB]

    def cli_pipe(argv: list, src=None) -> FoldPipeline:
        """``FoldPipeline`` on the card with the CLI's config for ``argv``,
        reading ``src`` (the file ``argv[0]`` by default)."""
        return FoldPipeline(src or open_source(argv[0]), dspsr_app.fold_config(
            dspsr_app.build_parser().parse_args(argv)), device=device)

    probe = cli_pipe(["x", *base], DummySource(flagship_obs()))
    nsamp = (nblocks - 1) * probe.stride_in_samples + probe.block_in_samples
    launches = dict(megastep=0, megafil=0)
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "flagship.dada")
        t0 = time.perf_counter()
        write_dada(path, flagship_obs(), nsamp, device)
        print(f"cli: {path}: {nsamp} samples ({nblocks} blocks, "
              f"{os.path.getsize(path) / 1e6:.1f} MB) written in "
              f"{time.perf_counter() - t0:.2f} s", flush=True)

        def fold(name: str, extra: list) -> FoldPipeline:
            """``dspsr path base+extra`` against ``FoldPipeline.run`` on
            the same config: the same archive, and one launch a block of
            the engine's kernel (none on the general chain)."""
            argv = [path, *base, *extra]
            t0 = time.perf_counter()
            pipe = cli_pipe(argv)
            reset_launch_counts()
            res = pipe.run()
            api_wall = time.perf_counter() - t0
            api = launch_counts()
            out = os.path.join(tmp, f"{name}.npz")
            reset_launch_counts()
            _, err, wall = run_cli(
                dspsr_app.main, [*argv, "-O", out, "--device", device],
                pipe.mega_mode is not None)
            got = launch_counts()
            for k in launches:
                launches[k] += got[k]
            nb = (nsamp - pipe.block_in_samples) // pipe.stride_in_samples + 1
            check(nb >= 1, f"{name}: a block of {pipe.block_in_samples} "
                  f"samples does not fit the file's {nsamp}")
            kernel = {"full": "megastep", "hybrid": "megafil"}.get(
                pipe.mega_mode)
            want = {k: nb if k == kernel else 0 for k in launches}
            check({k: got[k] for k in launches} == want,
                  f"{name}: CLI launches {got}, want {want}")
            check(got == api, f"{name}: CLI launches {got} != API {api}")
            check(f"engine {pipe.mega_mode or 'general'} on" in err,
                  f"{name}: engine line missing: {err[-300:]}")
            rel = same_archive(name, load_archive(out), res, TOL_FLAGSHIP)
            msps = nb * pipe.stride_in_samples / wall / 1e6
            api_msps = nb * pipe.stride_in_samples / api_wall / 1e6
            print(f"cli {name} (dspsr {' '.join(base + extra)}): engine "
                  f"{pipe.mega_mode}, freq_res {pipe.fb_plan.freq_res}, "
                  f"{nb} blocks, launches { {k: got[k] for k in launches} }"
                  f"; CLI wall {wall:.3f} s, host-fed {msps:.1f} Msamp/s "
                  f"({msps / 800:.4f} x real time); the API run (construct "
                  f"+ run) {api_wall:.3f} s, {api_msps:.1f} Msamp/s; "
                  f"archive against the API {rel:.3e}, hits exact "
                  f"[{card}]", flush=True)
            return pipe

        pipe = fold("fold", [])
        check(pipe.mega_mode == "full", f"cli fold: {pipe.mega_mode}")
        host_stages(path, pipe, card)
        _, err, wall = run_cli(dspsr_app.main, [
            path, *base, "-r", "-O", os.path.join(tmp, "r.npz"),
            "--device", device], True)
        report = err[err.index("run report:"):].strip().splitlines()
        print(f"cli fold -r ({wall:.3f} s): "
              + "; ".join(" ".join(l.split()) for l in report[1:]
                          if not l.startswith("dspsr:")),
              flush=True)
        skz = fold("skz", ["--skz", "--skzm", "1024"])
        check(skz.mega_mode == "hybrid", f"cli skz: {skz.mega_mode}")

        # --fft-bench: the bench fills the cost table (it calls torch.fft),
        # so it runs before the guarded CLI run, which then reads it
        t0 = time.perf_counter()
        probe = cli_pipe([path, *base, "--fft-bench"])
        bench = FFTBench(device)
        print(f"cli fft-bench: cost table ({bench._cache_path.name}, "
              f"{time.perf_counter() - t0:.2f} s with the bench): "
              + ", ".join(f"{n}: {t * 1e9:.2f} ns"
                          for n, t in sorted(bench._table.items()))
              + f"; chosen freq_res {probe.fb_plan.freq_res} (default "
              f"{pipe.fb_plan.freq_res}), engine {probe.mega_mode} "
              f"[{card}]", flush=True)
        fb = fold("fft_bench", ["--fft-bench"])
        check(fb.mega_mode in ("full", None),
              f"cli fft_bench: engine {fb.mega_mode}")
        # the fused step at the chosen length (the CLI run above launched it
        # there) against its plain version on the file's first block, and
        # its time beside the flagship's default 4096 and 8192
        src = open_source(path)
        chosen = fb.fb_plan.freq_res if fb.mega_mode else None
        for n in sorted({4096, 8192} | ({chosen} if chosen else set())):
            p = fb if n == chosen else cli_pipe([path, *base, "-x", str(n)])
            check(p.mega_mode == "full" and p.fb_plan.freq_res == n,
                  f"cli -x {n}: engine {p.mega_mode}, {p.fb_plan.freq_res}")
            raw = p.to_device(src.read_samples(0, p.block_in_samples))
            args, _ = step_against_plain(
                p, raw, f"cli fft_bench {n}",
                f"cli --fft-bench: megastep at freq_res {n}"
                f"{' (chosen)' if n == chosen else ''} on the file's first "
                f"block ({raw.numel()} B) against plain")
            ms = cuda_ms(lambda: p._megastep(*args), 10)
            plain = cuda_ms(
                lambda: megastep_plain(p.mega_plan, p.constants, *args), 3)
            print(f"cli --fft-bench: megastep at freq_res {n}: {ms:.3f} ms "
                  f"a block of {p.stride_in_samples} samples, "
                  f"{ms * 1e6 / p.stride_in_samples:.4f} ns a sample (plain "
                  f"{plain:.3f} ms) [{card}]", flush=True)

        # -G: the phase-locked filterbank on the card against the CPU
        outs = {}
        for dev in (device, other):
            out = os.path.join(tmp, f"plfb_{dev}.npz")
            _, _, wall = run_cli(dspsr_app.main, [
                path, "-c", "0.00575745", "-G", "64", "--plfb-chan", "1024",
                "-T", "0.02", "-O", out, "-q", "--device", dev], False)
            with np.load(out) as z:
                outs[dev] = (z["spectra"], z["hits"], wall)
        (sa, ha, wa), (sb, hb, wb) = outs[device], outs[other]
        err = float(np.abs(sa - sb).max() / np.abs(sb).max())
        print(f"cli plfb (-G 64 --plfb-chan 1024 -T 0.02): spectra "
              f"{sa.shape}, {int(ha.sum())} windows; {device} {wa:.3f} s, "
              f"{other} {wb:.3f} s; {device} against {other} {err:.3e}, "
              f"hits exact [{card}]", flush=True)
        check(bool(np.isfinite(sa).all()) and err < 2e-4,
              f"cli plfb: {err}")
        check(bool(np.array_equal(ha, hb)) and ha.sum() > 0,
              "cli plfb: hits differ")

        # digistat and passband on the card against the CPU: printed
        # numbers, and the unrounded statistics, counts and bandpass
        src = open_source(path)
        for tool, argv in (("digistat", [path, "-n", str(1 << 20)]),
                           ("passband", [path, "-F", "256", "-n",
                                         str(1 << 20)])):
            a, _, wa = run_cli(getattr(diagnostics, tool),
                               [*argv, "--device", device], False)
            b, _, wb = run_cli(getattr(diagnostics, tool),
                               [*argv, "--device", other], False)
            same_printed(a, b, 1e-5)
            print(f"cli {tool}: {device} {wa * 1e3:.1f} ms, {other} "
                  f"{wb * 1e3:.1f} ms, {len(a.splitlines())} lines alike "
                  f"[{card}]", flush=True)
        got = {}
        for dev in (device, other):
            raw, x, _ = diagnostics._unpack(src, 0, 1 << 20, dev)
            got[dev] = (diagnostics.sample_stats(x),
                        digitizer_histogram(raw, 8).cpu().numpy(),
                        diagnostics.bandpass(x, 256, True))
        (sa, ha, ba), (sb, hb, bb) = got[device], got[other]
        serr = max(float(np.abs(sa[k] - sb[k]).max()
                         / max(np.abs(sb[k]).max(), 1e-30)) for k in sa)
        berr = float(np.abs(ba - bb).max() / np.abs(bb).max())
        print(f"cli digistat/passband unrounded: statistics {serr:.3e}, "
              f"bandpass {berr:.3e}, histogram exact ({int(ha.sum())} "
              f"codes)", flush=True)
        check(serr < 1e-5 and berr < 1e-5, f"cli stats {serr}, {berr}")
        check(bool(np.array_equal(ha, hb)), "cli histogram differs")
        print("cli searchplot: not driven on the card (its PNGs need "
              "matplotlib, which the card's machine lacks); the CPU tests "
              "hold it against the JAX app", flush=True)

        if torch.cuda.device_count() >= 2:
            out = os.path.join(tmp, "t2.npz")
            reset_launch_counts()
            _, _, wall = run_cli(dspsr_app.main, [
                path, *base, "-t", "2", "-O", out, "-q"], True)
            got = launch_counts()
            launches["megastep"] += got["megastep"]
            ref = cli_pipe([path, *base]).run()
            rel = same_archive("t2", load_archive(out), ref, TOL_FLAGSHIP)
            print(f"cli -t 2: {torch.cuda.device_count()} cards, "
                  f"{got['megastep']} megastep launches, {wall:.3f} s, "
                  f"against one card {rel:.3e} [{card}]", flush=True)
        else:
            print(f"cli -t 2: not run ({torch.cuda.device_count()} CUDA "
                  f"card(s) visible; it needs 2)", flush=True)
    return launches


# ---- the live rings: the flagship fold and search read while written ----


def live_key() -> int:
    """live_phase's SysV key, one per process, so that two checkouts
    running this script on one machine never share a ring: its hdu takes
    key + 1 for the header and key + 0x100 * (i + 1) for buffer i, all
    inside its 0x2000 span of [0x7E000000, 0x80000000), clear of
    psrdada's default 0xDADA and of the tests' keys (below 0x20000000)."""
    return 0x7E000000 + (os.getpid() % 4096) * 0x2000


#: bytes a ring buffer (4 MiB) and buffers a ring, where room allows
RING_BUF = 4 << 20
RING_DEPTH = 16
#: seconds a live reader waits for a buffer; at the end of the data a SysV
#: pop waits this long before it reports the end (``dada_pop``)
LIVE_TIMEOUT = 3.0

#: the ring writer, a separate process: ``python -c WRITER <DADA file>
#: <ring> <buffer bytes> <buffers>`` pushes every whole buffer of the file
#: into a SysV hdu (ring ``0x<key>``) or a POSIX ring (``/<name>``), then
#: signals the end of the data; it refuses any import of jax or dspsr_tpu
WRITER = r"""
import importlib.abc, os, sys, time


class Refuse(importlib.abc.MetaPathFinder):
    def find_spec(self, name, path=None, target=None):
        if name.split(".")[0] in ("jax", "dspsr_tpu"):
            raise ImportError(f"the ring writer imported {name}")
        return None


sys.meta_path.insert(0, Refuse())
sys.path.insert(0, os.getcwd())
from dspsr_tpu_torch.io.hostio import DadaWriter, RingWriter
from dspsr_tpu_torch.io.sources import open_source

path, ring, buf_bytes, nbufs = sys.argv[1], sys.argv[2], *map(int, sys.argv[3:])
src = open_source(path)
n = buf_bytes // src.bytes_per_sample_exact()
sysv = ring.lower().startswith("0x")
if sysv:
    w = DadaWriter(int(ring, 16), src.obs, buf_bytes, nbufs=nbufs)
else:
    w = RingWriter(ring, src.obs, buf_bytes, nbufs=nbufs)
t_end = time.time() + 300.0
read_s = push_s = 0.0
t0 = time.perf_counter()
try:
    for i in range(src.total_samples // n):
        t1 = time.perf_counter()
        buf = src.read_samples(i * n, n)
        t2 = time.perf_counter()
        if sysv:
            ok = w.push(buf, timeout=60.0)
        else:
            while not (ok := w.push(buf)) and time.time() < t_end:
                time.sleep(0.0002)
        push_s += time.perf_counter() - t2
        read_s += t2 - t1
        if not ok:
            sys.exit(f"ring writer: no room for buffer {i}")
finally:
    w.set_eod()
    w.close(**({"destroy": False} if sysv else {"unlink": False}))
print(f"{i + 1} buffers of {buf_bytes} B in {time.perf_counter() - t0:.3f} s:"
      f" file reads {read_s:.3f} s, pushes (with waits for room) "
      f"{push_s:.3f} s", flush=True)
"""


def posix_ring_size(free: int) -> tuple:
    """(buffer bytes, buffers) of a POSIX ring that takes at most half of
    ``free`` bytes of ``/dev/shm``: past its size a write into the mapped
    ring dies with SIGBUS, not with an error.  The buffer stays a divisor of
    ``RING_BUF``, so a file of whole 4 MiB buffers is whole buffers of it."""
    buf = RING_BUF
    while buf > 4096 and 2 * buf > free // 2:
        buf //= 2
    depth = min(RING_DEPTH, free // 2 // buf)
    check(depth >= 2, f"/dev/shm has {free} B free: no room for a ring")
    return buf, depth


@contextlib.contextmanager
def ring_writer(path: str, ring: str, buf_bytes: int, nbufs: int):
    """The ``WRITER`` process feeding ``ring`` from the DADA file at
    ``path``; on leaving, waits for it (or kills it, if the body failed),
    removes the ring and fails unless the writer exited 0."""
    proc = subprocess.Popen(
        [sys.executable, "-c", WRITER, path, ring, str(buf_bytes),
         str(nbufs)], cwd=os.path.dirname(os.path.abspath(__file__)),
        stdout=subprocess.PIPE, text=True)
    done = False
    try:
        yield proc
        done = True
    finally:
        if not done:
            proc.kill()
        try:
            out, _ = proc.communicate(timeout=120)
        except subprocess.TimeoutExpired:
            proc.kill()
            proc.communicate()
            raise
        remove_ring(ring)
    check(proc.returncode == 0,
          f"ring writer for {ring} exited {proc.returncode}")
    print(f"live ring writer ({ring}): {out.strip()}", flush=True)


def open_ring(ring: str):
    """The port's reader of ``ring``: a SysV hdu for ``0x<key>``, else a
    POSIX ring."""
    from dspsr_tpu_torch.io.hostio import DadaReader, RingReader

    if ring.lower().startswith("0x"):
        return DadaReader(int(ring, 16), timeout=LIVE_TIMEOUT)
    return RingReader(ring)


def remove_ring(ring: str) -> None:
    """Destroy (SysV) or unlink (POSIX) ``ring`` if it is still there."""
    try:
        r = open_ring(ring)
    except OSError:
        return
    if ring.lower().startswith("0x"):
        r.close(destroy=True)
    else:
        r.close(unlink=True)


def connect(ring: str, proc):
    """The reader of ``ring`` once its writer ``proc`` has made it and
    written its header (within 120 s)."""
    t_end = time.time() + 120.0
    while True:
        try:
            return open_ring(ring)
        except OSError:
            check(proc.poll() is None,
                  f"ring writer exited {proc.returncode} before {ring} was "
                  "up")
            check(time.time() < t_end, f"{ring} not up after 120 s")
            time.sleep(0.05)


def clocked(inner):
    """``inner`` (a Source) with its reads timed: ``read_s`` sums the reads
    that returned data (for a ring: its pops and the carry's
    concatenation), ``end_s`` is the read that met the end of the data,
    and for a ring ``pop_s`` sums the pops of the reads that returned data
    (copies out of the ring, waits for the writer included)."""
    from dspsr_tpu_torch.io.sources import Source

    class Clocked(Source):
        def __init__(self):
            self.obs = inner.obs
            self.read_s = self.end_s = self.pop_s = 0.0
            pop = getattr(inner, "_pop", None)
            if pop is not None:
                def timed_pop():
                    t0 = time.perf_counter()
                    try:
                        return pop()
                    finally:
                        self.pop_s += time.perf_counter() - t0
                inner._pop = timed_pop

        @property
        def total_samples(self) -> int:
            return inner.total_samples

        def read_samples(self, start: int, nsamp: int) -> np.ndarray:
            t0, pops = time.perf_counter(), self.pop_s
            try:
                out = inner.read_samples(start, nsamp)
            except EOFError:
                self.end_s = time.perf_counter() - t0
                self.pop_s = pops  # the read that met the end: not a pop
                raise
            self.read_s += time.perf_counter() - t0
            return out

    return Clocked()


def close_bytes(name: str, got: np.ndarray, want: np.ndarray) -> tuple:
    """The search paths' rule for two arrays of 8-bit samples of one size:
    every byte within 1 LSB of ``want``, at least 99% exact; returns (max
    diff, exact share)."""
    diff = np.abs(got.astype(np.int64) - want.astype(np.int64))
    mx, exact = int(diff.max()), float((diff == 0).mean())
    check(mx <= 1 and exact >= 0.99,
          f"{name}: bytes max diff {mx} LSB, {exact} exact")
    return mx, exact


def same_bytes(name: str, got: str, want: str) -> tuple:
    """Two SIGPROC files: equal channels, bits and sample time, data of one
    size within 1 LSB and at least 99% exact (the search rule); returns
    (max diff, exact share, data bytes)."""
    from dspsr_tpu_torch.io.sigproc import read_sigproc_header

    (gi, gh), (wi, wh) = read_sigproc_header(got), read_sigproc_header(want)
    for k in ("nchans", "nbits", "tsamp", "fch1", "foff"):
        check(gi[k] == wi[k], f"{name}: header {k} {gi[k]} != {wi[k]}")
    a = np.fromfile(got, np.uint8, offset=gh)
    b = np.fromfile(want, np.uint8, offset=wh)
    check(a.size == b.size and a.size > 0,
          f"{name}: {a.size} data bytes != {b.size}")
    return (*close_bytes(name, a, b), a.size)


def live_phase(card: str) -> dict:
    """The flagship fold and search read live from shared-memory rings
    (``io/hostio.py``), each against the same bytes read from a DADA file
    of 3 flagship blocks on the card:

    a. a SysV hdu (psrdada's architecture) fed by a separate writer
       process, folded by ``FoldPipeline(DadaReader(key))`` on ``megastep``
       (3 launches, hits exact, profiles within ``TOL_FLAGSHIP``), then
       again with ``digitizer_stats=False``;
    b. a POSIX ring sized to ``/dev/shm``, searched by
       ``FilPipeline(RingReader(name))`` on ``megafil`` to SIGPROC;
    c. the decimator (``apps/decimator_app.py``, ``-F 128``) on a POSIX
       ring: the general chain, no fused launch;
    d. ``PrefetchSource`` around the file: the flagship fold through it;
    e. ``verify_psrfits_fold`` on the live fold's archive, where
       ``libcfitsio`` is present.

    Prints each run's wall, host-fed rate and real-time factor (800
    Msamp/s) and its ``RunReport`` stages.  Returns the kernels' launches
    of the live and prefetch runs."""
    from dspsr_tpu_torch import launch_counts, reset_launch_counts
    from dspsr_tpu_torch.apps import decimator_app
    from dspsr_tpu_torch.io import cfitsio
    from dspsr_tpu_torch.io.archive import save_archive
    from dspsr_tpu_torch.io.hostio import PrefetchSource, load_hostio
    from dspsr_tpu_torch.io.sources import DummySource, open_source
    from dspsr_tpu_torch.models.load_to_fil import FilPipeline
    from dspsr_tpu_torch.models.load_to_fold import FoldPipeline

    load_hostio()
    key = live_key()
    probe = FoldPipeline(DummySource(flagship_obs()), flagship_cfg(),
                         device="cuda")
    nblocks = 3
    # the file is a whole number of 4 MiB ring buffers
    nbytes = 2 * ((nblocks - 1) * probe.stride_in_samples
                  + probe.block_in_samples)
    nbytes = -(-nbytes // RING_BUF) * RING_BUF
    st = os.statvfs("/dev/shm")
    shm_free = st.f_bavail * st.f_frsize
    pbuf, pdepth = posix_ring_size(shm_free)
    print(f"live: /dev/shm {shm_free} B free; POSIX ring {pdepth} x {pbuf} "
          f"B = {pdepth * pbuf} B; SysV hdu 0x{key:x}: {RING_DEPTH} x "
          f"{RING_BUF} B [{card}]", flush=True)
    launches = dict(megastep=0, megafil=0)
    live = {}

    def fold(src, name: str, **kw):
        """The flagship fold on the card over ``src`` (``report=True``) to
        the end of its data: (result, launches, wall, run report)."""
        pipe = FoldPipeline(src, flagship_cfg(report=True, **kw),
                            device="cuda")
        check(pipe.mega_mode == "full", f"{name}: engine {pipe.mega_mode}")
        check((pipe.block_in_samples, pipe.stride_in_samples)
              == (probe.block_in_samples, probe.stride_in_samples),
              f"{name}: block {pipe.block_in_samples}")
        err = io.StringIO()
        reset_launch_counts()
        with NoLibraryFFT(), contextlib.redirect_stderr(err):
            t0 = time.perf_counter()
            try:
                res = pipe.run()
            except EOFError:
                res = pipe._finish()
            wall = time.perf_counter() - t0
        n = launch_counts()
        check(n["megastep"] == nblocks and n["megafil"] == 0,
              f"{name}: launches {n}, want {nblocks} megastep")
        text = err.getvalue()
        report = text[text.index("run report:"):].splitlines()[1:]
        return res, n["megastep"], wall, "; ".join(
            " ".join(line.split()) for line in report)

    def rates(name: str, src, wall: float, nsamp: int, report: str,
              extra: str = "") -> float:
        busy = wall - src.end_s
        msps = nsamp / busy / 1e6
        pops = f" (pops {src.pop_s:.3f} s)" if src.pop_s else ""
        print(f"live {name}: wall {wall:.3f} s (end-of-data wait "
              f"{src.end_s:.3f} s), reads {src.read_s:.3f} s{pops}; host-fed "
              f"{msps:.1f} Msamp/s ({msps / 800:.4f} x real time){extra}; "
              f"{report} [{card}]", flush=True)
        return msps

    def same_fold(name: str, got, want) -> float:
        err = float(np.abs(got.profiles - want.profiles).max()
                    / np.abs(want.profiles).max())
        check(got.profiles.shape == want.profiles.shape,
              f"{name}: shape {got.profiles.shape}")
        check(bool(np.isfinite(got.profiles).all()), f"{name}: finite")
        check(err < TOL_FLAGSHIP, f"{name}: against the file {err}")
        check(bool(np.array_equal(got.hits, want.hits))
              and float(got.hits.sum()) > 0, f"{name}: hits differ")
        return err

    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "flagship.dada")
        t0 = time.perf_counter()
        write_dada(path, flagship_obs(), nbytes // 2, "cuda")
        print(f"live: {path}: {nbytes // 2} samples ({nblocks} fold blocks, "
              f"{os.path.getsize(path) / 1e6:.1f} MB) written in "
              f"{time.perf_counter() - t0:.2f} s", flush=True)
        nsamp = nblocks * probe.stride_in_samples
        direct = clocked(open_source(path))
        want, _, wall, report = fold(direct, "file fold")
        rates("file fold (the reference)", direct, wall, nsamp, report)

        # a. the SysV hdu, fed by a separate process
        ring = f"0x{key:x}"
        for counts in (True, False):
            tag = "" if counts else " without byte counts"
            with ring_writer(path, ring, RING_BUF, RING_DEPTH) as proc:
                reader = connect(ring, proc)
                try:
                    src = clocked(reader)
                    res, n, wall, report = fold(
                        src, f"live fold{tag}", digitizer_stats=counts)
                finally:
                    reader.close(destroy=True)
            launches["megastep"] += n
            err = same_fold(f"live fold{tag}", res, want)
            if counts:
                live["fold"] = res
                check(bool(np.array_equal(res.digitizer_counts,
                                          want.digitizer_counts)),
                      "live fold: digitizer counts differ")
            rates(f"fold from the SysV hdu{tag} (separate writer process)",
                  src, wall, nsamp, report,
                  f"; {n} megastep launches; against the file {err:.3e}, "
                  "hits exact")

        # d. PrefetchSource around the file, and the direct read again
        pf = PrefetchSource(open_source(path), probe.block_in_samples,
                            probe.stride_in_samples)
        try:
            src = clocked(pf)
            res, n, wall, report = fold(src, "prefetch fold")
        finally:
            pf.close()
        launches["megastep"] += n
        err = same_fold("prefetch fold", res, want)
        pf_msps = rates("fold through PrefetchSource", src, wall, nsamp,
                        report, f"; {n} megastep launches; against the "
                        f"direct read {err:.3e}, hits exact")
        direct = clocked(open_source(path))
        res, _, wall, report = fold(direct, "file fold")
        same_fold("file fold again", res, want)
        msps = rates("file fold again (no prefetch)", direct, wall, nsamp,
                     report)
        print(f"live prefetch: {pf_msps:.1f} Msamp/s with PrefetchSource, "
              f"{msps:.1f} without [{card}]", flush=True)

        # b. the flagship search from a POSIX ring
        outs = {k: os.path.join(tmp, f"search_{k}.fil")
                for k in ("file", "live")}
        total = nbytes // 2
        walls, counts = {}, {}
        for kind in ("file", "live"):
            name = f"/dspsr_live_search_{os.getpid()}"
            with contextlib.ExitStack() as stack:
                if kind == "file":
                    src = clocked(open_source(path))
                else:
                    proc = stack.enter_context(
                        ring_writer(path, name, pbuf, pdepth))
                    reader = connect(name, proc)
                    stack.callback(reader.close, unlink=True)
                    src = clocked(reader)
                pipe = FilPipeline(src, search_cfg(), device="cuda")
                check(pipe.megafil_plan is not None,
                      f"{kind} search: no fused plan")
                reset_launch_counts()
                with NoLibraryFFT():
                    t0 = time.perf_counter()
                    try:
                        pipe.run(outs[kind])
                    except EOFError:
                        pass
                    walls[kind] = time.perf_counter() - t0
                counts[kind] = launch_counts()
            nb = (total - pipe.block_in_samples) // pipe.stride_in_samples + 1
            check(nb >= 2 and counts[kind]["megafil"] == nb
                  and counts[kind]["megastep"] == 0,
                  f"{kind} search: launches {counts[kind]}, want {nb} "
                  "megafil")
            rates("search from the " + ("file" if kind == "file" else
                                        "POSIX ring (separate writer "
                                        "process)"), src, walls[kind],
                  nb * pipe.stride_in_samples,
                  "no RunReport on the search path",
                  f"; {nb} megafil launches")
        launches["megafil"] += counts["live"]["megafil"]
        mx, exact, size = same_bytes("live search", outs["live"],
                                     outs["file"])
        print(f"live search against the file: {size} data bytes, max diff "
              f"{mx} LSB, {exact:.6f} exact", flush=True)

        # c. the decimator on a POSIX ring, against FilPipeline on the file
        name = f"/dspsr_live_dec_{os.getpid()}"
        dec = os.path.join(tmp, "decimator.fil")
        argv = [name, "-F", "128", "-o", dec, "-q", "--device", "cuda"]
        with ring_writer(path, name, pbuf, pdepth) as proc:
            connect(name, proc).close()  # the app attaches to it itself
            reset_launch_counts()
            t0 = time.perf_counter()
            check(decimator_app.main(argv) == 0, "decimator: exit status")
            wall = time.perf_counter() - t0
        no_fused_launches("live decimator")
        cfg = decimator_app.fil_config(
            decimator_app.build_parser().parse_args(argv), pbuf // 2)
        pipe = FilPipeline(open_source(path), cfg, device="cuda")
        check(pipe.megafil_plan is None, "decimator: fused plan chosen")
        ref = os.path.join(tmp, "decimator_file.fil")
        reset_launch_counts()
        pipe.run(ref)
        no_fused_launches("decimator config on the file")
        mx, exact, size = same_bytes("live decimator", dec, ref)
        msps = total / wall / 1e6
        print(f"live decimator (-F 128, POSIX ring): wall {wall:.3f} s, "
              f"host-fed {msps:.1f} Msamp/s ({msps / 800:.4f} x real time) "
              f"incl. the app's start; 0 fused launches (general chain, "
              f"block {pipe.block_in_samples}); against FilPipeline on the "
              f"file {size} data bytes, max diff {mx} LSB, {exact:.6f} "
              f"exact [{card}]", flush=True)

        # e. cfitsio on the live fold's archive
        if cfitsio.available():
            ar = os.path.join(tmp, "live.ar")
            save_archive(ar, live["fold"])
            m = cfitsio.verify_psrfits_fold(ar, live["fold"])
            print(f"live cfitsio: {os.path.getsize(ar)} B archive of the "
                  f"live fold read through libcfitsio: {m['nsub']} "
                  f"sub-integration(s), profile round trip "
                  f"{m['max_profile_err']:.3e}", flush=True)
        else:
            print("live cfitsio: absent (no libcfitsio on this machine)",
                  flush=True)
    return launches


# ---- multi-GPU: the sharded pipelines on a mesh that repeats the card ----

#: the device every shard of the mesh runs on: shards on one card run one
#: after another, so these phases check the sharded dataflow and time its
#: overheads (halo copies, time sums, stripe reads), not a speed-up
CARD0 = "cuda:0"


def cuda_mesh(nt: int, nc: int = 1):
    """A (nt, nc) mesh whose every shard is ``cuda:0``."""
    from dspsr_tpu_torch.parallel.sharded import make_mesh

    return make_mesh(nt * nc, nc, devices=[torch.device(CARD0)] * (nt * nc))


def buffer_source(obs, nsamp: int, make):
    """A ``Source`` of ``nsamp`` samples of ``obs`` held in host memory:
    ``make(start, n)`` gives the bytes of samples ``[start, start + n)`` on
    the card (in chunks of about 64 MB, whole JA98 blocks of 256 samples),
    and every read is a slice, so the sharded and the single run read the
    same bytes at no cost."""
    from dspsr_tpu_torch.io.sources import Source

    bps = obs.nbytes_per_sample
    buf = np.empty(int(round(nsamp * bps)), np.uint8)
    step = max(256, int((1 << 26) / bps) // 256 * 256)
    for s in range(0, nsamp, step):
        n = min(step, nsamp - s)
        buf[int(round(s * bps)):int(round((s + n) * bps))] = \
            make(s, n).cpu().numpy()

    class BufferSource(Source):
        def __init__(self):
            self.obs = obs.replace(ndat=nsamp)

        @property
        def total_samples(self) -> int:
            return nsamp

        def read_samples(self, start: int, n: int) -> np.ndarray:
            return buf[int(round(start * bps)):int(round((start + n) * bps))]

    return BufferSource()


def noise_source(obs, nsamp: int):
    """``buffer_source`` of ``device_noise_bytes``."""
    from dspsr_tpu_torch.io.sources import device_noise_bytes

    bps = obs.nbytes_per_sample
    return buffer_source(obs, nsamp, lambda s, n: device_noise_bytes(
        int(round(s * bps)), int(round(n * bps)), CARD0))


def sized_source(probe, obs, nsb: int, make=None):
    """A source of exactly ``nsb`` superblocks of ``probe``'s geometry
    (noise bytes unless ``make`` gives others)."""
    # the search pipeline keeps the overlap, the fold pipeline's inner one
    ov = getattr(probe, "nsamp_overlap", None)
    if ov is None:
        ov = probe.inner.nsamp_overlap
    total = nsb * probe.superblock_stride + ov
    return (noise_source(obs, total) if make is None
            else buffer_source(obs, total, make))


def sharded_run(pipe, nsb: int, card: str, name: str, run):
    """``run()`` (the sharded pipeline's run over ``nsb`` superblocks) with
    the launch counts set to 0 just before and read just after, timed
    (CUDA events and the host clock), with the pipeline's halo and
    reduction seconds and the peak device memory; prints them.  Returns
    ``(result, launch counts)``."""
    from dspsr_tpu_torch import launch_counts, reset_launch_counts

    pipe.timed = True
    pipe.seconds = dict.fromkeys(pipe.seconds, 0.0)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    reset_launch_counts()
    with NoLibraryFFT():
        t0 = time.perf_counter()
        start.record()
        res = run()
        stop.record()
        stop.synchronize()
        wall = time.perf_counter() - t0
    counts = launch_counts()
    peak = (torch.cuda.max_memory_allocated() - base) / 2**20
    inner = pipe.inner
    rt = inner.obs_in.rate / 1e6
    msps = nsb * pipe.superblock_stride / wall / 1e6
    mesh = pipe.mesh.shape
    print(f"{name}: mesh {mesh['time']} x {mesh.get('chan', 1)} of "
          f"{CARD0} (shards run one after another: overheads, not a "
          f"speed-up), {nsb} superblocks of {pipe.superblock_stride} "
          f"samples: {start.elapsed_time(stop) / nsb:.3f} ms a superblock "
          f"(CUDA events; host reads and copies included), {msps:.1f} "
          f"Msamp/s ({msps / rt:.4f} x real time at {rt:g} Msamp/s); a "
          f"superblock's host and overhead stages: "
          + ", ".join(f"{k} {1e3 * v / nsb:.3f} ms"
                      for k, v in pipe.seconds.items())
          + "; peak "
          f"device memory {peak:.0f} MiB; launches "
          f"{ {k: v for k, v in counts.items() if v} } [{card}]",
          flush=True)
    return res, counts


def check_same_fold(name: str, a, b, tol: float = TOL_FLAGSHIP) -> float:
    """The sharded result ``a`` against the single run ``b``: profiles to
    ``tol`` of their largest value, hits exactly, the same division;
    returns the relative error."""
    check(a.profiles.shape == b.profiles.shape,
          f"{name}: shapes {a.profiles.shape} {b.profiles.shape}")
    check(bool(np.isfinite(a.profiles).all()), f"{name}: finite")
    err = float(np.abs(a.profiles - b.profiles).max()
                / np.abs(b.profiles).max())
    hdiff = float(np.abs(a.hits - b.hits).max())
    print(f"{name}: sharded against single: rel err {err:.3e}, hits diff "
          f"{hdiff}, hits {float(a.hits.sum())}, subints "
          f"{a.profiles.shape[0]}", flush=True)
    check(err < tol, f"{name}: rel err {err} >= {tol}")
    check(hdiff == 0 and float(a.hits.sum()) > 0, f"{name}: hits")
    check(np.array_equal(a.integration_length, b.integration_length),
          f"{name}: integration lengths")
    return err


def sharded_small() -> dict:
    """Both kernel variants of the channel-sharded steps at the test
    geometry, real and complex input: ``build_megastep(response_as_args=
    True)`` on input channels 2-3 of 4 with their chirp rows, and
    ``build_megafil(jones_as_args=True)`` (one-CTA and multi-pass inverse;
    bare, and with the chirp and passband on the call) with the Jones rows:
    each launch against the full-band launch's rows of that group and
    against the float64 plain version, at TOL_SMALL.  Returns the largest
    absolute error of each kernel against plain."""
    from dspsr_tpu_torch.ops.megakernel import (
        MegaConstants, build_megafil, build_megastep, megafil_plain,
        megastep_plain, unpack_affine)

    npart, rows = 3, slice(2, 4)
    rng = np.random.default_rng(21)
    worst = {"megastep": 0.0, "megafil": 0.0}

    def group_bytes(plan, raw):
        per = plan.npol * plan.ndim
        return raw.view(-1, plan.nchan_in, per)[:, rows].reshape(-1) \
            .contiguous()

    for kind in ("real", "complex"):
        plan = small_plan(kind, 32, npol=2, nchan_in=4)
        grp = dataclasses.replace(plan, nchan_in=2)
        raw = small_raw(plan, npart, rng)
        graw = group_bytes(plan, raw)
        resp = np.exp(1j * rng.uniform(-3, 3, (4 * plan.nsub,
                                               plan.freq_res)))
        scale, offset = unpack_affine(8)
        cst = MegaConstants.build(plan, resp, scale, offset).to("cuda")
        phi0 = torch.from_numpy(rng.uniform(0, 1, npart).astype(
            np.float32)).cuda()
        dphi = torch.full((npart,), 0.013, device="cuda")
        gr, gi = cst.gr[rows].clone(), cst.gi[rows].clone()
        shp = (plan.nplane, plan.nsub, plan.nbin)
        for bounds in (None, (7, 70)):
            pf, hf = build_megastep(plan, cst, npart)(
                torch.zeros(4, *shp, device="cuda"),
                torch.zeros(4, plan.nbin, device="cuda"), raw, phi0, dphi,
                bounds)
            pk, hk = build_megastep(grp, cst, npart, response_as_args=True)(
                torch.zeros(2, *shp, device="cuda"),
                torch.zeros(2, plan.nbin, device="cuda"), graw, phi0, dphi,
                gr, gi, bounds=bounds)
            pp, hp = megastep_plain(
                grp, cst, torch.zeros(2, *shp, dtype=torch.float64,
                                      device="cuda"),
                torch.zeros(2, plan.nbin, dtype=torch.float64,
                            device="cuda"), graw, phi0, dphi, bounds,
                gr.double(), gi.double())
            torch.cuda.synchronize()
            errs = (rel_err(pk, pf[rows]), rel_err(pk, pp))
            hdiff = (float((hk - hf[rows]).abs().max()),
                     float((hk.double() - hp).abs().max()))
            what = f"sharded_small megastep {kind} chirp rows bounds={bounds}"
            print(f"{what}: rel err against full band {errs[0]:.3e}, "
                  f"against plain {errs[1]:.3e}; hits diff {hdiff}",
                  flush=True)
            check(max(errs) < TOL_SMALL, f"{what}: {errs}")
            check(max(hdiff) == 0 and float(hk.sum()) > 0, f"{what}: hits")
            worst["megastep"] = max(worst["megastep"],
                                    float((pk.double() - pp).abs().max()))

        for nsub, freq_res, inverse, npol_out in (
                (4, 64, "auto", 4), (1, 4096, "multipass", 1)):
            plan = small_plan(kind, 2, nsub=nsub, freq_res=freq_res, npol=2,
                              nchan_in=4, npol_out=npol_out)
            grp = dataclasses.replace(plan, nchan_in=2)
            raw = small_raw(plan, npart, rng)
            graw = group_bytes(plan, raw)
            chirp = np.exp(1j * rng.uniform(-3, 3, (4, plan.n_fft)))
            J = leaky_jones(plan.n_fft, 4) * chirp[:, :, None, None]
            full = MegaConstants.build(plan, None, scale, offset,
                                       jones=J).to("cuda")
            bare = MegaConstants.build(grp, None, scale, offset).to("cuda")
            jones = full.jones[rows].clone()
            mr, mi = masked_chirp(bare, rng)
            for tap in (False, True):
                kw = dict(output="detected", inverse=inverse, passband=tap)
                args = (mr, mi) if tap else ()
                got = build_megafil(grp, bare, npart, jones_as_args=True,
                                    response_as_args=tap, **kw)(
                    graw, *args, jones)
                ref = build_megafil(plan, dataclasses.replace(
                    full, gr=torch.cat([full.gr[:2], mr]) if tap else full.gr,
                    gi=torch.cat([full.gi[:2], mi]) if tap else full.gi),
                    npart, **kw)(raw)
                want = megafil_plain(
                    grp, bare, graw, npart, torch.float64, passband=tap,
                    gr=mr.double() if tap else None,
                    gi=mi.double() if tap else None, jones=jones.double())
                got, pb = got if tap else (got, None)
                ref = ref[0] if tap else ref
                want, wpb = want if tap else (want, None)
                orows = slice(2 * plan.nsub, 4 * plan.nsub)
                torch.cuda.synchronize()
                errs = (rel_err(got, ref[orows]), rel_err(got, want),
                        rel_err(pb, wpb) if tap else 0.0)
                what = (f"sharded_small megafil {kind} Jones rows nsub "
                        f"{nsub} {inverse}{' masked tap' if tap else ''}")
                print(f"{what}: rel err against full band {errs[0]:.3e}, "
                      f"against plain {errs[1]:.3e}, passband {errs[2]:.3e}",
                      flush=True)
                check(bool(torch.isfinite(got).all()), f"{what}: finite")
                check(max(errs) < TOL_SMALL, f"{what}: {errs}")
                worst["megafil"] = max(
                    worst["megafil"], float((got.double() - want).abs().max()))
    return worst


def sharded_fold(card: str) -> dict:
    """``mega_real_8bit`` on a (4 x 1) mesh of the card for 2 superblocks
    of 4 flagship blocks, against ``FoldPipeline`` on the card over the same
    bytes at the same per-block geometry: profiles to TOL_FLAGSHIP, hits
    exact, one ``megastep`` launch a shard a superblock."""
    from dspsr_tpu_torch.io.sources import DummySource
    from dspsr_tpu_torch.models.load_to_fold import FoldPipeline
    from dspsr_tpu_torch.parallel.pipeline import ShardedFoldPipeline

    nt, nsb = 4, 2
    mesh = cuda_mesh(nt)
    obs, cfg = flagship_obs(), flagship_cfg()
    probe = ShardedFoldPipeline(DummySource(obs), cfg, mesh)
    src = sized_source(probe, obs, nsb)
    pipe = ShardedFoldPipeline(src, cfg, mesh)
    check(pipe.mega and pipe.inner.npart == 75, "sharded_fold: the full "
          f"engine at the flagship geometry (npart {pipe.inner.npart})")
    res, counts = sharded_run(pipe, nsb, card, "sharded_fold", pipe.run)
    check(counts["megastep"] == nt * nsb,
          f"sharded_fold: {counts['megastep']} megastep launches")
    one = FoldPipeline(src, pipe.config, device="cuda").run()
    err = check_same_fold("sharded_fold", res, one)
    check(res.profiles.shape == (1, 64, 1, 1024), "sharded_fold shape")
    return dict(launches=counts["megastep"], err=err)


def chan_mega(card: str) -> dict:
    """``mega_guppi_2bit`` (32 channels of JA98 2-bit codes from
    ``ja98_bytes``, with saturated stretches in both channel groups) on a
    (2 time x 2 chan) mesh: ``megastep`` at nchan_in 16 with each group's
    chirp rows per call; against the single run: profiles to
    TOL_FLAGSHIP, hits exact, and a group's JA98 window weights equal to
    the full band's rows of that group."""
    from dspsr_tpu_torch.kernels.megastep import ja98_cuda
    from dspsr_tpu_torch.models.load_to_fold import FoldPipeline
    from dspsr_tpu_torch.parallel.pipeline import ShardedFoldPipeline

    nt, nc, nsb = 2, 2, 2
    mesh = cuda_mesh(nt, nc)
    probe = ShardedFoldPipeline(guppi2_source(), guppi2_cfg(), mesh)
    check(probe.mega_chan and probe.local_nchan == 16,
          "chan_mega: the channel-grouped full engine")
    src = sized_source(probe, guppi2_obs(), nsb, lambda s, n: ja98_bytes(
        s, n, 128, 256, guppi2_stretches()))
    pipe = ShardedFoldPipeline(src, guppi2_cfg(), mesh)
    res, counts = sharded_run(pipe, nsb, card, "chan_mega", pipe.run)
    check(counts["megastep"] == nt * nc * nsb
          and counts["mega_ja98"] == nt * nc * nsb,
          f"chan_mega: launches {counts}")
    one = FoldPipeline(src, pipe.config, device="cuda").run()
    err = check_same_fold("chan_mega", res, one)
    # the JA98 pre-pass of each group against the full band's rows
    inner = pipe.inner
    mp = inner.mega_plan
    lp = dataclasses.replace(mp, nchan_in=16)
    raw = src.read_samples(0, inner.block_in_samples)
    _, wfull = ja98_cuda(mp, inner.constants,
                         torch.from_numpy(raw).cuda(), inner.npart)
    groups = pipe._split_chan_groups(raw)
    want = guppi2_expected_weights(inner, 0)
    for c in range(nc):
        _, wg = ja98_cuda(lp, inner.constants,
                          torch.from_numpy(groups[c]).cuda(), inner.npart)
        rows = slice(16 * c, 16 * (c + 1))
        same = bool(torch.equal(wg, wfull[rows]))
        print(f"chan_mega group {c}: window weights equal to the band's "
              f"rows {same}, excised {int((wg == 0).sum())}", flush=True)
        check(same and np.array_equal(wg.cpu().numpy(), want[rows]),
              f"chan_mega group {c} window weights")
    stats = group_launch_megastep(card, pipe)
    return dict(launches=counts["megastep"], err=err, **stats)


def shard0_raw(pipe):
    """Shard (0, 0)'s bytes of the first superblock, halo included, on its
    device, as the sharded run hands them to its step."""
    rows, tail = pipe._read_superblock(0)
    return pipe._shard_raws(*pipe._upload(rows, tail))[0, 0]


def group_launch_megastep(card: str, pipe) -> dict:
    """The chan-mega step at its width (``megastep`` with
    ``response_as_args``, nchan_in 16 of ``mega_guppi_2bit``) on shard (0,
    0)'s bytes against its plain version (both f32): profiles to
    TOL_FLAGSHIP, hits exact; then both timed, with the full band's step
    and the bound of the group's work."""
    from dspsr_tpu_torch.ops.megakernel import megastep_plain

    inner = pipe.inner
    dev = torch.device(CARD0)
    lp = dataclasses.replace(inner.mega_plan, nchan_in=pipe.local_nchan)
    step, cst = pipe._chan_steps[dev], inner.constants
    gr, gi, _ = pipe._chan_resp[dev, 0]
    raw = shard0_raw(pipe)
    phi0, dphi = cyclic_anchors(inner)
    shape = (lp.nchan_in, lp.nplane, lp.nsub, lp.nbin)
    zp = torch.zeros(shape, device=dev)
    zh = torch.zeros(lp.nchan_in, lp.nbin, device=dev)
    pk, hk = step(zp, zh, raw, phi0, dphi, gr, gi)
    pp, hp = megastep_plain(lp, cst, zp, zh, raw, phi0, dphi, None, gr, gi)
    torch.cuda.synchronize()
    err = rel_err(pk, pp)
    abs_err = float((pk - pp).abs().max())
    check(err < TOL_FLAGSHIP and float((hk - hp).abs().max()) == 0,
          f"chan_mega group launch against plain: {err}")
    ms = cuda_ms(lambda: step(zp, zh, raw, phi0, dphi, gr, gi), 5)
    plain_ms = cuda_ms(lambda: megastep_plain(lp, cst, zp, zh, raw, phi0,
                                              dphi, None, gr, gi), 2)
    nbytes = (raw.numel() + 8 * gr.numel() + 4 * cst.twobit.numel()
              + 8 * (zp.numel() + zh.numel()) + 8 * phi0.numel())
    bound = bound_of(nbytes, front_ops(lp, inner.npart, 2, 2))
    print(f"chan_mega group launch (megastep, per-call chirp, nchan_in "
          f"{lp.nchan_in}): rel err against plain {err:.3e} (abs "
          f"{abs_err:.3e}); {ms:.3f} ms, plain {plain_ms:.3f} ms, bound "
          f"{bound['bound_ms']:.4f} ms ({bound['bound_by']}) [{card}]",
          flush=True)
    return dict(group_ms=ms, group_plain_ms=plain_ms,
                group_bound_ms=bound["bound_ms"], group_err=abs_err)


def chan_hybrid(card: str) -> dict:
    """Channel-grouped hybrid: ``conv32_jones`` (32 complex channels, nsub
    1, freq_res 2^19, a Jones calibration, Stokes) on (1 x 2), each group's
    Jones rows to ``build_megafil(jones_as_args=True)`` with the multi-pass
    inverse; and ``hybrid_conv32`` with ``sk_m=1024`` on (2 x 2), the SK
    sums pooled over the channel shards.  Against the single runs:
    profiles to TOL_FLAGSHIP, hits and the SK zap counts exact."""
    from dspsr_tpu_torch.io.sources import DummySource
    from dspsr_tpu_torch.models.load_to_fold import FoldPipeline
    from dspsr_tpu_torch.parallel.pipeline import ShardedFoldPipeline

    nsb, launches, err, stats = 2, 0, 0.0, {}
    J = np.array([[1.0, 0.35 + 0.1j], [-0.2j, 0.9]], np.complex128)
    with tempfile.TemporaryDirectory() as tmp:
        cal = os.path.join(tmp, "cal.npz")
        np.savez(cal, freq=np.linspace(1100.0, 1700.0, 16),
                 jones=np.broadcast_to(J, (16, 2, 2)))
        cases = (("chan_hybrid conv32_jones", 1, 2,
                  conv32_cfg(npol_out=4, calibration_path=cal)),
                 ("chan_hybrid conv32_sk", 2, 2,
                  conv32_cfg(sk_enable=True, sk_m=1024)))
        for name, nt, nc, cfg in cases:
            mesh = cuda_mesh(nt, nc)
            probe = ShardedFoldPipeline(DummySource(conv32_obs()), cfg, mesh)
            check(probe.hybrid_chan and probe.local_nchan == 16,
                  f"{name}: the channel-grouped hybrid engine")
            src = sized_source(probe, conv32_obs(), nsb)
            del probe
            pipe = ShardedFoldPipeline(src, cfg, mesh)
            res, counts = sharded_run(pipe, nsb, card, name, pipe.run)
            check(counts["megafil"] == nt * nc * nsb,
                  f"{name}: launches {counts}")
            launches += counts["megafil"]
            single = FoldPipeline(src, pipe.config, device="cuda")
            one = single.run()
            err = max(err, check_same_fold(name, res, one))
            if cfg.calibration_path:
                stats = group_launch_megafil(card, pipe)
            if cfg.sk_enable:
                zap = sum(p._zap["sk"][0] for p in pipe._inners.values())
                zap1 = single._zap["sk"][0]
                print(f"{name}: SK cells zapped {int(zap)} sharded, "
                      f"{int(zap1)} single", flush=True)
                check(int(zap) == int(zap1), f"{name}: SK zap counts")
            del pipe, single, src
            torch.cuda.empty_cache()
    return dict(launches=launches, err=err, **stats)


def group_launch_megafil(card: str, pipe) -> dict:
    """The chan-hybrid front end of ``conv32_jones`` at its width
    (``megafil`` with ``jones_as_args``: the group's Jones rows, 16
    channels, the multi-pass inverse) on shard (0, 0)'s bytes against its
    plain version (both f32) within TOL_FLAGSHIP; then both timed, with the
    bound of the group's work."""
    from dspsr_tpu_torch.ops.megakernel import build_megafil, megafil_plain

    inner = pipe.inner
    dev = torch.device(CARD0)
    fp = dataclasses.replace(inner.front_plan, nchan_in=pipe.local_nchan)
    ones = torch.ones((fp.nchan_in, fp.n_fft), device=dev)
    cst = dataclasses.replace(inner.constants, jones=None, gr=ones,
                              gi=torch.zeros_like(ones))
    jones = pipe._chan_resp[dev, 0][2]
    front = build_megafil(fp, cst, inner.npart, jones_as_args=True)
    raw = shard0_raw(pipe)
    got = front(raw, jones)
    want = megafil_plain(fp, cst, raw, inner.npart, jones=jones)
    torch.cuda.synchronize()
    err = rel_err(got, want)
    abs_err = float((got - want).abs().max())
    check(err < TOL_FLAGSHIP, f"chan_hybrid Jones group launch: {err}")
    ms = cuda_ms(lambda: front(raw, jones), 5)
    plain_ms = cuda_ms(lambda: megafil_plain(fp, cst, raw, inner.npart,
                                             jones=jones), 2)
    nbytes = (raw.numel() + 8 * ones.numel() + 4 * jones.numel()
              + 4 * got.numel())
    bound = bound_of(nbytes, front_ops(fp, inner.npart, 2, 2))
    print(f"chan_hybrid group launch (megafil, per-call Jones, nchan_in "
          f"{fp.nchan_in}, multi-pass inverse): rel err against plain "
          f"{err:.3e} (abs {abs_err:.3e}); {ms:.3f} ms, plain "
          f"{plain_ms:.3f} ms, bound {bound['bound_ms']:.4f} ms "
          f"({bound['bound_by']}) [{card}]", flush=True)
    return dict(group_ms=ms, group_plain_ms=plain_ms,
                group_bound_ms=bound["bound_ms"], group_err=abs_err)


def sharded_search(card: str) -> dict:
    """``megafil_search`` (constant levels) on a (4 x 1) mesh of the card
    for 2 superblocks to a SIGPROC file, against ``FilPipeline`` on the card
    over the same bytes: every byte within 1 LSB, at least 99% exact."""
    from dspsr_tpu_torch.io.sources import DummySource
    from dspsr_tpu_torch.models.load_to_fil import FilPipeline
    from dspsr_tpu_torch.parallel.search import ShardedFilPipeline

    nt, nsb = 4, 2
    mesh = cuda_mesh(nt)
    cfg = dataclasses.replace(search_cfg(), rescale_constant=True)
    probe = ShardedFilPipeline(DummySource(flagship_obs()), cfg, mesh)
    src = sized_source(probe, flagship_obs(), nsb)
    pipe = ShardedFilPipeline(src, cfg, mesh)
    check(pipe.inner.megafil_plan is not None, "sharded_search: fused")
    with tempfile.TemporaryDirectory() as tmp:
        a, b = os.path.join(tmp, "n.fil"), os.path.join(tmp, "one.fil")
        _, counts = sharded_run(pipe, nsb, card, "sharded_search",
                                lambda: pipe.run(a))
        FilPipeline(src, cfg, device="cuda").run(b)
        x = np.fromfile(a, np.uint8)
        y = np.fromfile(b, np.uint8)
    check(counts["megafil"] == nt * nsb,
          f"sharded_search: {counts['megafil']} megafil launches")
    check(x.size == y.size and x.size > nt * nsb * 16_896_000,
          f"sharded_search: file sizes {x.size} {y.size}")
    mx, exact = close_bytes("sharded_search", x, y)
    print(f"sharded_search: {x.size} B against the single run: max diff "
          f"{mx} LSB, {exact:.6f} exact", flush=True)
    return dict(launches=counts["megafil"])


def multiproc_phase(card: str) -> None:
    """``launch_fold``: 2 worker processes of 2 time shards each, both on
    ``cuda:0``, joined over gloo with their collectives staged through host
    memory, folding two flagship superblocks from a DADA file; against the
    in-process (4 x 1) sharded run: profiles to TOL_FLAGSHIP, hits exact.
    With two or more cards, also NCCL with one card a rank."""
    from dspsr_tpu_torch.io.dada import (
        format_ascii_header, header_from_observation)
    from dspsr_tpu_torch.io.sources import DummySource, open_source
    from dspsr_tpu_torch.models.load_to_fold import FoldConfig
    from dspsr_tpu_torch.parallel.multiproc import launch_fold
    from dspsr_tpu_torch.parallel.pipeline import ShardedFoldPipeline

    cfg_kw = dict(folding_period=0.00575745, dispersion_measure=2.64,
                  nchan=64, nbin=1024, block_parts=8, npol_out=1,
                  min_block_samples=block_samples("real"))
    obs = flagship_obs().replace(instrument="RAW")
    mesh = cuda_mesh(4)
    probe = ShardedFoldPipeline(DummySource(obs), FoldConfig(**cfg_kw), mesh)
    # two superblocks, so that the per-shard block cap keeps the flagship
    # block (a quarter of the file over the shards plus one)
    src = sized_source(probe, obs, 2)
    runs = [("gloo", CARD0)]
    if torch.cuda.device_count() >= 2:
        runs.append(("nccl", ["cuda:0", "cuda:1"]))
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "mp.dada")
        with open(path, "wb") as f:
            f.write(format_ascii_header(header_from_observation(
                obs.replace(ndat=0))))
            f.write(src.read_samples(0, src.total_samples).tobytes())
        del src
        one = ShardedFoldPipeline(open_source(path), FoldConfig(**cfg_kw),
                                  mesh).run()
        for backend, device in runs:
            t0 = time.perf_counter()
            d = launch_fold(path, cfg_kw, n_procs=2, shards_per_proc=2,
                            backend=backend, device=device,
                            out_path=os.path.join(tmp, f"{backend}.npz"),
                            timeout=400.0, timed=True)
            wall = time.perf_counter() - t0
            err = float(np.abs(d["profiles"] - one.profiles).max()
                        / np.abs(one.profiles).max())
            hdiff = float(np.abs(d["hits"] - one.hits).max())
            print(f"multiproc {backend} (2 processes x 2 shards on "
                  f"{device}): {wall:.1f} s wall incl. process start; rank "
                  f"0's halo copies {1e3 * float(d['seconds_halo']):.3f} ms, "
                  f"time sums {1e3 * float(d['seconds_reduce']):.3f} ms; "
                  f"against the in-process run: rel err {err:.3e}, hits "
                  f"diff {hdiff} [{card}]", flush=True)
            check(d["profiles"].shape == one.profiles.shape
                  and err < TOL_FLAGSHIP and hdiff == 0,
                  f"multiproc {backend}: {err}, {hdiff}")
            check(np.array_equal(d["digitizer_counts"],
                                 one.digitizer_counts),
                  f"multiproc {backend}: digitizer counts")
    ran = ", ".join(b for b, _ in runs)
    print(f"multiproc: ran {ran}"
          + ("" if len(runs) > 1 else "; nccl needs 2 cards, "
             f"{torch.cuda.device_count()} visible"), flush=True)


def sharded_all(card: str) -> dict:
    """The multi-GPU phases; returns the launches of each kernel on the
    sharded main paths and the largest error of each kernel variant
    against plain."""
    small = sharded_small()
    fold = sharded_fold(card)
    cm = chan_mega(card)
    ch = chan_hybrid(card)
    ss = sharded_search(card)
    multiproc_phase(card)
    return dict(megastep=fold["launches"] + cm["launches"],
                megafil=ch["launches"] + ss["launches"],
                err_megastep=max(small["megastep"], cm["group_err"]),
                err_megafil=max(small["megafil"], ch["group_err"]))


def build_all() -> None:
    """Build both kernels (one nvcc each) and the host I/O runtime
    (``csrc/hostio.cpp``, g++) at once and print ptxas lines."""
    from dspsr_tpu_torch.kernels.build import build, build_host

    with ThreadPoolExecutor(3) as pool:
        futs = {n: pool.submit(build, n, True)
                for n in ("megastep", "megafil")}
        futs["hostio"] = pool.submit(build_host, "hostio")
        results = {n: f.result() for n, f in futs.items()}
    for name, (path, log, secs) in results.items():
        print(f"built {path.name} in {secs:.1f} s", flush=True)
        kernel = "?"
        for line in log.splitlines():
            m = re.search(r"entry function '.*?(mega\w+?)"
                          r"(?:I((?:Li\d+E|Lb\d+E)+)EEv|E)", line)
            if m:
                args = re.findall(r"L[ib](\d+)E", m.group(2) or "")
                kernel = m.group(1) + (f"<{', '.join(args)}>" if args else "")
            elif "registers" in line or "spill" in line or "error" in line:
                print(f"  ptxas {kernel}: {line.strip()}", flush=True)


def small_all() -> None:
    """Every kernel variant against its plain version at the test
    geometry."""
    for kind in KINDS:
        small_checks(kind)
        small_checks_megafil(kind)
        small_checks_hybrid(kind)
        small_checks_conv(kind)
    small_unequal()
    small_checks_unpack()
    small_checks_unpack(FTP_CASES)
    small_checks_cluster()
    small_checks_multipass()


def main() -> None:
    card = card_facts()
    build_all()
    small_all()
    flag = flagship_block(card)
    launches = main_path(card)
    pipeline_rates(card)
    search = search_block(card)
    search_launches = search_path(card)
    search_rates(card)
    # complex (analytic) input: mega_analytic_8bit, and its search
    flag_c = flagship_block(card, "complex")
    launches += main_path(card, "complex")
    pipeline_rates(card, "complex")
    search_c = search_block(card, "complex")
    search_launches += search_path(card, "complex")
    search_rates(card, "complex")
    # CASPSR bytes: the flagship fold and search step, the fold main path
    flag_k = flagship_block(card, "caspsr")
    search_k = search_block(card, "caspsr")
    launches += main_path(card, "caspsr")
    hybrid = hybrid_block(card)
    hybrid_launches = hybrid_path(card)
    hybrid_rates(card)
    # cyclic spectroscopy: the voltage output and the lag-product fold
    cyclic = cyclic_block(card)
    hybrid_launches += cyclic_path(card)
    cyclic_rates(card)
    # the nsub == 1 convolution (the multi-pass inverse) and Jones
    conv = conv32_block(card)
    hybrid_launches += conv32_path(card)
    conv32_rates(card)
    conv_j = conv32_jones(card)
    # JA98 2-bit (mega_guppi_2bit): the fold kernel with the pre-pass
    guppi = guppi2_block(card)
    launches += guppi2_path(card)
    guppi2_rates(card)
    # the flagship band at J1713+0747's and J0613-0200's DMs: the
    # multi-pass inverse at nsub 64, and the long row pass
    dm = dm_phases(card)
    launches += dm["megastep"]
    search_launches += dm["megafil"]
    # the general chain: no fused kernel, so nothing for the kernels line
    for name in GENERAL:
        general_block(card, name)
        general_path(card, name)
        general_rates(card, name)
    general_search(card)
    # the dspsr CLI (fold, --skz, --fft-bench, -G) and the diagnostics
    # tools on a flagship DADA file
    cli = cli_phase(card)
    launches += cli["megastep"]
    hybrid_launches += cli["megafil"]
    # the live rings: the flagship fold and search read while written
    live = live_phase(card)
    launches += live["megastep"]
    search_launches += live["megafil"]
    # multi-GPU: the sharded pipelines on a mesh that repeats the card
    sharded = sharded_all(card)
    launches += sharded["megastep"]
    hybrid_launches += sharded["megafil"]
    flag["max_abs_err"] = max(f["max_abs_err"]
                              for f in (flag, flag_c, flag_k, guppi))
    flag["max_abs_err"] = max(flag["max_abs_err"], sharded["err_megastep"],
                              dm["err_megastep"])
    search["max_abs_err"] = max(search["max_abs_err"],
                                search_c["max_abs_err"],
                                search_k["max_abs_err"], hybrid["err"],
                                cyclic["err"], conv["max_abs_err"],
                                conv_j["max_abs_err"],
                                sharded["err_megafil"], dm["err_megafil"])
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
