"""Wrapper of the hand-written CUDA fused fold step (``csrc/megastep.cu``).

Replaces ``dspsr_tpu/ops/megakernel.py::build_megastep`` (the Pallas
kernel).  The source note in ``csrc/megastep.cu`` says what bounds it and
how it is laid out.  This wrapper checks every operand, allocates the
outputs and scratch with ``torch.empty``, launches the four kernels on the
current stream through the library's C entry point, raises on any CUDA
error, and counts the launch.  It never falls back to the plain version.
"""

from __future__ import annotations

import ctypes

import torch

from ..device import count_launch
from ..ops.megakernel import (
    MegaConstants, MegaPlan, bounds_pair, check_supported, detection_code,
    fold_pols)
from . import build

_c = ctypes.c_void_p
_i = ctypes.c_int
_f = ctypes.c_float
_LAUNCH_ARGTYPES = [_c] * 13 + [_i] * 16 + [_f, _f] + [_i] * 5 + [_c]


def _lib() -> ctypes.CDLL:
    lib = build.load("megastep")
    if lib.megastep_launch.argtypes is None:
        lib.megastep_launch.argtypes = _LAUNCH_ARGTYPES
        lib.megastep_launch.restype = _i
        lib.megastep_smem_bytes.argtypes = [_i] * 8
        lib.megastep_smem_bytes.restype = _i
        lib.megastep_error_string.argtypes = [_i]
        lib.megastep_error_string.restype = ctypes.c_char_p
    return lib


def _check(t: torch.Tensor, name: str, dtype, shape, device) -> None:
    if t.device != device:
        raise ValueError(f"{name} is on {t.device}, expected {device}")
    if t.dtype != dtype:
        raise ValueError(f"{name} has dtype {t.dtype}, expected {dtype}")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name} has shape {tuple(t.shape)}, expected "
                         f"{tuple(shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")


def _tile(lib, which: int, plan: MegaPlan, npolf: int, start: int,
          limit: int) -> int:
    """Largest power-of-two tile <= start whose shared memory fits."""
    tile = start
    while tile > 1 and _smem(lib, which, plan, npolf, tile) > limit:
        tile //= 2
    return tile


def _smem(lib, which: int, plan: MegaPlan, npolf: int, tile: int) -> int:
    return lib.megastep_smem_bytes(which, plan.R1, plan.row_len,
                                   plan.freq_res, npolf, plan.nplane,
                                   plan.nbin, tile)


def megastep_cuda(plan: MegaPlan, cst: MegaConstants, profiles: torch.Tensor,
                  hits: torch.Tensor, raw: torch.Tensor, phi0: torch.Tensor,
                  dphi: torch.Tensor, bounds=None):
    """One fused fold step on the card; arguments as
    ``ops.megakernel.megastep_plain`` (float32 carries).  Returns new
    ``(profiles, hits)``."""
    check_supported(plan)
    p = plan
    dev = raw.device
    if dev.type != "cuda":
        raise ValueError(f"megastep_cuda needs CUDA tensors, got {dev}")
    npart = phi0.shape[0]
    nchan = p.nchan_in
    f32 = torch.float32
    _check(raw, "raw", torch.uint8,
           (p.block_ndat(npart) * nchan * p.npol,), dev)
    _check(phi0, "phi0", f32, (npart,), dev)
    _check(dphi, "dphi", f32, (npart,), dev)
    _check(profiles, "profiles", f32, (nchan, p.nplane, p.nsub, p.nbin), dev)
    _check(hits, "hits", f32, (nchan, p.nbin), dev)
    _check(cst.gr, "cst.gr", f32, (nchan, p.n_fft), dev)
    _check(cst.gi, "cst.gi", f32, (nchan, p.n_fft), dev)
    if p.block_ndat(npart) * nchan * p.npol >= 1 << 31 \
            or npart * p.nkeep >= 1 << 31:
        raise NotImplementedError("blocks of 2^31 bytes or output samples")

    lib = _lib()
    pols = fold_pols(p)
    npolf = len(pols)
    props = torch.cuda.get_device_properties(dev)
    limit = getattr(props, "shared_memory_per_block_optin", 232448)
    tc = _tile(lib, 0, p, npolf, min(16, p.row_len), limit)
    tk = _tile(lib, 1, p, npolf, min(8, p.R1), limit)
    for which, tile in ((0, tc), (1, tk), (2, 0)):
        need = _smem(lib, which, p, npolf, tile)
        if need > limit:
            raise NotImplementedError(
                f"geometry (R1={p.R1}, R2={p.R2}, freq_res={p.freq_res}, "
                f"nbin={p.nbin}) needs {need} B of shared memory in pass "
                f"{which}, over the card's {limit} B; a multi-pass inverse "
                "is ROADMAP.md Queue 2 item 1 work")

    prof_out = torch.empty_like(profiles)
    hits_out = torch.empty_like(hits)
    cbuf = torch.empty((nchan * npolf, npart, p.R1, p.row_len, 2),
                       dtype=f32, device=dev)
    ybuf = torch.empty((nchan * npolf, npart, p.n_fft, 2), dtype=f32,
                       device=dev)
    pacc = torch.empty_like(profiles)
    hacc = torch.empty((nchan, p.nbin), dtype=torch.int32, device=dev)
    lo, hi = bounds_pair(bounds)
    stream = torch.cuda.current_stream(dev).cuda_stream
    with torch.cuda.device(dev):
        rc = lib.megastep_launch(
            raw.data_ptr(), phi0.data_ptr(), dphi.data_ptr(),
            cst.gr.data_ptr(), cst.gi.data_ptr(), profiles.data_ptr(),
            hits.data_ptr(), prof_out.data_ptr(), hits_out.data_ptr(),
            cbuf.data_ptr(), ybuf.data_ptr(), pacc.data_ptr(),
            hacc.data_ptr(),
            nchan, p.npol, pols[0], npolf, npart, p.R1, p.R2, p.nsub,
            p.freq_res, p.nfilt_pos, p.nkeep, p.nbin, p.nplane,
            detection_code(p), int(p.fourth_moment),
            int(p.twos_complement), cst.unpack_scale, cst.unpack_offset,
            p.nsamp_step, tc, tk, lo, hi, stream)
    if rc != 0:
        msg = lib.megastep_error_string(rc).decode()
        raise RuntimeError(f"megastep launch failed: CUDA error {rc}: {msg}")
    count_launch("megastep")
    return prof_out, hits_out
