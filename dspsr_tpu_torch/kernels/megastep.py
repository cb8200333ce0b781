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


def check_tensor(t: torch.Tensor, name: str, dtype, shape, device) -> None:
    """Raise ``ValueError`` unless ``t`` is a contiguous ``dtype`` tensor of
    ``shape`` on ``device``."""
    if t.device != device:
        raise ValueError(f"{name} is on {t.device}, expected {device}")
    if t.dtype != dtype:
        raise ValueError(f"{name} has dtype {t.dtype}, expected {dtype}")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name} has shape {tuple(t.shape)}, expected "
                         f"{tuple(shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")


def smem_limit(dev: torch.device) -> int:
    """Shared memory one block may opt in to on ``dev``, in bytes."""
    props = torch.cuda.get_device_properties(dev)
    return getattr(props, "shared_memory_per_block_optin", 232448)


def forward_tiles(smem, plan: MegaPlan, limit: int) -> tuple[int, int]:
    """Tiles (columns of ``mega_fwd1``, rows of ``mega_fwd2``): the largest
    powers of two up to 16 and 8 whose shared memory ``smem(which, tile)``
    fits in ``limit``."""
    def tile(which: int, start: int) -> int:
        t = start
        while t > 1 and smem(which, t) > limit:
            t //= 2
        return t

    return tile(0, min(16, plan.row_len)), tile(1, min(8, plan.R1))


def check_smem(smem, plan: MegaPlan, tiles, limit: int) -> None:
    """Raise ``NotImplementedError`` when a pass needs more shared memory
    than ``limit`` (``tiles`` for passes 0, 1; pass 2 is the inverse)."""
    for which, tile in ((0, tiles[0]), (1, tiles[1]), (2, 0)):
        need = smem(which, tile)
        if need > limit:
            raise NotImplementedError(
                f"geometry (R1={plan.R1}, R2={plan.R2}, freq_res="
                f"{plan.freq_res}, nbin={plan.nbin}) needs {need} B of shared "
                f"memory in pass {which}, over the card's {limit} B; a "
                "multi-pass inverse is open work (ROADMAP.md Queue 2)")


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
    check_tensor(raw, "raw", torch.uint8,
                 (p.block_ndat(npart) * nchan * p.npol,), dev)
    check_tensor(phi0, "phi0", f32, (npart,), dev)
    check_tensor(dphi, "dphi", f32, (npart,), dev)
    check_tensor(profiles, "profiles", f32,
                 (nchan, p.nplane, p.nsub, p.nbin), dev)
    check_tensor(hits, "hits", f32, (nchan, p.nbin), dev)
    check_tensor(cst.gr, "cst.gr", f32, (nchan, p.n_fft), dev)
    check_tensor(cst.gi, "cst.gi", f32, (nchan, p.n_fft), dev)
    if p.block_ndat(npart) * nchan * p.npol >= 1 << 31 \
            or npart * p.nkeep >= 1 << 31:
        raise NotImplementedError("blocks of 2^31 bytes or output samples")

    lib = _lib()
    pols = fold_pols(p)
    npolf = len(pols)

    def smem(which, tile):
        return lib.megastep_smem_bytes(which, p.R1, p.row_len, p.freq_res,
                                       npolf, p.nplane, p.nbin, tile)

    limit = smem_limit(dev)
    tc, tk = forward_tiles(smem, p, limit)
    check_smem(smem, p, (tc, tk), limit)

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
