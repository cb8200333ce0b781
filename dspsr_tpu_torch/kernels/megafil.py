"""Wrapper of the hand-written CUDA fused search front end
(``csrc/megafil.cu``).

Replaces ``dspsr_tpu/ops/megakernel.py::build_megafil`` (the Pallas kernel
and its de-permute) in the detected, scalar-chirp form.  The source note in
``csrc/megafil.cu`` says what bounds it and how it is laid out.  This
wrapper checks every operand, allocates the output and scratch with
``torch.empty``, launches the kernels on the current stream through the
library's C entry point, raises on any CUDA error, and counts the
launch.  It never falls back to the plain version.
"""

from __future__ import annotations

import ctypes

import torch

from ..device import count_launch
from ..ops.megakernel import (
    MegaConstants, MegaPlan, check_supported, detection_code, fold_pols)
from . import build
from .megastep import (
    check_resources, check_tensor, device_tables, forward_tiles, smem_limit)

_c = ctypes.c_void_p
_i = ctypes.c_int
_f = ctypes.c_float
_LAUNCH_ARGTYPES = [_c] * 8 + [_i] * 14 + [_f, _f] + [_i] * 3 + [_c]


def _lib() -> ctypes.CDLL:
    lib = build.load("megafil")
    if lib.megafil_launch.argtypes is None:
        lib.megafil_launch.argtypes = _LAUNCH_ARGTYPES
        lib.megafil_launch.restype = _i
        lib.megafil_resources.argtypes = [_i] * 7
        lib.megafil_resources.restype = _i
        lib.megafil_error_string.argtypes = [_i]
        lib.megafil_error_string.restype = ctypes.c_char_p
    return lib


def megafil_cuda(plan: MegaPlan, cst: MegaConstants, raw: torch.Tensor,
                 npart: int) -> torch.Tensor:
    """One fused search front-end step on the card; arguments as
    ``ops.megakernel.megafil_plain``.  Returns float32 ``[nchan_in*nsub,
    nplane, npart*nkeep]``."""
    check_supported(plan)
    p = plan
    dev = raw.device
    if dev.type != "cuda":
        raise ValueError(f"megafil_cuda needs CUDA tensors, got {dev}")
    if p.fourth_moment:
        raise ValueError("megafil: apply fourth moments after the front end")
    nchan = p.nchan_in
    f32 = torch.float32
    check_tensor(raw, "raw", torch.uint8,
                 (p.block_ndat(npart) * nchan * p.npol,), dev)
    check_tensor(cst.gr, "cst.gr", f32, (nchan, p.n_fft), dev)
    check_tensor(cst.gi, "cst.gi", f32, (nchan, p.n_fft), dev)
    # the kernels index with 64-bit offsets; the sample and window counts
    # they take as int must fit
    if npart * p.nkeep >= 1 << 31 or p.block_ndat(npart) >= 1 << 31:
        raise NotImplementedError("blocks of 2^31 samples per channel")

    lib = _lib()
    pols = fold_pols(p)
    npolf = len(pols)

    def res(kind, which, tile):
        return lib.megafil_resources(kind, which, p.R1, p.row_len,
                                     p.freq_res, npolf, tile)

    limit = smem_limit(dev)
    tc, tk = forward_tiles(res, p, limit)
    check_resources(res, p, (tc, tk), limit)

    out = torch.empty((nchan * p.nsub, p.nplane, npart * p.nkeep), dtype=f32,
                      device=dev)
    tw = device_tables(p, dev)
    psum = torch.empty((nchan, npart, 2), dtype=f32, device=dev)
    cbuf = torch.empty((nchan, npart, p.R1, p.row_len, 2), dtype=f32,
                       device=dev)
    ybuf = torch.empty((nchan * npolf, npart, p.n_fft, 2), dtype=f32,
                       device=dev)
    stream = torch.cuda.current_stream(dev).cuda_stream
    with torch.cuda.device(dev):
        rc = lib.megafil_launch(
            raw.data_ptr(), cst.gr.data_ptr(), cst.gi.data_ptr(),
            tw.data_ptr(), out.data_ptr(), psum.data_ptr(), cbuf.data_ptr(),
            ybuf.data_ptr(),
            nchan, p.npol, pols[0], npolf, npart, p.R1, p.R2, p.nsub,
            p.freq_res, p.nfilt_pos, p.nkeep, p.nplane, detection_code(p),
            int(p.twos_complement), cst.unpack_scale, cst.unpack_offset,
            p.nsamp_step, tc, tk, stream)
    if rc != 0:
        msg = lib.megafil_error_string(rc).decode()
        raise RuntimeError(f"megafil launch failed: CUDA error {rc}: {msg}")
    count_launch("megafil")
    return out
