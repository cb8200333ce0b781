"""Wrapper of the hand-written CUDA fused search front end
(``csrc/megafil.cu``).

Replaces ``dspsr_tpu/ops/megakernel.py::build_megafil`` (the Pallas kernel
and its de-permute), on every input ``build_megastep`` takes (1/2/4/8-bit
codes, JA98 2-bit with its window weights as the weights output, float32,
an apodization window): detected or voltage output, the scalar chirp or the
Jones 2x2 mix followed by it, with the passband tap and a chirp handed in
on each call, and past one CTA's shared memory or threads (the ``nsub ==
1`` convolution of ``hybrid_conv32``; ``-F nsub:D`` at the DMs of most
pulsars) the multi-pass inverse, with the long row pass for real input at
``R2 = 8192``.  The source note in
``csrc/megafil.cu`` says what bounds it and how it is laid out.  This
wrapper checks every operand, chooses the inverse from the geometry,
allocates the output and scratch with ``torch.empty``, launches the
kernels on the current stream through the library's C entry point, raises
on any CUDA error, and counts the launch.  It never falls back to the plain
version.
"""

from __future__ import annotations

import ctypes

import torch

from ..device import count_launch
from ..ops.megakernel import (
    MegaConstants, MegaPlan, detection_code, fold_pols, passband_layout,
    voltage_sign_flips)
from . import build
from .megastep import (
    FWD1, INV, INVA, INVB, cbuf_seqs, check_resources, check_tensor,
    code_kind, device_tables, fits, forward_tiles, ftp_buffer,
    kernel_attributes, layout_code, multipass_tiles, smem_limit, step_passes,
    unpack_operands)

_c = ctypes.c_void_p
_i = ctypes.c_int
_f = ctypes.c_float
_LAUNCH_ARGTYPES = [_c] * 17 + [_i] * 19 + [_f, _f] + [_i] * 8 + [_c]

#: rows of a ``megafil_invb`` tile at most: 4 (at R1 = 1024, 256 threads
#: and two CTAs an SM), or 8 for four detected planes, whose runs of 4
#: samples were half sectors (8 rows, one CTA an SM: ``conv32_jones`` 1.82
#: ms against 2.41, while ``hybrid_conv32``'s Intensity took 1.25-1.27
#: against 1.16, measured before the radix-8 fix of ``mega_common.cuh``
#: item 9; H100, 700 W)
INVB_ROWS = (4, 8)


def _lib() -> ctypes.CDLL:
    lib = build.load("megafil")
    if lib.megafil_launch.argtypes is None:
        lib.megafil_launch.argtypes = _LAUNCH_ARGTYPES
        lib.megafil_launch.restype = _i
        lib.megafil_resources.argtypes = [_i] * 8
        lib.megafil_resources.restype = _i
        lib.megafil_attributes.argtypes = [_i] * 5 + [_c]
        lib.megafil_attributes.restype = _i
        lib.megafil_error_string.argtypes = [_i]
        lib.megafil_error_string.restype = ctypes.c_char_p
    return lib


def inverse_passes(res, plan: MegaPlan, limit: int, inverse: str = "auto",
                   output: str = "detected") -> tuple[int, int]:
    """The inverse for ``plan``: ``(0, 0)`` for the one-CTA inverse
    (``megafil_invdet``/``megafil_invvolt``) while its shared memory and
    threads (``res(kind, INV, 0)``) fit, else the tiles ``(ta, tb)`` of the
    multi-pass inverse (``mega_inva``, ``megafil_invb``: any ``nsub``; pass
    B's rows ``INVB_ROWS``, the second for four detected planes), which
    ``inverse="multipass"`` also forces."""
    if inverse == "auto" and fits(res, INV, 0, limit):
        return 0, 0
    rows = INVB_ROWS[1 if output == "detected" and plan.nplane == 4 else 0]
    return multipass_tiles(res, plan, limit, min(rows, plan.R2))


def multipass_attributes(plan: MegaPlan, nout: int,
                         jones: bool = False) -> dict:
    """Registers and local bytes of the search front end's multi-pass
    passes for ``plan`` and ``nout`` pols (with the Jones mix when
    ``jones``): ``{"mega_inva": ..., "megafil_invb": ...}``
    (``kernels.megastep.kernel_attributes``)."""
    lib = _lib()
    return {"mega_inva": kernel_attributes(lib.megafil_attributes, INVA,
                                           plan.R1, plan.q, nout, int(jones)),
            "megafil_invb": kernel_attributes(lib.megafil_attributes,
                                              INVB, plan.R1, plan.q, nout,
                                              int(jones))}


def megafil_cuda(plan: MegaPlan, cst: MegaConstants, raw: torch.Tensor,
                 npart: int, passband: bool = False, gr=None, gi=None,
                 output: str = "detected", inverse: str = "auto",
                 return_weights: bool = False, jones=None,
                 row_pass: str = "auto"):
    """One fused search front-end step on the card; arguments as
    ``ops.megakernel.megafil_plain``.  Returns float32 ``[nchan_in*nsub,
    nplane, npart*nkeep]`` (``output="voltage"``: complex64
    ``[nchan_in*nsub, npol, npart*nkeep]``, every input pol), with
    ``return_weights`` then the window weights ``[nchan_in, npart]`` (the
    JA98 pre-pass's, else ones), and with ``passband`` last the passband
    ``[nchan_in*nsub, npol, freq_res]``.  ``gr``/``gi`` (default
    ``cst.gr``/``cst.gi``) are the chirp, float32 ``[nchan_in, n_fft]`` in
    natural bin order; ``jones`` (default ``cst.jones``), when set, the
    Jones response float32 ``[nchan_in, 4, n_fft, 2]`` mixed in before
    it.  ``inverse="multipass"`` forces the multi-pass inverse where the
    one-CTA inverse fits, ``row_pass="long"`` the long row pass where
    ``mega_fwd2`` fits (real input), for checks."""
    p = plan
    dev = raw.device
    if dev.type != "cuda":
        raise ValueError(f"megafil_cuda needs CUDA tensors, got {dev}")
    if p.fourth_moment:
        raise ValueError("megafil: apply fourth moments after the front end")
    if inverse not in ("auto", "multipass"):
        raise ValueError(f"unknown inverse: {inverse}")
    nchan = p.nchan_in
    f32 = torch.float32
    # held: the tensors behind the pointers, alive through the launch
    unpack_ptrs, held = unpack_operands(p, cst, raw, npart)
    gr = cst.gr if gr is None else gr
    gi = cst.gi if gi is None else gi
    check_tensor(gr, "gr", f32, (nchan, p.n_fft), dev)
    check_tensor(gi, "gi", f32, (nchan, p.n_fft), dev)
    jones = cst.jones if jones is None else jones
    if jones is not None:
        if p.npol != 2:
            raise ValueError("a Jones response needs npol == 2")
        check_tensor(jones, "jones", f32, (nchan, 4, p.n_fft, 2), dev)
    # the kernels index with 64-bit offsets; the sample and window counts
    # they take as int must fit
    if npart * p.nkeep >= 1 << 31 or p.block_ndat(npart) >= 1 << 31:
        raise NotImplementedError("blocks of 2^31 samples per channel")

    lib = _lib()
    voltage = output == "voltage"
    pols = tuple(range(p.npol)) if voltage else fold_pols(p)
    # the forward transforms the detected pols, or with the passband tap or
    # a Jones response every input pol; it keeps the detected ones (store
    # bits), or for the Jones mix both; the voltage keeps every input pol
    fwd = tuple(range(p.npol)) if passband or jones is not None else pols
    npolf = len(fwd)
    store = (3 if jones is not None
             else sum(1 << fwd.index(q) for q in pols))
    nout = len(pols)

    def res(kind, which, tile):
        return lib.megafil_resources(kind, which, p.R1, p.row_len,
                                     p.freq_res, nout, tile, layout_code(p))

    limit = smem_limit(dev)
    tc, tk = forward_tiles(res, p, limit, row_pass)
    ta, tb = inverse_passes(res, p, limit, inverse, output)
    inv = ((INVA, ta), (INVB, tb)) if ta else ((INV, 0),)
    check_resources(res, p, ((FWD1, tc),) + step_passes(p, tk, inv), limit)

    if voltage:
        out = torch.empty((nchan * p.nsub, p.npol, npart * p.nkeep),
                          dtype=torch.complex64, device=dev)
    else:
        out = torch.empty((nchan * p.nsub, p.nplane, npart * p.nkeep),
                          dtype=f32, device=dev)
    tw = device_tables(p, dev)
    # the multi-pass inverse's tables: lengths R1 and q, factors over M
    tw2 = device_tables(p, dev, row_len=p.q) if ta else tw
    psum = torch.empty((nchan, npart, 2), dtype=f32, device=dev)
    # stage-1 columns; the multi-pass inverse reuses them for its own
    # nchan*nout windows of N points (no larger)
    cbuf = torch.empty((nchan * cbuf_seqs(p, npolf), npart, p.R1,
                        p.row_len, 2), dtype=f32, device=dev)
    ybuf = torch.empty((nchan * (store & 1) + nchan * (store >> 1), npart,
                        p.n_fft, 2), dtype=f32, device=dev)
    pb = (torch.empty((nchan, npolf, p.n_fft), dtype=f32, device=dev)
          if passband else None)
    ftp = ftp_buffer(p, npart, dev)
    stream = torch.cuda.current_stream(dev).cuda_stream
    with torch.cuda.device(dev):
        rc = lib.megafil_launch(
            raw.data_ptr(), gr.data_ptr(), gi.data_ptr(), tw.data_ptr(),
            tw2.data_ptr(), None if jones is None else jones.data_ptr(),
            out.data_ptr(), psum.data_ptr(), cbuf.data_ptr(),
            ybuf.data_ptr(), None if pb is None else pb.data_ptr(),
            *unpack_ptrs, None if ftp is None else ftp.data_ptr(), nchan,
            p.npol, fwd[0], npolf, store, nout,
            pols[0] if jones is not None else 0, npart, p.R1, p.R2, p.nsub,
            p.freq_res, p.nfilt_pos, p.nkeep, p.nplane, detection_code(p),
            int(voltage), int(voltage_sign_flips(p)),
            int(p.twos_complement), cst.unpack_scale, cst.unpack_offset,
            p.nsamp_step, tc, tk, ta, tb, layout_code(p), code_kind(p),
            p.npw, stream)
    if rc != 0:
        msg = lib.megafil_error_string(rc).decode()
        raise RuntimeError(f"megafil launch failed: CUDA error {rc}: {msg}")
    count_launch("megafil")
    if p.npw:
        count_launch("mega_ja98")
    res = [out]
    if return_weights:
        res.append(held[-1] if p.npw else torch.ones(
            (nchan, npart), dtype=f32, device=dev))
    if passband:
        res.append(passband_layout(p, pb))
    return res[0] if len(res) == 1 else tuple(res)
