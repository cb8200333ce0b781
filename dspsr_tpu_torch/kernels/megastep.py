"""Wrapper of the hand-written CUDA fused fold step (``csrc/megastep.cu``).

Replaces ``dspsr_tpu/ops/megakernel.py::build_megastep`` (the Pallas
kernel) and what its XLA pre-stage (``_prepare_input``) computed: for JA98
2-bit input the nlow counts, level tables and window weights, and for
multi-channel TFP input the channel transpose (the pre-pass ``mega_ftp``,
into a copy this wrapper allocates, ``ftp_buffer``).  The source note in
``csrc/megastep.cu`` says what bounds it and how it is laid out.  This
wrapper checks every operand, chooses each pass from the geometry and the
card's limits (``forward_tiles``, ``fold_passes``: the multi-pass inverse
past one CTA, the long row pass at R2 = 8192, the clustered complex row
pass from ``CLUSTER_R2``; these choosers serve ``kernels.megafil`` too),
allocates the outputs and scratch with ``torch.empty``, builds the plan's
twiddle tables once (``twiddle_tables``, plain numpy, cached on the
device), launches the kernels on the current stream through the library's
C entry point, raises on any CUDA error, and counts the launch
(``megastep``, and ``mega_ja98`` for the JA98 pre-pass).  It never falls
back to the plain version.
"""

from __future__ import annotations

import ctypes

import numpy as np
import torch

from ..device import count_launch
from ..ops.megakernel import (
    MegaConstants, MegaPlan, bounds_pair, detection_code, fold_pols,
    raw_nbytes)
from . import build

_c = ctypes.c_void_p
_i = ctypes.c_int
_f = ctypes.c_float
_LAUNCH_ARGTYPES = [_c] * 23 + [_i] * 16 + [_f, _f] + [_i] * 10 + [_c]
_JA98_ARGTYPES = [_c] * 5 + [_i] * 7 + [_c]

#: the transform kernels' block size limit (``kMaxThreads``)
MAX_THREADS = 512
#: largest tiles tried: columns of ``mega_fwd1``, row pairs of ``mega_fwd2``
#: (real input), rows of ``mega_fwd2c`` (complex input)
TILE_CAPS = (8, 4, 8)
#: the passes a resource query names (``Pass`` in ``csrc/mega_common.cuh``):
#: the forward's two, the one-CTA inverse, the multi-pass inverse's pass A
#: and pass B, the long row pass's two kernels, and the complex row pass as
#: thread-block clusters (``mega_fwd2cc``, one row a CTA)
(FWD1, FWD2, INV, INVA, INVB, ROWFFT, ROWPAIR, FWD2_CLUSTER) = range(8)
#: complex input from this R2 (``kClusterR2``), where a ``mega_fwd2c`` tile
#: holds fewer than 4 rows, runs ``mega_fwd2cc`` in clusters of
#: ``CLUSTER_ROWS`` CTAs (``kClusterRows``; fewer when R1 is smaller)
CLUSTER_R2 = 4096
CLUSTER_ROWS = 4
#: time samples of a channel stream in the pre-pass's copy are rounded up
#: to a multiple of this (``kFtpAlign``)
FTP_ALIGN = 16
#: k1 columns of a pass-A tile (``mega_inva``) at least, where R1 and the
#: card allow: rows of 128 bytes; more where q is short, up to
#: ``MAX_THREADS`` threads
INVA_COLS = 16
#: rows of the fold's pass-B tile at most (``mega_invbfold``): 256
#: threads at R1 = 1024, so that two CTAs share an SM
FOLD_ROWS = 4


def _lib() -> ctypes.CDLL:
    lib = build.load("megastep")
    if lib.megastep_launch.argtypes is None:
        lib.megastep_launch.argtypes = _LAUNCH_ARGTYPES
        lib.megastep_launch.restype = _i
        lib.megastep_resources.argtypes = [_i] * 8
        lib.megastep_resources.restype = _i
        lib.megastep_attributes.argtypes = [_i] * 6 + [_c]
        lib.megastep_attributes.restype = _i
        lib.megastep_ja98.argtypes = _JA98_ARGTYPES
        lib.megastep_ja98.restype = _i
        lib.megastep_error_string.argtypes = [_i]
        lib.megastep_error_string.restype = ctypes.c_char_p
    return lib


def kernel_attributes(fn, *args) -> dict:
    """``cudaFuncGetAttributes`` of a kernel through a library's C entry
    point ``fn(*args, out)``: its registers a thread, local (spill) bytes a
    thread and the most threads a block may have."""
    out = (ctypes.c_int * 3)()
    rc = fn(*args, out)
    if rc != 0:
        raise RuntimeError(f"cudaFuncGetAttributes failed: CUDA error {rc}")
    return dict(regs=out[0], local_bytes=out[1], max_threads=out[2])


def step_resources(lib, p: MegaPlan):
    """``res(kind, which, tile)``: the fold step's shared-memory bytes
    (kind 0) or threads (kind 1) of pass ``which`` for ``p``
    (``megastep_resources``)."""
    npolf = len(fold_pols(p))

    def res(kind, which, tile):
        return lib.megastep_resources(kind, which, p.R1, p.row_len,
                                      p.freq_res, npolf, tile,
                                      layout_code(p))
    return res


def inverse_attributes(plan: MegaPlan) -> dict:
    """Registers and local bytes of the fold step's inverse kernels for
    ``plan`` on the card (``kernel_attributes``), as ``fold_passes``
    chooses them: ``{"mega_invfold": ...}`` for the one-CTA inverse, else
    ``{"mega_inva": ..., "mega_invbfold": ...}``."""
    lib = _lib()
    npolf = len(fold_pols(plan))
    ta, _ = fold_passes(step_resources(lib, plan), plan,
                        smem_limit(torch.device("cuda")))

    def attrs(which):
        return kernel_attributes(lib.megastep_attributes, which, plan.R1,
                                 plan.q, plan.freq_res, npolf, plan.nplane)
    if not ta:
        return {"mega_invfold": attrs(INV)}
    return {"mega_inva": attrs(INVA),
            "mega_invbfold": attrs(INVB)}


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


def fft_pass_bits(L: int) -> list[int]:
    """Bits of each pass of the kernels' length-L FFT (``pass_bits`` in
    ``csrc/mega_common.cuh``): radix 16 first (the whole sequence below 16
    points), then the remaining bits split as evenly as possible, larger
    first."""
    lgp = min(4, L.bit_length() - 1)
    if lgp == L.bit_length() - 1:
        return [lgp]
    rem = L.bit_length() - 1 - lgp
    n = -(-rem // lgp)
    return [lgp] + [rem // n + (1 if s < rem % n else 0) for s in range(n)]


def twiddle_tables(R1: int, row_len: int, M: int,
                   dtype=np.complex64) -> np.ndarray:
    """The kernels' twiddle tables for one plan, in one buffer (the layout
    of ``Tables`` in ``csrc/mega_common.cuh``):

    - for L = R1, row_len and M, L entries: for each pass s >= 1 of the
      length-L FFT in turn (radix R, Ns = product of the earlier radices),
      ``exp(-2 pi i k r / (Ns R))`` at ``(r-1)*Ns + k``, then zeros;
    - over the window length W = R1 * row_len (2N real samples for real
      input, where row_len = 2 R2; N complex samples for complex input,
      where row_len = R2): ``lo[e] = exp(-2 pi i e / W)``, ``e <
      2^lo_bits``, and ``hi[e] = exp(-2 pi i e 2^lo_bits / W)``, ``e < W /
      2^lo_bits``, with lo_bits = (log2(W) + 1) // 2;
    - ``col[k1*16 + c] = exp(-2 pi i c k1 / W)``, ``k1 < R1``, ``c < 16``.

    Computed in float64 and rounded once to ``dtype`` (complex64 for the
    kernels)."""
    two_n = R1 * row_len
    log2n = two_n.bit_length() - 1
    lo_bits = (log2n + 1) // 2

    def turns(num, den):
        return np.exp(-2j * np.pi * (np.asarray(num, np.float64) / den))

    parts = []
    for L in (R1, row_len, M):
        bits = fft_pass_bits(L)
        ns, table = 1 << bits[0], []
        for b in bits[1:]:
            R = 1 << b
            table.append(turns(np.arange(1, R)[:, None] * np.arange(ns),
                               ns * R).ravel())
            ns *= R
        table.append(np.zeros(L - sum(t.size for t in table)))
        parts += table
    parts.append(turns(np.arange(1 << lo_bits), two_n))
    parts.append(turns(np.arange(1 << (log2n - lo_bits)) << lo_bits, two_n))
    parts.append(turns(np.arange(R1)[:, None] * np.arange(16), two_n).ravel())
    return np.concatenate(parts).astype(dtype)


_tables: dict = {}


def device_tables(plan: MegaPlan, dev: torch.device,
                  row_len: int | None = None) -> torch.Tensor:
    """``twiddle_tables`` of ``plan`` (with ``row_len`` in place of the
    plan's, when given) as float32 ``[n, 2]`` on ``dev``, built once per
    geometry and device and cached."""
    row_len = plan.row_len if row_len is None else row_len
    key = (plan.R1, row_len, plan.freq_res, str(dev))
    t = _tables.get(key)
    if t is None:
        host = twiddle_tables(plan.R1, row_len, plan.freq_res)
        t = torch.from_numpy(host.view(np.float32).reshape(-1, 2)).to(dev)
        _tables[key] = t
    return t


def fitting_tile(res, which: int, start: int, limit: int) -> int:
    """The largest power of two up to ``start`` whose shared memory
    ``res(0, which, tile)`` fits in ``limit`` and whose threads ``res(1,
    which, tile)`` fit in a block (1 when none does)."""
    t = start
    while t > 1 and (res(0, which, t) > limit
                     or res(1, which, t) > MAX_THREADS):
        t //= 2
    return t


def forward_tiles(res, plan: MegaPlan, limit: int,
                  row_pass: str = "auto") -> tuple[int, int]:
    """Tiles (columns of ``mega_fwd1``; row pairs of ``mega_fwd2`` for real
    input, rows of ``mega_fwd2c`` for complex input): the largest powers of
    two up to ``TILE_CAPS`` (and row_len; R1/2 pairs or R1 rows) that fit
    (``fitting_tile``).  The second is 0 for the long row pass
    (``mega_rowfft``, ``mega_rowpair``): real input whose row pair fits no
    CTA (R2 = 8192), or any real input with ``row_pass="long"``; for
    complex input from ``CLUSTER_R2`` it is the CTAs of a ``mega_fwd2cc``
    cluster: ``CLUSTER_ROWS``, or R1 when that is smaller."""
    if row_pass not in ("auto", "long"):
        raise ValueError(f"unknown row pass: {row_pass}")
    tc = fitting_tile(res, FWD1, min(TILE_CAPS[0], plan.row_len), limit)
    if plan.real_input:
        if row_pass == "long" or not fits(res, FWD2, 1, limit):
            if plan.row_len < 32:
                raise ValueError("the long row pass needs rows of 32 points "
                                 "or more")
            return tc, 0
        return tc, fitting_tile(res, FWD2, min(TILE_CAPS[1], plan.R1 // 2),
                                limit)
    if row_pass == "long":
        raise ValueError("the long row pass is for real input")
    if plan.R2 >= CLUSTER_R2:
        return tc, min(CLUSTER_ROWS, plan.R1)
    return tc, fitting_tile(res, FWD2, min(TILE_CAPS[2], plan.R1), limit)


def ftp_nbytes(plan: MegaPlan, npart: int) -> int:
    """Bytes of the pre-pass's channel-transposed copy of one block (the
    ``ftp`` of ``launch_forward`` in ``csrc/mega_common.cuh``): 0 for one
    input channel
    (and the CASPSR layout), else nchan_in streams of block_ndat rounded up
    to ``FTP_ALIGN`` samples, each sample's npol*ndim codes in whole bytes,
    or a byte a code where they fill less than one."""
    p = plan
    if p.nchan_in == 1:
        return 0
    npd = p.npol * p.ndim
    tp = -(-p.block_ndat(npart) // FTP_ALIGN) * FTP_ALIGN
    bits = npd * p.nbit
    return p.nchan_in * tp * (npd if bits < 8 else bits // 8)


def ftp_buffer(plan: MegaPlan, npart: int, dev: torch.device):
    """The copy's scratch (``torch.empty``), or None for one channel."""
    n = ftp_nbytes(plan, npart)
    return torch.empty(n, dtype=torch.uint8, device=dev) if n else None


def fits(res, which: int, tile: int, limit: int) -> bool:
    """Whether pass ``which`` at ``tile`` fits a block: its shared memory
    in ``limit`` and its threads in ``MAX_THREADS``."""
    return res(0, which, tile) <= limit and res(1, which, tile) <= MAX_THREADS


def multipass_tiles(res, plan: MegaPlan, limit: int,
                    rows: int) -> tuple[int, int]:
    """Tiles of the multi-pass inverse: the k1 columns of a pass-A tile
    (``mega_inva``: ``INVA_COLS``, or where q is short as many as make
    ``MAX_THREADS`` threads of q/16 a column; at most R1; halved until it
    fits) and the rows of pass B (up to ``rows``)."""
    threads = plan.q // min(16, plan.q)  # a column's
    cols = min(plan.R1, max(INVA_COLS, MAX_THREADS // threads))
    return (fitting_tile(res, INVA, cols, limit),
            fitting_tile(res, INVB, rows, limit))


def fold_passes(res, plan: MegaPlan, limit: int,
                inverse: str = "auto") -> tuple[int, int]:
    """The fold step's inverse: ``(0, 0)`` for the one-CTA
    ``mega_invfold`` while it fits, else ``(ta, tb)``: the multi-pass
    inverse's tiles (pass B's rows at most q, so a tile is one subband's)
    with the fold in pass B.  ``inverse="multipass"`` forces the multi-pass
    inverse."""
    if inverse not in ("auto", "multipass"):
        raise ValueError(f"unknown inverse: {inverse}")
    if inverse == "auto" and fits(res, INV, 0, limit):
        return 0, 0
    return multipass_tiles(res, plan, limit, min(FOLD_ROWS, plan.q))


def layout_code(plan: MegaPlan) -> int:
    """The raw bytes' layout as the kernels' ``Layout``
    (``csrc/mega_common.cuh``): 0 real TFP, 1 real CASPSR, 2 complex
    TFP."""
    if not plan.real_input:
        return 2
    return 1 if plan.interleave == "caspsr" else 0


def code_kind(plan: MegaPlan) -> int:
    """The raw input's code kind as the kernels' ``Code``
    (``csrc/mega_common.cuh``): 0 8-bit, 1, 2 and 3 fixed-level 1-, 2- and
    4-bit, 4 JA98 2-bit, 5 float32."""
    if plan.npw:
        return 4
    return {8: 0, 1: 1, 2: 2, 4: 3, 32: 5}[plan.nbit]


def unpack_operands(plan: MegaPlan, cst: MegaConstants, raw: torch.Tensor,
                    npart: int):
    """Check the raw bytes of one block of ``plan`` and the unpack
    constants, and allocate the JA98 pre-pass's scratch: returns the C
    entry points' ``(window, tables, nlow, wblk, wwin)`` pointers (None
    where absent) and the tensors behind them; the last is the window
    weights ``wwin`` float32 ``[nchan_in, npart]`` for a JA98 plan."""
    p = plan
    dev = raw.device
    f32 = torch.float32
    check_tensor(raw, "raw", torch.uint8, (raw_nbytes(p, npart),), dev)
    if p.nbit == 32 and raw.data_ptr() % 4:
        raise ValueError("float32 input must be 4-byte aligned")
    held = []
    if cst.window is not None:
        check_tensor(cst.window, "cst.window", f32, (p.nsamp_fft,), dev)
        held.append(cst.window)
    window = None if cst.window is None else cst.window.data_ptr()
    if not p.npw:
        return (window, None, None, None, None), held
    check_tensor(cst.twobit, "cst.twobit", f32, (3, p.npw + 1), dev)
    nw = p.block_ndat(npart) // p.npw
    nlow = torch.empty((p.nchan_in * p.npol * p.ndim, nw), dtype=torch.int16,
                       device=dev)
    wblk = torch.empty((p.nchan_in, nw), dtype=f32, device=dev)
    wwin = torch.empty((p.nchan_in, npart), dtype=f32, device=dev)
    held += [cst.twobit, nlow, wblk, wwin]
    return (window, cst.twobit.data_ptr(), nlow.data_ptr(), wblk.data_ptr(),
            wwin.data_ptr()), held


def ja98_cuda(plan: MegaPlan, cst: MegaConstants, raw: torch.Tensor,
              npart: int):
    """The JA98 pre-pass alone (``mega_ja98``, ``mega_ja98_windows``) on
    one block of 2-bit codes: ``(nlow, wwin)``, the low-state counts int32
    ``[nchan_in, npol, ndim, nweights]`` and the window weights float32
    ``[nchan_in, npart]``, as ``ops.megakernel.twobit_plain`` gives them."""
    p = plan
    if not p.npw:
        raise ValueError("the JA98 pre-pass needs a plan with npw > 0")
    if raw.device.type != "cuda":
        raise ValueError(f"ja98_cuda needs CUDA tensors, got {raw.device}")
    ptrs, held = unpack_operands(p, cst, raw, npart)
    nlow, wwin = held[-3], held[-1]  # after the window, when there is one
    lib = _lib()
    stream = torch.cuda.current_stream(raw.device).cuda_stream
    with torch.cuda.device(raw.device):
        rc = lib.megastep_ja98(raw.data_ptr(), *ptrs[1:], p.nchan_in, p.npol,
                               p.ndim, npart, p.nsamp_step, p.nsamp_fft,
                               p.npw, stream)
    if rc != 0:
        msg = lib.megastep_error_string(rc).decode()
        raise RuntimeError(f"mega_ja98 launch failed: CUDA error {rc}: {msg}")
    count_launch("mega_ja98")
    nlow = (nlow.to(torch.int32) & 0xFFFF).reshape(
        p.nchan_in, p.npol, p.ndim, -1)
    return nlow, wwin


def cbuf_seqs(plan: MegaPlan, npolf: int) -> int:
    """Stage-1 sequences a (channel, window): one packed sequence for real
    input, one per transformed pol for complex input."""
    return 1 if plan.real_input else npolf


def check_resources(res, plan: MegaPlan, passes, limit: int) -> None:
    """Raise ``NotImplementedError`` when a pass needs more shared memory
    than ``limit`` or more threads than a block holds.  ``passes`` are
    ``(which, tile)`` pairs (``FWD1`` .. ``ROWPAIR``).  The pass choosers
    (``forward_tiles``, ``fold_passes``, ``kernels.megafil.inverse_passes``)
    fit every plan ``MegaPlan.choose_r1`` accepts on a card with 227 KB of
    shared memory a block, so this guards a smaller card."""
    for which, tile in passes:
        need, threads = res(0, which, tile), res(1, which, tile)
        if need > limit or threads > MAX_THREADS:
            raise NotImplementedError(
                f"geometry (R1={plan.R1}, R2={plan.R2}, freq_res="
                f"{plan.freq_res}, nbin={plan.nbin}) needs {need} B of shared "
                f"memory and {threads} threads in pass {which}, over the "
                f"card's {limit} B or {MAX_THREADS} threads")


def step_passes(plan: MegaPlan, tk: int, inverse_tiles) -> tuple:
    """The ``(which, tile)`` pairs a step launches after ``mega_fwd1``:
    the row pass (``mega_fwd2``/``mega_fwd2c`` at ``tk``, the long row pass
    when ``tk`` is 0, ``mega_fwd2cc`` in clusters of ``tk`` for complex
    input from ``CLUSTER_R2``), then ``inverse_tiles``."""
    if tk == 0:
        rows = ((ROWFFT, 0), (ROWPAIR, 0))
    elif not plan.real_input and plan.R2 >= CLUSTER_R2:
        rows = ((FWD2_CLUSTER, tk),)
    else:
        rows = ((FWD2, tk),)
    return rows + tuple(inverse_tiles)


def megastep_cuda(plan: MegaPlan, cst: MegaConstants, profiles: torch.Tensor,
                  hits: torch.Tensor, raw: torch.Tensor, phi0: torch.Tensor,
                  dphi: torch.Tensor, bounds=None, gr=None, gi=None,
                  weights=None, inverse: str = "auto",
                  row_pass: str = "auto"):
    """One fused fold step on the card; arguments as
    ``ops.megakernel.megastep_plain`` (float32 carries; ``gr``/``gi``, the
    chirp, default ``cst.gr``/``cst.gi``; ``weights``, when given, float32
    ``[nchan_in, npart]`` window weights that multiply the JA98 ones).
    ``inverse`` (``fold_passes``) and ``row_pass`` (``forward_tiles``)
    force the multi-pass inverse and the long row pass, for checks.
    Returns new ``(profiles, hits)``."""
    p = plan
    dev = raw.device
    if dev.type != "cuda":
        raise ValueError(f"megastep_cuda needs CUDA tensors, got {dev}")
    npart = phi0.shape[0]
    nchan = p.nchan_in
    f32 = torch.float32
    nbytes = raw_nbytes(p, npart)
    # held: the tensors behind the pointers, alive through the launch
    unpack_ptrs, held = unpack_operands(p, cst, raw, npart)
    check_tensor(phi0, "phi0", f32, (npart,), dev)
    check_tensor(dphi, "dphi", f32, (npart,), dev)
    check_tensor(profiles, "profiles", f32,
                 (nchan, p.nplane, p.nsub, p.nbin), dev)
    check_tensor(hits, "hits", f32, (nchan, p.nbin), dev)
    if weights is not None:
        check_tensor(weights, "weights", f32, (nchan, npart), dev)
    gr = cst.gr if gr is None else gr
    gi = cst.gi if gi is None else gi
    check_tensor(gr, "gr", f32, (nchan, p.n_fft), dev)
    check_tensor(gi, "gi", f32, (nchan, p.n_fft), dev)
    if nbytes >= 1 << 31 or npart * p.nkeep >= 1 << 31:
        raise NotImplementedError("blocks of 2^31 bytes or output samples")

    lib = _lib()
    pols = fold_pols(p)
    npolf = len(pols)
    res = step_resources(lib, p)
    limit = smem_limit(dev)
    tc, tk = forward_tiles(res, p, limit, row_pass)
    ta, tb = fold_passes(res, p, limit, inverse)
    inv = ((INVA, ta), (INVB, tb)) if ta else ((INV, 0),)
    check_resources(res, p, ((FWD1, tc),) + step_passes(p, tk, inv), limit)

    prof_out = torch.empty_like(profiles)
    hits_out = torch.empty_like(hits)
    tw = device_tables(p, dev)
    # the multi-pass inverse's tables: lengths R1 and q, factors over M
    tw2 = device_tables(p, dev, row_len=p.q) if ta else tw
    psum = torch.empty((nchan, npart, 2), dtype=f32, device=dev)
    # stage-1 columns; the multi-pass inverse reuses them for its own
    # nchan*npolf windows of N points (no larger)
    cbuf = torch.empty((nchan * cbuf_seqs(p, npolf), npart, p.R1,
                        p.row_len, 2), dtype=f32, device=dev)
    ybuf = torch.empty((nchan * npolf, npart, p.n_fft, 2), dtype=f32,
                       device=dev)
    pacc = torch.empty_like(profiles)
    hacc = torch.empty_like(hits)
    ftp = ftp_buffer(p, npart, dev)
    lo, hi = bounds_pair(bounds)
    stream = torch.cuda.current_stream(dev).cuda_stream
    with torch.cuda.device(dev):
        rc = lib.megastep_launch(
            raw.data_ptr(), phi0.data_ptr(), dphi.data_ptr(),
            gr.data_ptr(), gi.data_ptr(), tw.data_ptr(), tw2.data_ptr(),
            profiles.data_ptr(), hits.data_ptr(), prof_out.data_ptr(),
            hits_out.data_ptr(), psum.data_ptr(), cbuf.data_ptr(),
            ybuf.data_ptr(), pacc.data_ptr(), hacc.data_ptr(),
            None if weights is None else weights.data_ptr(), *unpack_ptrs,
            None if ftp is None else ftp.data_ptr(),
            nchan, p.npol, pols[0], npolf, npart, p.R1, p.R2, p.nsub,
            p.freq_res, p.nfilt_pos, p.nkeep, p.nbin, p.nplane,
            detection_code(p), int(p.fourth_moment),
            int(p.twos_complement), cst.unpack_scale, cst.unpack_offset,
            p.nsamp_step, tc, tk, ta, tb, lo, hi, layout_code(p),
            code_kind(p), p.npw, stream)
    if rc != 0:
        msg = lib.megastep_error_string(rc).decode()
        raise RuntimeError(f"megastep launch failed: CUDA error {rc}: {msg}")
    count_launch("megastep")
    if p.npw:
        count_launch("mega_ja98")
    return prof_out, hits_out
