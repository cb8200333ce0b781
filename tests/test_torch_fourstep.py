"""A float64 numpy mirror of the CUDA forward half and inverse
(``dspsr_tpu_torch/csrc/mega_common.cuh``), held against ``numpy.fft.rfft``
(real input), ``numpy.fft.fftshift(numpy.fft.fft(.))`` (complex input) and
the port's plain front end (``ops.megakernel._front_plain``).

The CUDA code cannot run on the CPU, so its index algebra is checked here:
the register-resident Stockham FFT (``fft_regs``: pass radices, thread
pattern ``j + T*i``, butterfly placement, table twiddles, the in-register
radix-2 DFT and its bit reversal), the packing of two real pols into one
complex sequence with the power-of-two scale of pol b, the row pairs
{k1, R1 - k1} with the self-paired rows 0 and R1/2, the partner columns and
the separation, the tile walk, the CASPSR byte index, the complex forward
half (one sequence per pol, the twiddle divisor N, one row a slot, the
centred store index; from R2 = 4096 the cluster's rank and k2 slice), the
channel-transposing pre-pass of multi-channel TFP input (``mega_ftp``,
``mega_ftpw``, and ``mega_ja98``'s stores: the tile walk, the widening of
sub-byte units, the one-channel addressing of the copy), and the wrapper's
twiddle-table layout (``kernels.megastep.twiddle_tables``, built here in
float64 so that the mirror can be held to 1e-12).
"""

import dataclasses

import numpy as np
import pytest
import torch

from dspsr_tpu.ops import megakernel as jmk
from dspsr_tpu.ops.filterbank import FilterbankPlan

from dspsr_tpu_torch.kernels.megastep import (
    CLUSTER_R2, CLUSTER_ROWS, FTP_ALIGN, TILE_CAPS, fft_pass_bits,
    ftp_nbytes, twiddle_tables)
from dspsr_tpu_torch.ops import megakernel as tmk
from dspsr_tpu_torch.unpack.unpackers import twobit_nlow

torch.set_num_threads(2)

TOL = 1e-12


# --------------------------------------------------------------------------
# the mirror
# --------------------------------------------------------------------------

def sidx(i):
    return i + (i >> 4)


def seq_ld(L):
    return L + (L >> 4) + 1


def fft_points(L):
    return 16 if L >= 16 else L


def pass_bits(s, logL, lgP):
    if s == 0:
        return lgP
    rem = logL - lgP
    n = (rem + lgP - 1) // lgP
    return rem // n + (1 if s - 1 < rem % n else 0)


def num_passes(logL, lgP):
    return 1 + (logL - lgP + lgP - 1) // lgP


def brev(i, bits):
    return int(format(i, f"0{bits}b")[::-1], 2) if bits else 0


def dft(x, d):
    """``dft<R, DIR>``: radix-2 DIF on the R registers, then bit reversal."""
    R = len(x)
    log = R.bit_length() - 1
    x = list(x)
    for st in range(log):
        h = R >> (st + 1)
        for g in range(0, R, 2 * h):
            for k in range(h):
                a, b = x[g + k], x[g + k + h]
                x[g + k] = a + b
                x[g + k + h] = (a - b) * np.exp(d * 2j * np.pi * (k * (8 // h)) / 16)
    y = [None] * R
    for i in range(R):
        y[brev(i, log)] = x[i]
    return y


def fft_regs(v, L, d, tw):
    """``fft_regs``: v[i, j, ...] is element j + T*i of each sequence (the
    trailing axes are sequences); returns X[j + T*i] in the same layout.
    ``tw`` is the length-L block of the wrapper's tables."""
    P = v.shape[0]
    T = L // P
    # no pass wider than radix 16 (P = 32: two butterflies a pass)
    lgP, logL = min(P.bit_length() - 1, 4), L.bit_length() - 1
    j = np.arange(T)
    seq = np.zeros((seq_ld(L),) + v.shape[2:], complex)
    v = v.astype(complex).copy()
    n, Ns, toff = num_passes(logL, lgP), 1, 0
    for s in range(n):
        if s > 0:
            v = np.stack([seq[sidx(j + T * i)] for i in range(P)])
        bits = pass_bits(s, logL, lgP)
        R, last = 1 << bits, s == n - 1
        B = P // R
        for u in range(B):
            b = j + u * T
            k = b & (Ns - 1)
            base = (b - k) * R + k
            x = [v[u + r * B].copy() for r in range(R)]
            if Ns > 1:
                for r in range(1, R):
                    w = tw[toff + (r - 1) * Ns + k]
                    w = w if d < 0 else np.conj(w)
                    x[r] = x[r] * w.reshape(w.shape + (1,) * (x[r].ndim - 1))
            x = dft(x, d)
            for r in range(R):
                if last:
                    v[u + r * B] = x[r]
                else:
                    seq[sidx(base + r * Ns)] = x[r]
        if s > 0:
            toff += (R - 1) * Ns
        Ns <<= bits
    return v


@dataclasses.dataclass
class Geom:
    R1: int
    R2: int
    M: int
    nchan: int
    npol: int
    pols: tuple
    npart: int
    step: int
    twos: bool = False
    scale: float = 1.0
    offset: float = -127.5
    cplx: bool = False  # complex (analytic) input: 2 bytes a pol sample
    caspsr: bool = False  # real input in the CASPSR byte layout
    nbit: int = 8  # bits a code (32: float32 samples)
    npw: int = 0  # JA98 2-bit codes: samples of a level block
    levels: object = None  # JA98: the lo and hi tables [2, npw + 1]
    nlow: object = None  # JA98: low-state counts [nchan*npol*ndim, blocks]

    @property
    def row_len(self):
        return self.R2 if self.cplx else 2 * self.R2

    @property
    def n(self):
        return self.R1 * self.R2

    def ndat(self):
        return (self.npart - 1) * self.step + self.R1 * self.row_len


def tables64(g):
    """The wrapper's table buffer, in float64, split as ``Tables``."""
    buf = twiddle_tables(g.R1, g.row_len, g.M, dtype=np.complex128)
    log2n = (g.R1 * g.row_len).bit_length() - 1
    lo_bits = (log2n + 1) // 2
    o = np.cumsum([0, g.R1, g.row_len, g.M, 1 << lo_bits,
                   1 << (log2n - lo_bits), 16 * g.R1, g.row_len])
    assert o[-1] == buf.size
    r1, row, inv, lo, hi, col, half = (buf[o[i]:o[i + 1]] for i in range(7))
    return dict(r1=r1, row=row, inv=inv, lo=lo, hi=hi, col=col, half=half,
                log2n=log2n, lo_bits=lo_bits)


def byte_index(g, t, c, pol):
    """Byte of real sample (t, c, pol): TFP, or the CASPSR layout
    (``caspsr_byte``); for complex input the byte of the real part."""
    if g.caspsr:
        return (t >> 2) * g.npol * 4 + pol * 4 + (t & 3)
    return ((t * g.nchan + c) * g.npol + pol) * (2 if g.cplx else 1)


def values(g, raw, pol):
    """Unpacked float64 samples of one pol, [nchan, ndat] (complex for
    complex input), straight from the TFP view of the bytes."""
    codes = raw.view(np.int8) if g.twos else raw
    if g.caspsr:  # the JAX package's reorder
        codes = codes.reshape(-1, g.npol, 4).transpose(0, 2, 1).reshape(-1)
    ndim = 2 if g.cplx else 1
    x = codes.reshape(g.ndat(), g.nchan, g.npol, ndim)[:, :, pol].astype(
        np.float64) * g.scale + g.offset
    x = x[..., 0] + 1j * x[..., 1] if g.cplx else x[..., 0]
    return x.T


# ---- the channel-transposing pre-pass (launch_forward's copy) ----

def ftp_layout(g):
    """``(T, tp, npd, bits)``: samples a block, samples between two channel
    streams of the copy (T rounded up to FTP_ALIGN), codes and bits of a
    channel's unit."""
    T = g.ndat()
    npd = g.npol * (2 if g.cplx else 1)
    return T, -(-T // FTP_ALIGN) * FTP_ALIGN, npd, npd * g.nbit


def ftp_ld(seg):
    return ((seg + 15) & ~15) + 16


def ftp_items(cc, nv):
    """``ftp_item``: thread item i -> (channel, 16-byte vector); lane pairs
    take the two halves of a sector, consecutive pairs consecutive
    channels."""
    i = np.arange(cc * 2 * ((nv + 1) // 2))
    c, v = (i >> 1) % cc, 2 * ((i >> 1) // cc) + (i & 1)
    return c[v < nv], v[v < nv]


def store_units(tile, E, out, writes, tp, t0, c0):
    """``store_units<E>``: tile [tt, cc*E] (rows t0.., channels c0..) to the
    copy, 16 bytes (16/E samples of one channel) an item."""
    tt, cc = tile.shape[0], tile.shape[1] // E
    per = 16 // E
    for c, v in zip(*ftp_items(cc, -(-tt // per))):
        r0 = v * per
        n = min(per, tt - r0)
        dst = ((c0 + c) * tp + t0 + r0) * E
        out[dst:dst + n * E] = tile[r0:r0 + n, c * E:(c + 1) * E].ravel()
        writes[dst:dst + n * E] += 1


def store_widened(span, nbit, nchan, npd, twos, out, writes, tp, t0, tt):
    """``store_widened<NBIT>``: rows t0 .. t0+tt-1 of every channel as one
    span of codes; each code to a byte (two's complement sign-extended)."""
    nb = tt * npd
    for c, v in zip(*ftp_items(nchan, -(-nb // 16))):
        o = 16 * v + np.arange(min(16, nb - 16 * v))
        r = o // npd
        f = code_field(span, (r * nchan + c) * npd + o - r * npd, nbit)
        if twos:
            f = np.where(f >= 1 << (nbit - 1), f - (1 << nbit), f)
        dst = (c * tp + t0) * npd + o
        out[dst] = f.astype(np.int64) & 0xFF
        writes[dst] += 1


def ftp_copy(g, raw):
    """The pre-pass's copy of a TFP block with nchan > 1 (``mega_ftp``,
    ``mega_ftpw``, or for JA98 ``mega_ja98``'s chunk stores), over the
    tiles ``launch_ftp``/``launch_ja98`` choose; returns the copy and how
    often each byte of it was written."""
    T, tp, npd, bits = ftp_layout(g)
    widen = bits < 8
    ub = npd if widen else bits // 8
    out = np.zeros(g.nchan * tp * ub, np.uint8)
    writes = np.zeros(out.size, int)
    rowbits = g.nchan * bits
    if g.npw:  # mega_ja98: chunks of TT samples of each npw-sample block
        TT = g.npw
        while TT > 16 and TT * rowbits // 8 > 32768:
            TT >>= 1
    elif widen:
        TT = 256
        while TT > 8 and TT * rowbits > 8 * 32768:
            TT >>= 1
    if g.npw or widen:
        for t0 in range(0, T, TT):
            tt = min(TT, T - t0)
            span = raw[t0 * rowbits // 8:(t0 * rowbits + tt * rowbits + 7) // 8]
            if widen:
                store_widened(span, g.nbit, g.nchan, npd,
                              g.twos and not g.npw, out, writes, tp, t0, tt)
            else:
                store_units(span.reshape(tt, g.nchan), 1, out, writes, tp,
                            t0, 0)
        return out, writes
    E = ub
    CC = g.nchan if g.nchan * E <= 512 else 512 // E
    TT = 256
    while TT > 16 and TT * ftp_ld(CC * E) > 32768:
        TT >>= 1
    rows = raw.reshape(T, g.nchan * E)
    for t0 in range(0, T, TT):
        for c0 in range(0, g.nchan, CC):
            cc = min(CC, g.nchan - c0)
            store_units(rows[t0:t0 + TT, c0 * E:(c0 + cc) * E], E, out,
                        writes, tp, t0, c0)
    return out, writes


def stream(g, raw):
    """What ``mega_polpow`` and ``mega_fwd1`` read (``launch_forward``):
    ``(bytes, cs, kind)``, the raw block or with nchan > 1 the pre-pass's
    copy, channel c's one-channel TFP stream at code c*cs, its codes of
    ``kind`` (the nbit, or "ja98", or "ja98w"/8 where the copy widened
    sub-byte units to a byte a code)."""
    kind = "ja98" if g.npw else g.nbit
    if g.nchan == 1:
        return raw, 0, kind
    T, tp, npd, bits = ftp_layout(g)
    if bits < 8:
        kind = "ja98w" if g.npw else 8
    return ftp_copy(g, raw)[0], tp * npd, kind


def sample(g, st, t, c, pol, d=0):
    """Float64 value of code d of (t, c, pol) as ``load_code`` reads it from
    ``stream`` ``st`` (8-bit CASPSR bytes by ``byte_index``)."""
    src, cs, kind = st
    if g.caspsr:
        codes = src.view(np.int8) if g.twos else src
        return codes[byte_index(g, t, c, pol)] * g.scale + g.offset
    ndim = 2 if g.cplx else 1
    i = c * cs + (t * g.npol + pol) * ndim + d
    dig = (c * g.npol + pol) * ndim + d
    if kind == 32:
        return src.view(np.float32)[i].astype(np.float64)
    if kind == 8:
        codes = src.view(np.int8) if g.twos else src
        return codes[i] * g.scale + g.offset
    if kind == "ja98w":
        lo, hi = g.levels
        code = src[i].astype(np.int64)
        nl = g.nlow[dig, t >> (g.npw.bit_length() - 1)]
        mag = np.where((code == 1) | (code == 2), lo[nl], hi[nl])
        return np.where(code >= 2, mag, -mag)
    return load_code(src, i, dig, t, 2 if kind == "ja98" else kind,
                     kind == "ja98", g.twos, g.scale, g.offset, g.levels,
                     g.nlow, g.npw.bit_length() - 1)


def pol_exponent(ea, eb):
    if not (ea > 0 and eb > 0):
        return 0
    d = 0.5 * (np.log2(ea) - np.log2(eb))
    return int(np.rint(min(max(d, -60.0), 60.0)))


def polpow(g, raw):
    """``mega_polpow``: [nchan, npart, 2] energies of the two pols, read
    through ``stream``."""
    st = stream(g, raw)
    out = np.zeros((g.nchan, g.npart, 2))
    t = np.arange(g.ndat())[None, :]
    c = np.arange(g.nchan)[:, None]
    for q in range(2):
        x = sample(g, st, t, c, g.pols[0] + q)
        for w in range(g.npart):
            out[:, w, q] = (x[:, w * g.step:w * g.step + 2 * g.n] ** 2).sum(-1)
    return out


def fwd1(g, raw, tb, psum, tc):
    """``mega_fwd1`` over every (channel, window, column) in tiles of ``tc``
    columns: cbuf [nchan, npart, R1, row_len]."""
    P = fft_points(g.R1)
    T = g.R1 // P
    npolf = len(g.pols)
    j = np.arange(T)[:, None, None, None]
    c = np.arange(g.nchan)[None, :, None, None]
    w = np.arange(g.npart)[None, None, :, None]
    m = np.arange(g.row_len)[None, None, None, :]
    e = np.array([[pol_exponent(*psum[ci, wi]) if npolf == 2 else 0
                   for wi in range(g.npart)] for ci in range(g.nchan)])
    sb = np.ldexp(1.0, e)[None, :, :, None]
    st = stream(g, raw)
    v = np.empty((P, T, g.nchan, g.npart, g.row_len), complex)
    for i in range(P):
        t = w * g.step + (j + T * i) * g.row_len + m
        a = sample(g, st, t, c, g.pols[0])
        b = sample(g, st, t, c, g.pols[0] + 1) * sb if npolf == 2 else 0.0
        v[i] = a + 1j * b
    v = fft_regs(v, g.R1, -1, tb["r1"])
    cbuf = np.empty((g.nchan, g.npart, g.R1, g.row_len), complex)
    mask = (1 << tb["log2n"]) - 1
    col = m % tc  # column within its tile: m = m0 + col
    for i in range(P):
        k1 = (np.arange(T) + T * i)[:, None, None, None]
        ex = ((m - col) * k1) & mask
        tw = (tb["hi"][ex >> tb["lo_bits"]]
              * tb["lo"][ex & ((1 << tb["lo_bits"]) - 1)]
              * tb["col"][k1 * 16 + col])
        cbuf[:, :, k1[:, 0, 0, 0], :] = np.moveaxis(v[i] * tw, 0, 2)
    return cbuf, e


def fwd2(g, cbuf, e, tb, chirp, tp, store=None, tap=False):
    """``mega_fwd2`` over every tile of ``tp`` row pairs: ybuf [nchan*nstore,
    npart, N] of the pols in ``store`` (bit 0 the first transformed pol, bit
    1 the second; default all), how often each bin was written, and with
    ``tap`` the passband [nchan, npolf, N] summed over the windows."""
    R1, R2, L = g.R1, g.R2, g.row_len
    P = fft_points(L)
    T = L // P
    npolf = len(g.pols)
    store = (3 if npolf == 2 else 1) if store is None else store
    nstore = (store & 1) + (store >> 1)
    ybuf = np.full((g.nchan * nstore, g.npart, g.n), np.nan, complex)
    pb = np.zeros((g.nchan, npolf, g.n)) if tap else None
    writes = np.zeros(g.n, int)
    j = np.arange(T)
    unscale = np.ldexp(1.0, -e)  # [nchan, npart]
    for a in range(0, R1 // 2, tp):
        klo = a + np.arange(tp)
        khi = np.where(klo == 0, R1 // 2, R1 - klo)
        # v[ii, j, q, i, c, w]
        v = np.empty((P, T, 2, tp, g.nchan, g.npart), complex)
        for ii in range(P):
            for q, rows in enumerate((klo, khi)):
                v[ii, :, q] = cbuf[:, :, rows][..., j + T * ii].transpose(
                    3, 2, 0, 1)
        v = fft_regs(v, L, -1, tb["row"])
        sm = np.empty((2 * tp, L, g.nchan, g.npart), complex)
        for ii in range(P):
            for q in range(2):
                sm[q * tp:(q + 1) * tp, j + T * ii] = v[ii, :, q].transpose(1, 0, 2, 3)
        nslot = 2 * tp
        qq = np.arange(nslot * R2)
        k2, r = qq // nslot, qq % nslot
        low = r < tp
        ii = nslot - 1 - r
        special = ~low & (a + ii == 0)
        slot = np.where(low, r, tp + ii)
        k1 = np.where(low, a + r, np.where(special, R1 // 2, R1 - a - ii))
        pslot = np.where(low, np.where(k1 == 0, slot, tp + r),
                         np.where(special, slot, ii))
        pcol = np.where(low & (k1 == 0), (L - k2) & (L - 1), L - 1 - k2)
        z = sm[slot, k2]
        p = sm[pslot, pcol]
        k = k2 * R1 + k1
        np.add.at(writes, k, 1)
        gch = np.moveaxis(chirp[:, k], 1, 0)[..., None]  # [nq, nchan, 1]
        xa = 0.5 * (z + np.conj(p))
        for c in range(g.nchan):
            xs = [xa[:, c]]
            if npolf == 2:
                xs.append(-0.5j * (z[:, c] - np.conj(p[:, c]))
                          * unscale[c][None, :])
            slot = c * nstore
            for q, x in enumerate(xs):
                if tap:
                    pb[c, q, k] += (np.abs(x) ** 2).sum(-1)
                if store >> q & 1:
                    ybuf[slot, :, k] = x * gch[:, c]
                    slot += 1
    return (ybuf, writes, pb) if tap else (ybuf, writes)


def inverse(g, ybuf, tb, nsub):
    """``inverse_subband`` for every (channel, subband, window): voltages
    [nchan, npolf, npart, nsub, M] (unscaled inverse)."""
    M = g.M
    P = fft_points(M)
    T = M // P
    npolf = len(g.pols)
    y = ybuf.reshape(g.nchan, npolf, g.npart, nsub, M)
    v = np.stack([y[..., np.arange(T) + T * i] for i in range(P)])
    v = np.moveaxis(v, -1, 1)  # [P, T, nchan, npolf, npart, nsub]
    v = fft_regs(v, M, +1, tb["inv"])
    out = np.empty_like(y)
    for i in range(P):
        out[..., np.arange(T) + T * i] = np.moveaxis(v[i], 0, -1)
    return out


def fwd1_complex(g, raw, tb, tc):
    """``mega_fwd1<P, kComplexTfp>`` over every (channel, pol, window,
    column) in tiles of ``tc`` columns: one sequence per transformed pol,
    the (re, im) bytes of each sample, twiddle exp(-2 pi i m k1 / N).  cbuf
    [nchan, npolf, npart, R1, R2]."""
    P = fft_points(g.R1)
    T = g.R1 // P
    npolf = len(g.pols)
    j = np.arange(T)[:, None, None, None, None]
    c = np.arange(g.nchan)[None, :, None, None, None]
    q = np.arange(npolf)[None, None, :, None, None]
    w = np.arange(g.npart)[None, None, None, :, None]
    m = np.arange(g.row_len)[None, None, None, None, :]
    st = stream(g, raw)
    v = np.empty((P, T, g.nchan, npolf, g.npart, g.row_len), complex)
    for i in range(P):
        t = w * g.step + (j + T * i) * g.row_len + m
        v[i] = (sample(g, st, t, c, g.pols[0] + q, 0)
                + 1j * sample(g, st, t, c, g.pols[0] + q, 1))
    v = fft_regs(v, g.R1, -1, tb["r1"])
    cbuf = np.empty((g.nchan, npolf, g.npart, g.R1, g.row_len), complex)
    mask = (1 << tb["log2n"]) - 1
    col = m % tc
    for i in range(P):
        k1 = (np.arange(T) + T * i)[:, None, None, None, None]
        ex = ((m - col) * k1) & mask
        tw = (tb["hi"][ex >> tb["lo_bits"]]
              * tb["lo"][ex & ((1 << tb["lo_bits"]) - 1)]
              * tb["col"][k1 * 16 + col])
        cbuf[:, :, :, k1[:, 0, 0, 0, 0], :] = np.moveaxis(v[i] * tw, 0, 3)
    return cbuf


def cluster_slices(R2, cr):
    """``mega_fwd2cc``'s store walk: for each rank of a cluster of ``cr``
    one-row CTAs, thread item t -> (row r of the cluster, column k2): CTA
    ``rank`` stores k2 in [rank*R2/cr, (rank+1)*R2/cr) of every row, runs of
    cr consecutive rows."""
    t = np.arange(R2)
    lg = cr.bit_length() - 1
    return [(t & (cr - 1), rank * (R2 // cr) + (t >> lg))
            for rank in range(cr)]


def fwd2_complex(g, cbuf, tb, chirp, tr, store=None, tap=False):
    """``mega_fwd2c`` over every tile of ``tr`` rows, or from R2 =
    CLUSTER_R2 ``mega_fwd2cc`` over every cluster of ``tr`` one-row CTAs:
    the length-R2 FFT of each row, every column kept, bin k = k2*R1 + k1
    stored at the centred natural index ((k2 + R2/2) mod R2)*R1 + k1 of
    ybuf [nchan*nstore, npart, N], where the chirp and the passband are
    read; also how often each index was written and, with ``tap``, the
    passband [nchan, npolf, N]."""
    R1, R2 = g.R1, g.R2
    P = fft_points(R2)
    T = R2 // P
    npolf = len(g.pols)
    store = (3 if npolf == 2 else 1) if store is None else store
    nstore = (store & 1) + (store >> 1)
    ybuf = np.full((g.nchan * nstore, g.npart, g.n), np.nan, complex)
    pb = np.zeros((g.nchan, npolf, g.n)) if tap else None
    writes = np.zeros(g.n, int)
    j = np.arange(T)
    lg = tr.bit_length() - 1
    for a in range(0, R1, tr):
        rows = a + np.arange(tr)
        # v[ii, j, r, c, q, w]
        v = np.empty((P, T, tr, g.nchan, npolf, g.npart), complex)
        for ii in range(P):
            v[ii] = cbuf[:, :, :, rows][..., j + T * ii].transpose(4, 3, 0, 1,
                                                                  2)
        v = fft_regs(v, R2, -1, tb["row"])
        sm = np.empty((tr, R2, g.nchan, npolf, g.npart), complex)
        for ii in range(P):
            sm[:, j + T * ii] = v[ii].transpose(1, 0, 2, 3, 4)
        if R2 >= CLUSTER_R2:
            walk = cluster_slices(R2, tr)  # each rank's stores
        else:
            t = np.arange(tr * R2)
            walk = [(t & (tr - 1), t >> lg)]
        for r, k2 in walk:
            x = sm[r, k2]  # [items, nchan, npolf, npart]
            k = ((k2 + R2 // 2) & (R2 - 1)) * R1 + a + r
            np.add.at(writes, k, 1)
            for c in range(g.nchan):
                slot = c * nstore
                for q in range(npolf):
                    if tap:
                        pb[c, q, k] += (np.abs(x[:, c, q]) ** 2).sum(-1)
                    if store >> q & 1:
                        # (slot, k) index first: [items, npart]
                        ybuf[slot, :, k] = x[:, c, q] * chirp[c, k][:, None]
                        slot += 1
    return (ybuf, writes, pb) if tap else (ybuf, writes)


def mirror_forward(g, raw, chirp, tp, tc=TILE_CAPS[0], store=None,
                   tap=False):
    """The forward half: ``tp`` row pairs (real input) or rows (complex)
    a tile of the row pass, ``tc`` columns of the column pass."""
    tb = tables64(g)
    if g.cplx:
        cbuf = fwd1_complex(g, raw, tb, min(tc, g.row_len))
        return fwd2_complex(g, cbuf, tb, chirp, tp, store, tap)
    psum = polpow(g, raw) if len(g.pols) == 2 else None
    cbuf, e = fwd1(g, raw, tb, psum, min(tc, g.row_len))
    return fwd2(g, cbuf, e, tb, chirp, tp, store, tap)


# --------------------------------------------------------------------------
# the checks
# --------------------------------------------------------------------------

def _raw(g, rng, unequal=False):
    if g.cplx:
        return rng.integers(0, 256, size=g.ndat() * g.nchan * g.npol * 2,
                            dtype=np.uint8)
    raw = rng.integers(0, 256, size=(g.ndat(), g.nchan, g.npol), dtype=np.uint8)
    if unequal:
        raw[:, :, -1] = rng.integers(127, 129, size=(g.ndat(), g.nchan))
    return raw.reshape(-1)


@pytest.mark.parametrize("L", [8, 16, 32, 64, 128, 256, 512, 1024, 2048, 4096])
@pytest.mark.parametrize("d", [-1, +1])
def test_fft_regs_matches_numpy(L, d):
    rng = np.random.default_rng(L)
    x = rng.normal(size=(L, 3)) + 1j * rng.normal(size=(L, 3))
    P = fft_points(L)
    T = L // P
    v = np.stack([x[np.arange(T) + T * i] for i in range(P)])
    tw = twiddle_tables(L, 8, 8, dtype=np.complex128)[:L]
    got = fft_regs(v, L, d, tw)
    want = np.fft.fft(x, axis=0) if d < 0 else L * np.fft.ifft(x, axis=0)
    want = np.stack([want[np.arange(T) + T * i] for i in range(P)])
    assert np.abs(got - want).max() / np.abs(want).max() < TOL


@pytest.mark.parametrize("L, radices", [
    (8, [8]), (16, [16]), (32, [16, 2]), (64, [16, 4]), (512, [16, 8, 4]),
    (1024, [16, 8, 8]), (4096, [16, 16, 16]), (8192, [16, 8, 8, 8])])
def test_pass_radices(L, radices):
    lgP = fft_points(L).bit_length() - 1
    logL = L.bit_length() - 1
    got = [1 << pass_bits(s, logL, lgP)
           for s in range(num_passes(logL, lgP))]
    assert got == radices
    assert [1 << b for b in fft_pass_bits(L)] == radices  # the wrapper's
    assert int(np.prod(got)) == L


@pytest.mark.parametrize("R1, row_len, M", [(8, 16, 64), (16, 64, 64),
                                            (512, 1024, 4096),
                                            (8, 16384, 64)])
def test_twiddle_tables_are_rounded_exp(R1, row_len, M):
    got = twiddle_tables(R1, row_len, M)
    assert got.dtype == np.complex64
    two_n = R1 * row_len
    log2n = two_n.bit_length() - 1
    lo_bits = (log2n + 1) // 2
    def fft_turns(L):  # per pass: k*r / (Ns*R) at (r-1)*Ns + k
        lgP, logL = fft_points(L).bit_length() - 1, L.bit_length() - 1
        ns, block = 1 << lgP, []
        for s in range(1, num_passes(logL, lgP)):
            R = 1 << pass_bits(s, logL, lgP)
            for r in range(1, R):
                block += [k * r / (ns * R) for k in range(ns)]
            ns *= R
        return block + [None] * (L - len(block))

    turns = fft_turns(R1) + fft_turns(row_len) + fft_turns(M)
    turns += [e / two_n for e in range(1 << lo_bits)]
    turns += [(e << lo_bits) / two_n for e in range(1 << (log2n - lo_bits))]
    turns += [c * k1 / two_n for k1 in range(R1) for c in range(16)]
    # the long row pass's first stage over half rows, and their FFT table
    turns += [n / row_len for n in range(row_len // 2)]
    turns += fft_turns(row_len // 2) if row_len > 1 else [None]
    assert got.size == len(turns)
    used = np.array([t is not None for t in turns])
    want = np.exp(-2j * np.pi * np.array([t or 0.0 for t in turns]))
    assert (got[~used] == 0).all()
    for part in ("real", "imag"):
        g32 = getattr(got[used], part)
        w64 = getattr(want[used], part)
        half_ulp = np.spacing(np.abs(g32)) / 2
        assert (np.abs(g32.astype(np.float64) - w64) <= half_ulp).all()
    # the inter-stage factors multiply to exp(-2 pi i m k1 / 2N)
    m, k1 = np.meshgrid(np.arange(row_len), np.arange(R1))
    col = m % 16
    ex = ((m - col) * k1) & (two_n - 1)
    prod = (got[R1 + row_len + M:][ex & ((1 << lo_bits) - 1)].astype(complex)
            * got[R1 + row_len + M + (1 << lo_bits):][ex >> lo_bits]
            * got[-16 * R1 - row_len:-row_len][k1 * 16 + col])
    assert np.abs(prod - np.exp(-2j * np.pi * m * k1 / two_n)).max() < 4e-7


FWD_CASES = [
    dict(R1=R1, R2=R2, npol=npol, pols=pols, nchan=nchan, tp=tp, tc=tc)
    for R1 in (8, 16, 64) for R2 in (8, 32)
    for (npol, pols) in ((2, (0, 1)), (1, (0,)), (2, (1,)))
    for nchan in (1, 2)
    for tp, tc in ((1, 16), (min(TILE_CAPS[1], R1 // 2), TILE_CAPS[0]),
                   (min(8, R1 // 2), 4))
    if (nchan == 1 or npol == 2) and (tp == 1 or pols == (0, 1))
]


@pytest.mark.parametrize("case", FWD_CASES, ids=lambda c: "-".join(
    f"{k}{v}" for k, v in c.items()).replace(" ", ""))
def test_forward_mirror_matches_rfft(case):
    """Every kept bin of every pol, window and channel is written once and
    equals rfft * chirp of that pol's window, including the self-paired
    rows 0 and R1/2."""
    R1, R2 = case["R1"], case["R2"]
    g = Geom(R1=R1, R2=R2, M=R1, nchan=case["nchan"], npol=case["npol"],
             pols=case["pols"], npart=2, step=2 * R1 * R2 - 2 * (2 * R2))
    rng = np.random.default_rng(R1 * 100 + R2)
    raw = _raw(g, rng)
    chirp = np.exp(1j * rng.uniform(-3, 3, (g.nchan, g.n)))
    ybuf, writes = mirror_forward(g, raw, chirp, case["tp"], case["tc"])
    assert (writes == 1).all()
    assert np.isfinite(ybuf).all()
    npolf = len(g.pols)
    for q, pol in enumerate(g.pols):
        x = values(g, raw, pol)
        for w in range(g.npart):
            win = x[:, w * g.step:w * g.step + 2 * g.n]
            want = np.fft.rfft(win, axis=-1)[:, :g.n] * chirp
            got = ybuf[np.arange(g.nchan) * npolf + q, w]
            assert np.abs(got - want).max() / np.abs(want).max() < TOL


@pytest.mark.parametrize("nchan", [1, 2])
def test_unequal_pols_keep_their_precision(nchan):
    """Pol b at 1/150 the amplitude of pol a: the power-of-two scale keeps
    it exact in the mirror and scales it by 2^e before packing."""
    g = Geom(R1=16, R2=8, M=16, nchan=nchan, npol=2, pols=(0, 1), npart=2,
             step=2 * 16 * 8 - 32)
    rng = np.random.default_rng(5)
    raw = _raw(g, rng, unequal=True)
    psum = polpow(g, raw)
    assert all(pol_exponent(*psum[c, w]) >= 6
               for c in range(nchan) for w in range(g.npart))
    chirp = np.ones((nchan, g.n), complex)
    ybuf, writes = mirror_forward(g, raw, chirp, 4)
    x = values(g, raw, 1)
    for w in range(g.npart):
        want = np.fft.rfft(x[:, w * g.step:w * g.step + 2 * g.n])[:, :g.n]
        got = ybuf[np.arange(nchan) * 2 + 1, w]
        assert np.abs(got - want).max() / np.abs(want).max() < TOL


COMPLEX_CASES = [
    dict(R1=R1, R2=R2, npol=npol, pols=pols, nchan=nchan, tr=tr, tc=tc)
    for R1 in (8, 16, 64) for R2 in (8, 32)
    for (npol, pols) in ((2, (0, 1)), (1, (0,)), (2, (1,)))
    for nchan in (1, 2)
    for tr, tc in ((1, 16), (min(TILE_CAPS[2], R1), TILE_CAPS[0]),
                   (min(2, R1), 4))
    if (nchan == 1 or npol == 2) and (tr == 1 or pols == (0, 1))
] + [
    # channels through the pre-pass's copy: 3 (no 16-byte multiple a row)
    # and 32 (hybrid_conv32's 128-byte rows)
    dict(R1=R1, R2=R2, npol=2, pols=(0, 1), nchan=nchan, tr=tr, tc=8)
    for R1, R2 in ((8, 8), (16, 32)) for nchan in (3, 32)
    for tr in (1, min(TILE_CAPS[2], R1))
] + [
    # long rows at R1 8: the row tile to 2048, clusters of 4 and 8 one-row
    # CTAs from CLUSTER_R2
    dict(R1=8, R2=R2, npol=2, pols=pols, nchan=1, tr=tr, tc=8)
    for R2 in (2048, 4096, 8192) for tr in (4, 8)
    for pols in ((0, 1), (1,))
]


@pytest.mark.parametrize("case", COMPLEX_CASES, ids=lambda c: "-".join(
    f"{k}{v}" for k, v in c.items()).replace(" ", ""))
def test_complex_forward_mirror_matches_fft(case):
    """Complex input: every bin of every pol, window and channel is written
    once, at its centred natural index, and equals fftshift(fft) * chirp of
    that pol's window of N complex samples."""
    R1, R2 = case["R1"], case["R2"]
    g = Geom(R1=R1, R2=R2, M=R1, nchan=case["nchan"], npol=case["npol"],
             pols=case["pols"], npart=2, step=R1 * R2 - 2 * R2, cplx=True)
    rng = np.random.default_rng(R1 * 100 + R2 + 7)
    raw = _raw(g, rng)
    chirp = np.exp(1j * rng.uniform(-3, 3, (g.nchan, g.n)))
    ybuf, writes = mirror_forward(g, raw, chirp, case["tr"], case["tc"])
    assert (writes == 1).all()
    assert np.isfinite(ybuf).all()
    npolf = len(g.pols)
    for q, pol in enumerate(g.pols):
        x = values(g, raw, pol)
        for w in range(g.npart):
            win = x[:, w * g.step:w * g.step + g.n]
            want = np.fft.fftshift(np.fft.fft(win, axis=-1), axes=-1) * chirp
            got = ybuf[np.arange(g.nchan) * npolf + q, w]
            assert np.abs(got - want).max() / np.abs(want).max() < TOL


@pytest.mark.parametrize("R1,R2", [(8, 8), (64, 32)])
@pytest.mark.parametrize("pols", [(0, 1), (0,), (1,)])
def test_caspsr_forward_mirror_matches_rfft(R1, R2, pols):
    """Real input in the CASPSR byte layout: the kernels' byte index gives
    the spectra of the reordered (TFP) stream."""
    g = Geom(R1=R1, R2=R2, M=R1, nchan=1, npol=2, pols=pols, npart=2,
             step=2 * R1 * R2 - 4 * R2, twos=True, caspsr=True)
    g.scale, g.offset = tmk.unpack_affine(8, True)
    rng = np.random.default_rng(R1 + R2)
    raw = _raw(g, rng)
    chirp = np.exp(1j * rng.uniform(-3, 3, (1, g.n)))
    ybuf, writes = mirror_forward(g, raw, chirp, min(4, R1 // 2))
    assert (writes == 1).all()
    for q, pol in enumerate(pols):
        x = values(g, raw, pol)
        for w in range(g.npart):
            win = x[:, w * g.step:w * g.step + 2 * g.n]
            want = np.fft.rfft(win, axis=-1)[:, :g.n] * chirp
            assert np.abs(ybuf[q, w] - want[0]).max() / np.abs(want).max() \
                < TOL


NSUB, FREQ_RES, NPART = 4, 64, 3


def _geom(plan, raw_kw=None):
    """The mirror's geometry for a port plan (JA98 levels and counts are
    set by the caller)."""
    g = Geom(R1=plan.R1, R2=plan.R2, M=plan.freq_res, nchan=plan.nchan_in,
             npol=plan.npol, pols=tmk.fold_pols(plan), npart=NPART,
             step=plan.nsamp_step, twos=plan.twos_complement,
             cplx=not plan.real_input, caspsr=plan.interleave == "caspsr",
             nbit=plan.nbit, npw=plan.npw)
    g.scale, g.offset = ((1.0, 0.0) if plan.npw else
                         tmk.unpack_affine(plan.nbit, plan.twos_complement))
    return g


def _row_tile(plan):
    """Row pairs (real input) or rows (complex) of the mirror's row pass."""
    return min(8, plan.R1 // 2) if plan.real_input else min(8, plan.R1)


@pytest.mark.parametrize("kw", [
    dict(npol=2, npol_out=2), dict(npol=2, npol_out=4), dict(npol=1),
    dict(npol=2, detection="qq"), dict(npol=2, npol_out=2, nchan_in=2),
    dict(npol=2, npol_out=4, twos_complement=True),
    dict(npol=2, npol_out=2, unequal=True),
    dict(npol=2, nsub=1, freq_res=256),
    dict(npol=2, npol_out=4, complex=True),
    dict(npol=2, detection="qq", complex=True),
    dict(npol=1, complex=True),
    dict(npol=2, npol_out=2, nchan_in=2, twos_complement=True, complex=True),
    dict(npol=2, nsub=1, freq_res=256, complex=True),
    dict(npol=2, npol_out=4, interleave="caspsr", twos_complement=True),
    dict(npol=2, detection="pp", interleave="caspsr"),
], ids=lambda kw: "-".join(f"{k}={v}" for k, v in kw.items()))
def test_front_mirror_matches_plain(kw):
    """The mirror's detected front end equals the port's float64
    ``_front_plain`` (rfft, or fft and fftshift for complex input; chirp,
    ifft, detect) on the same plan."""
    kw = dict(kw)
    unequal = kw.pop("unequal", False)
    real = not kw.pop("complex", False)
    nsub, freq_res = kw.pop("nsub", NSUB), kw.pop("freq_res", FREQ_RES)
    fb = FilterbankPlan(real_input=real, nchan_subband=nsub,
                        freq_res=freq_res, nfilt_pos=5, nfilt_neg=6)
    jplan = jmk.MegaPlan.from_filterbank(fb, nbin=2, **kw)
    plan = tmk.MegaPlan(**dataclasses.asdict(jplan))
    rng = np.random.default_rng(11)
    nci = plan.nchan_in
    g = _geom(plan)
    raw = _raw(g, rng, unequal)
    resp = np.exp(1j * rng.uniform(-3, 3, (nci * nsub, freq_res)))
    cst = tmk.MegaConstants.build(plan, resp, g.scale, g.offset).to("cpu")
    chirp = cst.gr.double().numpy() + 1j * cst.gi.double().numpy()
    ybuf, writes = mirror_forward(g, raw, chirp, _row_tile(plan))
    v = inverse(g, ybuf, tables64(g), nsub) / freq_res
    v = v[..., plan.nfilt_pos:plan.nfilt_pos + plan.nkeep]
    got = tmk._detect_plain(torch.from_numpy(v), plan).numpy()
    want = tmk._front_plain(plan, cst, torch.from_numpy(raw), NPART,
                            torch.float64)[0].numpy()
    assert got.shape == want.shape
    for p in range(plan.nplane):  # each plane against its own maximum
        err = np.abs(got[:, p] - want[:, p]).max() / np.abs(want[:, p]).max()
        assert err < TOL, (p, err)


def _passband_tap(detection, store, nchan, real):
    """The passband tap mirror against the float64 plain front end with
    ``passband=True`` and a chirp that zeroes some bins."""
    npol_out = 2 if detection == "auto" else 1
    fb = FilterbankPlan(real_input=real, nchan_subband=NSUB,
                        freq_res=FREQ_RES, nfilt_pos=5, nfilt_neg=6)
    jplan = jmk.MegaPlan.from_filterbank(fb, nbin=2, npol=2, nchan_in=nchan,
                                         npol_out=npol_out,
                                         detection=detection)
    plan = tmk.MegaPlan(**dataclasses.asdict(jplan))
    rng = np.random.default_rng(store)
    g = _geom(plan)
    g.pols = (0, 1)  # the tap transforms both pols
    raw = _raw(g, rng)
    resp = np.exp(1j * rng.uniform(-3, 3, (nchan * NSUB, FREQ_RES)))
    resp[:, ::7] = 0.0  # zapped bins: the tap reads the spectra before them
    cst = tmk.MegaConstants.build(plan, resp, g.scale, g.offset).to("cpu")
    chirp = cst.gr.double().numpy() + 1j * cst.gi.double().numpy()
    ybuf, writes, pb = mirror_forward(g, raw, chirp, _row_tile(plan),
                                      store=store, tap=True)
    assert (writes == 1).all() and np.isfinite(ybuf).all()
    kept = [q for q in (0, 1) if store >> q & 1]
    assert ybuf.shape[0] == nchan * len(kept)
    for q, pol in enumerate(kept):
        x = values(g, raw, pol)
        for w in range(g.npart):
            if real:
                win = x[:, w * g.step:w * g.step + 2 * g.n]
                want = np.fft.rfft(win, axis=-1)[:, :g.n] * chirp
            else:
                win = x[:, w * g.step:w * g.step + g.n]
                want = np.fft.fftshift(np.fft.fft(win, axis=-1),
                                       axes=-1) * chirp
            got = ybuf[np.arange(nchan) * len(kept) + q, w]
            assert np.abs(got - want).max() / np.abs(want).max() < TOL
    _, want = tmk.megafil_plain(plan, cst, torch.from_numpy(raw), NPART,
                                torch.float64, passband=True)
    got = tmk.passband_layout(plan, torch.from_numpy(pb)).numpy()
    assert np.abs(got - want.numpy()).max() / want.numpy().max() < TOL


@pytest.mark.parametrize("detection,store", [("pp", 1), ("qq", 2),
                                             ("auto", 3)])
@pytest.mark.parametrize("nchan", [1, 2])
def test_passband_tap_mirror(detection, store, nchan):
    """The passband tap (hybrid front end): both pols transformed, |X|^2 of
    each summed over the windows before the chirp, only the detected pols'
    spectra kept; against the port's float64 plain front end with
    ``passband=True`` and a chirp that zeroes some bins."""
    _passband_tap(detection, store, nchan, real=True)


@pytest.mark.parametrize("detection,store", [("pp", 1), ("qq", 2),
                                             ("auto", 3)])
@pytest.mark.parametrize("nchan", [1, 2])
def test_complex_passband_tap_mirror(detection, store, nchan):
    """The passband tap on complex input: |X|^2 of each pol at its centred
    natural index, summed over the windows before the chirp."""
    _passband_tap(detection, store, nchan, real=False)


# --------------------------------------------------------------------------
# the unpack of the first pass: sub-byte fields, JA98 levels, the window
# --------------------------------------------------------------------------


def code_field(raw, i, nbit):
    """``code_field<NBIT>``: code ``i`` of the stream in byte ``i >> lg`` at
    shift ``(per - 1 - (i & (per - 1))) * nbit``, ``per = 8 / nbit``."""
    lg = {1: 3, 2: 2, 4: 1}[nbit]
    per = 1 << lg
    b = raw[i >> lg].astype(np.int64)
    return (b >> ((per - 1 - (i & (per - 1))) * nbit)) & ((1 << nbit) - 1)


def ja98_prepass(raw, ndig, nd_chan, npw, nweights, weight):
    """``mega_ja98``: one CTA per npw-sample block; byte k of the block
    holds codes 4k..4k+3 of digitizers (4k + f) mod ndig, the same for
    every k of one residue r = k mod pb; a byte's fields are low where
    ``((b >> 1) ^ b) & 0x55`` has their low bit.  Returns nlow [ndig,
    nweights] and the block weights [ndig / nd_chan, nweights]."""
    gcd4 = 4 if ndig % 4 == 0 else (2 if ndig % 2 == 0 else 1)
    pb = ndig // gcd4
    nb = npw * ndig // 4
    nlow = np.zeros((ndig, nweights), np.int64)
    for blk in range(nweights):
        src = raw[blk * nb:(blk + 1) * nb].astype(np.int64)
        for r in range(pb):
            low = ((src[r::pb] >> 1) ^ src[r::pb]) & 0x55
            for f, sh in enumerate((6, 4, 2, 0)):
                nlow[(4 * r + f) % ndig, blk] += ((low >> sh) & 1).sum()
    wblk = weight[nlow].reshape(ndig // nd_chan, nd_chan, nweights).min(1)
    return nlow, wblk


#: npw-sample blocks of a ``mega_ja98`` CTA (``kJa98Blocks``)
JA98_BLOCKS = 4


def ja98_mask(d, nd, widened):
    """``ja98_mask``: the low bits of digitizer d (of nd) in a word of one
    channel's stream, packed (field f of a byte: digitizer f mod nd) or
    widened (byte p: digitizer p mod nd)."""
    m = 0
    if d < nd:
        for x in range(d, 4, nd):
            m |= 1 << (8 * x) if widened else 0x01010101 << (6 - 2 * x)
    return m


def ja98_count(words, nd, widened):
    """``ja98_count`` over uint32 ``words [..., n]``: counts [..., 4] of
    digitizers 0..3 (0 past nd), one popc a digitizer and word."""
    low = ((words >> 1) ^ words) & 0x55555555
    return np.stack([np.bitwise_count(low & ja98_mask(d, nd, widened)).astype(
        np.int64).sum(-1) for d in range(4)], -1)


def le_words(b):
    """Little-endian uint32 words of bytes ``b [..., 4n]``."""
    b = b.astype(np.uint32).reshape(b.shape[:-1] + (-1, 4))
    return b[..., 0] | b[..., 1] << 8 | b[..., 2] << 16 | b[..., 3] << 24


#: bytes of pad after every 16 rows of the word path (``kJa98Pad``) and
#: the threads of a ``mega_ja98`` CTA (``kJa98Threads``)
JA98_PAD, JA98_THREADS = 32, 128


def ja98_group(nchan, nd_chan, TT):
    """``ja98_group``: the staged bytes between two pads of the word path
    (16 rows), or 0 where the chunk takes another path."""
    ncw = nchan >> 2
    ok = (nd_chan == 4 and nchan % 4 == 0 and 4 <= ncw <= 32
          and ncw & (ncw - 1) == 0 and TT % 16 == 0)
    return 16 * nchan if ok else 0


def byte_perm(x, y, sel):
    """``__byte_perm``: byte n of the result is byte (sel >> 4n) & 7 of
    the 8 bytes of (y, x), x's first."""
    b = [(x >> (8 * k)) & 0xFF for k in range(4)]
    b += [(y >> (8 * k)) & 0xFF for k in range(4)]
    return sum(b[(sel >> (4 * n)) & 7] << (8 * n) for n in range(4))


def hsum4(x):
    """``hsum4``: the sum of the 4 bytes of x (as the kernel's multiply)."""
    return ((x * 0x01010101) & 0xFFFFFFFF) >> 24


def ja98_rows4(tile, nchan, TT, gsize, cnt, copy, t0):
    """``ja98_rows4`` on one chunk: staged with JA98_PAD bytes after every
    gsize; items (cw fastest, in warps of 32 lanes, each warp's lanes all
    through the loop) read their column's 16 words, transpose 4x4 byte
    blocks with ``byte_perm``, store each channel's 16 samples into
    ``copy [nchan, T]`` at t0 and count in nibbles; a warp's lanes of one
    column add their packed counts, and lane g adds the channels m with
    m = g mod (32 / ncw)."""
    staged = np.zeros(tile.size + tile.size // gsize * JA98_PAD, np.uint8)
    o = np.arange(tile.size)
    staged[o + o // gsize * JA98_PAD] = tile
    words = le_words(staged).astype(np.int64)
    ncw, nv = nchan >> 2, TT >> 4
    gw = 4 * nchan + JA98_PAD // 4
    total = ncw * nv
    i = np.arange(-(-total // JA98_THREADS) * JA98_THREADS)
    cw, v = i & (ncw - 1), i // ncw
    act = v < nv
    vv = np.minimum(v, nv - 1)
    pk = np.zeros((4, i.size), np.int64)
    for m in range(4):
        lo, hi = np.zeros(i.size, np.int64), np.zeros(i.size, np.int64)
        for q in range(4):
            a = [words[vv * gw + cw + (4 * q + k) * ncw] for k in range(4)]
            sel = 0x5140 if m < 2 else 0x7362
            b = (byte_perm(a[0], a[1], sel), byte_perm(a[2], a[3], sel))
            out = byte_perm(b[0], b[1], 0x5410 if m % 2 == 0 else 0x7632)
            for k in range(4):  # sample 4q + k of channel 4 cw + m
                copy[(4 * cw + m)[act], t0 + 16 * v[act] + 4 * q + k] = (
                    out[act] >> (8 * k)) & 0xFF
            low = ((out >> 1) ^ out) & 0x55555555
            lo += low & 0x11111111
            hi += (low >> 2) & 0x11111111
        pk[m] = np.where(act, hsum4((hi >> 4) & 0x0F0F0F0F)
                         | hsum4((lo >> 4) & 0x0F0F0F0F) << 8
                         | hsum4(hi & 0x0F0F0F0F) << 16
                         | hsum4(lo & 0x0F0F0F0F) << 24, 0)
    lane = i & 31
    g = lane // ncw
    for m in range(4):
        # the shuffle sum over a warp's lanes of one column
        tot = np.zeros(i.size, np.int64)
        key = (i >> 5) * ncw + cw
        np.add.at(tot, key, pk[m])
        tot = tot[key]
        assert (tot >> 8 & 0xFF).max() <= 16 * 32 // ncw
        mine = m % (32 // ncw) == g
        for d in range(4):
            np.add.at(cnt, (4 * (4 * cw + m) + d)[mine],
                      (tot[mine] >> (8 * d)) & 0xFF)


def ja98_words_mirror(raw, nchan, nd_chan, npw, nweights, weight):
    """``mega_ja98``: CTAs of JA98_BLOCKS consecutive blocks, chunks of TT
    samples (``launch_ja98``), each counted from the words of one
    channel's stream (``ja98_rows4``: the word path; ``ja98_units``: the
    copy's 16-sample items with nd_chan == 4 otherwise; ``ja98_widened``:
    widened codes; ``ja98_words``: one channel, the raw words), a lane
    pair's two items of one channel added together.  Returns nlow [ndig,
    nweights], the block weights [nchan, nweights] and the copy's bytes
    [nchan, T * unit] (None for one channel)."""
    ndig = nchan * nd_chan
    TT = npw
    while TT > 16 and TT * ndig // 4 > 32768:
        TT >>= 1
    cb, nq = TT * ndig // 4, npw // TT
    gsize = ja98_group(nchan, nd_chan, TT) if nchan > 1 else 0
    nlow = np.zeros((ndig, nweights), np.int64)
    unit = 1 if nd_chan == 4 else nd_chan
    copy = np.full((nchan, npw * nweights * unit), -1, np.int64)
    for b0 in range(0, nweights, JA98_BLOCKS):
        G = min(JA98_BLOCKS, nweights - b0)
        cnt = np.zeros((JA98_BLOCKS, ndig), np.int64)
        src = raw[b0 * npw * ndig // 4:]
        for s in range(G * nq):
            tile = src[s * cb:(s + 1) * cb]
            t0 = b0 * npw + s * TT
            if gsize:
                ja98_rows4(tile, nchan, TT, gsize, cnt[s // nq], copy, t0)
                continue
            if nchan == 1:
                pad = np.zeros(-(-cb // 4) * 4, np.uint8)
                pad[:cb] = tile
                cnt[s // nq] += ja98_count(le_words(pad), ndig, False)[:ndig]
                continue
            if nd_chan == 4:
                nv = -(-TT // 16)
                c, v = ftp_items(nchan, nv)
                o = 16 * v[:, None] + np.arange(16)[None, :]
                rows = tile.reshape(TT, nchan)
                b = np.where(o < TT, rows[np.minimum(o, TT - 1), c[:, None]],
                             0)
            else:
                nb = TT * nd_chan
                c, v = ftp_items(nchan, -(-nb // 16))
                o = 16 * v[:, None] + np.arange(16)[None, :]
                r = o // nd_chan
                idx = (r * nchan + c[:, None]) * nd_chan + o - r * nd_chan
                f = code_field(tile, np.minimum(idx, 4 * cb - 1), 2)
                b = np.where(o < nb, f, 0)
            n = ja98_count(le_words(b), nd_chan, nd_chan < 4)
            for d in range(nd_chan):
                np.add.at(cnt[s // nq], c * nd_chan + d, n[:, d])
            ok = o < (TT if nd_chan == 4 else TT * nd_chan)
            for k in range(16):
                at = t0 * unit + o[:, k]
                copy[c[ok[:, k]], at[ok[:, k]]] = b[ok[:, k], k]
        nlow[:, b0:b0 + G] = cnt[:G].T
    wblk = weight[nlow].reshape(nchan, nd_chan, nweights).min(1)
    return nlow, wblk, (copy if nchan > 1 else None)


@pytest.mark.parametrize("nchan,npol,ndim,npw,nweights", [
    (32, 2, 2, 256, 20), (3, 2, 1, 16, 11), (2, 1, 1, 64, 9),
    (5, 1, 2, 32, 17), (1, 2, 2, 256, 12), (1, 2, 1, 16, 9),
    (1, 1, 1, 64, 8)],
    ids=["guppi-32chan", "widened-3chan", "widened-1dig", "widened-5chan",
         "one-chan-4dig", "one-chan-2dig", "one-chan-1dig"])
def test_ja98_word_counts_match_plain(nchan, npol, ndim, npw, nweights):
    """``mega_ja98``'s counts from words (at mega_guppi_2bit's geometry,
    32 complex dual-pol channels: 128 digitizers, npw 256, the word path's
    byte transposes and nibble counts; elsewhere a popc a digitizer and
    word of one channel's stream), several blocks a CTA and the last CTA
    short, equal the plain count (``twobit_nlow``) and the byte-wise mirror
    exactly, on widened and one-channel streams too; the block weights
    equal the plain least weight over each channel's digitizers, and the
    copy the plain transpose."""
    nd_chan = npol * ndim
    ndig = nchan * nd_chan
    rng = np.random.default_rng(ndig * npw + nweights)
    T = npw * nweights
    # skewed codes, so that the counts span their range
    p = np.linspace(0.05, 0.95, ndig) if ndig > 1 else np.full(1, 0.5)
    low = rng.uniform(size=(T, ndig)) < p
    codes = np.where(low, rng.integers(1, 3, (T, ndig)),
                     3 * rng.integers(0, 2, (T, ndig))).astype(np.uint8)
    flat = codes.reshape(-1, 4)
    raw = (flat[:, 0] << 6 | flat[:, 1] << 4 | flat[:, 2] << 2
           | flat[:, 3]).astype(np.uint8)
    weight = (rng.uniform(size=npw + 1) < 0.5).astype(np.float32)
    got, wblk, copy = ja98_words_mirror(raw, nchan, nd_chan, npw, nweights,
                                        weight)
    plain = twobit_nlow(torch.from_numpy(codes.T.reshape(
        nchan, npol, ndim, T)).long(), npw).reshape(ndig, nweights).numpy()
    assert np.array_equal(got, plain)
    want, _ = ja98_prepass(raw, ndig, nd_chan, npw, nweights, weight)
    assert np.array_equal(got, want)
    assert np.array_equal(wblk, weight[plain].reshape(
        nchan, nd_chan, nweights).min(1))
    assert ndig == 1 or (got.min() < npw // 4 and got.max() > 3 * npw // 4)
    # the copy: each channel's stream, 4 codes a byte or a byte a code
    if nchan > 1:
        if nd_chan == 4:
            want = raw.reshape(T, nchan).T
        else:
            want = codes.reshape(T, nchan, nd_chan).transpose(1, 0, 2)
        assert np.array_equal(copy, want.reshape(nchan, -1))


def load_code(raw, i, dig, t, nbit, ja98, twos, scale, offset, tables,
              nlow, lg_npw):
    """``load_code<CODE>`` for sub-byte codes: JA98 ``sign * (lo or
    hi)[nlow]`` with nlow of the sample's block ``t >> lg_npw`` of its
    digitizer, else the field (two's-complement fields wrapped to signed)
    times scale plus offset."""
    code = code_field(raw, i, nbit)
    if ja98:
        nl = nlow[dig, t >> lg_npw]
        mag = np.where((code == 1) | (code == 2), tables[0][nl],
                       tables[1][nl])
        return np.where(code >= 2, mag, -mag)
    v = np.where(twos & (code >= 1 << (nbit - 1)), code - (1 << nbit), code)
    return v * scale + offset


@pytest.mark.parametrize("nbit,twos,real,ja98,nchan", [
    (1, False, True, False, 1), (2, True, True, False, 2),
    (4, False, False, False, 1), (4, True, False, False, 2),
    (2, False, True, True, 1), (2, False, False, True, 2),
    (2, False, False, True, 3)],
    ids=["1bit", "2bit-twos-2chan", "4bit-complex", "4bit-twos-complex-2chan",
         "ja98-real", "ja98-complex-2chan", "ja98-complex-3chan"])
def test_unpack_mirror_matches_plain(nbit, twos, real, ja98, nchan):
    """The kernels' code index ``((t*nchan + c)*npol + pol)*ndim + d`` and
    field extraction, the JA98 pre-pass and level lookup, and the window
    index ``(j + T*i)*row_len + m`` of ``mega_fwd1``, against the port's
    plain unpack (``_unpack_plain``, ``twobit_plain``)."""
    npw = 16 if ja98 else 0
    fb = FilterbankPlan(real_input=real, nchan_subband=NSUB,
                        freq_res=FREQ_RES, nfilt_pos=5, nfilt_neg=6)
    plan = tmk.MegaPlan(**dataclasses.asdict(jmk.MegaPlan.from_filterbank(
        fb, nbin=2, npol=2, nbit=nbit, nchan_in=nchan, ndat_per_weight=npw,
        twos_complement=twos)))
    ndim, T_ = plan.ndim, plan.block_ndat(NPART)
    ndig = nchan * 2 * ndim
    rng = np.random.default_rng(nbit * 7 + nchan)
    raw = rng.integers(0, 256, tmk.raw_nbytes(plan, NPART), dtype=np.uint8)
    scale, offset = (1.0, 0.0) if ja98 else tmk.unpack_affine(nbit, twos)
    cst = tmk.MegaConstants.build(plan, None, scale, offset).to("cpu")
    want, wgt = tmk._unpack_plain(plan, cst, torch.from_numpy(raw), NPART,
                                  torch.float64)
    tables = cst.twobit.double().numpy() if ja98 else None
    nlow = None
    if ja98:
        nlow, wblk = ja98_prepass(raw, ndig, 2 * ndim, npw, T_ // npw,
                                  cst.twobit[2].numpy())
        codes = tmk.bytes_to_codes(torch.from_numpy(raw), 2).reshape(
            T_, nchan, 2, ndim).permute(1, 2, 3, 0)
        pn, pw = tmk.twobit_plain(plan, cst, codes, NPART)
        assert np.array_equal(nlow.reshape(pn.shape), pn.numpy())
        # mega_ja98_windows: the least block weight over each window
        sb, sp = plan.nsamp_step // npw, plan.nsamp_fft // npw
        ww = np.stack([wblk[:, w * sb:w * sb + sp].min(1)
                       for w in range(NPART)], 1)
        assert np.array_equal(ww, pw.numpy()) and np.array_equal(
            ww, wgt.numpy())
    t = np.arange(T_)[None, None, None, :]
    c = np.arange(nchan)[:, None, None, None]
    pol = np.arange(2)[None, :, None, None]
    d = np.arange(ndim)[None, None, :, None]
    i = ((t * nchan + c) * 2 + pol) * ndim + d
    dig = (c * 2 + pol) * ndim + d
    got = load_code(raw, i, dig, t, nbit, ja98, twos, scale, offset, tables,
                    nlow, 4)
    assert np.array_equal(got, want.numpy())
    # mega_fwd1's window index: thread j, point i of column m in window w
    # reads window[(j + T*i)*row_len + m], the sample's offset in its window
    P = fft_points(plan.R1)
    T = plan.R1 // P
    j, ii, m = np.meshgrid(np.arange(T), np.arange(P),
                           np.arange(plan.row_len), indexing="ij")
    for w in range(NPART):
        ts = w * plan.nsamp_step + (j + T * ii) * plan.row_len + m
        assert np.array_equal((j + T * ii) * plan.row_len + m,
                              ts - w * plan.nsamp_step)
        assert ts.max() < T_


# --------------------------------------------------------------------------
# the channel-transposing pre-pass of multi-channel TFP input
# --------------------------------------------------------------------------

#: (nbit, twos, real, npol, ja98, nchan): every unit width the copy takes
#: (whole bytes 1, 2, 4, 8, 16 a unit; 1, 2 and 4 bits widened), two's
#: complement widened with its sign, JA98 stored whole and widened, odd
#: channel counts, and 33 float32 dual-pol complex channels (two channel
#: tiles of 512 and 16 bytes)
FTP_CASES = [
    (8, False, True, 2, False, 2), (8, True, True, 1, False, 3),
    (8, False, False, 2, False, 3), (8, False, False, 2, False, 32),
    (8, False, False, 1, False, 2), (4, False, True, 1, False, 3),
    (4, True, True, 2, False, 2), (4, False, False, 2, False, 3),
    (2, False, True, 2, False, 2), (2, True, True, 2, False, 3),
    (2, False, False, 2, False, 2), (2, True, False, 1, False, 2),
    (1, False, True, 1, False, 3), (1, False, False, 2, False, 2),
    (2, False, False, 2, True, 2), (2, False, False, 2, True, 3),
    (2, False, True, 2, True, 2), (2, False, False, 1, True, 3),
    (32, False, True, 2, False, 2), (32, False, False, 2, False, 33),
]


def _ftp_case(nbit, twos, real, npol, ja98, nchan):
    """Plan, mirror geometry (JA98 levels and counts set), constants and
    one block of random bytes of an FTP_CASES entry at the test
    geometry."""
    npw = 16 if ja98 else 0
    fb = FilterbankPlan(real_input=real, nchan_subband=NSUB,
                        freq_res=FREQ_RES, nfilt_pos=5, nfilt_neg=6)
    plan = tmk.MegaPlan(**dataclasses.asdict(jmk.MegaPlan.from_filterbank(
        fb, nbin=2, npol=npol, nbit=nbit, nchan_in=nchan,
        ndat_per_weight=npw, twos_complement=twos,
        npol_out=2 if npol == 2 else 1)))
    g = _geom(plan)
    rng = np.random.default_rng(nbit * 100 + nchan * 10 + npol)
    if nbit == 32:
        raw = rng.normal(0, 20, plan.block_ndat(NPART) * nchan * npol
                         * plan.ndim).astype(np.float32).view(np.uint8)
    else:
        raw = rng.integers(0, 256, tmk.raw_nbytes(plan, NPART),
                           dtype=np.uint8)
    cst = tmk.MegaConstants.build(plan, None, g.scale, g.offset).to("cpu")
    if ja98:
        ndig = nchan * npol * plan.ndim
        g.nlow, _ = ja98_prepass(raw, ndig, npol * plan.ndim, npw,
                                 g.ndat() // npw, cst.twobit[2].numpy())
        g.levels = cst.twobit[:2].double().numpy()
    return plan, g, cst, raw


@pytest.mark.parametrize("nbit,twos,real,npol,ja98,nchan", FTP_CASES,
                         ids=lambda v: str(v))
def test_transposed_stream_matches_plain(nbit, twos, real, npol, ja98,
                                         nchan):
    """The pre-pass's copy (``mega_ftp``, ``mega_ftpw``, ``mega_ja98``'s
    stores, over the tiles the launchers choose): every byte of each
    channel's stream is written once and the padding to FTP_ALIGN samples
    never; read with the one-channel addressing (code c*cs + (t*npol +
    pol)*ndim + d, widened units as bytes), every code equals the port's
    plain unpack of the TFP bytes; the copy's size is the wrapper's."""
    plan, g, cst, raw = _ftp_case(nbit, twos, real, npol, ja98, nchan)
    T, tp, npd, bits = ftp_layout(g)
    copy, writes = ftp_copy(g, raw)
    assert copy.size == ftp_nbytes(plan, NPART)
    ub = copy.size // (nchan * tp)
    per_chan = writes.reshape(nchan, tp, ub)
    assert (per_chan[:, :T] == 1).all() and (per_chan[:, T:] == 0).all()
    want, _ = tmk._unpack_plain(plan, cst, torch.from_numpy(raw), NPART,
                                torch.float64)
    st = stream(g, raw)
    assert st[1] == tp * npd
    assert st[2] == ("ja98w" if ja98 and bits < 8 else "ja98" if ja98
                     else 8 if bits < 8 else nbit)
    t = np.arange(T)[None, :]
    c = np.arange(nchan)[:, None]
    for pol in range(npol):
        for d in range(plan.ndim):
            got = sample(g, st, t, c, pol, d)
            assert np.array_equal(got, want[:, pol, d].numpy()), (pol, d)


@pytest.mark.parametrize("nbit,twos,real,npol,ja98,nchan", [
    (2, False, False, 2, True, 3), (2, False, True, 2, True, 2),
    (1, False, True, 2, False, 2), (4, True, False, 2, False, 3),
    (2, True, True, 1, False, 2), (32, False, False, 2, False, 2),
    (8, False, True, 2, False, 3)], ids=lambda v: str(v))
def test_forward_mirror_through_copy(nbit, twos, real, npol, ja98, nchan):
    """The forward half read through the pre-pass's copy (widened sub-byte
    and JA98 units included): every bin of every transformed pol, window
    and channel equals rfft (real) or fftshift(fft) (complex) of the plain
    unpack's samples, times the chirp."""
    plan, g, cst, raw = _ftp_case(nbit, twos, real, npol, ja98, nchan)
    g.pols = tuple(range(npol))
    g.npart = NPART
    rng = np.random.default_rng(3)
    chirp = np.exp(1j * rng.uniform(-3, 3, (nchan, g.n)))
    ybuf, writes = mirror_forward(g, raw, chirp, _row_tile(plan))
    assert (writes == 1).all() and np.isfinite(ybuf).all()
    x, _ = tmk._unpack_plain(plan, cst, torch.from_numpy(raw), NPART,
                             torch.float64)
    x = x.numpy()
    x = x[:, :, 0] + 1j * x[:, :, 1] if not real else x[:, :, 0]
    for q in range(npol):
        for w in range(NPART):
            if real:
                win = x[:, q, w * g.step:w * g.step + 2 * g.n]
                want = np.fft.rfft(win, axis=-1)[:, :g.n] * chirp
            else:
                win = x[:, q, w * g.step:w * g.step + g.n]
                want = np.fft.fftshift(np.fft.fft(win, axis=-1),
                                       axes=-1) * chirp
            got = ybuf[np.arange(nchan) * npol + q, w]
            assert np.abs(got - want).max() / np.abs(want).max() < TOL


@pytest.mark.parametrize("R2,cr", [(4096, 4), (4096, 8), (8192, 4),
                                   (8192, 8), (8192, 2)])
def test_cluster_store_walk(R2, cr):
    """``mega_fwd2cc``'s stores: the cr ranks of a cluster together store
    each of the cluster's cr rows' R2 columns once; each rank's slice is
    R2/cr consecutive k2, and every warp of 32 threads stores runs of cr
    consecutive rows (k1) at 32/cr columns."""
    seen = np.zeros((cr, R2), int)
    for rank, (r, k2) in enumerate(cluster_slices(R2, cr)):
        np.add.at(seen, (r, k2), 1)
        lo = rank * (R2 // cr)
        assert k2.min() == lo and k2.max() == lo + R2 // cr - 1
        for w in range(0, R2, 32):
            assert (r[w:w + 32] == np.tile(np.arange(cr), 32 // cr)).all()
            assert (np.diff(k2[w:w + 32:cr]) == 1).all()
    assert (seen == 1).all()
    assert CLUSTER_ROWS == 4 and CLUSTER_R2 == 4096


@pytest.mark.parametrize("row_len,npw,S", [(256, 256, 8), (64, 16, 8),
                                           (64, 4, 8), (32, 8, 8),
                                           (128, 2, 4), (8, 8, 8)])
def test_ja98_level_table_blocks(row_len, npw, S):
    """``mega_fwd1``'s JA98 level table: entry (n1 << lgb) + (col >> lg_npw)
    of the tile of columns m0 .. m0 + S - 1 holds the npw-sample block of
    sample (w*step + n1*row_len + m0 + col), for every window, row, tile and
    column; the table (16 bytes an entry) fits the tile's exchange area."""
    R1, npart = 16, 3
    step = row_len * 8
    lg = npw.bit_length() - 1
    lgb = (S.bit_length() - 1 - lg) if S > npw else 0
    assert 16 * R1 * (1 << lgb) <= S * seq_ld(R1) * 8
    for w in range(npart):
        for m0 in range(0, row_len, S):
            tw = w * step + m0
            e = np.arange(R1 << lgb)
            table = ((tw + (e >> lgb) * row_len) >> lg) + (e & ((1 << lgb) - 1))
            n1, col = np.meshgrid(np.arange(R1), np.arange(S), indexing="ij")
            got = table[(n1 << lgb) + (col >> lg)]
            want = (w * step + n1 * row_len + m0 + col) >> lg
            assert np.array_equal(got, want)
