"""A float64 numpy mirror of the CUDA forward half and inverse
(``dspsr_tpu_torch/csrc/mega_common.cuh``), held against ``numpy.fft.rfft``
and the port's plain front end (``ops.megakernel._front_plain``).

The CUDA code cannot run on the CPU, so its index algebra is checked here:
the register-resident Stockham FFT (``fft_regs``: pass radices, thread
pattern ``j + T*i``, butterfly placement, table twiddles, the in-register
radix-2 DFT and its bit reversal), the packing of two real pols into one
complex sequence with the power-of-two scale of pol b, the row pairs
{k1, R1 - k1} with the self-paired rows 0 and R1/2, the partner columns and
the separation, the tile walk, and the wrapper's twiddle-table layout
(``kernels.megastep.twiddle_tables``, built here in float64 so that the
mirror can be held to 1e-12).
"""

import dataclasses

import numpy as np
import pytest
import torch

from dspsr_tpu.ops import megakernel as jmk
from dspsr_tpu.ops.filterbank import FilterbankPlan

from dspsr_tpu_torch.kernels.megastep import (
    TILE_CAPS, fft_pass_bits, twiddle_tables)
from dspsr_tpu_torch.ops import megakernel as tmk

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
    return 16 if L >= 16 else 8


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
    lgP, logL = P.bit_length() - 1, L.bit_length() - 1
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

    @property
    def row_len(self):
        return 2 * self.R2

    @property
    def n(self):
        return self.R1 * self.R2

    def ndat(self):
        return (self.npart - 1) * self.step + 2 * self.n


def tables64(g):
    """The wrapper's table buffer, in float64, split as ``Tables``."""
    buf = twiddle_tables(g.R1, g.row_len, g.M, dtype=np.complex128)
    log2n = (2 * g.n).bit_length() - 1
    lo_bits = (log2n + 1) // 2
    o = np.cumsum([0, g.R1, g.row_len, g.M, 1 << lo_bits,
                   1 << (log2n - lo_bits), 16 * g.R1])
    assert o[-1] == buf.size
    r1, row, inv, lo, hi, col = (buf[o[i]:o[i + 1]] for i in range(6))
    return dict(r1=r1, row=row, inv=inv, lo=lo, hi=hi, col=col, log2n=log2n,
                lo_bits=lo_bits)


def values(g, raw, pol):
    """Unpacked float64 samples of one pol, [nchan, ndat]."""
    codes = raw.view(np.int8) if g.twos else raw
    x = codes.reshape(g.ndat(), g.nchan, g.npol)[:, :, pol].T
    return x.astype(np.float64) * g.scale + g.offset


def pol_exponent(ea, eb):
    if not (ea > 0 and eb > 0):
        return 0
    d = 0.5 * (np.log2(ea) - np.log2(eb))
    return int(np.rint(min(max(d, -60.0), 60.0)))


def polpow(g, raw):
    """``mega_polpow``: [nchan, npart, 2] energies of the two pols."""
    out = np.zeros((g.nchan, g.npart, 2))
    for q in range(2):
        x = values(g, raw, g.pols[0] + q)
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
    codes = raw.view(np.int8) if g.twos else raw
    v = np.empty((P, T, g.nchan, g.npart, g.row_len), complex)
    for i in range(P):
        t = w * g.step + (j + T * i) * g.row_len + m
        off = (t * g.nchan + c) * g.npol + g.pols[0]
        a = codes[off] * g.scale + g.offset
        b = (codes[off + 1] * g.scale + g.offset) * sb if npolf == 2 else 0.0
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


def mirror_forward(g, raw, chirp, tp, tc=TILE_CAPS[0], store=None,
                   tap=False):
    tb = tables64(g)
    psum = polpow(g, raw) if len(g.pols) == 2 else None
    cbuf, e = fwd1(g, raw, tb, psum, min(tc, g.row_len))
    return fwd2(g, cbuf, e, tb, chirp, tp, store, tap)


# --------------------------------------------------------------------------
# the checks
# --------------------------------------------------------------------------

def _raw(g, rng, unequal=False):
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
                                            (512, 1024, 4096)])
def test_twiddle_tables_are_rounded_exp(R1, row_len, M):
    got = twiddle_tables(R1, row_len, M)
    assert got.dtype == np.complex64
    two_n = R1 * row_len
    log2n = two_n.bit_length() - 1
    lo_bits = (log2n + 1) // 2
    turns = []
    for L in (R1, row_len, M):  # per pass: k*r / (Ns*R) at (r-1)*Ns + k
        lgP, logL = fft_points(L).bit_length() - 1, L.bit_length() - 1
        ns, block = 1 << lgP, []
        for s in range(1, num_passes(logL, lgP)):
            R = 1 << pass_bits(s, logL, lgP)
            for r in range(1, R):
                block += [k * r / (ns * R) for k in range(ns)]
            ns *= R
        turns += block + [None] * (L - len(block))
    turns += [e / two_n for e in range(1 << lo_bits)]
    turns += [(e << lo_bits) / two_n for e in range(1 << (log2n - lo_bits))]
    turns += [c * k1 / two_n for k1 in range(R1) for c in range(16)]
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
            * got[-16 * R1:][k1 * 16 + col])
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


NSUB, FREQ_RES, NPART = 4, 64, 3


@pytest.mark.parametrize("kw", [
    dict(npol=2, npol_out=2), dict(npol=2, npol_out=4), dict(npol=1),
    dict(npol=2, detection="qq"), dict(npol=2, npol_out=2, nchan_in=2),
    dict(npol=2, npol_out=4, twos_complement=True),
    dict(npol=2, npol_out=2, unequal=True),
    dict(npol=2, nsub=1, freq_res=256),
], ids=lambda kw: "-".join(f"{k}={v}" for k, v in kw.items()))
def test_front_mirror_matches_plain(kw):
    """The mirror's detected front end equals the port's float64
    ``_front_plain`` (rfft, chirp, ifft, detect) on the same plan."""
    kw = dict(kw)
    unequal = kw.pop("unequal", False)
    nsub, freq_res = kw.pop("nsub", NSUB), kw.pop("freq_res", FREQ_RES)
    fb = FilterbankPlan(real_input=True, nchan_subband=nsub,
                        freq_res=freq_res, nfilt_pos=5, nfilt_neg=6)
    jplan = jmk.MegaPlan.from_filterbank(fb, nbin=2, **kw)
    plan = tmk.MegaPlan(**dataclasses.asdict(jplan))
    rng = np.random.default_rng(11)
    nci = plan.nchan_in
    g = Geom(R1=plan.R1, R2=plan.R2, M=plan.freq_res, nchan=nci,
             npol=plan.npol, pols=tmk.fold_pols(plan), npart=NPART,
             step=plan.nsamp_step, twos=plan.twos_complement)
    g.scale, g.offset = tmk.unpack_affine(8, plan.twos_complement)
    raw = _raw(g, rng, unequal)
    resp = np.exp(1j * rng.uniform(-3, 3, (nci * nsub, freq_res)))
    cst = tmk.MegaConstants.build(plan, resp, g.scale, g.offset).to("cpu")
    chirp = cst.gr.double().numpy() + 1j * cst.gi.double().numpy()
    ybuf, writes = mirror_forward(g, raw, chirp, min(8, plan.R1 // 2))
    v = inverse(g, ybuf, tables64(g), nsub) / freq_res
    v = v[..., plan.nfilt_pos:plan.nfilt_pos + plan.nkeep]
    got = tmk._detect_plain(torch.from_numpy(v), plan).numpy()
    want = tmk._front_plain(plan, cst, torch.from_numpy(raw), NPART,
                            torch.float64)[0].numpy()
    assert got.shape == want.shape
    for p in range(plan.nplane):  # each plane against its own maximum
        err = np.abs(got[:, p] - want[:, p]).max() / np.abs(want[:, p]).max()
        assert err < TOL, (p, err)


@pytest.mark.parametrize("detection,store", [("pp", 1), ("qq", 2),
                                             ("auto", 3)])
@pytest.mark.parametrize("nchan", [1, 2])
def test_passband_tap_mirror(detection, store, nchan):
    """The passband tap (hybrid front end): both pols transformed, |X|^2 of
    each summed over the windows before the chirp, only the detected pols'
    spectra kept; against the port's float64 plain front end with
    ``passband=True`` and a chirp that zeroes some bins."""
    npol_out = 2 if detection == "auto" else 1
    fb = FilterbankPlan(real_input=True, nchan_subband=NSUB,
                        freq_res=FREQ_RES, nfilt_pos=5, nfilt_neg=6)
    jplan = jmk.MegaPlan.from_filterbank(fb, nbin=2, npol=2, nchan_in=nchan,
                                         npol_out=npol_out,
                                         detection=detection)
    plan = tmk.MegaPlan(**dataclasses.asdict(jplan))
    rng = np.random.default_rng(store)
    g = Geom(R1=plan.R1, R2=plan.R2, M=plan.freq_res, nchan=nchan, npol=2,
             pols=(0, 1), npart=NPART, step=plan.nsamp_step)
    raw = _raw(g, rng)
    resp = np.exp(1j * rng.uniform(-3, 3, (nchan * NSUB, FREQ_RES)))
    resp[:, ::7] = 0.0  # zapped bins: the tap reads the spectra before them
    cst = tmk.MegaConstants.build(plan, resp, g.scale, g.offset).to("cpu")
    chirp = cst.gr.double().numpy() + 1j * cst.gi.double().numpy()
    ybuf, writes, pb = mirror_forward(g, raw, chirp, min(8, plan.R1 // 2),
                                      store=store, tap=True)
    assert (writes == 1).all() and np.isfinite(ybuf).all()
    kept = [q for q in (0, 1) if store >> q & 1]
    assert ybuf.shape[0] == nchan * len(kept)
    for q, pol in enumerate(kept):
        x = values(g, raw, pol)
        for w in range(g.npart):
            win = x[:, w * g.step:w * g.step + 2 * g.n]
            want = np.fft.rfft(win, axis=-1)[:, :g.n] * chirp
            got = ybuf[np.arange(nchan) * len(kept) + q, w]
            assert np.abs(got - want).max() / np.abs(want).max() < TOL
    _, want = tmk.megafil_plain(plan, cst, torch.from_numpy(raw), NPART,
                                torch.float64, passband=True)
    got = tmk.passband_layout(plan, torch.from_numpy(pb)).numpy()
    assert np.abs(got - want.numpy()).max() / want.numpy().max() < TOL
