"""Diagnostic CLIs on the port: dmsmear, digihdr, digistat, digihist,
digitxt, passband, digimon, load_bits, cbird and sklimit.

Counterpart of ``dspsr_tpu/apps/diagnostics.py`` (reference
``Signal/General/dmsmear.C``, ``Kernel/Applications/digihdr.C``,
``Signal/General/digistat.C`` and the others named below), with the same
options.  The five tools that unpack data (digistat, digihist, digitxt,
passband, digimon) copy the bytes to ``--device`` (``cuda`` by default;
the CPU must be asked for by name), unpack and reduce them there, and bring
only the numbers they print back; dmsmear, digihdr, load_bits, cbird and
sklimit run on the host.

    python -m dspsr_tpu_torch.apps.diagnostics digistat -n 1048576 in.dada
"""

from __future__ import annotations

import argparse
import math
import sys

import numpy as np


def _device_arg(p: argparse.ArgumentParser) -> None:
    p.add_argument("--device", default="cuda",
                   help="torch device to unpack on (default cuda; 'cpu' "
                        "must be asked for by name)")


def _unpack(src, start: int, nsamp: int, device):
    """Samples ``[start, start + nsamp)`` of ``src`` unpacked on
    ``device``: ``(raw, x, w)``, the bytes, the FPT samples (float32, or
    complex64 for complex input) and the JA98 weights (or None)."""
    from ..device import host_to_device, resolve_device
    from ..unpack.unpackers import UnpackPlan

    raw = host_to_device(np.ascontiguousarray(
        src.read_samples(start, nsamp)), resolve_device(device))
    x, w = UnpackPlan(src.obs).unpack(raw)
    return raw, x, w


def _components(x):
    """FPT samples as real components ``[nchan, npol, ndat, ndim]``."""
    import torch

    return torch.view_as_real(x) if x.is_complex() else x[..., None]


def sample_stats(x) -> dict:
    """Per (channel, pol) mean, rms, min and max of unpacked samples
    ``x`` over time and both components of complex samples, reduced on
    ``x``'s device in float64: numpy ``[nchan, npol]`` each."""
    d = _components(x).double()
    d = d.reshape(d.shape[0], d.shape[1], -1)
    out = dict(mean=d.mean(-1), rms=d.std(-1, correction=0),
               min=d.amin(-1), max=d.amax(-1))
    return {k: v.cpu().numpy() for k, v in out.items()}


def bandpass(x, nchan: int, real: bool):
    """Mean power of each polarization in ``nchan`` channels (the
    critically sampled filterbank, ``freq_res`` 1) of unpacked samples
    ``x [nchan_in, npol, ndat]``, on ``x``'s device: numpy float64
    ``[nchan_in * (nchan // nchan_in), npol]`` (natural channel order)."""
    from ..ops.detection import detect_ppqq
    from ..ops.filterbank import FilterbankPlan, filterbank_block

    plan = FilterbankPlan(real_input=real,
                          nchan_subband=max(nchan // x.shape[0], 1),
                          freq_res=1)
    npart = plan.npart(x.shape[-1])
    y = filterbank_block(x[..., :plan.block_ndat(npart)], plan, npart)
    return detect_ppqq(y).double().mean(-1).cpu().numpy()


def dmsmear(argv=None) -> int:
    """Print dispersion smearing and FFT sizing for a DM/band
    (reference ``dmsmear -d DM -f MHz -b MHz -n nchan``)."""
    p = argparse.ArgumentParser(prog="dmsmear")
    p.add_argument("-d", "--dm", type=float, required=True)
    p.add_argument("-f", "--freq", type=float, default=1400.0, help="MHz")
    p.add_argument("-b", "--bw", type=float, default=400.0, help="MHz")
    p.add_argument("-n", "--nchan", type=int, default=1)
    args = p.parse_args(argv)

    from ..ops.dedispersion import Dedispersion, smearing_time
    from ..ops.response import choose_nfft

    cf, bw, nchan, dm = args.freq, args.bw, args.nchan, args.dm
    total = smearing_time(dm, cf, bw)
    ch_bw = abs(bw) / nchan
    lowest = cf - (abs(bw) - ch_bw) / 2.0
    worst = smearing_time(dm, lowest, ch_bw)
    nfp = Dedispersion._half_smearing_samples(dm, cf, bw, nchan, +1, 0.1)
    nfn = Dedispersion._half_smearing_samples(dm, cf, bw, nchan, -1, 0.1)
    nfft = choose_nfft(nfp + nfn)
    print(f"DM = {dm} pc cm^-3")
    print(f"Band: {cf} MHz, BW {bw} MHz, {nchan} channel(s)")
    print(f"Total dispersion delay across band: {total*1e3:.6f} ms")
    print(f"Smearing in worst channel: {worst*1e3:.6f} ms")
    print(f"Overlap samples (impulse_pos/neg): {nfp} / {nfn}")
    print(f"Suggested FFT length per channel: {nfft} "
          f"(efficiency {(nfft-nfp-nfn)/nfft*100:.1f}%)")
    return 0


def digihdr(argv=None) -> int:
    """Dump the parsed header/Observation of a data file
    (reference ``digihdr``)."""
    p = argparse.ArgumentParser(prog="digihdr")
    p.add_argument("file")
    args = p.parse_args(argv)

    from ..io.sources import open_source

    src = open_source(args.file)
    o = src.obs
    rows = [
        ("FORMAT", type(src).__name__),
        ("SOURCE", o.source),
        ("TELESCOPE", o.telescope),
        ("INSTRUMENT", o.instrument),
        ("MODE", o.mode),
        ("FREQ (MHz)", o.centre_frequency),
        ("BW (MHz)", o.bandwidth),
        ("NCHAN", o.nchan),
        ("NPOL", o.npol),
        ("NDIM", o.ndim),
        ("NBIT", o.nbit),
        ("STATE", o.state.value),
        ("RATE (Hz)", o.rate),
        ("TSAMP (us)", 1e6 / o.rate if o.rate else 0),
        ("START MJD", str(o.start_time)),
        ("NDAT", src.total_samples),
        ("LENGTH (s)", src.total_samples / o.rate if o.rate else 0),
    ]
    for k, v in rows:
        print(f"{k:12s} {v}")
    return 0


def digistat(argv=None) -> int:
    """Sample statistics and digitizer histogram of a stretch of data
    (reference ``digistat``)."""
    p = argparse.ArgumentParser(prog="digistat")
    p.add_argument("file")
    p.add_argument("-n", "--nsamp", type=int, default=1 << 20)
    p.add_argument("-S", "--skip", type=int, default=0, help="samples to skip")
    _device_arg(p)
    args = p.parse_args(argv)

    from ..io.sources import open_source
    from ..unpack.unpackers import digitizer_histogram

    src = open_source(args.file)
    o = src.obs
    n = min(args.nsamp, src.total_samples - args.skip)
    raw, x, w = _unpack(src, args.skip, n, args.device)
    st = sample_stats(x)
    print(f"{n} samples from {args.file}")
    for c in range(o.nchan):
        for pol in range(o.npol):
            print(f"chan {c} pol {pol}: mean {st['mean'][c, pol]:+.4f} "
                  f"rms {st['rms'][c, pol]:.4f} min {st['min'][c, pol]:+.3f}"
                  f" max {st['max'][c, pol]:+.3f}")
    if o.nbit <= 8:
        hist = digitizer_histogram(raw, o.nbit).cpu().numpy()
        print(f"digitizer histogram ({1 << o.nbit} states):")
        total = hist.sum()
        for i, h in enumerate(hist):
            bar = "#" * int(60 * h / max(hist.max(), 1))
            print(f"  {i:3d} {h:10d} {100*h/total:5.2f}% {bar}")
    if w is not None:
        print(f"excision: {100*(1-float(w.double().mean())):.3f}% of "
              "weights zapped")
    return 0


def digihist(argv=None) -> int:
    """Digitizer state histogram per channel/pol (reference ``digihist``;
    2-bit histograms used for the TwoBitStats archive extension)."""
    p = argparse.ArgumentParser(prog="digihist")
    p.add_argument("file")
    p.add_argument("-n", "--nsamp", type=int, default=1 << 20)
    _device_arg(p)
    args = p.parse_args(argv)

    from ..device import host_to_device, resolve_device
    from ..io.sources import open_source
    from ..unpack.unpackers import digitizer_histogram

    src = open_source(args.file)
    o = src.obs
    n = min(args.nsamp, src.total_samples)
    raw = host_to_device(np.ascontiguousarray(src.read_samples(0, n)),
                         resolve_device(args.device))
    ndig = o.nchan * o.npol * o.ndim
    hist = digitizer_histogram(raw, o.nbit, ndig=ndig).reshape(
        ndig, -1).cpu().numpy()
    for d in range(ndig):
        chan = d // (o.npol * o.ndim)
        pol = (d // o.ndim) % o.npol
        dim = d % o.ndim
        print(f"digitizer chan={chan} pol={pol} dim={dim}: "
              + " ".join(str(int(h)) for h in hist[d]))
    return 0


def digitxt(argv=None) -> int:
    """Dump unpacked samples as text (reference ``digitxt``)."""
    p = argparse.ArgumentParser(prog="digitxt")
    p.add_argument("file")
    p.add_argument("-n", "--nsamp", type=int, default=32)
    p.add_argument("-S", "--skip", type=int, default=0)
    _device_arg(p)
    args = p.parse_args(argv)

    from ..io.sources import open_source

    src = open_source(args.file)
    o = src.obs
    _, x, _ = _unpack(src, args.skip, args.nsamp, args.device)
    d = _components(x).cpu().numpy()  # [nchan, npol, ndat, ndim]
    for t in range(d.shape[2]):
        if d.shape[3] == 2:
            vals = " ".join(f"{d[c, pl, t, 0]:+.4f}{d[c, pl, t, 1]:+.4f}j"
                            for c in range(o.nchan) for pl in range(o.npol))
        else:
            vals = " ".join(f"{d[c, pl, t, 0]:+.4f}"
                            for c in range(o.nchan) for pl in range(o.npol))
        print(f"{args.skip + t:10d} {vals}")
    return 0


def passband(argv=None) -> int:
    """Bandpass estimate of undetected data (reference ``passband``;
    Signal/General/Bandpass.C role).  Prints nchan x npol mean power."""
    p = argparse.ArgumentParser(prog="passband")
    p.add_argument("file")
    p.add_argument("-F", "--nchan", type=int, default=256)
    p.add_argument("-n", "--nsamp", type=int, default=1 << 20)
    _device_arg(p)
    args = p.parse_args(argv)

    from ..io.sources import open_source
    from ..ops.filterbank import FilterbankPlan

    src = open_source(args.file)
    o = src.obs
    real = o.state.value == "Nyquist"
    plan = FilterbankPlan(real_input=real,
                          nchan_subband=max(args.nchan // o.nchan, 1),
                          freq_res=1)
    n = min(args.nsamp, src.total_samples)
    _, x, _ = _unpack(src, 0, plan.block_ndat(plan.npart(n)), args.device)
    bp = bandpass(x, args.nchan, real)  # [nchan, npol]
    nchan_out = bp.shape[0]
    for c in range(nchan_out):
        f = (o.centre_frequency - 0.5 * o.bandwidth
             + (c + 0.5) * o.bandwidth / nchan_out)
        print(f"{f:12.4f} " + " ".join(f"{v:.6e}" for v in bp[c]))
    return 0


def digimon(argv=None) -> int:
    """Digitizer level monitor (reference ``digimon`` +
    ``Signal/General/LevelMonitor.C:monitor/accumulate_stats/set_thresholds``):
    iteratively measures per-digitizer (chan,pol,dim) mean and variance and
    emits ``GAIN ichan ipol idim delta_gain`` / ``LEVEL ichan ipol idim
    delta_mean`` correction commands until levels are within tolerance.
    The unpacked levels are BitTable variance-normalized, so the optimal
    variance is 1.0 (``LevelMonitor.C:95`` get_optimal_variance)."""
    p = argparse.ArgumentParser(prog="digimon")
    p.add_argument("file")
    p.add_argument("-n", "--integrate", type=int, default=1 << 18,
                   help="samples per iteration")
    p.add_argument("-i", "--iterations", type=int, default=0,
                   help="max iterations (0 = until good/EOD)")
    p.add_argument("-c", "--consecutive", action="store_true",
                   help="integrate consecutive blocks (default: stride)")
    p.add_argument("--var-tolerance", type=float, default=0.01)
    p.add_argument("--mean-tolerance", type=float, default=0.01)
    _device_arg(p)
    args = p.parse_args(argv)

    from ..io.sources import open_source

    src = open_source(args.file)
    optimal_variance = 1.0
    n = args.integrate
    pos = 0
    it = 0
    while (not args.iterations or it < args.iterations):
        if pos + n > src.total_samples:
            break
        _, x, _ = _unpack(src, pos, n, args.device)
        d = _components(x).double()  # [nchan, npol, ndat, ndim]
        mean = d.mean(2).cpu().numpy()  # [nchan, npol, ndim]
        var = d.var(2, correction=0).cpu().numpy()
        far_from_good = False
        all_good = True
        for ic in range(mean.shape[0]):
            for ip in range(mean.shape[1]):
                for idim in range(mean.shape[2]):
                    v, m = var[ic, ip, idim], mean[ic, ip, idim]
                    if v <= 0:
                        continue
                    dvar = abs(v - optimal_variance)
                    if dvar >= args.var_tolerance:
                        all_good = False
                        if dvar > 5 * args.var_tolerance:
                            far_from_good = True
                        delta_gain = math.sqrt(optimal_variance / v)
                        print(f"GAIN {ic} {ip} {idim} {delta_gain:.6f}")
                    if not far_from_good and abs(m) > args.mean_tolerance:
                        all_good = False
                        print(f"LEVEL {ic} {ip} {idim} {m:.6f}")
        sys.stdout.flush()
        if all_good or not far_from_good:
            # as LevelMonitor::monitor: return once not far_from_good
            break
        pos += n if args.consecutive else 4 * n
        it += 1
    return 0


def load_bits(argv=None) -> int:
    """Dump raw sample bits to stdout (reference
    ``Kernel/Applications/load_bits.C``): each byte printed MSB-first as
    '0'/'1' characters, one byte per line."""
    p = argparse.ArgumentParser(prog="load-bits")
    p.add_argument("files", nargs="+")
    p.add_argument("-n", "--nbytes", type=int, default=1024,
                   help="bytes to dump per file")
    p.add_argument("-S", "--skip", type=int, default=0, help="bytes to skip")
    args = p.parse_args(argv)

    from ..io.sources import open_source

    for path in args.files:
        src = open_source(path)
        bps = src.bytes_per_sample_exact()
        s0 = args.skip // bps
        nsamp = -(-args.nbytes // bps)
        raw = src.read_samples(s0, min(nsamp, src.total_samples - s0))
        raw = raw[: args.nbytes]
        bits = np.unpackbits(raw.reshape(-1, 1), axis=1)  # MSB first
        for row in bits:
            print("".join("1" if b else "0" for b in row))
    return 0


def cbird(argv=None) -> int:
    """Bandpass birdie lister (reference ``Signal/General/cbird.C``):
    median-filter the bandpass with a window of ``-w`` (fraction of nchan),
    flag channels deviating more than ``-t`` sigma from the smoothed
    bandpass, print the birdie channel list."""
    p = argparse.ArgumentParser(prog="cbird")
    p.add_argument("bandpass",
                   help="bandpass file: text rows of 'freq pow [pow...]' "
                        "(the passband output) or .npz with freq/power")
    p.add_argument("-t", "--threshold", type=float, default=4.0,
                   help="threshold in sigma (default 4)")
    p.add_argument("-w", "--window", type=float, default=0.01,
                   help="median window as a fraction of nchan (default 0.01)")
    p.add_argument("-o", "--output", default=None,
                   help="write birdie list here instead of stdout")
    args = p.parse_args(argv)

    if args.bandpass.endswith(".npz"):
        d = np.load(args.bandpass)
        freq, power = d["freq"], d["power"]
    else:
        rows = np.loadtxt(args.bandpass, ndmin=2)
        freq, power = rows[:, 0], rows[:, 1:].sum(axis=1)
    nchan = len(power)
    win = max(3, int(args.window * nchan) | 1)  # odd
    half = win // 2
    padded = np.pad(power, half, mode="edge")
    smooth = np.median(
        np.lib.stride_tricks.sliding_window_view(padded, win), axis=-1)
    resid = power - smooth
    sigma = 1.4826 * np.median(np.abs(resid - np.median(resid)))  # MAD
    bird = np.flatnonzero(np.abs(resid) > args.threshold * max(sigma, 1e-30))
    out = sys.stdout if not args.output else open(args.output, "w")
    try:
        for c in bird:
            print(f"{c} {freq[c]:.6f} {resid[c]/max(sigma,1e-30):.2f}",
                  file=out)
    finally:
        if args.output:
            out.close()
    print(f"cbird: {len(bird)}/{nchan} birdie channels "
          f"(threshold {args.threshold} sigma, window {win})", file=sys.stderr)
    return 0


def sklimit(argv=None) -> int:
    """Print spectral-kurtosis excision thresholds for a range of M
    (reference ``Signal/Statistics/sklimit.C``: SKLimits via the Pearson IV
    family, Nita & Gary 2010)."""
    p = argparse.ArgumentParser(prog="sklimit")
    p.add_argument("-m", type=int, default=128,
                   help="samples integrated per SK estimate")
    p.add_argument("-M", type=int, default=0,
                   help="sweep M from -m to this (doubling)")
    p.add_argument("-s", type=float, default=3.0,
                   help="excision threshold in std deviations")
    args = p.parse_args(argv)
    from ..utils.stats import sk_limits

    m = args.m
    print("# M  std_devs  lower  upper")
    while True:
        t = sk_limits(m, args.s)
        print(f"{m} {args.s} {t.lower:.6f} {t.upper:.6f}")
        m *= 2
        if not args.M or m > args.M:
            break
    return 0


TOOLS = {"dmsmear": dmsmear, "digihdr": digihdr, "digistat": digistat,
         "digihist": digihist, "digitxt": digitxt, "passband": passband,
         "digimon": digimon, "load_bits": load_bits, "cbird": cbird,
         "sklimit": sklimit}


def main(argv=None) -> int:
    """Dispatcher: python -m dspsr_tpu_torch.apps.diagnostics <tool> [args]."""
    argv = list(sys.argv[1:] if argv is None else argv)
    if not argv or argv[0] not in TOOLS:
        print(f"usage: diagnostics {{{','.join(TOOLS)}}} [options]",
              file=sys.stderr)
        return 2
    return TOOLS[argv[0]](argv[1:])


if __name__ == "__main__":
    raise SystemExit(main())
