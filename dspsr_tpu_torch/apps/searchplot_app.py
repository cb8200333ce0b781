"""searchplot on the port: plot search-mode (detected filterbank) data.

Counterpart of ``dspsr_tpu/apps/searchplot_app.py`` (reference
``searchplot``, ``More/Applications/searchplot.C``, and its plot classes
``More/Plotting/FrequencyVsTime.C``, ``HistoPlot.C``): frequency-vs-time
waterfall (-F), sample histogram (-H), incoherent dedispersion at a trial
DM (-D), band-summed flux time series (-K), last-N-seconds windowing (-l),
polarization selection (-p), and summed-channel text output (-s).  PGPLOT
devices are replaced by PNG files (matplotlib Agg, imported only where a
PNG is written), so ``-g/--device`` keeps its meaning, the plot file; the
torch device that unpacks baseband input is ``--torch-device`` (``cuda`` by
default; the CPU must be asked for by name).  A SIGPROC filterbank is read
on the host as it is.

    python -m dspsr_tpu_torch.apps.searchplot_app -K -D 30 -s in.fil

Plot styling: magnitude is encoded with a single perceptually-uniform
sequential ramp (viridis — monotone lightness, CVD-safe; never a rainbow);
single-series line panels carry their identity in the title (no legend
box); grids are recessive; all text in neutral ink.
"""

from __future__ import annotations

import argparse
import sys

import numpy as np

_DM_CONST = 4.149377593360996e3  # MHz^2 s per (pc cm^-3): 1/2.41e-4 usec MHz^2


def _load(path: str, last_seconds: float, pol: int, device="cuda"):
    from ..io import open_source

    src = open_source(path)
    o = src.obs
    nsamp = src.total_samples
    start = 0
    if last_seconds > 0:
        want = int(last_seconds * o.rate)
        start = max(0, nsamp - want)
        nsamp -= start
    # cap what we image; decimate on read for very long files
    if hasattr(src, "read_detected"):
        data = src.read_detected(start, nsamp)  # [ndat, npol, nchan]
    else:
        # baseband: unpack and detect on the device
        from ..device import host_to_device, resolve_device
        from ..unpack.unpackers import UnpackPlan

        raw = host_to_device(np.ascontiguousarray(
            src.read_samples(start, nsamp)), resolve_device(device))
        x, _w = UnpackPlan(o).unpack(raw)
        if x.is_complex():  # analytic: show detected power
            x = x.real ** 2 + x.imag ** 2
        elif o.state.name in ("NYQUIST", "ANALYTIC"):
            x = x ** 2
        data = x.reshape(o.nchan, o.npol, -1).permute(2, 1, 0).cpu().numpy()
    pol = min(pol, data.shape[1] - 1)
    return src, data[:, pol, :], start  # [ndat, nchan]


def _channel_freqs(obs) -> np.ndarray:
    # channel 0 at centre_frequency - bw/2 + bw/(2 nchan); sign of bw orders
    edge = obs.centre_frequency - obs.bandwidth / 2.0
    step = obs.bandwidth / obs.nchan
    return edge + step * (np.arange(obs.nchan) + 0.5)


def dedisperse_shifts(obs, dm: float) -> np.ndarray:
    """Integer sample delays per channel relative to the highest frequency
    (the incoherent-dedispersion shift the reference applies for -D/-K)."""
    f = _channel_freqs(obs)
    fref = f.max()
    delay_s = _DM_CONST * dm * (f ** -2 - fref ** -2)
    return np.round(delay_s * obs.rate).astype(int)


def _apply_dedispersion(data: np.ndarray, shifts: np.ndarray) -> np.ndarray:
    out = np.empty_like(data)
    for c in range(data.shape[1]):
        out[:, c] = np.roll(data[:, c], -shifts[c])
    return out


def main(argv=None) -> int:
    p = argparse.ArgumentParser(
        prog="searchplot",
        description="plot search-mode data (reference searchplot)")
    p.add_argument("files", nargs="+")
    p.add_argument("-F", action="store_true", help="frequency vs time waterfall")
    p.add_argument("-H", action="store_true", help="histogram of samples")
    p.add_argument("-K", action="store_true",
                   help="dedispersed band-summed time series")
    p.add_argument("-D", "--dm", type=float, default=0.0,
                   help="dedisperse at this DM before plotting")
    p.add_argument("-p", "--pol", type=int, default=0)
    p.add_argument("-l", "--last", type=float, default=0.0,
                   help="plot only the last SEC seconds")
    p.add_argument("-x", default=None, help="x zoom: x1,x2 (seconds)")
    p.add_argument("-y", default=None, help="y zoom: y1,y2 (MHz or count)")
    p.add_argument("-s", action="store_true",
                   help="write summed channels to searchplot.out")
    p.add_argument("-g", "--device", default="searchplot.png",
                   help="output image path (replaces the PGPLOT device)")
    p.add_argument("--torch-device", default="cuda",
                   help="torch device that unpacks baseband input "
                        "(default cuda; 'cpu' must be asked for by name)")
    args = p.parse_args(argv)

    if not (args.F or args.H or args.K or args.s):
        args.F = True  # default view

    for path in args.files:
        src, data, start = _load(path, args.last, args.pol,
                                 args.torch_device)
        o = src.obs
        tsamp = 1.0 / o.rate
        t0 = start * tsamp
        if args.dm or args.K:
            shifts = dedisperse_shifts(o, args.dm if args.dm else
                                       o.dispersion_measure)
            if shifts.any():
                data = _apply_dedispersion(data, shifts)

        panels = sum([args.F, args.H, args.K])
        if args.s:
            summed = data.sum(axis=1)
            np.savetxt("searchplot.out",
                       np.c_[t0 + np.arange(len(summed)) * tsamp, summed],
                       fmt="%.9f %.6f")
            print("wrote searchplot.out")
        if panels == 0:
            continue

        import matplotlib
        matplotlib.use("Agg")
        import matplotlib.pyplot as plt

        fig, axes = plt.subplots(panels, 1, figsize=(9, 3.2 * panels),
                                 squeeze=False)
        axes = axes.ravel()
        ink, muted = "#333333", "#bbbbbb"
        i = 0
        freqs = _channel_freqs(o)
        flo, fhi = min(freqs[0], freqs[-1]), max(freqs[0], freqs[-1])
        if args.F:
            ax = axes[i]; i += 1
            img = data.T if freqs[0] < freqs[-1] else data.T[::-1]
            ax.imshow(img, aspect="auto", origin="lower",
                      cmap="viridis", interpolation="nearest",
                      extent=[t0, t0 + data.shape[0] * tsamp, flo, fhi])
            ax.set_xlabel("time (s)", color=ink)
            ax.set_ylabel("frequency (MHz)", color=ink)
            ax.set_title(f"{o.source or path}: frequency vs time"
                         + (f" (DM {args.dm})" if args.dm else ""), color=ink)
        if args.K:
            ax = axes[i]; i += 1
            summed = data.sum(axis=1)
            t = t0 + np.arange(len(summed)) * tsamp
            ax.plot(t, summed, lw=1.2, color="#2166ac")
            ax.set_xlabel("time (s)", color=ink)
            ax.set_ylabel("summed power", color=ink)
            ax.set_title("dedispersed band-summed flux", color=ink)
            ax.grid(True, color=muted, lw=0.4, alpha=0.5)
        if args.H:
            ax = axes[i]; i += 1
            nbins = min(1 << o.nbit, 256) if o.nbit <= 8 else 128
            ax.hist(data.ravel(), bins=nbins, color="#2166ac",
                    edgecolor="white", linewidth=0.3)
            ax.set_xlabel("sample value", color=ink)
            ax.set_ylabel("count", color=ink)
            ax.set_title("sample histogram", color=ink)
            ax.grid(True, axis="y", color=muted, lw=0.4, alpha=0.5)
        for ax in axes[:i]:
            if args.x:
                x1, x2 = (float(v) for v in args.x.split(","))
                ax.set_xlim(x1, x2)
            if args.y:
                y1, y2 = (float(v) for v in args.y.split(","))
                ax.set_ylim(y1, y2)
            for s in ax.spines.values():
                s.set_color(muted)
            ax.tick_params(colors=ink)
        fig.tight_layout()
        out = args.device if len(args.files) == 1 else \
            f"{path.rsplit('/', 1)[-1]}.{args.device}"
        fig.savefig(out, dpi=110)
        plt.close(fig)
        print(f"wrote {out}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
