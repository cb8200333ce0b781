"""FFT micro-benchmark on the port's device.

Counterpart of ``dspsr_tpu/utils/fftbench.py`` (reference
``filterbank_speed`` / ``fftbatch_speed``,
``Signal/General/filterbank_speed.C:189-221``): sweep transform lengths and
batch sizes of ``torch.fft.fft`` on ``complex64``, print the time per
transform and the reference's MFLOPS figure
``5*nfft*nchan*(log2 nfft + log2 nchan)/t_us``.

    python -m dspsr_tpu_torch.utils.fftbench --nfft 4096 65536 --device cuda
"""

from __future__ import annotations

import argparse

import numpy as np


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="fftbench")
    ap.add_argument("--nfft", type=int, nargs="+",
                    default=[4096, 65536, 1 << 20])
    ap.add_argument("--nchan", type=int, nargs="+", default=[1, 64, 1024])
    ap.add_argument("--batch", type=int, default=4,
                    help="rows a timed call transforms at least (more "
                         "where fewer would make 2^22 points: "
                         "optimalfft.MIN_POINTS)")
    ap.add_argument("--trials", type=int, default=3)
    ap.add_argument("--device", default="cuda",
                    help="torch device to time on (default cuda; 'cpu' "
                         "times the CPU's FFT)")
    args = ap.parse_args(argv)

    from .optimalfft import FFTBench

    print(f"{'nchan':>6s} {'nfft':>9s} {'t/xform(us)':>12s} {'MFLOPS':>10s} "
          f"{'Mcsamp/s':>9s}")
    for nchan in args.nchan:
        for nfft in args.nfft:
            n = nchan * nfft
            if n > (1 << 24):
                continue
            bench = FFTBench(args.device, batch=args.batch,
                             trials=args.trials, cache=False)
            dt = bench.time_fft(n)
            t_us = dt * 1e6
            mflops = 5 * nfft * nchan * (np.log2(nfft)
                                         + np.log2(max(nchan, 2))) / t_us
            print(f"{nchan:6d} {nfft:9d} {t_us:12.1f} {mflops:10.0f} "
                  f"{n / dt / 1e6:9.1f}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
