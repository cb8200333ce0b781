"""digifil on the port: baseband -> detected n-bit SIGPROC filterbank (or
search-mode PSRFITS with ``--fits``).

Counterpart of ``dspsr_tpu/apps/digifil_app.py`` (reference ``digifil``,
``Signal/General/digifil.C``), with the same options plus ``--device``.

    python -m dspsr_tpu_torch.apps.digifil_app -F 64 -D 2.64 -o out.fil in.dada
"""

from __future__ import annotations

import argparse
import sys


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="digifil",
        description="Convert baseband to a SIGPROC filterbank file "
        "(PyTorch/CUDA digifil)",
    )
    p.add_argument("files", nargs="+")
    p.add_argument("-o", "--output", required=True, help="output .fil file")
    p.add_argument("-F", "--nchan", type=int, default=128,
                   help="filterbank channels")
    p.add_argument("-x", "--freq-res", type=int, default=None)
    p.add_argument("-D", "--dm", type=float, default=0.0,
                   help="coherently dedisperse while channelizing")
    p.add_argument("-t", "--tscrunch", type=int, default=1,
                   help="time decimation factor")
    p.add_argument("-f", "--fscrunch", type=int, default=1,
                   help="frequency decimation factor")
    p.add_argument("-d", "--npol", type=int, default=1, choices=[1, 2, 4])
    p.add_argument("-b", "--nbits", type=int, default=8,
                   choices=[1, 2, 4, 8, 32], help="output bits per sample")
    p.add_argument("-I", "--rescale-interval", type=float, default=0.0,
                   metavar="SEC",
                   help="seconds between rescale updates (0 = every block; "
                        "reference -I)")
    p.add_argument("-P", "--poln-select", type=int, default=None,
                   metavar="POL", help="keep only this input polarization "
                   "(reference PolnSelect)")
    p.add_argument("-K", "--interchannel-align", action="store_true",
                   help="remove inter-channel dispersion delays "
                        "(SampleDelay)")
    p.add_argument("--fixed-twobit", action="store_true",
                   help="2-bit input: plain BitTable levels, no JA98 "
                        "dynamic correction/excision")
    p.add_argument("--no-weights", action="store_true",
                   help="do not zero excision-flagged stretches")
    p.add_argument("--fits", action="store_true",
                   help="write search-mode PSRFITS instead of SIGPROC "
                        "(digifits)")
    p.add_argument("--threads", type=int, default=1, metavar="N",
                   help="shard time blocks over N devices "
                        "(reference digifil -t threads / LoadToFilN)")
    p.add_argument("-c", "--constant-levels", action="store_true",
                   help="freeze offset/scale after first block (digifil -c)")
    p.add_argument("-s", "--scale", type=float, default=1.0,
                   metavar="FAC",
                   help="data scale factor applied before requantization "
                        "(reference -s)")
    p.add_argument("-B", "--block-mb", type=float, default=None,
                   metavar="MB",
                   help="block size in megabytes (reference -B; see also "
                        "--block-samples)")
    p.add_argument("-2", "--no-excision", dest="no_excision",
                   action="store_true",
                   help="disable 2-bit excision: plain BitTable levels "
                        "(reference -2; alias of --fixed-twobit)")
    p.add_argument("-T", "--total", type=float, default=None)
    p.add_argument("--block-parts", type=int, default=4)
    p.add_argument("--block-samples", type=int, default=None,
                   help="input samples per device block; determines "
                        "rescale bootstrap granularity")
    p.add_argument("--device", default="cuda",
                   help="torch device to run on (default cuda; 'cpu' runs "
                        "the plain PyTorch front end)")
    p.add_argument("-q", "--quiet", action="store_true")
    return p


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)
    if args.threads > 1:
        raise NotImplementedError(
            "--threads > 1 (time-sharded digifil); see ROADMAP.md Queue 1 "
            "item 10 (multi-GPU)")
    from ..io.sources import MultiFile, open_source

    from ..models.load_to_fil import FilConfig, FilPipeline

    if args.block_samples is not None:
        block = {"min_block_samples": args.block_samples}
    elif args.block_mb:
        block = {"min_block_samples": int(args.block_mb * 1e6 / 4)}
    else:
        block = {}
    cfg = FilConfig(
        nchan=args.nchan,
        frequency_resolution=args.freq_res,
        dispersion_measure=args.dm,
        tscrunch_factor=args.tscrunch,
        fscrunch_factor=args.fscrunch,
        npol_out=args.npol,
        nbits=args.nbits,
        rescale_constant=args.constant_levels,
        rescale_seconds=args.rescale_interval,
        poln_select=args.poln_select,
        interchannel_align=args.interchannel_align,
        apply_weights=not args.no_weights,
        dynamic_twobit=not (args.fixed_twobit or args.no_excision),
        scale_factor=args.scale,
        block_parts=args.block_parts,
        **block,
    )
    src = (open_source(args.files[0]) if len(args.files) == 1
           else MultiFile(args.files))
    pipe = FilPipeline(src, cfg, device=args.device)
    if not args.quiet:
        o = pipe.obs_out
        print(f"digifil: -> {args.output} nchan {o.nchan} npol {o.npol} "
              f"nbit {o.nbit} tsamp {1e6 / o.rate:.3f} us on {pipe.device}",
              file=sys.stderr)
    pipe.run(args.output, total_seconds=args.total,
             format="psrfits" if args.fits else "sigproc")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
