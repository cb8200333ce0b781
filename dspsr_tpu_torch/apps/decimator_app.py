"""the-decimator on the port: live DADA ring -> SIGPROC filterbank.

Counterpart of ``dspsr_tpu/apps/decimator_app.py`` (reference
``the_decimator``, ``Signal/General/the_decimator.C:59-111``): attach to a
live shared-memory ring (``io/hostio.py``), channelize, detect and
decimate, and stream a SIGPROC filterbank file while the observation runs.
Same options, plus ``--device``.

It has no ``-D``: with no dispersion measure the ``FilPipeline`` takes the
general chain (the no-DM search: plain PyTorch filterbank, detection,
scrunch and digitizer) and launches neither fused kernel.

    python -m dspsr_tpu_torch.apps.decimator_app /my_ring -F 128 -o live.fil
"""

from __future__ import annotations

import argparse
import sys


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="the-decimator",
        description="Live ring buffer -> SIGPROC filterbank converter "
        "(PyTorch/CUDA)",
    )
    p.add_argument("ring",
                   help="shared-memory ring: a POSIX name (/my_ring) or a "
                        "psrdada-style SysV hex key (e.g. 0xdada; the "
                        "reference's dada_hdu key, DADABuffer.C:175-208)")
    p.add_argument("-o", "--output", required=True)
    p.add_argument("-F", "--nchan", type=int, default=128)
    p.add_argument("-t", "--tscrunch", type=int, default=1)
    p.add_argument("-b", "--nbits", type=int, default=8)
    p.add_argument("-q", "--quiet", action="store_true")
    p.add_argument("--device", default="cuda",
                   help="torch device to run on (default cuda; 'cpu' runs "
                        "the plain PyTorch path)")
    return p


def fil_config(args, buffer_samples: int):
    """The app's ``FilConfig`` for parsed ``args`` on a ring whose buffers
    hold ``buffer_samples`` samples."""
    from ..models.load_to_fil import FilConfig

    return FilConfig(nchan=args.nchan, tscrunch_factor=args.tscrunch,
                     nbits=args.nbits, min_block_samples=buffer_samples,
                     block_parts=1)


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)
    from ..io.hostio import DadaReader, RingReader
    from ..models.load_to_fil import FilPipeline

    if args.ring.lower().startswith("0x"):
        ring = DadaReader(int(args.ring, 16))
    else:
        ring = RingReader(args.ring)
    try:
        nbuf = ring.buffer_samples()
        pipe = FilPipeline(ring, fil_config(args, nbuf), device=args.device)
        if pipe.block_in_samples % nbuf:
            print(f"warning: block {pipe.block_in_samples} not a multiple "
                  f"of ring buffer {nbuf}; the ring serves whole buffers "
                  "only", file=sys.stderr)
        if not args.quiet:
            o = pipe.obs_out
            print(f"the-decimator: {args.ring} -> {args.output} nchan "
                  f"{o.nchan} nbit {o.nbit} on {pipe.device}",
                  file=sys.stderr)
        try:
            pipe.run(args.output)
        except EOFError:
            pass  # the writer ended the stream
    finally:
        ring.close()
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
