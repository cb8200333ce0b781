"""The channel-transposing pre-pass's share of its roofline, %: the least
time its bytes could take at the memory peak (``portbench/work.py``) over
the trace's ``mega_ftp`` kernel time.  Its bytes are the block read once
and written once, whatever does the transpose: twice the window's HtoD
bytes (the blocks and their anchors), over the same blocks as the
kernels'.  A block split at a sub-integration's end runs the step twice,
and each run transposes the whole block: the share then reads low by the
window's share of split blocks (about one in 94 blocks of 106 ms at 10 s
sub-integrations)."""

from portbench.trace import short_name
from portbench.work import HBM_BYTES_S


def read(ctx):
    us = sum(e.dur for e in ctx.trace.kernels()
             if short_name(e.name) == "mega_ftp")
    nbytes = sum(e.nbytes for e in ctx.trace.copies("HtoD"))
    if us <= 0 or nbytes <= 0 or not ctx.blocks:
        return None
    return 100.0 * (2 * nbytes / HBM_BYTES_S) / (us * 1e-6)
