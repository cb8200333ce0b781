"""Device milliseconds a block in the fused step: every kernel whose name
starts ``mega`` (``csrc/megastep.cu``, ``megafil.cu``,
``mega_common.cuh``)."""

from portbench.trace import short_name


def read(ctx):
    us = sum(e.dur for e in ctx.trace.kernels()
             if short_name(e.name).startswith("mega"))
    if us <= 0 or not ctx.blocks:
        return None
    return us * 1e-3 / ctx.blocks
