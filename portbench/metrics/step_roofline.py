"""The fused step's share of its roofline, %: the least time its required
work could take (``portbench/work.py``: the filterbank's operations at the
float32 peak, or its input, constants and output bytes once each at the
memory peak) over its device time a block."""

from portbench.metrics import step_ms


def read(ctx):
    ms = step_ms.read(ctx)
    if ms is None:
        return None
    return 100.0 * ctx.bound_ms / ms
