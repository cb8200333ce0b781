"""Device milliseconds a block in the program's ``h2d_wait`` spans: the
step's stream waiting for the block's copies, which run on a copy stream of
their own (``device.BlockStaging`` in ``FoldPipeline.run``), from the run
report of the traced window.  The part of ``h2d_span_ms`` that the step
did not hide; nothing from a program that copies on the step's stream."""

from portbench.program_report import per_block


def read(ctx):
    return per_block(ctx, "device_ms", "h2d_wait")
