"""Device milliseconds a block in the program's ``ftp`` spans: the fused
fold step's channel-transposing pre-pass on multi-channel input
(``mega_ftp``, inside the block's ``step`` span), from the run report of
the traced window.  Nothing where the program has no such span: one input
channel, or a program that times the pre-pass inside the step."""

from portbench.program_report import per_block


def read(ctx):
    return per_block(ctx, "device_ms", "ftp")
