"""Share of the traced window, %, in which the card ran neither a kernel nor
a copy nor a set."""


def read(ctx):
    window = ctx.trace.window_s
    if window <= 0:
        return None
    return 100.0 * (1.0 - ctx.trace.busy_s() / window)
