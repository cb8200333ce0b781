"""Host-to-device copy rate: bytes of the profiler's HtoD copy records over
their device time, GB/s (``device.host_to_device`` from the pinned ring)."""


def read(ctx):
    copies = ctx.trace.copies("HtoD")
    nbytes = sum(e.nbytes for e in copies)
    us = sum(e.dur for e in copies)
    if nbytes <= 0 or us <= 0:
        return None
    return nbytes / (us * 1e-6) / 1e9
