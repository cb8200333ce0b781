"""Per-layer metric readers, one module a metric, found by the metric's
name in ``BENCHMARK.json``.

Each defines ``read(ctx) -> float | None``: the metric from the traced
run's ``ctx`` (``portbench.run.Context``: the ``Trace``, the blocks in the
window, the program's run report, the step's work bound), or None where
there is nothing to read, and then the run leaves the metric out.
"""
