"""Run one cell of ``BENCHMARK.json`` once.

    python3 -m portbench.run --workload <cell> --seed <n> --seconds <s> --trace <0|1>

From the root of a checkout.  Set-up makes the cell's ring of input blocks
on the card from the seed, builds the port's pipeline over it
(``dspsr_tpu_torch``: its kernels are built into ``build/dspsr_tpu_torch/``
on the first run in a checkout), and warms it up, which also sizes the
window: the blocks that last ``--seconds``.  The window is one call of the
pipeline's public entry for those blocks, ending with its result on the
host.  Then the program's state is freed, the plain reference works out
what the window produced, and the numbers compared are printed beside
their limits, last on standard error and under ``checks`` in the result.

The last line of standard output is one JSON object: ``correct``,
``attempted``, ``failed``, ``metrics`` (``--trace 0``: the cell's
end-to-end metrics; ``--trace 1``: its per-layer metrics, read from a
``torch.profiler`` trace of the window by ``portbench/metrics/<name>.py``),
``device`` and, traced, ``breakdown``.  No result, and a non-zero exit,
where there is no card or too few, or where ``jax``, ``jaxlib``, ``flax``
or the JAX package is loaded once the window has closed.
"""

from __future__ import annotations

import time

T_START = time.monotonic()

import argparse  # noqa: E402
import contextlib  # noqa: E402
import io  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from dataclasses import dataclass  # noqa: E402

#: top-level module names that no run may load: JAX and the JAX package
FORBIDDEN = ("jax", "jaxlib", "flax", "dspsr_tpu")


def forbidden_modules(names) -> list:
    """The names among ``names`` whose top-level name, the part before the
    first dot, is one of ``FORBIDDEN`` as a whole word (``dspsr_tpu_torch``
    is not ``dspsr_tpu``)."""
    return sorted(n for n in names if n.split(".")[0] in FORBIDDEN)


@dataclass
class Context:
    """What a per-layer metric's reader reads (``portbench/metrics/``)."""

    trace: object  # portbench.trace.Trace of the window
    blocks: int  # blocks in the window
    report: str  # what the program printed on standard error meanwhile
    bound_ms: float  # the least time of one step (portbench/work.py)


def run_cell(cell, seed: int, seconds: float, trace: bool,
             device: str = "cuda", t_start: float = T_START,
             prepare=None) -> dict:
    """One run of ``cell`` (``portbench.spec.Cell``); returns the result's
    fields, ``checks`` last.  ``prepare(driver)``, where given, is called
    once set-up has built the pipeline, before the warm-up."""
    import torch

    from portbench import trace as tracing
    from portbench.spec import reader
    from portbench.work import bound_ms

    t_import = time.monotonic() - t_start
    drv = cell.driver.Driver(cell, seed, device, trace)
    if prepare is not None:
        prepare(drv)
    nblocks = drv.warm(seconds)
    drv.sync()
    setup_s = time.monotonic() - t_start
    print(f"portbench: {cell.name} seed {seed}: {nblocks} blocks of "
          f"{drv.geom.sky_seconds:.6f} s of sky, ring of "
          f"{drv.ring.nblocks} x {drv.geom.stride_bytes} B, ring views "
          f"pinned: {drv.pinned}, set-up {setup_s:.3f} s (start and "
          f"imports {t_import:.3f}, " + ", ".join(
              f"{k} {v:.3f}" for k, v in drv.setup_parts.items()) + ")",
          file=sys.stderr, flush=True)

    cuda = drv.device.type == "cuda"
    if trace:
        printed = io.StringIO()
        with contextlib.redirect_stderr(printed):
            out, tr = tracing.capture(lambda: drv.window(nblocks))
        wall = tr.window_s
    else:
        t0 = time.perf_counter()
        out = drv.window(nblocks)
        drv.sync()
        wall = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated() if cuda else 0
    name = torch.cuda.get_device_name(0) if cuda else "cpu"
    nbytes, ops = drv.work()
    step_bound = bound_ms(nbytes, ops)[0]

    attempted = nblocks
    failed = 0

    drv.release()
    numbers = drv.judge(out)
    limits = cell.limits["limits"]
    checks = {k: {"value": v, "limit": limits[k]} for k, v in numbers.items()}
    correct = all(c["value"] <= c["limit"] for c in checks.values()) \
        and failed == 0

    device_info = {"platform": "gpu" if cuda else "cpu", "kind": name,
                   "count": cell.chips, "memory_peak_bytes": int(peak)}
    result = {"correct": correct, "attempted": attempted, "failed": failed}
    if trace:
        ctx = Context(tr, nblocks, printed.getvalue(), step_bound)
        metrics = {}
        for m in cell.per_layer:
            v = reader(m["name"])(ctx)
            if v is not None:
                metrics[m["name"]] = {"value": float(v), "unit": m["unit"]}
        device_info.update(busy_s=tr.busy_s(), window_s=tr.window_s)
        result.update(metrics=metrics, device=device_info, breakdown={
            "device_ops": tracing.top_device_ops(tr),
            "idle_gaps": tracing.idle_by_host(tr)})
    else:
        sky = nblocks * drv.geom.sky_seconds
        values = {"realtime_x": sky / wall, "setup_s": setup_s}
        result.update(metrics={m["name"]: {"value": values[m["name"]],
                                           "unit": m["unit"]}
                               for m in cell.end_to_end},
                      device=device_info)
    result["checks"] = checks
    return result


def main(argv=None) -> int:
    p = argparse.ArgumentParser(prog="python3 -m portbench.run")
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = p.parse_args(argv)

    root = os.getcwd()
    # caches of anything that compiles, at fixed paths inside the checkout
    for var, sub in (("TORCH_EXTENSIONS_DIR", "torch_extensions"),
                     ("TRITON_CACHE_DIR", "triton")):
        os.environ[var] = os.path.join(root, "build", "portbench", sub)

    from portbench.spec import load_cell

    cell = load_cell(args.workload, root)
    import torch

    if not torch.cuda.is_available() \
            or torch.cuda.device_count() < cell.chips:
        print(f"portbench: {cell.name} needs {cell.chips} CUDA device(s); "
              f"torch.cuda.is_available() is {torch.cuda.is_available()}",
              file=sys.stderr)
        return 2
    result = run_cell(cell, args.seed, args.seconds, bool(args.trace))
    bad = forbidden_modules(sys.modules)
    if bad:
        print(f"portbench: the run loaded {', '.join(bad)}", file=sys.stderr)
        return 3
    for k, c in result["checks"].items():
        print(f"check {k} {c['value']!r} limit {c['limit']!r}",
              file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
