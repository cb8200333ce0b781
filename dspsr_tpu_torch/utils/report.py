"""Lightweight run reporting: per-stage wall timing + throughput.

Equivalent of the reference's Operation timing report (-r:
``Operation::record_time`` + ``Operation::report``, ``Operation.h:36-96``,
``SingleThread.C:589-594``) and the "Finished X s (N%)" progress meter
(``SingleThread.C:434-451``).  Device stages are fused into one program, so
the unit of accounting is the device step plus host-side phases.
"""

from __future__ import annotations

import sys
import time
from collections import defaultdict
from contextlib import contextmanager


class RunReport:
    def __init__(self, enabled: bool = True, stream=None):
        self.enabled = enabled
        self.stream = stream or sys.stderr
        self.totals = defaultdict(float)
        self.counts = defaultdict(int)
        self.t_start = time.perf_counter()
        self.samples = 0
        self._last_progress = 0.0

    @contextmanager
    def stage(self, name: str):
        t0 = time.perf_counter()
        try:
            yield
        finally:
            dt = time.perf_counter() - t0
            self.totals[name] += dt
            self.counts[name] += 1

    def add_samples(self, n: int):
        self.samples += n

    def progress(self, seconds_done: float, seconds_total: float):
        """Progress meter, throttled to ~1 line/s (SingleThread.C:434-451)."""
        if not self.enabled:
            return
        now = time.perf_counter()
        if now - self._last_progress < 1.0:
            return
        self._last_progress = now
        pct = 100.0 * seconds_done / seconds_total if seconds_total else 0.0
        print(f"Finished {seconds_done:.1f} s ({pct:.0f}%)",
              file=self.stream, flush=True)

    def report(self):
        if not self.enabled:
            return
        wall = time.perf_counter() - self.t_start
        print("run report:", file=self.stream)
        for name in sorted(self.totals, key=self.totals.get, reverse=True):
            t = self.totals[name]
            n = self.counts[name]
            print(f"  {name:<16s} {t:8.3f} s  ({n} calls, "
                  f"{t / max(n, 1) * 1e3:7.2f} ms/call)", file=self.stream)
        if self.samples:
            print(f"  input samples    {self.samples} "
                  f"({self.samples / wall / 1e6:.2f} Msamp/s wall)",
                  file=self.stream)
        print(f"  total wall       {wall:8.3f} s", file=self.stream)
