"""Run reporting (-r): host stages, device spans, the device's waits on the
host, block latency and the device counters.

Equivalent of the reference's Operation timing report (-r:
``Operation::record_time`` + ``Operation::report``, ``Operation.h:36-96``,
``SingleThread.C:589-594``) and the "Finished X s (N%)" progress meter
(``SingleThread.C:434-451``).  Device stages are fused into one program, so
the unit of accounting is the pipeline's loop: for each block, host stages
(``stage``: read, anchors, enqueue, flush, write ...) and device spans
(``device``: h2d, h2d_wait, step, d2h; ftp, the fused step's channel
transpose of multi-channel input, inside its block's step), each a
``Span`` with the block's index and the host stage that was open when it
began.

A device span is a pair of CUDA events on the current stream, taken from a
pool and resolved without waiting: by a non-blocking ``query()`` of the
oldest pending pairs whenever a span closes (a few at a time), and at the
end of the run.  On
the CPU the work is synchronous, and a device span is timed on the host.
Between two device spans on the step's stream (the stream current when the
report began) the device had none of the loop's work: that gap is its wait
on the host (``stall``), put down to the host stages open in the gap's last
stretch before the second span was recorded (``other`` where none was).
Spans on another stream, such as the fold's copy stream
(``device.BlockStaging``), count as device time but give no stall: their
gaps are waits on the device.  A block's latency runs from ``begin_block``
to the end of its last device span, put on the host clock by one anchor
event recorded after a ``synchronize()`` when the report starts.

Everything is kept in memory and summarised by ``report()``: the stages'
lines, then device, stall, counter and latency lines, and last a ``run
report json: {...}`` line that readers parse.  A disabled report records
nothing: ``stage`` and ``device`` return one shared no-op context.
"""

from __future__ import annotations

import bisect
import contextlib
import json
import sys
import time
from collections import defaultdict, deque
from typing import NamedTuple

import numpy as np
import torch

from ..device import launch_counts

#: what a disabled report's ``stage`` and ``device`` return
_NOOP = contextlib.nullcontext()
#: the stall of a gap in which no host stage was open
OTHER = "other"
#: pending device spans resolved at most when a span closes: after a wait
#: (a flush's copy back) the whole backlog has passed, and resolving it at
#: once would hold the host, and the refilling device, for milliseconds
RESOLVE_AT_ONCE = 4


class Span(NamedTuple):
    """One host stage or device span: ``block`` is the block's index (-1
    before the first), ``cause`` the host stage open when it began (None at
    the loop's top level), ``start``/``end`` seconds on the host clock."""

    name: str
    block: int
    cause: str | None
    start: float
    end: float


class _Pending(NamedTuple):
    """A device span whose events the device may not have reached yet."""

    name: str
    block: int
    cause: str | None
    stream: int
    begin: object  # torch.cuda.Event
    end: object
    t_begin: float  # host clock when ``begin`` was recorded
    t_end: float  # and ``end``


class RunReport:
    def __init__(self, enabled: bool = True, stream=None, device="cpu"):
        self.enabled = enabled
        self.stream = stream or sys.stderr
        self.totals = defaultdict(float)
        self.counts = defaultdict(int)
        self.t_start = time.perf_counter()
        self.samples = 0
        self._last_progress = 0.0
        #: the current block's index
        self.block = -1
        #: host stages and device spans, in the order they were resolved
        self.host_spans: list[Span] = []
        self.device_spans: list[Span] = []
        #: the device's wait on the host, seconds by host stage
        self.stall = defaultdict(float)
        if not enabled:
            return
        self._dev = torch.device(device)
        self._cuda = self._dev.type == "cuda"
        # stages go on the profiler's clock only where a profiler runs: a
        # record_function costs tens of microseconds even where none does
        self._profiled = torch.autograd._profiler_enabled()
        self._counters = launch_counts()
        self._open: list[str] = []  # the host stages open now, innermost last
        # the innermost open stage over time: from _mark_t[i] on, _mark_name[i]
        self._mark_t: list[float] = [self.t_start]
        self._mark_name: list[str | None] = [None]
        self._block_start: list[float] = []
        self._block_end: dict[int, float] = {}
        self._pending: deque = deque()
        self._pool: list = []
        # the end of the last resolved device span on the step's stream: its
        # event and the host clock when it was recorded; on the CPU a host
        # time
        self._last_end: tuple | None = None
        self._last_t: float | None = None
        if self._cuda:
            torch.cuda.synchronize(self._dev)
            step = torch.cuda.current_stream(self._dev)
            self._step_stream = step.cuda_stream
            self._anchor = torch.cuda.Event(enable_timing=True)
            self._anchor.record(step)
            self._t_anchor = time.perf_counter()

    # ---- recording ----

    def begin_block(self) -> None:
        """Start the next block: the spans that follow carry its index."""
        if not self.enabled:
            return
        self.block += 1
        self._block_start.append(time.perf_counter())

    def stage(self, name: str):
        """A host stage: host seconds, and where a profiler ran when the
        report began, ``record_function("dspsr.<name>")`` on its clock."""
        if not self.enabled:
            return _NOOP
        return self._stage(name)

    @contextlib.contextmanager
    def _stage(self, name: str):
        cause = self._open[-1] if self._open else None
        t0 = time.perf_counter()
        self._open.append(name)
        self._mark(t0, name)
        try:
            if self._profiled:
                with torch.profiler.record_function(f"dspsr.{name}"):
                    yield
            else:
                yield
        finally:
            t1 = time.perf_counter()
            self._open.pop()
            self._mark(t1, self._open[-1] if self._open else None)
            self.totals[name] += t1 - t0
            self.counts[name] += 1
            self.host_spans.append(Span(name, self.block, cause, t0, t1))

    def device(self, name: str):
        """A device span around work enqueued on the current stream; only
        spans on the step's stream give the stall."""
        if not self.enabled:
            return _NOOP
        return self._device(name) if self._cuda else self._host_timed(name)

    @contextlib.contextmanager
    def _device(self, name: str):
        cause = self._open[-1] if self._open else None
        stream = torch.cuda.current_stream(self._dev)
        begin = self._event()
        begin.record(stream)
        t_begin = time.perf_counter()
        try:
            yield
        finally:
            end = self._event()
            end.record(stream)
            self._pending.append(_Pending(name, self.block, cause,
                                          stream.cuda_stream, begin, end,
                                          t_begin, time.perf_counter()))
            self._poll()

    @contextlib.contextmanager
    def _host_timed(self, name: str):
        cause = self._open[-1] if self._open else None
        t0 = time.perf_counter()
        try:
            yield
        finally:
            t1 = time.perf_counter()
            if self._last_t is not None:
                self._stall(t0 - self._last_t, self._last_t, t0)
            self._last_t = t1
            self._add_device(Span(name, self.block, cause, t0, t1))

    def add_samples(self, n: int):
        if self.enabled:
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

    # ---- resolving device spans ----

    def _event(self):
        return (self._pool.pop() if self._pool
                else torch.cuda.Event(enable_timing=True))

    def _mark(self, t: float, name: str | None) -> None:
        self._mark_t.append(t)
        self._mark_name.append(name)

    def _poll(self, wait: bool = False) -> None:
        """Resolve up to ``RESOLVE_AT_ONCE`` pending spans whose end the
        device has passed, oldest first; with ``wait``, all of them."""
        if wait and self._pending:
            self._pending[-1].end.synchronize()
        n = len(self._pending) if wait else RESOLVE_AT_ONCE
        while n and self._pending and (wait or self._pending[0].end.query()):
            self._resolve(self._pending.popleft())
            n -= 1

    def _resolve(self, p: _Pending) -> None:
        ms = p.begin.elapsed_time(p.end)
        start = self._t_anchor + self._anchor.elapsed_time(p.begin) * 1e-3
        if p.stream != self._step_stream:
            self._pool.append(p.end)
        else:
            if self._last_end is not None:
                event, t_recorded = self._last_end
                self._stall(event.elapsed_time(p.begin) * 1e-3, t_recorded,
                            p.t_begin)
                self._pool.append(event)
            self._last_end = (p.end, p.t_end)
        self._pool.append(p.begin)
        self._add_device(Span(p.name, p.block, p.cause, start,
                              start + ms * 1e-3))

    def _add_device(self, s: Span) -> None:
        self.device_spans.append(s)
        if s.block >= 0:
            self._block_end[s.block] = max(
                self._block_end.get(s.block, s.end), s.end)

    def _stall(self, gap: float, t_prev: float, t_next: float) -> None:
        """Put the device's wait of ``gap`` seconds between two spans, whose
        events the host recorded at ``t_prev`` and ``t_next``, down to the
        host stages innermost in the last ``gap`` seconds of that interval
        (the device reaches an event no earlier than it is recorded)."""
        if gap <= 0:
            return
        lo = max(t_next - gap, t_prev)
        i = max(bisect.bisect_right(self._mark_t, lo) - 1, 0)
        share = defaultdict(float)
        while i < len(self._mark_t) and self._mark_t[i] < t_next:
            a = max(self._mark_t[i], lo)
            b = (min(self._mark_t[i + 1], t_next)
                 if i + 1 < len(self._mark_t) else t_next)
            share[self._mark_name[i] or OTHER] += max(b - a, 0.0)
            i += 1
        total = sum(share.values())
        if total <= 0:
            self.stall[OTHER] += gap
            return
        for name, t in share.items():
            self.stall[name] += gap * t / total

    # ---- the summary ----

    def summary(self) -> dict:
        """Every pending span resolved, then the run in numbers: the device
        type (on the CPU, device spans are host time), blocks, host and
        device ms by name, stall ms by host stage, the device
        counters' differences over the run, block latency percentiles."""
        if not self.enabled:
            return {}
        if self._cuda:
            self._poll(wait=True)
        now = launch_counts()
        blocks = self.block + 1
        device_ms = defaultdict(float)
        for s in self.device_spans:
            device_ms[s.name] += (s.end - s.start) * 1e3
        lat = [self._block_end[b] - t for b, t in enumerate(self._block_start)
               if b in self._block_end]
        latency = {}
        if lat:
            p50, p95 = np.percentile(lat, [50, 95])
            latency = {"p50": p50 * 1e3, "p95": p95 * 1e3,
                       "max": max(lat) * 1e3}
        return {
            "device": self._dev.type,
            "blocks": blocks,
            "host_ms": {k: v * 1e3 for k, v in self.totals.items()},
            "device_ms": dict(device_ms),
            "stall_ms": {k: v * 1e3 for k, v in self.stall.items()},
            "counters": {k: now[k] - self._counters.get(k, 0) for k in now},
            "latency_ms": latency,
        }

    def report(self):
        if not self.enabled:
            return
        s = self.summary()
        wall = time.perf_counter() - self.t_start
        out = self.stream
        print("run report:", file=out)
        for name in sorted(self.totals, key=self.totals.get, reverse=True):
            t = self.totals[name]
            n = self.counts[name]
            print(f"  {name:<16s} {t:8.3f} s  ({n} calls, "
                  f"{t / max(n, 1) * 1e3:7.2f} ms/call)", file=out)
        if self.samples:
            print(f"  input samples    {self.samples} "
                  f"({self.samples / wall / 1e6:.2f} Msamp/s wall)",
                  file=out)
        print(f"  total wall       {wall:8.3f} s", file=out)
        per = max(s["blocks"], 1)
        for name, ms in sorted(s["device_ms"].items(), key=lambda kv: -kv[1]):
            print(f"  device {name:<9s} {ms * 1e-3:8.3f} s  "
                  f"({ms / per:7.3f} ms a block)", file=out)
        for name, ms in sorted(s["stall_ms"].items(), key=lambda kv: -kv[1]):
            print(f"  stall {name:<10s} {ms * 1e-3:8.3f} s  "
                  f"({ms / per:7.3f} ms a block)", file=out)
        for name, n in s["counters"].items():
            print(f"  counter {name:<10s} {n:12d}  ({n / per:.3f} a block)",
                  file=out)
        if s["latency_ms"]:
            lat = s["latency_ms"]
            print(f"  block latency    p50 {lat['p50']:.3f} ms, p95 "
                  f"{lat['p95']:.3f} ms, max {lat['max']:.3f} ms", file=out)
        print("run report json: " + json.dumps(s), file=out, flush=True)


#: the report of a run that asked for none, for code outside a run's loop
DISABLED = RunReport(enabled=False)
