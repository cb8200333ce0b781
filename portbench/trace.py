"""The traced window: ``torch.profiler`` over the timed call, read back as
plain events from its Chrome trace.

Device events are the kernels, copies and sets the profiler recorded
(``cat`` ``kernel``, ``gpu_memcpy``, ``gpu_memset``); host events are the
rest (operators, runtime calls, and the benchmark's own spans:
``portbench.window`` around the timed call, ``portbench.read`` around each
read of the ring).  Times are microseconds on the profiler's clock.
"""

from __future__ import annotations

import bisect
import json
import os
import re
import tempfile
from dataclasses import dataclass, field

DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
WINDOW = "portbench.window"


@dataclass
class Event:
    name: str
    cat: str
    ts: float  # start, us
    dur: float  # us
    nbytes: int = 0

    @property
    def end(self) -> float:
        return self.ts + self.dur


@dataclass
class Trace:
    device: list = field(default_factory=list)
    host: list = field(default_factory=list)
    #: the timed call's span (us)
    t0: float = 0.0
    t1: float = 0.0

    @property
    def window_s(self) -> float:
        return (self.t1 - self.t0) * 1e-6

    def kernels(self):
        return [e for e in self.device if e.cat == "kernel"]

    def copies(self, direction: str):
        """Copies whose name carries ``direction`` (``HtoD``, ``DtoH``)."""
        return [e for e in self.device
                if e.cat == "gpu_memcpy" and direction in e.name]

    def busy(self) -> list:
        """The union of device events within the window, as sorted
        ``[start, end]`` intervals."""
        spans = sorted((max(e.ts, self.t0), min(e.end, self.t1))
                       for e in self.device)
        out = []
        for a, b in spans:
            if b <= a:
                continue
            if out and a <= out[-1][1]:
                out[-1][1] = max(out[-1][1], b)
            else:
                out.append([a, b])
        return out

    def busy_s(self) -> float:
        return sum(b - a for a, b in self.busy()) * 1e-6

    def gaps(self) -> list:
        """Idle intervals of the device within the window."""
        edges, t = [], self.t0
        for a, b in self.busy():
            if a > t:
                edges.append((t, a))
            t = max(t, b)
        if self.t1 > t:
            edges.append((t, self.t1))
        return edges


def parse(doc: dict) -> Trace:
    """A Chrome trace (``export_chrome_trace``'s JSON) as a ``Trace``."""
    tr = Trace()
    for ev in doc.get("traceEvents", []):
        if ev.get("ph") != "X":
            continue
        e = Event(name=str(ev.get("name", "")), cat=str(ev.get("cat", "")),
                  ts=float(ev.get("ts", 0.0)), dur=float(ev.get("dur", 0.0)))
        args = ev.get("args") or {}
        if e.cat in DEVICE_CATS:
            e.nbytes = int(args.get("bytes", 0) or 0)
            tr.device.append(e)
        elif e.cat != "Trace":
            tr.host.append(e)
            if e.name == WINDOW and e.cat == "user_annotation":
                tr.t0, tr.t1 = e.ts, e.end
    if tr.t1 <= tr.t0:
        raise ValueError(f"the trace has no {WINDOW} span")
    return tr


def capture(fn):
    """``(fn()'s result, Trace)``: ``fn`` run under the profiler, CPU and
    CUDA activity, inside a ``portbench.window`` span."""
    import torch
    from torch.profiler import ProfilerActivity, profile, record_function

    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        with record_function(WINDOW):
            out = fn()
            if torch.cuda.is_available():
                torch.cuda.synchronize()
    fd, path = tempfile.mkstemp(suffix=".json")
    os.close(fd)
    try:
        prof.export_chrome_trace(path)
        with open(path) as f:
            doc = json.load(f)
    finally:
        os.unlink(path)
    return out, parse(doc)


_NAME = re.compile(r"[\w:]+")


def short_name(name: str) -> str:
    """A kernel's name without its return type, anonymous namespace,
    template arguments and parameters (``void (anonymous
    namespace)::mega_fwd1<1, 0>(...)`` -> ``mega_fwd1``)."""
    s = name[5:] if name.startswith("void ") else name
    s = s.replace("(anonymous namespace)::", "")
    m = _NAME.match(s)
    return (m.group(0) if m else s)[:120]


def top_device_ops(tr: Trace, n: int = 10) -> list:
    """The ``n`` device operations that took most time: ``[name,
    seconds]``."""
    total: dict = {}
    for e in tr.device:
        key = short_name(e.name) if e.cat == "kernel" else e.name[:120]
        total[key] = total.get(key, 0.0) + e.dur * 1e-6
    return [[k, v] for k, v in
            sorted(total.items(), key=lambda kv: -kv[1])[:n]]


def idle_by_host(tr: Trace, n: int = 10, reach: int = 5000) -> list:
    """The device's idle time within the window by what the host was doing
    at the middle of each gap (the innermost host event then, found among
    the ``reach`` host events that started last before it, or ``host
    idle``): ``[label, seconds]`` for the ``n`` largest labels, each label
    with its count of gaps."""
    host = sorted((e for e in tr.host if e.name != WINDOW),
                  key=lambda e: e.ts)
    starts = [e.ts for e in host]
    total: dict = {}
    count: dict = {}
    for a, b in tr.gaps():
        mid = 0.5 * (a + b)
        label = "host idle"
        i = bisect.bisect_right(starts, mid)
        for e in reversed(host[max(0, i - reach):i]):
            if e.end >= mid:
                label = e.name[:100]
                break
        total[label] = total.get(label, 0.0) + (b - a) * 1e-6
        count[label] = count.get(label, 0) + 1
    top = sorted(total.items(), key=lambda kv: -kv[1])[:n]
    return [[f"{k} x{count[k]}", v] for k, v in top]
