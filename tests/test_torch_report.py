"""The port's run report (``dspsr_tpu_torch/utils/report.py``): host stages
and device spans with their block and causing stage, the device's waits on
the host, block latency, the device counters and the ``run report json:``
line, through ``FoldPipeline.run`` and ``FilPipeline.run_writer`` on the
CPU; a report that is off records nothing.  The ``card`` test holds the
counters and the device spans against a ``torch.profiler`` trace of the
same blocks; it imports no JAX, so on the card: ``python -m pytest
--noconftest -p no:cacheprovider tests/test_torch_report.py -m card``."""

import contextlib
import gc
import io
import json
import re
import time
from collections import Counter
from typing import NamedTuple

import numpy as np
import pytest
import torch

from dspsr_tpu_torch import device as tdevice
from dspsr_tpu_torch.io.sources import Source
from dspsr_tpu_torch.models import load_to_fil, load_to_fold
from dspsr_tpu_torch.models.load_to_fil import FilConfig, FilPipeline
from dspsr_tpu_torch.models.load_to_fold import (
    MJD, FoldConfig, FoldPipeline, Observation, Signal)
from dspsr_tpu_torch.utils import report as treport
from dspsr_tpu_torch.utils.report import RunReport

#: a band small enough for the plain step on the CPU (portbench's TINY): 4
#: subbands of a 16 MHz real-sampled band, blocks of 4864 input samples
TINY_OBS = dict(nchan=1, npol=2, ndim=1, nbit=8, centre_frequency=1400.0,
                bandwidth=-16.0, rate=32e6, state=Signal.NYQUIST)
TINY_FOLD = dict(folding_period=0.000123, dispersion_measure=0.5, nchan=4,
                 nbin=16, block_parts=2, min_block_samples=4096,
                 subint_seconds=0.0005, npol_out=1, digitizer_stats=False)
TINY_FIL = dict(nchan=4, dispersion_measure=0.5, block_parts=2,
                min_block_samples=4096)
#: ``portbench/metrics/anchors_ms.py``'s pattern, and ``read``'s
STAGE_LINE = r"^\s*{}\s+([0-9.eE+-]+) s\s+\((\d+) calls,\s+[0-9.]+ ms/call\)$"


class PeriodicSource(Source):
    """8-bit dual-pol bytes of a stream that repeats every ``period``
    samples, read as views of one host buffer (pinned with ``pin``):
    ``fill(block, stride)`` sizes it once the pipeline's geometry is known,
    as ``portbench/ring.py`` does."""

    def __init__(self, ndat: int, seed: int = 7, **obs):
        o = dict(TINY_OBS, **obs)
        self.obs = Observation(
            **o, start_time=MJD.from_utc("2010-04-13-02:05:45")).replace(
                ndat=ndat)
        self.seed = seed
        self.data = None

    @property
    def total_samples(self) -> int:
        return self.obs.ndat

    def fill(self, block: int, stride: int, strides: int = 3,
             pin: bool = False) -> None:
        self.period = strides * stride
        n = 2 * (self.period + block - stride)
        rng = np.random.default_rng(self.seed)
        codes = rng.integers(96, 160, size=2 * self.period, dtype=np.uint8)
        buf = torch.empty(n, dtype=torch.uint8, pin_memory=pin)
        buf[:codes.size] = torch.from_numpy(codes)
        buf[codes.size:] = buf[:n - codes.size]
        self.data = buf.numpy()

    def read_samples(self, start: int, nsamp: int) -> np.ndarray:
        a = 2 * (start % self.period)
        return self.data[a:a + 2 * nsamp]


class Writer:
    """A search output that keeps the bytes of each block."""

    def __init__(self):
        self.blocks = []

    def write_block(self, arr):
        self.blocks.append(arr.copy())


def fold_pipe(report: bool, nblocks: int, device="cpu",
              distinct: bool = False, **kw) -> FoldPipeline:
    """TINY's fold over ``nblocks`` blocks; with ``distinct`` no two blocks
    hold the same bytes.  On a card the buffer is pinned."""
    src = PeriodicSource(1 << 40)
    pipe = FoldPipeline(src, FoldConfig(**TINY_FOLD, report=report, **kw),
                        device=device)
    src.fill(pipe.block_in_samples, pipe.stride_in_samples,
             strides=nblocks if distinct else 3, pin=device == "cuda")
    src.obs = src.obs.replace(ndat=(nblocks - 1) * pipe.stride_in_samples
                              + pipe.block_in_samples)
    return pipe


def fil_pipe(report: bool, nblocks: int) -> FilPipeline:
    src = PeriodicSource(1 << 40)
    pipe = FilPipeline(src, FilConfig(**TINY_FIL, report=report),
                       device="cpu")
    src.fill(pipe.block_in_samples, pipe.stride_in_samples)
    src.obs = src.obs.replace(ndat=(nblocks - 1) * pipe.stride_in_samples
                              + pipe.block_in_samples)
    return pipe


def json_line(text: str) -> dict:
    lines = [ln for ln in text.splitlines()
             if ln.startswith("run report json: ")]
    assert lines, text
    return json.loads(lines[-1][len("run report json: "):])


@pytest.fixture
def reports(monkeypatch):
    """Every ``RunReport`` the pipelines make, kept."""
    made = []

    class Kept(RunReport):
        def __init__(self, *a, **kw):
            super().__init__(*a, **kw)
            made.append(self)

    monkeypatch.setattr(load_to_fold, "RunReport", Kept)
    monkeypatch.setattr(load_to_fil, "RunReport", Kept)
    return made


# ---- RunReport alone ----


def test_spans_counters_and_json_line():
    out = io.StringIO()
    rep = RunReport(stream=out)
    for b in range(3):
        rep.begin_block()
        with rep.stage("read"):
            pass
        with rep.stage("enqueue"):
            with rep.device("h2d"):
                tdevice.host_to_device(np.zeros(100, np.uint8),
                                       torch.device("cpu"))
            with rep.stage("flush"), rep.device("d2h"):
                pass
            with rep.device("step"):
                tdevice.count_launch("megastep", 7)
    rep.report()
    s = json_line(out.getvalue())
    assert s["device"] == "cpu" and s["blocks"] == 3
    assert set(s["host_ms"]) == {"read", "enqueue", "flush"}
    assert set(s["device_ms"]) == {"h2d", "d2h", "step"}
    c = s["counters"]
    assert (c["megastep"], c["kernels"]) == (3, 21)
    assert (c["h2d_copies"], c["h2d_bytes"]) == (3, 300)
    assert set(s["latency_ms"]) == {"p50", "p95", "max"}
    assert 0 <= s["latency_ms"]["p50"] <= s["latency_ms"]["max"]
    # every span carries its block and the host stage open when it began
    causes = {"read": None, "enqueue": None, "flush": "enqueue",
              "h2d": "enqueue", "d2h": "flush", "step": "enqueue"}
    spans = rep.host_spans + rep.device_spans
    assert len(spans) == 3 * 6
    for sp in spans:
        assert sp.cause == causes[sp.name]
        assert 0 <= sp.block < 3 and sp.start <= sp.end
    assert sorted(sp.block for sp in rep.device_spans) == [0] * 3 + [1] * 3 \
        + [2] * 3
    text = out.getvalue()
    assert re.search(STAGE_LINE.format("read"), text, re.M)
    assert re.search(r"^  device step .* ms a block\)$", text, re.M)
    assert re.search(r"^  counter kernels +21 +\(7\.000 a block\)$", text,
                     re.M)


def test_stages_sit_on_the_profilers_clock():
    """Under ``torch.profiler`` each stage is a ``dspsr.<stage>`` span; with
    no profiler running, no ``record_function`` is opened."""
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU]) as prof:
        rep = RunReport(stream=io.StringIO())
        rep.begin_block()
        with rep.stage("read"), rep.device("h2d"):
            pass
    assert "dspsr.read" in {e.name for e in prof.events()}
    rep = RunReport(stream=io.StringIO())
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(torch.profiler, "record_function", _refuse)
        with rep.stage("read"):
            pass
    assert rep.counts["read"] == 1


def test_stall_is_put_down_to_the_stage_the_device_waited_on():
    rep = RunReport(stream=io.StringIO())
    rep.begin_block()
    with rep.device("step"):
        pass
    with rep.stage("anchors"):
        time.sleep(0.03)
    time.sleep(0.01)
    with rep.stage("enqueue"), rep.device("step"):
        pass
    s = rep.summary()["stall_ms"]
    assert s["anchors"] >= 25 and s["other"] >= 8
    assert s["anchors"] + s["other"] + s.get("enqueue", 0) \
        == pytest.approx(1e3 * (rep.device_spans[1].start
                                - rep.device_spans[0].end))


class FakeStream(NamedTuple):
    cuda_stream: int


class FakeCuda:
    """A device that reaches each event when it is recorded and reports it
    passed once ``passed`` is set (an event's ``synchronize`` sets it), with
    two streams: the step's, current by default, and a copy stream, current
    inside ``copy_stream()``.  ``made`` counts the events made."""

    def __init__(self):
        self.made = 0
        self.passed = True
        self.current = [FakeStream(1)]

    @contextlib.contextmanager
    def copy_stream(self):
        self.current.append(FakeStream(2))
        try:
            yield
        finally:
            self.current.pop()


class FakeEvent:
    def __init__(self, cuda: FakeCuda):
        cuda.made += 1
        self.cuda = cuda
        self.t = None

    def record(self, stream=None):
        self.t = time.perf_counter()

    def query(self):
        return self.cuda.passed

    def synchronize(self):
        self.cuda.passed = True

    def elapsed_time(self, other):
        return (other.t - self.t) * 1e3


@pytest.fixture
def fake_cuda(monkeypatch):
    # the fake device's time is the host's: a full collection of what
    # earlier tests left (a profiler's events) would land in a span
    gc.collect()
    cuda = FakeCuda()
    monkeypatch.setattr(torch.cuda, "Event",
                        lambda enable_timing=False: FakeEvent(cuda))
    monkeypatch.setattr(torch.cuda, "current_stream",
                        lambda device=None: cuda.current[-1])
    monkeypatch.setattr(torch.cuda, "synchronize", lambda device=None: None)
    return cuda


def event_loop(rep, nblocks, sleep=0.0):
    for _ in range(nblocks):
        rep.begin_block()
        with rep.stage("read"):
            pass
        with rep.stage("anchors"):
            time.sleep(sleep)
        with rep.stage("enqueue"):
            with rep.device("h2d"):
                pass
            with rep.device("step"):
                pass


def test_event_spans_reuse_a_pool_and_put_waits_on_stages(fake_cuda):
    """CUDA-event spans: resolved as the device passes them, from a pool of
    a few events, on the host clock through the anchor; the device's wait
    while the host computed anchors is put down to ``anchors``."""
    rep = RunReport(stream=io.StringIO(), device="cuda")
    event_loop(rep, 40, sleep=0.002)
    assert fake_cuda.made <= 5
    assert len(rep.device_spans) == 80 and not rep._pending
    s = rep.summary()
    assert s["device"] == "cuda" and s["blocks"] == 40
    assert s["stall_ms"]["anchors"] >= 39 * 2 * 0.9
    assert s["stall_ms"]["anchors"] >= 0.9 * sum(s["stall_ms"].values())
    spans = rep.device_spans
    assert all(a.end <= b.start for a, b in zip(spans, spans[1:]))
    assert [sp.block for sp in spans] == [b for b in range(40) for _ in "hs"]
    assert 0 < s["latency_ms"]["p50"] <= s["latency_ms"]["max"] < 1e3


def test_event_spans_wait_for_nothing_until_the_end(fake_cuda):
    """A device that has not passed the events: nothing is resolved while
    the loop runs; once it has, a few at each span's close, and every span
    at the summary's one wait."""
    fake_cuda.passed = False
    rep = RunReport(stream=io.StringIO(), device="cuda")
    event_loop(rep, 3)
    assert rep.device_spans == [] and len(rep._pending) == 6
    fake_cuda.passed = True
    with rep.device("step"):
        pass
    assert len(rep.device_spans) == treport.RESOLVE_AT_ONCE
    s = rep.summary()
    assert len(rep.device_spans) == 7 and set(s["device_ms"]) == {"h2d",
                                                                "step"}


def test_copy_stream_spans_give_device_time_but_no_stall(fake_cuda):
    """The fold's staging on a card: each block's ``h2d`` span on a copy
    stream, then ``h2d_wait`` and ``step`` on the step's stream.  Every span
    is resolved and summed as device time; the stall comes from the gaps on
    the step's stream alone, put down to the host stages open in them (the
    anchors, and the enqueue of the copies), and not from the copy stream's
    gaps, which are waits on the device."""
    nblocks = 20
    rep = RunReport(stream=io.StringIO(), device="cuda")
    for _ in range(nblocks):
        rep.begin_block()
        with rep.stage("anchors"):
            time.sleep(0.002)
        with rep.stage("enqueue"):
            with fake_cuda.copy_stream(), rep.device("h2d"):
                time.sleep(0.001)
            with rep.device("h2d_wait"):
                time.sleep(0.0005)
            with rep.device("step"):
                time.sleep(0.001)
    assert fake_cuda.made <= 8
    s = rep.summary()
    spans = rep.device_spans
    assert [sp.name for sp in spans] == ["h2d", "h2d_wait", "step"] * nblocks
    for name, ms in (("h2d", 1.0), ("h2d_wait", 0.5), ("step", 1.0)):
        mine = [sp for sp in spans if sp.name == name]
        assert [sp.block for sp in mine] == list(range(nblocks))
        assert s["device_ms"][name] == pytest.approx(
            1e3 * sum(sp.end - sp.start for sp in mine))
        assert s["device_ms"][name] >= 0.9 * nblocks * ms
    step_side = [sp for sp in spans if sp.name != "h2d"]
    gaps = sum(b.start - a.end for a, b in zip(step_side, step_side[1:]))
    assert sum(s["stall_ms"].values()) == pytest.approx(1e3 * gaps)
    assert s["stall_ms"]["anchors"] >= 0.9 * (nblocks - 1) * 2
    assert s["stall_ms"]["enqueue"] >= 0.9 * (nblocks - 1) * 1


def test_an_off_report_records_nothing():
    rep = RunReport(enabled=False)
    assert rep.stage("read") is rep.device("h2d") is rep.stage("write")
    rep.begin_block()
    with rep.stage("read"), rep.device("step"):
        pass
    rep.add_samples(10)
    assert (rep.block, rep.samples, rep.host_spans, rep.device_spans) \
        == (-1, 0, [], [])
    assert not rep.totals and rep.summary() == {}


def _refuse(*a, **kw):
    raise AssertionError("called with the report off")


def test_off_pipelines_open_no_span_event_or_sync(monkeypatch, capsys):
    """With ``report=False``, ``FoldPipeline.run`` and ``FilPipeline.
    run_writer`` open no ``record_function``, make no CUDA event and add
    no synchronise, and print no report."""
    monkeypatch.setattr(torch.profiler, "record_function", _refuse)
    monkeypatch.setattr(torch.cuda, "Event", _refuse)
    monkeypatch.setattr(torch.cuda, "synchronize", _refuse)
    res = fold_pipe(False, 4).run()
    assert res.hits.sum() > 0
    w = Writer()
    fil_pipe(False, 3).run_writer(w)
    assert len(w.blocks) == 3
    assert "run report" not in capsys.readouterr().err


def test_fold_report(reports, capsys):
    """Each host stage once a block, the step once a block and once more at
    a block that a sub-integration's boundary splits, a ``d2h`` span a
    flush; the old lines as ``anchors_ms`` reads them."""
    nblocks = 5
    pipe = fold_pipe(True, nblocks)
    res = pipe.run()
    err = capsys.readouterr().err
    (rep,) = reports
    for name in ("read", "anchors", "enqueue"):
        m = re.search(STAGE_LINE.format(name), err, re.M)
        assert m and int(m.group(2)) == nblocks == rep.counts[name], err
    assert "device_step" not in err
    s = json_line(err)
    assert s["blocks"] == nblocks
    assert s["counters"]["h2d_copies"] == 3 * nblocks
    assert s["counters"]["h2d_bytes"] == nblocks * (
        2 * pipe.block_in_samples + 2 * 4 * pipe.npart)
    assert s["counters"]["h2d_staged"] == 0  # no copy stream on the CPU
    names = [sp.name for sp in rep.device_spans]
    nsub = len(res.profiles)
    assert names.count("h2d") == nblocks
    assert names.count("d2h") == rep.counts["flush"] == nsub
    # a flush between two steps splits one block's step in two
    assert nblocks <= names.count("step") <= nblocks + nsub - 1
    for sp in rep.device_spans:
        assert sp.cause == ("flush" if sp.name == "d2h" else "enqueue")
    assert [sp.block for sp in rep.device_spans if sp.name == "h2d"] \
        == list(range(nblocks))
    assert set(s["stall_ms"]) <= {"read", "anchors", "enqueue", "flush",
                                  "other"}


def test_fil_report(reports, capsys):
    nblocks = 3
    pipe = fil_pipe(True, nblocks)
    w = Writer()
    pipe.run_writer(w)
    err = capsys.readouterr().err
    (rep,) = reports
    for name in ("read", "enqueue", "write"):
        m = re.search(STAGE_LINE.format(name), err, re.M)
        assert m and int(m.group(2)) == nblocks, err
    s = json_line(err)
    assert s["blocks"] == nblocks and set(s["device_ms"]) == {
        "h2d", "step", "d2h"}
    assert s["counters"]["h2d_bytes"] == nblocks * 2 * pipe.block_in_samples
    cause = {"h2d": "enqueue", "step": "enqueue", "d2h": "write"}
    got = [(sp.block, sp.name, sp.cause) for sp in rep.device_spans]
    assert got == [(b, n, cause[n]) for b in range(nblocks)
                   for n in ("h2d", "step", "d2h")]


def test_fil_report_matches_its_output_off():
    """The report changes nothing of what the search writes."""
    a, b = Writer(), Writer()
    fil_pipe(False, 3).run_writer(a)
    fil_pipe(True, 3).run_writer(b)
    assert all(np.array_equal(x, y) for x, y in zip(a.blocks, b.blocks))


# ---- on the card ----


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("no CUDA card: torch.cuda.is_available() is False")


def warmed(fn):
    """``fn()`` after a spin of a few milliseconds on the card: the kernels
    a trace's first moments would miss are the spin's."""
    torch.cuda._sleep(10_000_000)
    torch.cuda.synchronize()
    return fn()


def j1713_pipe(report: bool) -> FoldPipeline:
    """J1713's fold (``portbench``'s ``fold.j1713``: 64 subbands of 400 MHz
    at 800 Msamp/s, DM 15.99, 68 MB blocks) on the card, from a pinned
    buffer."""
    src = PeriodicSource(1 << 50, rate=800e6, bandwidth=-400.0,
                         centre_frequency=1382.0)
    cfg = FoldConfig(folding_period=0.00457014, dispersion_measure=15.99,
                     nchan=64, nbin=1024, block_parts=8, npol_out=1,
                     min_block_samples=1 << 25, subint_seconds=10,
                     digitizer_stats=False, report=report)
    pipe = FoldPipeline(src, cfg, device="cuda")
    assert pipe.mega_mode == "full"
    src.fill(pipe.block_in_samples, pipe.stride_in_samples, pin=True)
    return pipe


def staged_blocks(fn) -> int:
    """The blocks whose copies went through the copy stream in ``fn()``."""
    before = tdevice.launch_counts()["h2d_staged"]
    fn()
    return tdevice.launch_counts()["h2d_staged"] - before


@pytest.mark.card
@pytest.mark.parametrize("kw", [{}, {"use_megakernel": False}],
                         ids=["full", "general"])
def test_staged_fold_matches_the_cpu(card, kw):
    """TINY's fold on the card over 9 blocks that all differ, from a pinned
    buffer, with sub-integrations that end mid-block: every block's copies
    go through the copy stream's two slots, and the profiles and hits are
    the CPU's (kernel against plain: 1e-4 of the largest, hits exact).  A
    slot written before its last step had read it would show here."""
    nblocks = 9
    pipe = fold_pipe(False, nblocks, device="cuda", distinct=True, **kw)
    assert pipe.mega_mode == ("full" if not kw else None)
    got = []
    assert staged_blocks(lambda: got.append(pipe.run())) == nblocks
    want = fold_pipe(False, nblocks, distinct=True, **kw).run()
    (got,) = got
    assert got.profiles.shape == want.profiles.shape
    assert len(want.profiles) > 1
    assert np.array_equal(got.hits, want.hits)
    err = np.abs(got.profiles - want.profiles).max() \
        / np.abs(want.profiles).max()
    assert err < 1e-4, err


@pytest.mark.card
def test_copies_overlap_the_step_in_two_slots(card):
    """J1713's fold: in a trace, a block's HtoD copy runs while a ``mega``
    kernel does, and the memory allocated over 8 blocks exceeds that over 2
    by less than one block's bytes: the copy stream holds two slots however
    far ahead the host runs."""
    from portbench.trace import capture, short_name

    pipe = j1713_pipe(report=False)
    block = 2 * pipe.block_in_samples
    pipe.run(max_blocks=2)  # builds and warms every kernel
    peak = {}
    for n in (2, 8):
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        assert staged_blocks(lambda: pipe.run(max_blocks=n)) == n
        peak[n] = torch.cuda.max_memory_allocated()
    assert peak[8] - peak[2] < block, peak
    _, tr = capture(lambda: warmed(lambda: pipe.run(max_blocks=8)))
    mega = [e for e in tr.kernels() if short_name(e.name).startswith("mega")]
    h2d = [e for e in tr.copies("HtoD") if e.nbytes == block]
    assert len(h2d) == 8 and mega
    assert any(c.ts < k.end and k.ts < c.end for c in h2d for k in mega)


@pytest.mark.card
def test_counters_and_spans_agree_with_the_trace(card, capsys):
    """J1713's fold (``portbench``'s ``fold.j1713``: 64 subbands of 400
    MHz at 800 Msamp/s, DM 15.99, 68 MB blocks) from a pinned buffer with
    the report on, traced as ``portbench`` traces a window: the ``kernels``
    counter equals the trace's ``mega`` kernels, ``h2d_bytes`` its HtoD
    bytes, the ``step`` spans hold at least the ``mega`` kernels' time and
    the ``h2d`` spans the copies'."""
    from portbench.trace import capture, short_name

    nblocks = 6
    pipe = j1713_pipe(report=True)
    pipe.run(max_blocks=2)  # builds and warms every kernel
    capsys.readouterr()
    _, tr = capture(lambda: warmed(lambda: pipe.run(max_blocks=nblocks)))
    s = json_line(capsys.readouterr().err)
    mega = [e for e in tr.kernels() if short_name(e.name).startswith("mega")]
    assert s["counters"]["kernels"] == len(mega) > 0
    h2d = tr.copies("HtoD")
    assert s["counters"]["h2d_copies"] == len(h2d) == 3 * nblocks
    assert s["counters"]["h2d_bytes"] == sum(e.nbytes for e in h2d) \
        == nblocks * (2 * pipe.block_in_samples + 8 * pipe.npart)
    assert s["device_ms"]["step"] >= 0.99e-3 * sum(e.dur for e in mega)
    assert s["device_ms"]["h2d"] >= 0.97e-3 * sum(e.dur for e in h2d)
    assert s["blocks"] == nblocks and s["latency_ms"]["p50"] > 0
    assert s["counters"]["h2d_staged"] == nblocks
    assert 0 <= s["device_ms"]["h2d_wait"] <= s["device_ms"]["h2d"]


@pytest.mark.card
def test_search_counters_agree_with_the_trace(card, capsys):
    """The search at J1713 (``digifil -F 64:D``, the fused front end):
    ``kernels`` is each ``megafil`` call's kernels, as many as the trace
    shows kinds of ``mega`` kernel, and ``h2d_bytes`` the blocks' bytes.
    (The profiler's trace of so short a window has missed one or two of
    its 20 kernel records in some runs, so the count is held against the
    kinds it shows, not its records.)"""
    from portbench.trace import capture, short_name

    nblocks = 4
    src = PeriodicSource(1 << 50, rate=800e6, bandwidth=-400.0,
                         centre_frequency=1382.0)
    cfg = FilConfig(nchan=64, dispersion_measure=15.99, block_parts=8,
                    min_block_samples=1 << 25, report=True)
    pipe = FilPipeline(src, cfg, device="cuda")
    assert pipe.megafil_plan is not None
    src.fill(pipe.block_in_samples, pipe.stride_in_samples, pin=True)
    w = Writer()
    pipe.run_writer(w, max_blocks=2)  # builds and warms every kernel
    capsys.readouterr()
    _, tr = capture(lambda: warmed(lambda: pipe.run_writer(
        w, max_blocks=nblocks)))
    s = json_line(capsys.readouterr().err)
    kinds = Counter(short_name(e.name) for e in tr.kernels()
                    if short_name(e.name).startswith("mega"))
    c = s["counters"]
    assert c["megafil"] == nblocks and c["kernels"] == nblocks * len(kinds) \
        >= sum(kinds.values()), (c, kinds)
    assert c["h2d_bytes"] == nblocks * 2 * pipe.block_in_samples
    assert s["device_ms"]["d2h"] > 0 and s["blocks"] == nblocks
