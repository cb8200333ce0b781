"""Each per-layer metric's reader on a synthetic profiler trace."""

import pytest

from portbench.run import Context
from portbench.spec import reader
from portbench.trace import idle_by_host, parse, short_name, top_device_ops


def _x(name, cat, ts, dur, **args):
    return {"ph": "X", "name": name, "cat": cat, "ts": ts, "dur": dur,
            "args": args}


def synthetic():
    """Two blocks in a 100 us window: each an HtoD copy of 1 MB in 10 us,
    two ``mega`` kernels of 5 and 15 us, a plain kernel of 4 us, a DtoH
    copy of 6 us; the device idle between them."""
    ev = [_x("portbench.window", "user_annotation", 0, 100),
          _x("PyTorch Profiler (0)", "Trace", 0, 100)]
    for b, t in enumerate((0, 50)):
        ev += [
            _x("Memcpy HtoD (Pinned -> Device)", "gpu_memcpy", t, 10,
               bytes=1_000_000),
            _x("void (anonymous namespace)::mega_fwd1<1, 0>(float*)",
               "kernel", t + 10, 5),
            _x("(anonymous namespace)::mega_rowpair(float2 const*)",
               "kernel", t + 15, 15),
            _x("void at::native::reduce_kernel<512, 1>(int)", "kernel",
               t + 30, 4),
            _x("Memcpy DtoH (Device -> Pageable)", "gpu_memcpy", t + 34, 6),
            _x("portbench.read", "user_annotation", t + 41, 5),
        ]
    ev.append({"ph": "s", "name": "flow", "ts": 3})
    return parse({"traceEvents": ev})


def ctx(report=""):
    return Context(trace=synthetic(), blocks=2, report=report, bound_ms=0.002)


def test_parse_and_busy():
    tr = synthetic()
    assert (tr.t0, tr.t1) == (0, 100)
    assert len(tr.device) == 10 and tr.window_s == pytest.approx(1e-4)
    assert tr.busy_s() == pytest.approx(80e-6)
    assert tr.gaps() == [(40, 50), (90, 100)]


def test_step_ms():
    assert reader("step_ms")(ctx()) == pytest.approx(0.020)


def test_step_roofline():
    assert reader("step_roofline")(ctx()) == pytest.approx(10.0)


def test_h2d_gbps():
    assert reader("h2d_gbps")(ctx()) == pytest.approx(100.0)


def test_device_idle_pct():
    assert reader("device_idle_pct")(ctx()) == pytest.approx(20.0)


def test_anchors_ms():
    report = ("run report:\n  device_step         0.500 s  (2 calls, "
              "250.00 ms/call)\n  anchors             0.004 s  (2 calls,"
              "    2.00 ms/call)\n")
    assert reader("anchors_ms")(ctx(report)) == pytest.approx(2.0)


@pytest.mark.parametrize("name", ["anchors_ms", "h2d_gbps", "step_ms",
                                  "step_roofline", "device_idle_pct"])
def test_nothing_to_read_gives_none(name):
    empty = parse({"traceEvents": [
        _x("portbench.window", "user_annotation", 0, 100)]})
    c = Context(trace=empty, blocks=2, report="", bound_ms=1.0)
    got = reader(name)(c)
    # an empty device is wholly idle; every other reader finds nothing
    assert got == (100.0 if name == "device_idle_pct" else None)


def test_breakdown():
    tr = synthetic()
    ops = dict(top_device_ops(tr))
    assert ops["Memcpy HtoD (Pinned -> Device)"] == pytest.approx(20e-6)
    assert ops["mega_rowpair"] == pytest.approx(30e-6)
    # both gaps fall while the host reads the ring
    assert idle_by_host(tr) == [["portbench.read x2", pytest.approx(20e-6)]]


def test_short_name():
    assert short_name("void (anonymous namespace)::mega_fwd1<1>(int)") \
        == "mega_fwd1"
    assert short_name("void at::native::reduce_kernel<512>(int)") \
        == "at::native::reduce_kernel"
