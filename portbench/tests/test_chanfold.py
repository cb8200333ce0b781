"""The cell ``fold.ska1_band2.j0613`` (channelised complex input, driver
``chanfold``): found by its files, its two metrics read right and read
nothing where there is nothing, and a step that mixes up channels or
subbands comes out ``correct: false`` (on the CPU at ``chancell.
TINY_CHAN``)."""

import pytest

from portbench.run import Context, run_cell
from portbench.spec import load_cell, reader
from portbench.tests.chancell import tiny_chan_cell
from portbench.tests.conftest import ROOT
from portbench.tests.test_program_metrics import ctx, report
from portbench.trace import parse

CELL = "fold.ska1_band2.j0613"


def test_the_cell_is_found_and_loads():
    cell = load_cell(CELL, ROOT)
    assert cell.config["driver"] == "chanfold"
    assert cell.driver.__name__ == "portbench.drivers.chanfold"
    assert (cell.config["nchan_in"], cell.config["nchan"]) == (81, 1296)
    assert cell.traffic["pulsar"] == "J0613-0200"
    assert set(cell.limits["limits"]) == {"subints_diff", "hits_diff",
                                          "profile_err"}
    assert [m["name"] for m in cell.per_layer] == [
        "h2d_gbps", "step_ms", "step_roofline", "device_idle_pct",
        "ftp_span_ms", "ftp_roofline"]
    assert [m["name"] for m in cell.end_to_end] == ["realtime_x", "setup_s"]


def test_ftp_span_ms_reads_the_span_over_the_blocks():
    text = report(device_ms={"h2d": 20.0, "ftp": 2.0, "step": 19.6})
    assert reader("ftp_span_ms")(ctx(text)) == pytest.approx(0.5)


@pytest.mark.parametrize("text, blocks", [
    ("", 4), (report(), 4),
    (report(device="cpu", device_ms={"ftp": 2.0}), 4),
    (report(device_ms={"ftp": 2.0}), 0)],
    ids=["empty", "no_span", "cpu", "no_blocks"])
def test_ftp_span_ms_reads_nothing(text, blocks):
    assert reader("ftp_span_ms")(ctx(text, blocks)) is None


def _x(name, cat, ts, dur, **args):
    return {"ph": "X", "name": name, "cat": cat, "ts": ts, "dur": dur,
            "args": args}


def _trace(ftp=True):
    """Two blocks in a 100 us window: each an HtoD copy of 2 MB, the
    pre-pass for 5 us (where ``ftp``) and another ``mega`` kernel."""
    ev = [_x("portbench.window", "user_annotation", 0, 100)]
    for t in (0, 50):
        ev.append(_x("Memcpy HtoD (Pinned -> Device)", "gpu_memcpy", t, 20,
                     bytes=2_000_000))
        if ftp:
            ev.append(_x("void (anonymous namespace)::mega_ftp<4>(unsigned "
                         "char const*, unsigned char*, long long, int)",
                         "kernel", t + 20, 5))
        ev.append(_x("void (anonymous namespace)::mega_fwd1<16, 2, 0>(int)",
                     "kernel", t + 25, 10))
    return parse({"traceEvents": ev})


def test_ftp_roofline_reads_the_block_twice_over_the_kernel():
    c = Context(trace=_trace(), blocks=2, report="", bound_ms=1.0)
    # 2 x 4 MB at 3.35 TB/s over 10 us
    assert reader("ftp_roofline")(c) == pytest.approx(
        100 * 8e6 / 3.35e12 / 10e-6)


def test_ftp_roofline_reads_nothing_without_the_kernel():
    for tr, blocks in ((_trace(ftp=False), 2), (_trace(), 0)):
        c = Context(trace=tr, blocks=blocks, report="", bound_ms=1.0)
        assert reader("ftp_roofline")(c) is None


def _swap_channels(pipe):
    step, nci = pipe._megastep, pipe.obs_in.nchan
    unit = pipe.obs_in.npol * pipe.obs_in.ndim

    def swapped(profiles, hits, raw, *args, **kw):
        # input channels 0 and 1 of every time sample exchanged
        x = raw.reshape(-1, nci, unit).clone()
        x[:, [0, 1]] = x[:, [1, 0]]
        return step(profiles, hits, x.reshape(-1), *args, **kw)
    pipe._megastep = swapped


def _subbands_reversed(pipe):
    step = pipe._megastep

    def reversed_(profiles, hits, *args, **kw):
        # channel 0's subbands folded in the wrong order this step
        p, h = step(profiles, hits, *args, **kw)
        p = p.clone()
        p[0] = profiles[0] + (p[0] - profiles[0]).flip(1)
        return p, h
    pipe._megastep = reversed_


FAULTS = [_swap_channels, _subbands_reversed]


@pytest.mark.parametrize("fault", FAULTS,
                         ids=[f.__name__.strip("_") for f in FAULTS])
def test_fault_is_not_correct(fault):
    res = run_cell(tiny_chan_cell(), 2**31 + 99, 0.05, False, device="cpu",
                   prepare=lambda drv: fault(drv.pipe))
    assert res["correct"] is False, res["checks"]


def test_sound_run_is_correct():
    res = run_cell(tiny_chan_cell(), 2**31 + 99, 0.05, False, device="cpu")
    assert res["correct"] is True, res["checks"]
    assert res["checks"]["profile_err"]["value"] > 0


def test_the_reference_and_work_count_load_nothing_of_the_program():
    import subprocess
    import sys

    code = ("import sys\n"
            "import portbench.reference.channelised, portbench.chanwork\n"
            "print(sorted(n for n in sys.modules if n.split('.')[0] in"
            " ('dspsr_tpu_torch', 'dspsr_tpu', 'jax')))\n")
    p = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                       capture_output=True, text=True, timeout=300)
    assert p.returncode == 0, p.stderr
    assert p.stdout.strip().splitlines()[-1] == "[]"
