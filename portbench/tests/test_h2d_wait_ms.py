"""``h2d_wait_ms``'s reader on a synthetic run report: the step's waits for
its copies over the blocks, and nothing from a report of the CPU or of a
program without the span."""

import pytest

from portbench.spec import reader
from portbench.tests.test_program_metrics import ctx, report

WITH_WAIT = {"h2d": 20.0, "h2d_wait": 1.2, "step": 19.6, "d2h": 0.3}


def test_reads_the_waits_over_the_blocks():
    assert reader("h2d_wait_ms")(ctx(report(device_ms=WITH_WAIT))) \
        == pytest.approx(0.3)


@pytest.mark.parametrize("text, blocks", [
    ("", 4), (report(), 4), (report(device="cpu", device_ms=WITH_WAIT), 4),
    (report(device_ms=WITH_WAIT), 0)],
    ids=["empty", "no_span", "cpu", "no_blocks"])
def test_nothing_to_read_gives_none(text, blocks):
    assert reader("h2d_wait_ms")(ctx(text, blocks)) is None
