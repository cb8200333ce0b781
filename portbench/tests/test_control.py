"""The control: the plain reference's filterbank computed in bfloat16, the
next precision below the configuration's float32, and folded exactly, put
in the program's place, has to fail the output comparison; the program
itself passes it.  At the
small CPU size of ``conftest.TINY``; on the card ``python3 -m
portbench.limits`` reads the same at each cell's own size."""

from portbench.limits import readings, summary
from portbench.tests.conftest import tiny_cell


def test_control_fails_and_program_passes():
    cell = tiny_cell()
    limits = cell.limits["limits"]
    recs = [readings(cell, seed, 0.05, control=True, device="cpu")
            for seed in (7, 2**31 + 5)]
    got = summary(recs)
    for rec in recs:
        prog, ctrl = rec["program"], rec["control"]
        assert all(prog[k] <= limits[k] for k in limits), prog
        assert any(ctrl[k] > limits[k] for k in limits), ctrl
    for k, v in got.items():
        assert v["lower"] <= limits[k]
