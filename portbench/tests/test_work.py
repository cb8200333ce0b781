"""The frozen work count gives ``chip_smoke.py``'s numbers at the fold cells'
plans, and does not move when the plan's pass split does."""

import dataclasses
import json
import math
import os

import pytest

from portbench.reference.geometry import geometry
from portbench.tests.conftest import file_cell, program_pipe
from portbench.work import F32_OPS_S, HBM_BYTES_S, bound_ms, fold_bytes, \
    front_ops

CELLS = ["fold.j0613", "fold.j1713"]


def _cell(name):
    return file_cell(name)


@pytest.fixture(scope="module")
def smoke():
    import chip_smoke

    return chip_smoke


@pytest.mark.parametrize("name", CELLS)
def test_same_numbers_as_chip_smoke(name, smoke):
    cell = _cell(name)
    pipe = program_pipe(cell)
    plan = pipe.mega_plan
    g = geometry(cell.config, cell.traffic["dm"], cell.config["nbin"])
    assert front_ops(g) == smoke.front_ops(plan, pipe.npart, 2, 2)
    raw = pipe.block_in_samples * 2
    chirp = 8 * pipe.constants.gr.numel()
    acc = plan.nplane * plan.nsub * plan.nbin + plan.nbin
    want = raw + chirp + 8 * acc + 8 * pipe.npart
    assert fold_bytes(g) == want
    ms, by = bound_ms(want, front_ops(g))
    assert (ms, by) == (smoke.bound_of(want, front_ops(g))["bound_ms"],
                        smoke.bound_of(want, front_ops(g))["bound_by"])
    assert (HBM_BYTES_S, F32_OPS_S) == (smoke.HBM_BYTES_S, smoke.F32_OPS_S)


@pytest.mark.parametrize("name", CELLS)
def test_pass_split_does_not_move_the_count(name, smoke):
    cell = _cell(name)
    g = geometry(cell.config, cell.traffic["dm"], cell.config["nbin"])
    pipe = program_pipe(cell)
    plan = pipe.mega_plan
    for r1 in (64, 256, plan.R1 // 2):
        other = dataclasses.replace(g, R1=r1)
        assert front_ops(other) == front_ops(g)
        assert fold_bytes(other) == fold_bytes(g)
        split = dataclasses.replace(plan, R1=r1)
        assert split.R2 != plan.R2
        assert smoke.front_ops(split, pipe.npart, 2, 2) == front_ops(g)


def test_operations_bound_the_dm_steps():
    """At both DMs the step is bound by its operations, about 0.45 and
    0.11 ms (PERF.md's kernel table)."""
    for name, want in (("fold.j0613", 0.446), ("fold.j1713", 0.114)):
        cell = _cell(name)
        g = geometry(cell.config, cell.traffic["dm"], 1024)
        ms, by = bound_ms(fold_bytes(g), front_ops(g))
        assert by == "operations" and math.isclose(ms, want, rel_tol=0.01)
