"""A run with the timed path broken underneath comes out ``correct: false``.

Each test drives the rest of a run (``portbench.run.run_cell``, past the
look for a card, on the CPU at ``conftest.TINY``) with one fault planted in
the pipeline once set-up has built it: a step that returns its state
unchanged, half of each block left out, an answer altered where it is
made, a sub-integration lost.  One chip and no exchange between chips,
so that fault has no place here."""

import numpy as np
import pytest

from portbench.run import run_cell
from portbench.tests.conftest import tiny_cell


def _fold_unchanged(pipe):
    pipe._megastep = lambda profiles, hits, *args, **kw: (profiles, hits)


def _fold_half(pipe):
    step, half = pipe._megastep, pipe.out_per_block // 2

    def halved(profiles, hits, raw, phi0, dphi, bounds=None):
        # the first half of the block's samples folded, the rest left out,
        # and the profile scaled up to stand for all of them
        before = profiles.clone()
        p, h = step(profiles, hits, raw, phi0, dphi, (0, half))
        return before + 2 * (p - before), h
    pipe._megastep = halved


def _fold_altered(pipe):
    step = pipe._megastep

    def altered(*args, **kw):
        p, h = step(*args, **kw)
        p = p.clone()
        p[0, 0, 0, 0] *= 1.001
        return p, h
    pipe._megastep = altered


def _fold_flush_lost(pipe):
    flush = pipe._flush_division

    def lost():
        # a sub-integration's profile zeroed and not handed on
        n = len(pipe._subints)
        flush()
        del pipe._subints[n:]
    pipe._flush_division = lost


FAULTS = [_fold_unchanged, _fold_half, _fold_altered, _fold_flush_lost]


@pytest.mark.parametrize("fault", FAULTS,
                         ids=[f.__name__.strip("_") for f in FAULTS])
def test_fault_is_not_correct(fault):
    res = run_cell(tiny_cell(), 2**31 + 99, 0.05, False, device="cpu",
                   prepare=lambda drv: fault(drv.pipe))
    assert res["correct"] is False, res["checks"]


def test_sound_run_is_correct():
    res = run_cell(tiny_cell(), 2**31 + 99, 0.05, False, device="cpu")
    assert res["correct"] is True, res["checks"]
    assert np.isfinite([c["value"] for c in res["checks"].values()]).all()
