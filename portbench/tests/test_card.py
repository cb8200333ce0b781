"""On the card: one short window of each cell of ``BENCHMARK.json``, and the
control at the cell's size, through the same code as a benchmark run.  Skipped without a card;
on the card: ``python3 -m pytest portbench/tests/test_card.py -q``."""

import json
import os

import pytest

from portbench.tests.conftest import ROOT

with open(os.path.join(ROOT, "BENCHMARK.json")) as f:
    CELLS = [w["name"] for w in json.load(f)["workloads"]]


@pytest.mark.card
@pytest.mark.parametrize("name", CELLS)
def test_cell_is_correct_and_control_is_not(name, card):
    from portbench.limits import readings
    from portbench.spec import load_cell

    cell = load_cell(name, ROOT)
    limits = cell.limits["limits"]
    rec = readings(cell, 2**31 + 77, 1.0, control=True)
    assert all(rec["program"][k] <= limits[k] for k in limits), rec
    assert any(rec["control"][k] > limits[k] for k in limits), rec
