"""The result's last line: its keys, its metrics, and no result without a
card or outside a full checkout."""

import json
import os
import shutil
import subprocess
import sys

import pytest

from portbench.run import main, run_cell
from portbench.tests.conftest import ROOT, tiny_cell

KEYS = ["correct", "attempted", "failed", "metrics", "device"]


def test_untraced_line():
    res = run_cell(tiny_cell(), 2**31 + 1, 0.05, False, device="cpu")
    assert list(res) == KEYS + ["checks"]
    assert set(res["metrics"]) == {"realtime_x", "setup_s"}
    assert all(m["value"] > 0 for m in res["metrics"].values())
    assert set(res["device"]) == {"platform", "kind", "count",
                                  "memory_peak_bytes"}
    assert res["attempted"] >= 2 and res["failed"] == 0
    assert all(set(c) == {"value", "limit"} for c in res["checks"].values())
    json.dumps(res)


def test_traced_line():
    cell = tiny_cell()
    with open(os.path.join(ROOT, "BENCHMARK.json")) as f:
        cell.per_layer = json.load(f)["per_layer"]
    res = run_cell(cell, 2**31 + 2, 0.05, True, device="cpu")
    assert list(res) == KEYS + ["breakdown", "checks"]
    assert {"busy_s", "window_s"} <= set(res["device"])
    assert set(res["breakdown"]) == {"device_ops", "idle_gaps"}
    assert all(len(v) <= 10 for v in res["breakdown"].values())
    # the CPU has no device trace: only what the host reads is there
    assert set(res["metrics"]) <= {"anchors_ms", "device_idle_pct"}
    # the program's run report gives the anchors' seconds to a millisecond,
    # which a CPU window of a few tiny blocks rounds to nothing
    assert "anchors_ms" in res["metrics"]


def test_no_card_no_result(capsys):
    import torch

    if torch.cuda.is_available():
        pytest.skip("a card is present")
    rc = main(["--workload", "fold.j0613", "--seed", "1", "--seconds", "1",
               "--trace", "0"])
    assert rc != 0
    assert capsys.readouterr().out == ""


def test_benchmark_files_alone_give_no_result(tmp_path):
    shutil.copy(os.path.join(ROOT, "BENCHMARK.json"), tmp_path)
    shutil.copytree(os.path.join(ROOT, "portbench"), tmp_path / "portbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    p = subprocess.run([sys.executable, "-m", "portbench.run", "--workload",
                        "fold.j1713", "--seed", "3", "--seconds", "1",
                        "--trace", "0"], cwd=tmp_path, capture_output=True,
                       text=True, timeout=300)
    assert p.returncode != 0
    assert p.stdout == ""
