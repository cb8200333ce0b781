"""A cell of ``BENCHMARK.json`` and the files it is found by.

A workload names a configuration and a traffic; the configuration's entry
names its file, whose ``driver`` key names ``portbench/drivers/<driver>.py``;
the traffic is ``portbench/traffic/<traffic>.json``; the limits of the
output comparison are ``portbench/limits/<workload>.json``; each per-layer
metric whose ``workloads`` list holds the cell (or that has none) is read
by ``portbench/metrics/<name>.py``.  Adding a cell, a configuration, a
traffic or a metric is adding files and entries: nothing here names one.
"""

from __future__ import annotations

import importlib
import json
import os
from dataclasses import dataclass, field

HERE = os.path.dirname(os.path.abspath(__file__))


@dataclass
class Cell:
    name: str
    chips: int
    config: dict
    traffic: dict
    limits: dict
    #: end-to-end and per-layer metric entries of ``BENCHMARK.json`` that
    #: this cell reports
    end_to_end: list = field(default_factory=list)
    per_layer: list = field(default_factory=list)

    @property
    def driver(self):
        return importlib.import_module(
            f"portbench.drivers.{self.config['driver']}")


def _json(path: str) -> dict:
    with open(path) as f:
        return json.load(f)


def _reports(metric: dict, cell: str) -> bool:
    return "workloads" not in metric or cell in metric["workloads"]


def load_cell(name: str, root: str = ".") -> Cell:
    """The cell ``name`` of ``root/BENCHMARK.json``, with its files read."""
    bench = _json(os.path.join(root, "BENCHMARK.json"))
    work = {w["name"]: w for w in bench["workloads"]}
    if name not in work:
        raise KeyError(f"no workload {name!r} in BENCHMARK.json")
    w = work[name]
    conf = {c["name"]: c for c in bench["configs"]}[w["config"]]
    pkg = os.path.join(root, "portbench")
    return Cell(
        name=name, chips=int(w["chips"]),
        config=_json(os.path.join(root, conf["file"])),
        traffic=_json(os.path.join(pkg, "traffic", f"{w['traffic']}.json")),
        limits=_json(os.path.join(pkg, "limits", f"{name}.json")),
        end_to_end=[m for m in bench["end_to_end"] if _reports(m, name)],
        per_layer=[m for m in bench["per_layer"] if _reports(m, name)])


def reader(metric: str):
    """The ``read`` function of ``portbench/metrics/<metric>.py``."""
    return importlib.import_module(f"portbench.metrics.{metric}").read
