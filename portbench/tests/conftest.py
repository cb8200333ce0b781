"""Shared fixtures of the benchmark's CPU tests.

Tests that need a card carry the ``card`` marker and skip inside the test
where ``torch.cuda.is_available()`` is false.  Run them all with
``python -m pytest portbench/tests -q`` from the repository's root.
"""

import copy
import json
import os
import types

import pytest

from portbench.spec import Cell

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "card: needs a CUDA card; skips where there is none")


def _json(*parts):
    with open(os.path.join(ROOT, "portbench", *parts)) as f:
        return json.load(f)


#: a band small enough for the plain step on the CPU: 4 subbands of a 16
#: MHz real-sampled band, a DM whose smear needs a few dozen samples, blocks
#: of 576 output samples and sub-integrations of 2000
TINY = dict(rate_hz=32000000, bandwidth_mhz=-16.0, centre_frequency_mhz=1400.0,
            nchan=4, nbin=16, block_parts=2, min_block_samples=4096,
            subint_seconds=0.0005)


def tiny_cell(limits=None, **traffic) -> Cell:
    """A cell of the deployment ``caspsr_fold`` at the ``TINY`` size."""
    config = _json("configs", "caspsr_fold.json")
    config.update(TINY)
    tr = dict(pulsar="TEST", dm=0.5, period_s=0.000123, ring_blocks=3)
    tr.update(traffic)
    default = _json("limits", "fold.j0613.json")["limits"]
    return Cell(name="fold.tiny", chips=1, config=config, traffic=tr,
                limits={"limits": limits or default},
                end_to_end=copy.deepcopy(_bench()["end_to_end"]),
                per_layer=[])


def file_cell(name: str) -> Cell:
    """Cell ``fold.<traffic>`` of the deployment ``caspsr_fold`` at its full
    size, read from the configuration and traffic files alone (whether or
    not ``BENCHMARK.json`` lists it; no limits)."""
    traffic = name.split(".")[1]
    return Cell(name=name, chips=1,
                config=_json("configs", "caspsr_fold.json"),
                traffic=_json("traffic", f"{traffic}.json"),
                limits={"limits": {}})


def _bench():
    with open(os.path.join(ROOT, "BENCHMARK.json")) as f:
        return json.load(f)


@pytest.fixture
def card():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("no CUDA card: torch.cuda.is_available() is False")


def program_pipe(cell):
    """The program's pipeline of ``cell`` on the CPU, over a ring source with
    no ring: its plan only."""
    import torch

    from dspsr_tpu_torch.models.load_to_fold import MJD, Observation, Signal
    from portbench.ring import RingSource

    cfg = cell.config
    obs = Observation(nchan=1, npol=2, ndim=1, nbit=8,
                      centre_frequency=cfg["centre_frequency_mhz"],
                      bandwidth=cfg["bandwidth_mhz"],
                      rate=float(cfg["rate_hz"]),
                      start_time=MJD.from_utc(cfg["start_utc"]),
                      state=Signal.NYQUIST).replace(ndat=1 << 50)
    drv = types.SimpleNamespace(config=cfg, traffic=cell.traffic,
                                source=RingSource(obs, 2),
                                device=torch.device("cpu"), trace=False)
    return cell.driver.Driver.build(drv)
