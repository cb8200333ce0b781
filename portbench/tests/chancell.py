"""A cell of the deployment ``ska1_band2_fold`` small enough for the plain
step on the CPU: 9 complex channels (an odd count, as Band 2's 81) of 1 MHz,
4 subbands each, a DM whose smear needs a few dozen samples (freq_res 128,
R1 32, 11 windows of 512 points a block) and sub-integrations of 2500
output samples."""

import json
import os

from portbench.spec import Cell
from portbench.tests.conftest import ROOT

TINY_CHAN = dict(nchan_in=9, nchan=36, rate_hz=1e6, bandwidth_mhz=-9.0,
                 centre_frequency_mhz=1400.0, nbin=16, block_parts=2,
                 min_block_samples=4096, subint_seconds=0.01)


def _json(*parts):
    with open(os.path.join(ROOT, "portbench", *parts)) as f:
        return json.load(f)


def tiny_chan_cell(limits=None, config=None, **traffic) -> Cell:
    """``ska1_band2_fold`` at ``TINY_CHAN`` (and ``config``'s keys), DM
    100, under the new cell's limits unless ``limits`` are given."""
    cfg = _json("configs", "ska1_band2_fold.json")
    cfg.update(TINY_CHAN, **(config or {}))
    tr = dict(pulsar="TEST", dm=100.0, period_s=0.000984, ring_blocks=3)
    tr.update(traffic)
    bench = _json("..", "BENCHMARK.json")
    default = _json("limits", "fold.ska1_band2.j0613.json")["limits"]
    return Cell(name="fold.ska1_band2.tiny", chips=1, config=cfg, traffic=tr,
                limits={"limits": limits or default},
                end_to_end=bench["end_to_end"], per_layer=[])
