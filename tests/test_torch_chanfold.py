"""Channelised complex input through the port's fold (``FoldPipeline``,
the fused step's plain version on the CPU) against the benchmark's plain
reference (``portbench/reference/channelised.py``: each channel's own
FFT, chirp and subband inverses in float64): 9 complex channels, an odd
count as SKA1-Mid Band 2's 81, of 4 subbands each.  Also the reference's
block geometry and chirp against the pipeline's plan at Band 2's full 81 x
16 widths (the plan only), and the run report's ``ftp`` span and
``ftp_bytes`` counter of the step's channel transpose."""

import json
import os
import types

import numpy as np
import pytest
import torch

from dspsr_tpu_torch.models import load_to_fold
from dspsr_tpu_torch.utils.report import RunReport
from portbench.limits import readings
from portbench.reference.channelised import channel_chirp, channel_geometry
from portbench.spec import Cell
from portbench.tests.chancell import tiny_chan_cell
from test_torch_report import fold_pipe

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

#: profile_err of the float32 step: each bin sums some 150 samples' power
#: a sub-integration, each from a 512-point FFT and a 128-point inverse in
#: float32 (a few 1e-7 of the subband's level, measured 4-5e-7); 2e-5
#: leaves 40 times that and lies below a float16 filterbank's 2.8e-4 and a
#: bfloat16 one's 3e-3
TOL = 2e-5


@pytest.mark.parametrize("seed", [7, 2**31 + 5, 12345])
def test_fold_against_the_channelised_reference(seed):
    rec = readings(tiny_chan_cell(), seed, 0.05, control=True, device="cpu")
    prog, ctrl = rec["program"], rec["control"]
    assert prog["subints_diff"] == 0 and prog["hits_diff"] == 0, prog
    assert prog["profile_err"] < TOL, prog
    # the same reference's filterbank in bfloat16 fails the tolerance
    assert ctrl["profile_err"] > TOL, ctrl


def _band2():
    with open(os.path.join(ROOT, "portbench", "configs",
                           "ska1_band2_fold.json")) as f:
        cfg = json.load(f)
    with open(os.path.join(ROOT, "portbench", "traffic", "j0613.json")) as f:
        tr = json.load(f)
    return Cell(name="fold.ska1_band2.j0613", chips=1, config=cfg,
                traffic=tr, limits={"limits": {}})


@pytest.fixture(scope="module")
def band2_pipe():
    """Band 2's pipeline on the CPU over a ring source with no ring: the
    plan, block geometry and constants only."""
    from dspsr_tpu_torch.models.load_to_fold import MJD, Observation, Signal
    from portbench.drivers.chanfold import Driver
    from portbench.ring import RingSource

    cell = _band2()
    cfg = cell.config
    obs = Observation(nchan=81, npol=2, ndim=2, nbit=8,
                      centre_frequency=cfg["centre_frequency_mhz"],
                      bandwidth=cfg["bandwidth_mhz"],
                      rate=float(cfg["rate_hz"]),
                      start_time=MJD.from_utc(cfg["start_utc"]),
                      state=Signal.ANALYTIC).replace(ndat=1 << 50)
    drv = types.SimpleNamespace(config=cfg, traffic=cell.traffic,
                                source=RingSource(obs, 324),
                                device=torch.device("cpu"), trace=False)
    return cell, Driver.build(drv)


@pytest.mark.parametrize("what", ["plan", "blocks", "chirp"])
def test_band2_geometry_is_the_plans(band2_pipe, what):
    cell, pipe = band2_pipe
    g = channel_geometry(cell.config, cell.traffic["dm"], 1024)
    plan = pipe.mega_plan
    if what == "plan":
        assert pipe.mega_mode == "full"
        assert (g.nchan_in, g.nsub, g.freq_res, g.R1, g.nfilt_pos,
                g.nfilt_neg, g.nkeep) == (
            plan.nchan_in, plan.nsub, plan.freq_res, plan.R1,
            plan.nfilt_pos, plan.nfilt_neg, plan.nkeep) == (
            81, 16, 1024, 128, 81, 111, 832)
        assert not plan.real_input and plan.R2 == 128
    elif what == "blocks":
        assert (g.npart, g.block_ndat, g.stride_ndat) == (
            pipe.npart, pipe.block_in_samples, pipe.stride_in_samples) \
            == (79, 1054720, 1051648)
        assert g.out_rate == pipe.obs_out.rate == 625000.0
        assert g.block_bytes == 341729280
    else:
        h = channel_chirp(g, cell.traffic["dm"],
                          cell.config["centre_frequency_mhz"],
                          cell.config["bandwidth_mhz"], "cpu")
        got = torch.complex(pipe.constants.gr, pipe.constants.gi)
        assert float((h - got.to(torch.complex128)).abs().max()) < 1e-6
        # the whole band's first point zapped, no other channel's
        assert h[0, 0] == 0 and float(h[1:, 0].abs().min()) > 0.999


@pytest.fixture
def reports(monkeypatch):
    made = []

    class Kept(RunReport):
        def __init__(self, *a, **kw):
            super().__init__(*a, **kw)
            made.append(self)

    monkeypatch.setattr(load_to_fold, "RunReport", Kept)
    return made


@pytest.mark.parametrize("channels", [9, 1])
def test_the_step_s_transpose_is_a_span_and_a_counter(reports, channels):
    """Nine channels: one ``ftp`` span a block inside its ``step`` span,
    and ``ftp_bytes`` twice the block's bytes (read once, written once);
    one channel: neither."""
    nblocks = 3
    if channels == 1:
        pipe = fold_pipe(True, nblocks)
        pipe.run()
        nbytes = 0
    else:
        from portbench.drivers.chanfold import Driver

        # 10 s sub-integrations: no boundary splits a block's step
        drv = Driver(tiny_chan_cell(config=dict(subint_seconds=10)), 3,
                     "cpu", trace=True)
        drv.run_blocks(nblocks)
        nbytes = drv.geom.block_bytes
    (rep,) = reports
    s = rep.summary()
    spans = {n: [sp for sp in rep.device_spans if sp.name == n]
             for n in ("ftp", "step")}
    assert s["counters"]["ftp_bytes"] == 2 * nbytes * nblocks
    if channels == 1:
        assert spans["ftp"] == [] and "ftp" not in s["device_ms"]
        return
    assert [sp.block for sp in spans["ftp"]] == list(range(nblocks))
    for f, st in zip(spans["ftp"], spans["step"]):
        assert f.block == st.block and st.start <= f.start <= f.end <= st.end
    assert np.isclose(s["device_ms"]["ftp"],
                      sum(sp.end - sp.start for sp in spans["ftp"]) * 1e3)
