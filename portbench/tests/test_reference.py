"""The plain reference works out what the program works out: the same block
geometry, the same float32 phase anchors and bins bit for bit, the same
sub-integration boundaries, the same unpack levels and chirp, and the same
detected filterbank."""

import math

import numpy as np
import pytest
import torch

from portbench.drivers.base import start_seconds
from portbench.reference.filterbank import Precision, chirp, detect_block
from portbench.reference.fold import Divisions, anchors, bins
from portbench.reference.geometry import geometry
from portbench.reference.levels import level_step
from portbench.tests.conftest import file_cell, program_pipe, tiny_cell

CELLS = ["fold.j0613", "fold.j1713"]


def _cell(name):
    return file_cell(name)


@pytest.mark.parametrize("name", CELLS)
def test_geometry_is_the_programs(name):
    cell = _cell(name)
    pipe = program_pipe(cell)
    plan = pipe.mega_plan
    g = geometry(cell.config, cell.traffic["dm"], cell.config["nbin"])
    assert (g.nsub, g.freq_res, g.R1, g.nfilt_pos, g.nfilt_neg, g.nkeep) == \
        (plan.nsub, plan.freq_res, plan.R1, plan.nfilt_pos, plan.nfilt_neg,
         plan.nkeep)
    assert (g.npart, g.block_ndat, g.stride_ndat) == \
        (pipe.npart, pipe.block_in_samples, pipe.stride_in_samples)
    assert g.out_rate == pipe.obs_out.rate


@pytest.mark.parametrize("name", CELLS)
def test_anchors_and_bins_bit_for_bit(name):
    from dspsr_tpu_torch.ops.fold import compute_anchors, compute_bins

    cell = _cell(name)
    pipe = program_pipe(cell)
    g = geometry(cell.config, cell.traffic["dm"], cell.config["nbin"])
    start = start_seconds(cell.config["start_utc"])
    for b in (0, 1, 7, 333, 4096, 65537):
        want0, want1 = compute_anchors(
            pipe.predictor, pipe.output_start_time(b * pipe.stride_in_samples),
            1.0 / pipe.obs_out.rate, pipe.out_per_block, pipe.fold_plan.seg_len)
        want0 = (want0 - 0.0) % 1.0
        phi0, dphi = anchors(g, b, start, cell.traffic["period_s"])
        got0 = phi0.astype(np.float32)
        got0 = np.where(got0 >= 1.0, got0 - 1.0, got0)
        np.testing.assert_array_equal(got0, want0)
        np.testing.assert_array_equal(dphi.astype(np.float32), want1)
        got = bins(phi0, dphi, g.nkeep, g.nbin, "cpu")
        ref = compute_bins(torch.from_numpy(want0), torch.from_numpy(want1),
                           g.nkeep, g.nbin)
        assert torch.equal(got, ref)


@pytest.mark.parametrize("name,seconds", [("fold.j0613", 10),
                                          ("fold.j1713", 10),
                                          ("fold.j1713", 7.25)])
def test_divisions_are_the_programs(name, seconds):
    from dspsr_tpu_torch.timing.timedivide import TimeDivide

    cell = _cell(name)
    pipe = program_pipe(cell)
    g = geometry(cell.config, cell.traffic["dm"], cell.config["nbin"])
    want = TimeDivide(rate=pipe.obs_out.rate,
                      start_time=pipe.output_start_time(0), seconds=seconds)
    got = Divisions(g, start_seconds(cell.config["start_utc"]), seconds)
    assert [got.boundary(k) for k in range(-1, 200)] == \
        [want.boundary_sample(k) for k in range(-1, 200)]
    nuse = g.out_per_block
    for s in (0, 1, nuse - 1, 31 * nuse + 5, 10**9 + 7,
              want.boundary_sample(3), want.boundary_sample(3) - 1):
        assert got.of(s) == want.division_of(s)


def test_levels_are_the_programs():
    from dspsr_tpu_torch.ops.megakernel import unpack_affine

    scale, offset = unpack_affine(8)
    assert math.isclose(level_step(8), scale, rel_tol=1e-7)
    assert math.isclose(-127.5 * level_step(8), offset, rel_tol=1e-7)


def test_chirp_is_the_programs():
    from dspsr_tpu_torch.ops.dedispersion import Dedispersion

    cell = _cell("fold.j1713")
    cfg, dm = cell.config, cell.traffic["dm"]
    g = geometry(cfg, dm, 1024)
    want = Dedispersion.build(dm, cfg["centre_frequency_mhz"],
                              cfg["bandwidth_mhz"], g.nsub, g.freq_res).phasors
    got = chirp(g, dm, cfg["centre_frequency_mhz"], cfg["bandwidth_mhz"],
                "cpu").numpy().reshape(want.shape)
    assert np.abs(got - want).max() < 1e-6
    assert got[0, 0] == 0


def test_detected_filterbank_is_the_programs():
    from dspsr_tpu_torch.ops.megakernel import _front_plain

    cell = tiny_cell()
    pipe = program_pipe(cell)
    g = geometry(cell.config, cell.traffic["dm"])
    raw = torch.randint(0, 256, (g.block_bytes,), dtype=torch.uint8,
                        generator=torch.Generator().manual_seed(3))
    h = chirp(g, cell.traffic["dm"], cell.config["centre_frequency_mhz"],
              cell.config["bandwidth_mhz"], "cpu")
    got = detect_block(raw, g, h, Precision("float64"))
    # [nchan_in, nplane, npart, nsub, nkeep] -> [nsub, npart * nkeep]
    want = _front_plain(pipe.mega_plan, pipe.constants, raw, pipe.npart,
                        torch.float64)[0][0, 0]
    want = want.permute(1, 0, 2).reshape(g.nsub, -1)
    assert float((got - want).abs().max() / want.abs().max()) < 1e-6
