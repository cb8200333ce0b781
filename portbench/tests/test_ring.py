"""The pinned ring: periodic, block-aligned reads are views, the same seed
makes the same bytes."""

import numpy as np
import pytest
import torch

from portbench.ring import PinnedRing, noise_bytes

CPU = torch.device("cpu")


def test_reads_are_periodic_views():
    ring = PinnedRing(3, 100, 130, 32.0, 2**31 + 17, CPU)
    assert ring.array.size == 3 * 100 + 30
    # the tail repeats the head: a block that wraps reads on unbroken
    np.testing.assert_array_equal(ring.array[300:], ring.array[:30])
    for k in range(7):
        v = ring.view(k * 100, 130)
        assert np.shares_memory(v, ring.array)
        np.testing.assert_array_equal(v, ring.block(k % 3))
    np.testing.assert_array_equal(ring.block(2)[100:], ring.block(0)[:30])
    # distinct blocks
    assert not np.array_equal(ring.block(0)[:100], ring.block(1)[:100])


def test_unaligned_read_refused():
    ring = PinnedRing(3, 100, 130, 32.0, 1, CPU)
    with pytest.raises(ValueError):
        ring.view(250, 130)


def test_seed_makes_the_bytes():
    a = PinnedRing(2, 1000, 1200, 32.0, 2**31 + 3, CPU).array
    b = PinnedRing(2, 1000, 1200, 32.0, 2**31 + 3, CPU).array
    c = PinnedRing(2, 1000, 1200, 32.0, 2**31 + 4, CPU).array
    np.testing.assert_array_equal(a, b)
    assert not np.array_equal(a, c)


def test_noise_levels():
    out = torch.empty(1 << 20, dtype=torch.uint8)
    gen = torch.Generator().manual_seed(5)
    noise_bytes(out.numel(), 32.0, gen, out)
    x = out.double() - 127.5
    assert abs(float(x.mean())) < 0.2
    assert abs(float(x.std()) - 32.0) < 0.2


def test_ring_source_reads_the_ring():
    from portbench.ring import RingSource
    from portbench.tests.conftest import tiny_cell
    from portbench.drivers.fold import Driver

    drv = Driver(tiny_cell("fold"), 11, "cpu")
    g = drv.geom
    raw = drv.source.read_samples(5 * g.stride_ndat, g.block_ndat)
    np.testing.assert_array_equal(raw, drv.ring.block(5 % drv.ring.nblocks))
    assert np.shares_memory(raw, drv.ring.array)
    assert RingSource(drv.obs, 2).total_samples == drv.obs.ndat
