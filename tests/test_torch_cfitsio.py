"""The port's cfitsio binding (``dspsr_tpu_torch/io/cfitsio.py``): archives
and search files the port writes, read back through the SYSTEM cfitsio
library (the third-party code the reference links against).

The four checks of ``tests/test_cfitsio.py`` on an archive that the port's
``FoldPipeline`` (``device="cpu"``) writes, with Vela's period as
``folding_period`` in place of the polyco and ephemeris that the JAX test
reads (so no POLYCO or PSRPARAM extension is written); the port's
``CfitsioFile`` against the JAX one on the same file; and the sharded
digifits check of ``tests/test_sharded_pipeline.py`` on the port's
``parallel/search.py``.  Skipped where no ``libcfitsio`` is installed.
"""

import numpy as np
import pytest
import torch

from dspsr_tpu.io import cfitsio as jcf

from dspsr_tpu_torch.io.cfitsio import (CfitsioError, CfitsioFile,
                                        available, verify_psrfits_fold)
from dspsr_tpu_torch.io.psrfits import save_psrfits_fold
from dspsr_tpu_torch.io.sources import RawFileSource
from dspsr_tpu_torch.models.load_to_fold import (MJD, FoldConfig,
                                                 FoldPipeline, Observation,
                                                 Signal)

torch.set_num_threads(2)

VELA_PERIOD = 1.0 / 11.19  # s


@pytest.fixture(autouse=True)
def need_cfitsio():
    if not available():
        pytest.skip("libcfitsio not present")


def vela_obs(rate=1e6) -> Observation:
    return Observation(nchan=1, npol=2, ndim=1, nbit=8,
                       centre_frequency=1400.0, bandwidth=-2.0, rate=rate,
                       start_time=MJD.from_utc("2010-04-13-02:05:45"),
                       state=Signal.NYQUIST, source="J0835-4510",
                       telescope="PKS", instrument="RAW")


@pytest.fixture(scope="module")
def fold_result(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("tcf")
    rng = np.random.default_rng(1)
    p = str(tmp / "x.raw")
    with open(p, "wb") as f:
        f.write(rng.integers(0, 256, 1 << 17).astype(np.uint8).tobytes())
    cfg = FoldConfig(folding_period=VELA_PERIOD, dispersion_measure=67.99,
                     nchan=4, nbin=32, block_parts=2, min_block_samples=0,
                     passband=True, subint_seconds=0.02,
                     use_megakernel=False)
    res = FoldPipeline(RawFileSource(p, vela_obs()), cfg, device="cpu").run()
    assert res.profiles.shape[0] >= 2  # several sub-integrations
    return res, tmp


class TestFoldArchiveThroughCfitsio:
    def test_structure_and_values(self, fold_result):
        res, tmp = fold_result
        path = str(tmp / "v.ar")
        save_psrfits_fold(path, res)
        metrics = verify_psrfits_fold(path, res)
        assert metrics["nsub"] == res.profiles.shape[0]
        assert metrics["max_profile_err"] < 1e-3

    def test_extensions_visible_to_cfitsio(self, fold_result):
        res, tmp = fold_result
        path = str(tmp / "v2.ar")
        save_psrfits_fold(path, res)
        with CfitsioFile(path) as f:
            names = f.hdu_names()
            for want in ("HISTORY", "DIG_CNTS", "BANDPASS", "SUBINT"):
                assert want in names, (want, names)
            # a fixed period folds with no polyco and no ephemeris
            assert "POLYCO" not in names and "PSRPARAM" not in names
            with pytest.raises(CfitsioError):
                f.move_to("POLYCO")
            f.move_to("SUBINT")
            assert f.key_float("DM") == pytest.approx(67.99)
            period = f.read_col("PERIOD", 1)[:, 0]
            assert np.allclose(1.0 / period, 11.19)  # Vela spin frequency

    def test_bandpass_value_roundtrip(self, fold_result):
        """A reader applying the PSRFITS convention v = offs + scl*data must
        reconstruct the integrated bandpass."""
        res, tmp = fold_result
        path = str(tmp / "vbp.ar")
        save_psrfits_fold(path, res)
        pb = np.asarray(res.passband, np.float64)  # [nchan, npol, nres]
        nchan, npol, nres = pb.shape
        with CfitsioFile(path) as f:
            f.move_to("BANDPASS")
            offs = f.read_col("DAT_OFFS", npol)[0]
            scl = f.read_col("DAT_SCL", npol)[0]
            data = f.read_col("DATA", npol * nchan * nres, np.int16)[0]
        v = (offs[:, None] + scl[:, None]
             * data.astype(np.float64).reshape(npol, nchan * nres))
        want = pb.transpose(1, 0, 2).reshape(npol, nchan * nres)
        step = scl.max()  # one quantization step
        assert np.abs(v - want).max() <= step

    def test_primary_keywords(self, fold_result):
        res, tmp = fold_result
        path = str(tmp / "v3.ar")
        save_psrfits_fold(path, res)
        with CfitsioFile(path) as f:
            f.move_abs(1)
            assert f.key_str("OBS_MODE") == "PSR"
            assert f.key_str("SRC_NAME") == "J0835-4510"
            assert f.key_int("STT_IMJD") == 55299

    def test_mismatch_raises(self, fold_result):
        """The check fails on an archive of other profiles."""
        res, tmp = fold_result
        path = str(tmp / "v4.ar")
        save_psrfits_fold(path, res)
        other = type(res)(**{**res.__dict__,
                             "profiles": res.profiles[..., ::-1].copy()})
        with pytest.raises(AssertionError):
            verify_psrfits_fold(path, other)


def test_same_columns_as_jax_binding(fold_result):
    """The port's CfitsioFile and the JAX package's read the same HDUs,
    keywords and columns from the port's archive."""
    res, tmp = fold_result
    path = str(tmp / "both.ar")
    save_psrfits_fold(path, res)
    nsub = res.profiles.shape[0]
    nchan, npol, nbin = res.obs.nchan, res.obs.npol, res.nbin
    cols = [("TSUBINT", 1, np.float64), ("OFFS_SUB", 1, np.float64),
            ("PERIOD", 1, np.float64), ("DAT_FREQ", nchan, np.float64),
            ("DAT_WTS", nchan, np.float32),
            ("DAT_SCL", nchan * npol, np.float32),
            ("DAT_OFFS", nchan * npol, np.float32),
            ("DATA", nbin * nchan * npol, np.int16)]
    with CfitsioFile(path) as t, jcf.CfitsioFile(path) as j:
        assert t.num_hdus() == j.num_hdus()
        assert t.hdu_names() == j.hdu_names()
        t.move_to("SUBINT")
        j.move_to("SUBINT")
        assert t.num_rows() == j.num_rows() == nsub
        for key in ("NBIN", "NCHAN", "NPOL"):
            assert t.key_int(key) == j.key_int(key)
        assert t.key_float("DM") == j.key_float("DM")
        for name, n, dtype in cols:
            np.testing.assert_array_equal(t.read_col(name, n, dtype),
                                          j.read_col(name, n, dtype))
        t.move_abs(1)
        j.move_abs(1)
        for key in ("OBS_MODE", "SRC_NAME", "TELESCOP"):
            assert t.key_str(key) == j.key_str(key)


def test_sharded_digifits(tmp_path):
    """The port's time-sharded search (``parallel/search.py``, a mesh of the
    CPU four times) to search-mode PSRFITS, read through cfitsio: its rows
    are the single pipeline's (the sharded run drops the trailing ragged
    block that the single one folds in, so its last row ends in the zeros
    that pad it)."""
    from dspsr_tpu_torch.models.load_to_fil import FilConfig, FilPipeline
    from dspsr_tpu_torch.parallel.search import ShardedFilPipeline
    from dspsr_tpu_torch.parallel.sharded import make_mesh

    rng = np.random.default_rng(5)
    path = str(tmp_path / "sfit.raw")
    with open(path, "wb") as f:
        f.write(rng.integers(0, 256, 1 << 21).astype(np.uint8).tobytes())
    obs = vela_obs(rate=4e6).replace(source="FAKE")
    cfg = FilConfig(nchan=4, nbits=8, dispersion_measure=2.0,
                    min_block_samples=0, block_parts=2,
                    rescale_constant=True)
    sh = ShardedFilPipeline(RawFileSource(path, obs), cfg,
                            make_mesh(4, 1, devices=[torch.device("cpu")] * 4))
    out, one = str(tmp_path / "n.sf"), str(tmp_path / "one.sf")
    sh.run(out, format="psrfits")
    FilPipeline(RawFileSource(path, obs), cfg, device="cpu").run(
        one, format="psrfits")
    with CfitsioFile(out) as f, CfitsioFile(one) as g:
        f.move_to("SUBINT")
        g.move_to("SUBINT")
        rows = f.num_rows()
        assert 0 < rows <= g.num_rows()
        assert f.key_int("NCHAN") == 4
        nsblk = f.key_int("NSBLK")
        assert nsblk == g.key_int("NSBLK")
        a = f.read_col("DATA", 4 * nsblk, np.int16)
        b = g.read_col("DATA", 4 * nsblk, np.int16)[:rows]
        np.testing.assert_array_equal(a[:-1], b[:-1])
        k = np.flatnonzero(a[-1]).max() + 1
        np.testing.assert_array_equal(a[-1, :k], b[-1, :k])
