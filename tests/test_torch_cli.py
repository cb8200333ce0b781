"""The port's dspsr CLI (``dspsr_tpu_torch.apps.dspsr_app``, ``--device
cpu``) against the JAX package's (``dspsr_tpu.apps.dspsr_app``) on the same
argv: the ``dspsr`` cases of ``tests/test_diagnostics.py`` and
``tests/test_signalpath.py``'s ``--repeat``, each run through both CLIs.

Archives are held as ``tests/test_torch_pipeline.py`` holds pipelines:
profiles within 2e-4 of the largest magnitude, hits, epochs, lengths,
frequencies, digitizer counts and the metadata exact.  PSRFITS archives
are compared on their data (each profile rebuilt from its int16 samples,
DAT_SCL and DAT_OFFS: within 2e-4 of its range plus one quantization step
of either side) and on the header cards, all of which the two writers set
alike from the options (``-N``, ``--set``, ``-k``, ``-B``, ``-f``,
``--mjd``, ``-C``) and the run.
"""

import os
import tempfile

import numpy as np
import pytest
import torch

from dspsr_tpu.apps import dspsr_app as japp
from dspsr_tpu.io.archive import load_archive
from dspsr_tpu.io.fits import read_bintable_column, read_fits_headers

from dspsr_tpu_torch.apps import dspsr_app as tapp
from test_pipeline import DM, PERIOD, synth_pulsar_dada

torch.set_num_threads(2)

HDR = ["--header", "FREQ=1400", "BW=-2", "NCHAN=1", "NPOL=2", "NDIM=1",
       "NBIT=8", "TSAMP=1.0", "UTC_START=2010-04-13-02:05:45"]


def write_raw(tmp_path, n=1 << 16, seed=0, name="cli.raw"):
    rng = np.random.default_rng(seed)
    p = str(tmp_path / name)
    with open(p, "wb") as f:
        f.write(rng.integers(0, 256, n).astype(np.uint8).tobytes())
    return p


def run_both(tmp_path, argv, ext="npz"):
    """``argv`` through the JAX CLI (to ``j.<ext>``) and the port's CLI with
    ``--device cpu`` (to ``t.<ext>``) in ``tmp_path``: the two outputs."""
    outs = []
    for tag, main, dev in (("j", japp.main, []),
                           ("t", tapp.main, ["--device", "cpu"])):
        out = str(tmp_path / f"{tag}.{ext}")
        assert main([*argv, "-O", out, "-q", *dev]) == 0
        outs.append(out)
    return outs


def assert_same_npz(a_path, b_path):
    a, b = load_archive(a_path), load_archive(b_path)
    assert set(a) == set(b)
    assert a["profiles"].shape == b["profiles"].shape
    scale = np.abs(a["profiles"]).max()
    assert np.abs(b["profiles"] - a["profiles"]).max() <= 2e-4 * scale
    for k in a:
        if k not in ("profiles", "meta"):
            assert np.array_equal(a[k], b[k]), k
    assert a["meta"] == b["meta"]
    return a, b


def psrfits_profiles(path):
    """Each profile of a fold PSRFITS archive rebuilt from its int16
    samples: ``[nsub, npol, nchan, nbin]`` and the quantization step of
    each ``[nsub, npol, nchan]``."""
    sub = [h for h in read_fits_headers(path) if h.get("EXTNAME") == "SUBINT"][0]
    nbin, nchan, npol = (int(sub[k]) for k in ("NBIN", "NCHAN", "NPOL"))
    data = read_bintable_column(path, "SUBINT", "DATA").astype(np.float64)
    scl = read_bintable_column(path, "SUBINT", "DAT_SCL").astype(np.float64)
    offs = read_bintable_column(path, "SUBINT", "DAT_OFFS").astype(np.float64)
    nsub = data.shape[0]
    # DAT_SCL / DAT_OFFS are (chan, pol) ordered, DATA (pol, chan, bin)
    scl = scl.reshape(nsub, nchan, npol).transpose(0, 2, 1)
    offs = offs.reshape(nsub, nchan, npol).transpose(0, 2, 1)
    prof = data.reshape(nsub, npol, nchan, nbin) * scl[..., None] \
        + offs[..., None]
    return prof, scl


def assert_same_psrfits(a_path, b_path):
    ha, hb = read_fits_headers(a_path), read_fits_headers(b_path)
    assert ha == hb
    pa, sa = psrfits_profiles(a_path)
    pb, sb = psrfits_profiles(b_path)
    rng = (pa.max(-1) - pa.min(-1))[..., None]
    assert (np.abs(pa - pb) <= 2e-4 * rng + sa[..., None]
            + sb[..., None]).all()
    for col in ("TSUBINT", "OFFS_SUB", "PERIOD", "DAT_FREQ", "DAT_WTS"):
        assert np.array_equal(read_bintable_column(a_path, "SUBINT", col),
                              read_bintable_column(b_path, "SUBINT", col)), col
    return ha


BASE = ["-c", "0.005", "-F", "4", "-D", "3", "-b", "32"]


@pytest.mark.parametrize("extra", [
    [],
    ["-F", "4:D"],
    ["--bandwidth=-4.0", "-f", "1500.0", "-k", "GBT", "--mjd", "55299.5",
     "-C", "1.5"],
    ["-N", "J0000+0000", "--set", "telescope=GBT", "--set",
     "receiver=MULTI"],
    ["-L", "0.01", "--Lmin", "0.0099"],
    ["--cepoch", "55299.0871527777777"],
    ["-d", "4", "-p", "0.25"],
    ["--fft-window", "hanning", "--passband"],
    ["-R"],
    ["--skz", "--skzm", "256"],
    ["-2", "n256,c4.5", "--skz", "--skzm", "256", "--skz_start", "1",
     "--skz_end", "3"],
    ["-x", "minX2"],
    ["-t", "4", "--chan-shards", "2"],
], ids=["whole", "F_D", "source_overrides", "name_set", "subint_Lmin",
        "cepoch", "stokes_phase", "window_passband", "rfi", "skz",
        "excision_sk_range", "minX", "threads"])
def test_npz_matches_jax(tmp_path, extra):
    raw = write_raw(tmp_path)
    if "-F" in extra:
        # the JAX CLI takes -F N only; the port also takes the reference's
        # N:D, which means the same here
        a = str(tmp_path / "j.npz")
        assert japp.main([raw, *HDR, *BASE, "-O", a, "-q"]) == 0
        b = str(tmp_path / "t.npz")
        assert tapp.main([raw, *HDR, *BASE, *extra, "-O", b, "-q",
                          "--device", "cpu"]) == 0
    else:
        a, b = run_both(tmp_path, [raw, *HDR, *BASE, *extra])
    za, zb = assert_same_npz(a, b)
    assert zb["hits"].sum() > 0
    if "-L" in extra:
        assert zb["profiles"].shape[0] >= 2
        assert (zb["lengths"] >= 0.0099).all()
    if "-k" in extra:
        assert zb["meta"]["telescope"] == "GBT"
        assert zb["meta"]["centre_frequency"] == 1500.0
        assert zb["meta"]["bandwidth"] == -4.0
        assert abs(float(zb["epochs_mjd"][0]) - 55299.5) < 0.1
    if "-N" in extra:
        assert zb["meta"]["source"] == "J0000+0000"


@pytest.mark.parametrize("extra", [
    ["-N", "J0000+0000", "--set", "telescope=GBT", "--fft-window",
     "hanning", "--pulsar", "0.007"],
    ["--bandwidth=-4.0", "-f", "1500.0", "-k", "GBT", "--mjd", "55299.5",
     "-C", "1.5", "-L", "0.02"],
], ids=["name_set_pulsar", "source_overrides_subints"])
def test_psrfits_matches_jax(tmp_path, extra):
    """``-a psrfits``: the data and every header card equal the JAX CLI's;
    the cards the options set hold their values; ``--pulsar`` writes
    ``_src1``."""
    raw = write_raw(tmp_path)
    a, b = run_both(tmp_path, [raw, *HDR, *BASE, "-a", "psrfits", *extra],
                    ext="ar")
    prim = assert_same_psrfits(a, b)[0]
    if "-N" in extra:
        assert prim["SRC_NAME"] == "J0000+0000"
        assert prim["TELESCOP"] == "GBT"
        assert_same_psrfits(a.replace(".ar", "_src1.ar"),
                            b.replace(".ar", "_src1.ar"))
    else:
        assert prim["TELESCOP"] == "GBT"
        assert float(prim["OBSFREQ"]) == 1500.0
        assert float(prim["OBSBW"]) == -4.0
        assert int(prim["STT_IMJD"]) == 55299


def test_extension_and_default_name(tmp_path, monkeypatch):
    """``-e`` names the archive ``<source>_<MJD>.<ext>`` as the JAX CLI
    does, and ``-a psrfits`` without ``-O`` writes ``.ar``."""
    raw = write_raw(tmp_path)
    for tag, main, dev in (("j", japp.main, []),
                           ("t", tapp.main, ["--device", "cpu"])):
        d = tmp_path / tag
        d.mkdir()
        monkeypatch.chdir(d)
        assert main([raw, *HDR, *BASE, "-N", "SRC", "-e", "sf", "-q",
                     *dev]) == 0
        assert main([raw, *HDR, *BASE, "-N", "SRC", "-a", "psrfits", "-q",
                     *dev]) == 0
    names = sorted(os.listdir(tmp_path / "j"))
    assert names == sorted(os.listdir(tmp_path / "t"))
    assert [n.rsplit(".", 1)[1] for n in names] == ["ar", "sf"]
    for n in names:
        assert_same_psrfits(str(tmp_path / "j" / n), str(tmp_path / "t" / n))


def test_skz_noskz_too(tmp_path):
    """``--skz --noskz_too`` writes the un-zapped fold as ``.nosk``."""
    raw = write_raw(tmp_path)
    a, b = run_both(tmp_path, [raw, *HDR, *BASE, "--skz", "--skzm", "256",
                               "--noskz_too"])
    assert_same_npz(a, b)
    na, nb = (p.replace(".npz", ".nosk.npz") for p in (a, b))
    assert os.path.exists(nb)
    assert_same_npz(na, nb)


def test_predictors_file(tmp_path):
    """``-w`` folds each listed period as ``_srcN`` (test_diagnostics.py
    ``test_predictors_file``)."""
    raw = write_raw(tmp_path)
    pf = tmp_path / "preds.txt"
    pf.write_text("0.007\n# comment\n0.003\n")
    a, b = run_both(tmp_path, [raw, *HDR, "-c", "0.005", "-F", "4", "-D",
                               "1", "-b", "16", "-w", str(pf)])
    assert_same_npz(a, b)
    for i in (1, 2):
        assert_same_npz(a.replace(".npz", f"_src{i}.npz"),
                        b.replace(".npz", f"_src{i}.npz"))


def test_single_pulse_and_nsub(tmp_path):
    """``-s --nsub 2``: single pulses, two a sequence-numbered archive
    (test_diagnostics.py ``test_single_pulse_and_nsub``)."""
    raw = write_raw(tmp_path, 1 << 17)
    a, b = run_both(tmp_path, [raw, *HDR, "-c", "0.004", "-F", "4", "-D",
                               "1", "-b", "16", "-s", "--nsub", "2"])
    parts = sorted(p for p in os.listdir(tmp_path) if p.startswith("t_"))
    assert len(parts) >= 2
    for p in parts:
        assert_same_npz(str(tmp_path / ("j" + p[1:])), str(tmp_path / p))
    assert load_archive(str(tmp_path / parts[0]))["profiles"].shape[0] == 2


def test_cepoch_moves_the_peak(tmp_path):
    """``--cepoch`` half a period later rotates the profile by half a turn,
    as in the JAX CLI (test_diagnostics.py ``test_cepoch_moves_the_peak``),
    and each archive equals the JAX CLI's."""
    rng = np.random.default_rng(1)
    ndat = 1 << 16
    t = np.arange(ndat) / 1e6
    noise = rng.normal(0, 10, (ndat, 2))
    noise[(t % 0.004) < 0.0004] *= 5.0
    raw = str(tmp_path / "cep.raw")
    with open(raw, "wb") as f:
        f.write(np.clip(np.round(noise + 127.5), 0, 255)
                .astype(np.uint8).tobytes())
    base = 55299.0871527777777
    peaks = []
    for i, cep in enumerate([base, base + 0.002 / 86400.0]):
        d = tmp_path / f"c{i}"
        d.mkdir()
        a, b = run_both(d, [raw, *HDR, "-c", "0.004", "-F", "4", "-D", "1",
                            "-b", "32", "--cepoch", f"{cep:.12f}"])
        _, zb = assert_same_npz(a, b)
        peaks.append(int(np.argmax(zb["profiles"][0].sum(axis=(0, 1)))))
    assert abs((peaks[0] - peaks[1]) % 32 - 16) <= 2, peaks


def test_repeat_soak_writes_sequence_archives(tmp_path):
    """``--repeat 2`` writes ``_r1`` and ``_r2`` beside the first archive,
    all three equal (test_signalpath.py
    ``test_repeat_soak_writes_sequence_archives``), and equal to the JAX
    CLI's."""
    p = synth_pulsar_dada(str(tmp_path / "r.dada"), nsec=0.05)
    a, b = run_both(tmp_path, [p, "-c", str(PERIOD), "-D", str(DM),
                               "--repeat", "2"])
    for suffix in ("", "_r1", "_r2"):
        assert_same_npz(a.replace(".npz", f"{suffix}.npz"),
                        b.replace(".npz", f"{suffix}.npz"))
    z = [load_archive(b.replace(".npz", f"{s}.npz"))["profiles"]
         for s in ("", "_r1", "_r2")]
    assert np.array_equal(z[0], z[1]) and np.array_equal(z[1], z[2])


def test_post_script_and_inline_job(tmp_path):
    """``-J SCRIPT`` runs on each written archive, and ``-j CMD`` goes to a
    temporary psrsh script that is removed after (test_diagnostics.py
    ``test_post_script_hook_runs``, ``test_inline_job``)."""
    raw = write_raw(tmp_path)
    marker = tmp_path / "seen.txt"
    script = tmp_path / "hook.sh"
    script.write_text(f"#!/bin/sh\necho \"$1\" >> {marker}\n")
    script.chmod(0o755)
    out = str(tmp_path / "pj.ar")
    assert tapp.main([raw, *HDR, *BASE, "-a", "psrfits", "-O", out, "-q",
                      "-J", str(script), "--device", "cpu"]) == 0
    assert out in marker.read_text()
    # -j: the commands go to psrsh in a temporary script, removed after
    for main, dev in ((japp.main, []), (tapp.main, ["--device", "cpu"])):
        before = sorted(os.listdir(tempfile.gettempdir()))
        assert main([raw, *HDR, *BASE, "-O", str(tmp_path / "j.npz"), "-q",
                     "-j", "#!/bin/sh\ntrue", *dev]) == 0
        assert sorted(os.listdir(tempfile.gettempdir())) == before


def test_parser_tokens_and_coercion():
    """The option parser takes the JAX CLI's tokens (``-2``, ``--skz_*``),
    and ``--set`` coerces by the declared field type (test_diagnostics.py
    ``test_excision_fixed_token``, ``test_set_coerces_bool_and_declared_
    types``), as the JAX CLI's ``coerce_set_value`` does."""
    from dspsr_tpu.apps.dspsr_app import coerce_set_value as jcoerce
    from dspsr_tpu.observation import Observation as JObs
    from dspsr_tpu.observation import Signal as JSignal
    from dspsr_tpu.timing.mjd import MJD as JMJD

    from dspsr_tpu_torch.observation import Observation, Signal
    from dspsr_tpu_torch.timing.mjd import MJD

    for argv in (["x", "-2", "n256:c4.5", "--skz_start", "1", "--skz_end",
                  "3"], ["x", "-2", "fixed"]):
        ta = tapp.build_parser().parse_args(argv)
        ja = japp.build_parser().parse_args(argv)
        for k, v in vars(ja).items():
            assert getattr(ta, k) == v, k
    assert tapp.build_parser().parse_args(["x", "-F", "64:D"]).nchan == 64
    with pytest.raises(SystemExit):
        tapp.build_parser().parse_args(["x", "-F", "64:B"])

    kw = dict(nchan=1, npol=2, ndim=1, nbit=8, centre_frequency=1400.0,
              bandwidth=-2.0, rate=1e6, source="X", telescope="PKS",
              instrument="T")
    o = Observation(start_time=MJD(55000, 0.1), state=Signal.NYQUIST, **kw)
    jo = JObs(start_time=JMJD(55000, 0.1), state=JSignal.NYQUIST, **kw)
    for key, val in (("dc_centred", "False"), ("dc_centred", "true"),
                     ("calfreq", "11.125"), ("nchan", "16")):
        got = tapp.coerce_set_value(o, key, val)
        want = jcoerce(jo, key, val)
        assert got == want and type(got) is type(want)
    assert tapp.coerce_set_value(o, "state", "Analytic") is Signal.ANALYTIC
    with pytest.raises(AttributeError):
        tapp.coerce_set_value(o, "no_such_field", "1")


def test_fft_bench_matches_jax(tmp_path, monkeypatch):
    """``--fft-bench`` with one cost table given to both FFTBenches (no
    timing): the same FFT length, so the same archive (the JAX fused step
    through its ``mega_reference``: ``test_torch_extras.reference_route``)."""
    import dspsr_tpu.utils.optimalfft as joff

    import dspsr_tpu_torch.utils.optimalfft as toff
    from test_torch_extras import cost_table, port_table, reference_route

    jdir, tdir = tmp_path / "jcache", tmp_path / "tcache"
    monkeypatch.setattr(joff, "_CACHE_DIR", str(jdir))
    monkeypatch.setattr(toff, "_CACHE_DIR", tdir)
    cost_table(jdir / "fftbench_cpu.json", best=256)
    cost_table(port_table(), best=256)
    reference_route(monkeypatch)
    raw = write_raw(tmp_path, 1 << 17)
    a, b = run_both(tmp_path, [raw, *HDR, "-c", "0.005", "-F", "4", "-D",
                               "30", "-b", "32", "--fft-bench"])
    za, zb = assert_same_npz(a, b)
    fb = [r for r in zb["meta"]["signal_path"] if r["op"] == "Filterbank"]
    assert fb[0]["freq_res"] == 256


def test_cuda_without_a_card_raises(tmp_path):
    """The default device is the card: with none present the CLI raises,
    it never falls back to the CPU."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present")
    raw = write_raw(tmp_path)
    for extra in ([], ["-t", "2"], ["-G", "8", "--plfb-chan", "16"]):
        with pytest.raises(RuntimeError):
            tapp.main([raw, *HDR, *BASE, "-q", *extra,
                       "-O", str(tmp_path / "x.npz")])


def test_minimum_integration_drops_short_subint(tmp_path):
    """``minimum_integration_length`` drops the trailing short
    sub-integration on the general chain, as in the JAX pipeline
    (test_diagnostics.py ``test_minimum_integration_drops_short_subint``;
    the CLI's ``--Lmin`` above)."""
    from dspsr_tpu.models import load_to_fold as jl

    from dspsr_tpu_torch.models import load_to_fold as tl
    from test_torch_pipeline import _assert_same, raw_source

    path = write_raw(tmp_path, 1 << 18, seed=3)
    base = dict(folding_period=0.004, dispersion_measure=3.0, nchan=4,
                nbin=32, block_parts=2, min_block_samples=0,
                use_megakernel=False, subint_seconds=0.05)
    runs = []
    for cut in (0.0, 0.045):
        cfg = dict(base, minimum_integration_length=cut)
        a = jl.FoldPipeline(raw_source("jax", path, rate=1e6),
                            jl.FoldConfig(**cfg)).run()
        b = tl.FoldPipeline(raw_source("port", path, rate=1e6),
                            tl.FoldConfig(**cfg), device="cpu").run()
        _assert_same(a, b)
        runs.append(b)
    full, cut = runs
    assert full.profiles.shape[0] > cut.profiles.shape[0] > 0
    assert (cut.integration_length >= 0.045).all()


def test_digifil_threads_option(tmp_path):
    """``digifil --threads 4`` (the CPU four times, by name) writes the JAX
    CLI's bytes (within 1 LSB, at least 99% exact), and ``-T`` cuts the
    sharded run short (test_diagnostics.py ``test_digifil_threads_option``).
    """
    from dspsr_tpu.apps import digifil_app as jdig
    from dspsr_tpu.io.dada import format_ascii_header, header_from_observation
    from dspsr_tpu.observation import Observation, Signal
    from dspsr_tpu.timing.mjd import MJD

    from dspsr_tpu_torch.apps import digifil_app as tdig

    rng = np.random.default_rng(1)
    obs = Observation(nchan=1, npol=2, ndim=1, nbit=8,
                      centre_frequency=1400.0, bandwidth=-2.0, rate=1e6,
                      start_time=MJD(55000, 0.2), state=Signal.NYQUIST,
                      source="X", telescope="PKS", instrument="T")
    p = str(tmp_path / "t.dada")
    with open(p, "wb") as f:
        f.write(format_ascii_header(header_from_observation(obs)))
        f.write(rng.integers(0, 256, 1 << 19).astype(np.uint8).tobytes())
    sizes = {}
    for cut in ([], ["-T", "0.08"]):
        outs = []
        for tag, main, dev in (("j", jdig.main, []),
                               ("t", tdig.main, ["--device", "cpu"])):
            out = str(tmp_path / f"{tag}{len(cut)}.fil")
            assert main([p, "-o", out, "-F", "4", "-D", "2", "-b", "8",
                         "--threads", "4", "-c", "-q", *cut, *dev]) == 0
            outs.append(np.fromfile(out, np.uint8).astype(np.int64))
        a, b = outs
        assert a.size == b.size > 0
        diff = np.abs(a - b)
        assert diff.max() <= 1 and (diff == 0).mean() >= 0.99
        sizes[len(cut)] = b.size
    assert 0 < sizes[2] < sizes[0] and sizes[0] > 1000
