"""The port's diagnostics tools (``dspsr_tpu_torch.apps.diagnostics``, the
five that unpack with ``--device cpu``) and ``searchplot``
(``dspsr_tpu_torch.apps.searchplot_app``, ``--torch-device cpu``) against
the JAX package's on the same argv and files: the cases of
``tests/test_diagnostics.py`` and ``tests/test_searchplot.py``.

What each compares: the printed text exactly where the two print the same
values (the host tools, digihist's counts, digitxt's unpacked samples,
searchplot's sums); otherwise each printed number, counts exactly and
floats within 1e-5 relative (passband, with a float32 FFT on its path:
2e-4), plus the unrounded statistics of ``sample_stats`` against numpy on
the JAX package's unpack at 1e-5.  Means near zero are printed to 1e-4, so
a printed mean may also differ by one unit of its last digit.
"""

import os
import re

import numpy as np
import pytest
import torch

from dspsr_tpu.apps import diagnostics as jdiag
from dspsr_tpu.apps import searchplot_app as jsp

from dspsr_tpu_torch.apps import diagnostics as tdiag
from dspsr_tpu_torch.apps import searchplot_app as tsp

torch.set_num_threads(2)

DEVICE_TOOLS = ("digistat", "digihist", "digitxt", "passband", "digimon")


def mkdada(path, payload: bytes, nbit=8, npol=1, ndim=1, nchan=1):
    """``test_diagnostics._mkdada``: a DADA file of ``payload``."""
    hdr = (f"HDR_VERSION 1.0\nHDR_SIZE 4096\nBW 4.0\nFREQ 1400.0\n"
           f"NCHAN {nchan}\nNPOL {npol}\nNDIM {ndim}\nNBIT {nbit}\n"
           "TSAMP 0.125\nUTC_START 2010-04-13-02:05:45\nOBS_OFFSET 0\n"
           "SOURCE DIAG\nTELESCOPE PKS\nINSTRUMENT TEST\n").encode()
    with open(path, "wb") as f:
        f.write(hdr + b"\0" * (4096 - len(hdr)))
        f.write(payload)
    return str(path)


def run_both(capsys, tool, argv, device=True):
    """``tool argv`` through the JAX package's and the port's tool
    (``--device cpu`` where the port's tool unpacks): their stdouts."""
    outs = []
    for mod, extra in ((jdiag, []),
                       (tdiag, ["--device", "cpu"] if device else [])):
        assert getattr(mod, tool)([*argv, *extra]) == 0
        outs.append(capsys.readouterr().out)
    return outs


NUM = re.compile(r"[-+]?\d+\.?\d*(?:[eE][-+]?\d+)?")


def same_numbers(a: str, b: str, rel: float, quantum: bool = False):
    """``a`` and ``b`` alike but for their numbers; integers equal, floats
    within ``rel`` relative (or, with ``quantum``, one unit of the printed
    last digit)."""
    assert NUM.sub("#", a) == NUM.sub("#", b)
    for x, y in zip(NUM.findall(a), NUM.findall(b)):
        if "." not in x and "e" not in x.lower():
            assert x == y
            continue
        fx, fy = float(x), float(y)
        step = 10.0 ** -len(x.split(".")[1].split("e")[0]) if quantum else 0
        assert abs(fx - fy) <= rel * max(abs(fx), abs(fy)) + step * 1.0001, \
            (x, y)


def gauss8(rng, mean, sigma, n=1 << 16):
    from dspsr_tpu.unpack.bittable import optimal_spacing

    d = optimal_spacing(8)
    x = rng.normal(mean, sigma / d, size=n)
    return np.clip(np.round(x) + 128, 0, 255).astype(np.uint8)


@pytest.mark.parametrize("case", ["quiet", "offset", "good"])
def test_digimon_matches_jax(tmp_path, capsys, rng, case):
    """GAIN while 3x too quiet (no LEVEL while far from good), LEVEL for
    a +5 code offset, nothing for good levels (test_diagnostics.py
    ``TestDigimon``), as the JAX tool prints them."""
    codes = {"quiet": gauss8(rng, 8.0, 1.0 / 3.0),
             "offset": gauss8(rng, 5.0, 1.0),
             "good": gauss8(rng, 0.0, 1.0)}[case]
    p = mkdada(tmp_path / f"{case}.dada", codes.tobytes())
    tol = ["--var-tolerance", "0.05", "--mean-tolerance", "0.05"] \
        if case == "good" else []
    a, b = run_both(capsys, "digimon", [p, "-n", "32768", "-i", "2", *tol])
    same_numbers(a, b, 1e-5)
    lines = b.strip().splitlines()
    if case == "quiet":
        gains = [float(l.split()[4]) for l in lines if l.startswith("GAIN")]
        assert gains and 2.0 < gains[0] < 4.5
        assert not any(l.startswith("LEVEL") for l in lines)
    elif case == "offset":
        levels = [float(l.split()[4]) for l in lines
                  if l.startswith("LEVEL")]
        assert levels and 0.1 < levels[0] < 0.3
    else:
        assert "GAIN" not in b and "LEVEL" not in b


def test_load_bits(tmp_path, capsys):
    payload = bytes([0b10110001, 0b00000000, 0b11111111])
    p = mkdada(tmp_path / "bits.dada", payload + b"\0" * 61)
    a, b = run_both(capsys, "load_bits", [p, "-n", "3"], device=False)
    assert a == b
    assert b.strip().splitlines() == ["10110001", "00000000", "11111111"]


def test_cbird(tmp_path, capsys):
    nchan = 256
    rng = np.random.default_rng(7)
    freq = np.linspace(1300.0, 1400.0, nchan)
    power = (1.0 + 0.1 * np.sin(np.arange(nchan) / 17.0)
             + rng.normal(0, 0.02, nchan))
    power[100], power[200] = 8.0, 6.0
    p = str(tmp_path / "band.txt")
    np.savetxt(p, np.column_stack([freq, power]))
    a, b = run_both(capsys, "cbird", [p, "-t", "4.0", "-w", "0.05"],
                    device=False)
    assert a == b
    chans = [int(l.split()[0]) for l in b.strip().splitlines()]
    assert 100 in chans and 200 in chans and len(chans) <= 6


@pytest.mark.parametrize("argv", [["-m", "128", "-M", "256", "-s", "3"],
                                  ["-m", "1024", "-s", "4"]])
def test_sklimit(capsys, argv):
    from dspsr_tpu_torch.utils.stats import sk_limits

    a, b = run_both(capsys, "sklimit", argv, device=False)
    assert a == b
    rows = b.strip().splitlines()
    t = sk_limits(int(argv[1]), float(argv[-1]))
    assert abs(float(rows[1].split()[2]) - t.lower) < 1e-6
    assert abs(float(rows[1].split()[3]) - t.upper) < 1e-6


@pytest.mark.parametrize("argv", [["-d", "2.64", "-f", "1382", "-b",
                                   "-400", "-n", "64"],
                                  ["-d", "71", "-f", "1400", "-b", "400",
                                   "-n", "2048"]])
def test_dmsmear(capsys, argv):
    a, b = run_both(capsys, "dmsmear", argv, device=False)
    assert a == b and "Suggested FFT length" in b


def _files(tmp_path, rng):
    """8-bit real 2-pol, 8-bit complex 2-chan, JA98 2-bit 2-chan 2-pol
    (clean blocks but one saturated stretch) and 4-bit real 2-chan DADA
    files of the diagnostics geometry."""
    from test_torch_twobit import clean_twobit_codes, pack2

    f = {}
    f["real8"] = mkdada(tmp_path / "real8.dada",
                        gauss8(rng, 0.0, 1.0, 1 << 15).tobytes(), npol=2)
    f["cplx8"] = mkdada(tmp_path / "cplx8.dada",
                        gauss8(rng, 1.0, 1.0, 1 << 15).tobytes(), nchan=2,
                        npol=2, ndim=2)
    codes = clean_twobit_codes(rng, 8192, 4, 512)
    codes[1000:1600, 0] = 3  # a saturated stretch that JA98 excises
    f["ja98"] = mkdada(tmp_path / "ja98.dada", pack2(codes.reshape(-1)),
                       nbit=2, nchan=2, npol=2)
    f["real4"] = mkdada(tmp_path / "real4.dada",
                        rng.integers(0, 256, 1 << 13, dtype=np.uint8
                                     ).tobytes(), nbit=4, nchan=2)
    return f


KINDS = ["real8", "cplx8", "ja98", "real4"]


@pytest.mark.parametrize("kind", KINDS)
def test_digistat_matches_jax(tmp_path, capsys, rng, kind):
    """Statistics within 1e-5 (or the printed digit), the histogram and the
    excised share exactly; ``sample_stats`` against numpy in float64 on
    the JAX package's unpack at 1e-5."""
    import jax.numpy as jnp

    from dspsr_tpu.io.sources import open_source as jopen
    from dspsr_tpu.unpack.unpackers import UnpackPlan as JPlan

    p = _files(tmp_path, rng)[kind]
    a, b = run_both(capsys, "digistat", [p, "-n", "4096", "-S", "512"])
    same_numbers(a, b, 1e-5, quantum=True)
    if kind == "ja98":
        assert "excision" in b and "0.000%" not in b

    from dspsr_tpu_torch.io.sources import open_source

    src = open_source(p)
    _, x, _ = tdiag._unpack(src, 512, 4096, "cpu")
    st = tdiag.sample_stats(x)
    jsrc = jopen(p)
    jx, _ = JPlan(jsrc.obs).unpack(jnp.asarray(jsrc.read_samples(512, 4096)))
    if isinstance(jx, tuple):
        d = np.stack([np.asarray(jx[0]), np.asarray(jx[1])], axis=-1)
    else:
        d = np.asarray(jx)[..., None]
    d = d.astype(np.float64).reshape(d.shape[0], d.shape[1], -1)
    for k, want in (("mean", d.mean(-1)), ("rms", d.std(-1)),
                    ("min", d.min(-1)), ("max", d.max(-1))):
        assert np.abs(st[k] - want).max() <= 1e-5 * np.abs(d).max(), k


@pytest.mark.parametrize("kind", KINDS)
def test_digihist_and_digitxt_match_jax(tmp_path, capsys, rng, kind):
    """Counts of each digitizer state, and the unpacked samples as text,
    exactly the JAX tools'."""
    p = _files(tmp_path, rng)[kind]
    a, b = run_both(capsys, "digihist", [p, "-n", "4096"])
    assert a == b
    counts = [sum(int(v) for v in l.split(":")[1].split())
              for l in b.strip().splitlines()]
    assert len(set(counts)) == 1 and counts[0] > 0
    # JA98 unpacks whole 512-sample weight blocks only
    a, b = run_both(capsys, "digitxt", [p, "-n", "1024", "-S", "1024"])
    assert a == b and len(b.strip().splitlines()) == 1024


@pytest.mark.parametrize("nbit,hist_size", [(1, 0), (2, 0), (2, 3),
                                             (4, 0), (8, 0), (8, 300)])
def test_digitizer_histogram_matches_jax(rng, nbit, hist_size):
    """``unpack.unpackers.digitizer_histogram`` (digistat's and digihist's
    one histogram) against the JAX function, exactly; with ``ndig``
    interleaved digitizers, each row is numpy's count of that digitizer's
    codes."""
    from dspsr_tpu.unpack.unpackers import (bytes_to_codes,
                                            digitizer_histogram)

    from dspsr_tpu_torch.unpack import unpackers as tu

    raw = rng.integers(0, 256, 3001, dtype=np.uint8)
    got = tu.digitizer_histogram(torch.from_numpy(raw), nbit, hist_size)
    want = np.asarray(digitizer_histogram(raw, nbit, hist_size))
    assert got.dtype == torch.int64
    np.testing.assert_array_equal(got.numpy(), want)
    codes = np.asarray(bytes_to_codes(raw, nbit)).astype(np.int64)
    ndig = 6
    rows = tu.digitizer_histogram(torch.from_numpy(raw), nbit, hist_size,
                                  ndig=ndig).numpy()
    n = hist_size or (1 << nbit)
    codes = codes[: codes.size // ndig * ndig].reshape(-1, ndig)
    for d in range(ndig):
        c = codes[:, d]
        np.testing.assert_array_equal(
            rows[d], np.bincount(c[c < n], minlength=n))


@pytest.mark.parametrize("kind,nchan", [("real8", 16), ("cplx8", 8),
                                        ("ja98", 32)])
def test_passband_matches_jax(tmp_path, capsys, rng, kind, nchan):
    p = _files(tmp_path, rng)[kind]
    a, b = run_both(capsys, "passband", [p, "-F", str(nchan), "-n", "8192"])
    same_numbers(a, b, 2e-4)
    assert len(b.strip().splitlines()) == nchan


def test_digihdr(tmp_path, capsys, rng):
    for p in _files(tmp_path, rng).values():
        a, b = run_both(capsys, "digihdr", [p], device=False)
        assert a == b and "NBIT" in b


def test_dispatcher(capsys):
    assert tdiag.main([]) == 2
    assert "usage: diagnostics" in capsys.readouterr().err
    assert set(tdiag.TOOLS) == {"dmsmear", "digihdr", "digistat",
                                "digihist", "digitxt", "passband",
                                "digimon", "load_bits", "cbird", "sklimit"}
    assert tdiag.main(["sklimit", "-m", "64"]) == 0
    assert capsys.readouterr().out.startswith("# M")


@pytest.mark.parametrize("tool", DEVICE_TOOLS)
def test_device_tools_need_the_card(tmp_path, rng, tool):
    """With no ``--device``, a tool that unpacks runs on the card, and
    raises where there is none: never falls back to the CPU."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present")
    p = _files(tmp_path, rng)["real8"]
    with pytest.raises(RuntimeError):
        getattr(tdiag, tool)([p, "-n", "4096"])


# ------------------------------------------------------------- searchplot


@pytest.fixture
def dispersed_fil(tmp_path):
    """``test_searchplot.py``'s 8-bit filterbank with one dispersed pulse,
    written by the JAX package's SIGPROC writer."""
    from dspsr_tpu.io.sigproc import SigProcWriter
    from dspsr_tpu.observation import Observation, Signal
    from dspsr_tpu.timing.mjd import MJD

    nchan, nsamp, dm, rate = 64, 4096, 30.0, 10e3
    obs = Observation(nchan=nchan, npol=1, ndim=1, nbit=8,
                      centre_frequency=1400.0, bandwidth=-64.0, rate=rate,
                      start_time=MJD.from_mjd(55000.0),
                      state=Signal.INTENSITY, source="FAKE_PSR")
    rng = np.random.default_rng(7)
    data = rng.normal(40.0, 4.0, (nsamp, nchan))
    path = str(tmp_path / "pulse.fil")
    w = SigProcWriter(path, obs, 8)
    shifts = jsp.dedisperse_shifts(obs, dm)
    t_pulse = 1000
    for c in range(nchan):
        data[t_pulse + shifts[c], c] += 80.0
    w.write_block(np.clip(data, 0, 255).astype(np.uint8).ravel())
    w.close()
    return path, obs, dm, t_pulse, rate


def test_sigproc_source_registered(dispersed_fil):
    from dspsr_tpu_torch.io import open_source
    from dspsr_tpu_torch.io.sigproc import SigProcFile

    path, obs, *_ = dispersed_fil
    src = open_source(path)
    assert isinstance(src, SigProcFile)
    assert src.obs.nchan == obs.nchan and src.total_samples == 4096
    assert src.read_detected(0, 16).shape == (16, 1, 64)
    assert src.read_samples(4090, 16)[6 * 64:].max() == 0


def _searchplot_both(tmp_path, monkeypatch, argv):
    """``argv`` through both searchplot apps, each in its own directory
    (``-s`` writes ``searchplot.out`` there): the two directories."""
    dirs = []
    for tag, main, extra in (("j", jsp.main, []),
                             ("t", tsp.main, ["--torch-device", "cpu"])):
        d = tmp_path / tag
        d.mkdir()
        monkeypatch.chdir(d)
        assert main([*argv, *extra]) == 0
        dirs.append(d)
    return dirs


def test_dedispersed_sum_recovers_pulse(dispersed_fil, tmp_path,
                                        monkeypatch):
    path, obs, dm, t_pulse, rate = dispersed_fil
    for shifts in (tsp.dedisperse_shifts(obs, dm),):
        assert np.array_equal(shifts, jsp.dedisperse_shifts(obs, dm))
    jd, td = _searchplot_both(tmp_path, monkeypatch,
                              [path, "-K", "-D", str(dm), "-s", "-g",
                               "k.png"])
    assert (td / "searchplot.out").read_text() == \
        (jd / "searchplot.out").read_text()
    assert os.path.getsize(td / "k.png") > 2000
    t, summed = np.loadtxt(td / "searchplot.out").T
    peak = int(np.argmax(summed))
    assert abs(peak - t_pulse) <= 1
    assert t[peak] == pytest.approx(t_pulse / rate, abs=2 / rate)


@pytest.mark.parametrize("argv", [["-F", "-H"], ["-F", "-l", "0.1"]],
                         ids=["waterfall_histogram", "last_seconds"])
def test_pngs(dispersed_fil, tmp_path, monkeypatch, argv):
    path, *_ = dispersed_fil
    jd, td = _searchplot_both(tmp_path, monkeypatch,
                              [path, *argv, "-g", "fh.png"])
    assert os.path.getsize(td / "fh.png") > 2000


@pytest.mark.parametrize("kind", ["real8", "cplx8"])
def test_baseband_sum_matches_jax(tmp_path, monkeypatch, rng, kind):
    """Baseband input is unpacked and detected on ``--torch-device``: the
    summed channels equal the JAX app's (1e-5)."""
    p = _files(tmp_path, rng)[kind]
    jd, td = _searchplot_both(tmp_path, monkeypatch, [p, "-s", "-l",
                                                      "0.002"])
    a = np.loadtxt(jd / "searchplot.out")
    b = np.loadtxt(td / "searchplot.out")
    assert a.shape == b.shape and len(b) > 1000
    assert np.array_equal(a[:, 0], b[:, 0])
    assert np.abs(a[:, 1] - b[:, 1]).max() <= 1e-5 * np.abs(a[:, 1]).max()


def test_searchplot_needs_the_card(tmp_path, rng, monkeypatch):
    """Baseband input with no ``--torch-device`` unpacks on the card, and
    raises where there is none; ``-g`` still names the plot file."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present")
    monkeypatch.chdir(tmp_path)
    p = _files(tmp_path, rng)["real8"]
    with pytest.raises(RuntimeError):
        tsp.main([p, "-s", "-g", "x.png"])
