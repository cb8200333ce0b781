"""Measured-cost FFT length selection.

Counterpart of ``dspsr_tpu/utils/optimalfft.py`` (reference
``dsp::OptimalFFT`` + ``FTransform::Bench``,
``Signal/General/OptimalFFT.C:18-171``, enabled by ``--fft-bench``): instead
of the analytic N*log2(N) model (``ops.response.choose_nfft``), time the
transform the pipeline runs, ``torch.fft.fft`` on ``complex64``, on the
pipeline's own device for each candidate length, and minimise the measured
cost per useful output sample, cost(N) = t(N) / (N - nfilt_tot).

Timings are cached as a JSON table (``{"N": seconds}``, the JAX package's
format) in ``build/dspsr_tpu_torch/fftbench/`` at the repository root, one
file per device (``cpu``, or ``cuda-<card name>``) and method (``MIN_POINTS``
and the batch): a table measured on one device, or measured another way,
never chooses a length.

The bench times the library's transform, which the fused engine
(``megastep``/``megafil``, its own FFTs) does not run: its choice models the
general chain's cost and only approximates the fused kernels'.
"""

from __future__ import annotations

import json
import re
import time
from pathlib import Path
from typing import Dict, Optional

import torch

from ..device import resolve_device

_CACHE_DIR = (Path(__file__).resolve().parents[2] / "build"
              / "dspsr_tpu_torch" / "fftbench")


def device_key(device: torch.device) -> str:
    """The cache key of ``device``: ``cpu``, or ``cuda-`` and the card's
    name with every run of other characters than letters, digits, ``.``
    and ``-`` made one ``_``."""
    if device.type != "cuda":
        return device.type
    name = torch.cuda.get_device_name(device)
    return "cuda-" + re.sub(r"[^A-Za-z0-9.-]+", "_", name)


#: points a timed call transforms at least: the pipeline transforms whole
#: blocks of windows at once, so a call of a few short rows would time the
#: launch and not the transform (on an H100, batches of 8 rows cost about
#: one launch, 3-6 us, at every length up to 2^18)
MIN_POINTS = 1 << 22


class FFTBench:
    """Measured seconds per ``complex64`` transform of length N on
    ``device`` (``"cuda"`` by default; the CPU must be asked for by name):
    a call transforms ``batch`` rows, or as many as make ``MIN_POINTS``
    points."""

    def __init__(self, device="cuda", batch: int = 8, trials: int = 5,
                 cache: bool = True):
        self.device = resolve_device(device)
        self.batch = batch
        self.trials = trials
        self.cache = cache
        self._table: Dict[int, float] = {}
        if cache:
            self._load()

    @property
    def _cache_path(self) -> Path:
        return Path(_CACHE_DIR) / (f"fftbench_{device_key(self.device)}"
                                   f"_min{MIN_POINTS}_batch{self.batch}.json")

    def _load(self) -> None:
        try:
            with open(self._cache_path) as f:
                self._table = {int(k): float(v)
                               for k, v in json.load(f).items()}
        except (OSError, ValueError):
            self._table = {}

    def _save(self) -> None:
        try:
            self._cache_path.parent.mkdir(parents=True, exist_ok=True)
            with open(self._cache_path, "w") as f:
                json.dump({str(k): v for k, v in self._table.items()}, f)
        except OSError:
            pass  # the cache is best-effort

    def _sync(self) -> None:
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def time_fft(self, n: int) -> float:
        """Seconds per forward transform of length ``n`` (measured once,
        then cached): one untimed call first, the device synchronised
        before each reading of the clock."""
        if n in self._table:
            return self._table[n]
        batch = max(self.batch, -(-MIN_POINTS // n))
        x = torch.randn((batch, n), dtype=torch.complex64,
                        generator=torch.Generator().manual_seed(0)
                        ).to(self.device)
        torch.fft.fft(x, dim=-1)
        self._sync()
        t0 = time.perf_counter()
        for _ in range(self.trials):
            torch.fft.fft(x, dim=-1)
        self._sync()
        dt = (time.perf_counter() - t0) / (self.trials * batch)
        self._table[n] = dt
        if self.cache:
            self._save()
        return dt


class OptimalFFT:
    """Choose the FFT length minimising measured cost per useful sample."""

    def __init__(self, bench: Optional[FFTBench] = None):
        self.bench = bench or FFTBench()

    def get_best_ndat(self, nfilt_tot: int, nchan_subband: int = 1,
                      max_nfft: int = 1 << 22) -> int:
        """Reference ``OptimalFFT::get_best_ndat``: scan powers of two above
        the smear, stop after two rises; return the total forward length
        (x nchan_subband)."""
        if nfilt_tot < 0:
            raise ValueError("negative smear")
        n = 16
        while n <= nfilt_tot:
            n *= 2
        best_n, best_cost = None, None
        rising = 0
        while n <= max_nfft:
            keep = n - nfilt_tot
            cost = self.bench.time_fft(n * nchan_subband) / keep
            if best_cost is None or cost < best_cost:
                best_n, best_cost = n, cost
                rising = 0
            else:
                rising += 1
                if rising >= 2:  # measured cost a sample is noisy-unimodal
                    break
            n *= 2
        return best_n * nchan_subband

    def compute_cost(self, nfft: int, nfilt_tot: int) -> float:
        """Measured seconds per useful output sample at length nfft."""
        return self.bench.time_fft(nfft) / max(nfft - nfilt_tot, 1)
