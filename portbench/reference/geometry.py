"""Block geometry of the coherent filterbank, worked out from a deployment.

The dspsr formulas (``Dedispersion.C:385-475`` for the smear, the
analytic FFT-length choice, ``Filterbank.C:55-263`` for the windows), and
the fused path's rounding of the overlap to whole 8-row groups of its
``[rows, R2]`` view, which the pipeline adopts as its block geometry.
Plain Python on integers and float64: nothing of the program.
"""

from __future__ import annotations

import math
from dataclasses import dataclass

#: MHz^2 pc^-1 cm^3 s (``Dedispersion.C:28``)
DM_DISPERSION = 2.41e-4
#: fractional guard on the smearing time (``Dedispersion.C:30``)
SMEARING_BUFFER = 0.1
#: the largest FFT the deployment may choose (dspsr's default)
MAX_NFFT = 1 << 24


def half_smearing_samples(dm: float, cfreq: float, bw: float, nchan: int,
                          half: int) -> int:
    """Complex samples of smear in the upper (+1) or lower (-1) half of the
    lowest channel, with the 10% guard (``Dedispersion.C:385-475``)."""
    ch_abs_bw = abs(bw) / nchan
    lowest = cfreq - (abs(bw) - ch_abs_bw) / 2.0
    half_bw = ch_abs_bw / 2.0
    centre = lowest + half * half_bw
    f1 = centre - abs(0.5 * half_bw)
    f2 = centre + abs(0.5 * half_bw)
    tsmear = dm / DM_DISPERSION * (1.0 / f1 ** 2 - 1.0 / f2 ** 2)
    return int(math.ceil(abs(tsmear) * (1.0 + SMEARING_BUFFER)
                         * ch_abs_bw * 1e6))


def choose_nfft(nfilt_tot: int, max_nfft: int = MAX_NFFT) -> int:
    """The power of two that minimises ``N log2 N / (N - nfilt)``, the FFT
    work a kept sample."""
    n = 16
    while n <= nfilt_tot:
        n *= 2
    best_n, best_cost = None, None
    while n <= max_nfft:
        cost = n * math.log2(max(n, 2)) / (n - nfilt_tot)
        if best_cost is None or cost < best_cost:
            best_n, best_cost = n, cost
        if n > 4 * best_n:
            break
        n *= 2
    return best_n


def first_radix(n_fft: int, freq_res: int) -> int:
    """R1, the rows of the fused path's ``[R1, R2]`` view of a window's
    spectrum: about sqrt(N), dividing freq_res, at most 1024, with R2 at
    most 4096 where R1 can grow."""
    r1 = 1 << (n_fft.bit_length() // 2)
    r1 = min(r1, freq_res, 1024)
    while n_fft // r1 > 4096 and r1 * 2 <= min(freq_res, 1024):
        r1 *= 2
    return r1


@dataclass(frozen=True)
class Geometry:
    """One block of real-sampled (Nyquist) input of ``npol`` pols, one
    input channel split into ``nsub`` coherently dedispersed subbands."""

    nsub: int
    freq_res: int
    R1: int
    nfilt_pos: int
    nfilt_neg: int
    npart: int
    npol: int
    nbin: int
    rate: float

    @property
    def n_fft(self) -> int:
        return self.nsub * self.freq_res

    @property
    def nsamp_fft(self) -> int:
        """Real samples a window."""
        return 2 * self.n_fft

    @property
    def nkeep(self) -> int:
        return self.freq_res - self.nfilt_pos - self.nfilt_neg

    @property
    def nsamp_step(self) -> int:
        return self.nsamp_fft - 2 * self.nsub * (self.nfilt_pos
                                                 + self.nfilt_neg)

    @property
    def block_ndat(self) -> int:
        """Input samples a block, overlap included."""
        return self.npart * self.nsamp_step + self.nsamp_fft \
            - self.nsamp_step

    @property
    def stride_ndat(self) -> int:
        """Input samples from one block's start to the next's."""
        return self.npart * self.nsamp_step

    @property
    def block_bytes(self) -> int:
        return self.block_ndat * self.npol

    @property
    def stride_bytes(self) -> int:
        return self.stride_ndat * self.npol

    @property
    def out_rate(self) -> float:
        """Output samples a second in each subband."""
        return self.rate * (self.freq_res / self.nsamp_fft)

    @property
    def out_per_block(self) -> int:
        return self.npart * self.nkeep

    @property
    def sky_seconds(self) -> float:
        """Seconds of sky one block advances."""
        return self.stride_ndat / self.rate


def geometry(config: dict, dm: float, nbin: int = 0) -> Geometry:
    """The block geometry of ``config`` (a configuration file's keys) at
    dispersion measure ``dm``."""
    if config["state"] != "nyquist" or config["nchan_in"] != 1:
        raise ValueError("the reference takes one real-sampled channel")
    nsub = config["nchan"]
    cfreq, bw = config["centre_frequency_mhz"], config["bandwidth_mhz"]
    nfp = half_smearing_samples(dm, cfreq, bw, nsub, +1)
    nfn = half_smearing_samples(dm, cfreq, bw, nsub, -1)
    freq_res = choose_nfft(nfp + nfn)
    r1 = first_radix(nsub * freq_res, freq_res)
    q = freq_res // r1
    nfilt = nfp + nfn
    rounded = -(-nfilt // (8 * q)) * (8 * q)
    nfn += rounded - nfilt
    g = Geometry(nsub=nsub, freq_res=freq_res, R1=r1, nfilt_pos=nfp,
                 nfilt_neg=nfn, npart=1, npol=config["npol"], nbin=nbin,
                 rate=float(config["rate_hz"]))
    npart = max(-(-config["min_block_samples"] // g.nsamp_step),
                config["block_parts"])
    return Geometry(**{**g.__dict__, "npart": npart})
