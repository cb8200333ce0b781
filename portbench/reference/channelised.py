"""The coherent filterbank of channelised complex input, plain PyTorch.

The input is ``nchan_in`` critically sampled complex channels, as a
beamformer delivers them (SKA1-Mid Band 2: 81 channels of 10 MHz), 8-bit
offset-binary, dual-pol, time major: one time sample holds every channel's
pols, each a real and an imaginary code (TFP).  dspsr's convolving
filterbank (``Filterbank.C:477-670``) runs on each channel alone:

1. unpack each code to ``(code - 127.5) * level_step()`` (``BitTable``);
2. each window of ``n_fft`` complex samples, ``nsamp_step`` apart: the
   unscaled ``n_fft``-point complex FFT, its bins in centred order
   (``fftshift``): bin ``j`` lies ``(j - n_fft / 2)`` bins of ``bw_c /
   n_fft`` from the channel's centre, ``bw_c`` its signed width;
3. times that channel's own chirp (``Dedispersion.C:478-556``), built from
   the channel's centre frequency and width, ``nsub`` subbands of
   ``freq_res`` points;
4. each subband's ``freq_res`` bins inverse-transformed (``1 / freq_res``),
   keeping ``nkeep`` samples from ``nfilt_pos`` on;
5. ``|x|^2`` summed over the two pols (``PP + QQ``).

The output is ``[nchan_in * nsub, npart * nkeep]``: output channel ``c *
nsub + s`` is subband ``s`` of channel ``c``, each channel's subbands in the
order of its signed width, as dspsr numbers them.  ``Precision`` rounds as
in ``filterbank.py``.  The block geometry is dspsr's (``Dedispersion.C:
385-475`` over the band's ``nchan_in * nsub`` output channels, the FFT
length that costs least a kept sample), with the overlap rounded up to
whole 8-row groups of the fused path's ``[rows, R2]`` view, which the
pipeline adopts.  Float64; imports nothing of the program.
"""

from __future__ import annotations

import math
from dataclasses import dataclass

import torch

from .filterbank import Precision
from .geometry import DM_DISPERSION, choose_nfft, first_radix, \
    half_smearing_samples
from .levels import level_step


@dataclass(frozen=True)
class ChannelGeometry:
    """One block of ``nchan_in`` complex channels of ``npol`` pols, each
    channel split into ``nsub`` coherently dedispersed subbands.  ``rate``
    is complex samples a second in each channel."""

    nchan_in: int
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
    def nchan(self) -> int:
        """Output channels of the band."""
        return self.nchan_in * self.nsub

    @property
    def n_fft(self) -> int:
        """Complex samples a window, and points of its forward FFT."""
        return self.nsub * self.freq_res

    @property
    def nkeep(self) -> int:
        return self.freq_res - self.nfilt_pos - self.nfilt_neg

    @property
    def nsamp_step(self) -> int:
        return self.n_fft - self.nsub * (self.nfilt_pos + self.nfilt_neg)

    @property
    def block_ndat(self) -> int:
        """Time samples a block, overlap included."""
        return self.npart * self.nsamp_step + self.n_fft - self.nsamp_step

    @property
    def stride_ndat(self) -> int:
        return self.npart * self.nsamp_step

    @property
    def sample_bytes(self) -> int:
        """Bytes of one time sample: every channel's pols, two codes each."""
        return self.nchan_in * self.npol * 2

    @property
    def block_bytes(self) -> int:
        return self.block_ndat * self.sample_bytes

    @property
    def stride_bytes(self) -> int:
        return self.stride_ndat * self.sample_bytes

    @property
    def out_rate(self) -> float:
        """Output samples a second in each subband."""
        return self.rate * (self.freq_res / self.n_fft)

    @property
    def out_per_block(self) -> int:
        return self.npart * self.nkeep

    @property
    def sky_seconds(self) -> float:
        return self.stride_ndat / self.rate


def channel_geometry(config: dict, dm: float, nbin: int = 0
                     ) -> ChannelGeometry:
    """The block geometry of ``config`` (a configuration file's keys:
    complex input, ``state`` ``analytic``) at dispersion measure ``dm``."""
    if config["state"] != "analytic" or config["ndim"] != 2:
        raise ValueError("the channelised reference takes complex channels")
    nchan_in, nchan = config["nchan_in"], config["nchan"]
    if nchan % nchan_in:
        raise ValueError(f"{nchan} output channels do not split "
                         f"{nchan_in} input channels evenly")
    nsub = nchan // nchan_in
    cfreq, bw = config["centre_frequency_mhz"], config["bandwidth_mhz"]
    # the smear of the band's lowest output channel sizes every channel's
    nfp = half_smearing_samples(dm, cfreq, bw, nchan, +1)
    nfn = half_smearing_samples(dm, cfreq, bw, nchan, -1)
    freq_res = choose_nfft(nfp + nfn)
    r1 = first_radix(nsub * freq_res, freq_res)
    q = freq_res // r1
    nfilt = nfp + nfn
    # departure: the fused path's rounding of the overlap (see the top)
    nfn += -(-nfilt // (8 * q)) * (8 * q) - nfilt
    g = ChannelGeometry(nchan_in=nchan_in, nsub=nsub, freq_res=freq_res,
                        R1=r1, nfilt_pos=nfp, nfilt_neg=nfn, npart=1,
                        npol=config["npol"], nbin=nbin,
                        rate=float(config["rate_hz"]))
    npart = max(-(-config["min_block_samples"] // g.nsamp_step),
                config["block_parts"])
    return ChannelGeometry(**{**g.__dict__, "npart": npart})


def channel_chirp(g: ChannelGeometry, dm: float, cfreq: float, bw: float,
                  device) -> torch.Tensor:
    """Each channel's chirp, complex128 ``[nchan_in, n_fft]``: its
    subbands in turn, each ``freq_res`` bins from its lower band edge in the
    order of the signed width.  Built channel by channel from the channel's
    own centre frequency and width, as ``Dedispersion.C:478-556`` builds a
    response of ``nsub`` channels of ``freq_res`` points."""
    bw_c = bw / g.nchan_in
    sign = bw / abs(bw)
    chanwidth = bw_c / g.nsub
    binwidth = chanwidth / g.freq_res
    per_mhz = 1e6 * dm / DM_DISPERSION
    c = torch.arange(g.nchan_in, dtype=torch.float64, device=device)
    centre = cfreq - 0.5 * bw + (c + 0.5) * bw_c
    s = torch.arange(g.nsub, dtype=torch.float64, device=device)
    # [nchan_in, nsub]: each subband's centre frequency
    f0 = (centre - 0.5 * bw_c + 0.5 * chanwidth)[:, None] + s * chanwidth
    coeff = -sign * 2.0 * math.pi * per_mhz / f0 ** 2
    f = torch.arange(g.freq_res, dtype=torch.float64, device=device) \
        * binwidth - 0.5 * chanwidth
    phase = coeff[..., None] * f ** 2 / (f0[..., None] + f)
    h = torch.polar(torch.ones_like(phase), phase).reshape(g.nchan_in, -1)
    # dspsr zaps the first point of the whole band's response
    # (Dedispersion.C:322-323), which is channel 0's alone: not each
    # channel's first point, nor each channel's DC
    h[0, 0] = 0
    return h


def unpack(raw: torch.Tensor, g: ChannelGeometry,
           prec: Precision) -> torch.Tensor:
    """uint8 TFP bytes ``[block_ndat * sample_bytes]`` -> complex levels
    ``[nchan_in, npol, block_ndat]``."""
    x = (raw.to(torch.float64) - 127.5) * level_step(8)
    x = x.reshape(-1, g.nchan_in, g.npol, 2)
    z = torch.complex(x[..., 0], x[..., 1]).permute(1, 2, 0)
    return prec(z)


def detect_block(raw: torch.Tensor, g: ChannelGeometry, h: torch.Tensor,
                 prec: Precision) -> torch.Tensor:
    """Detected ``[nchan_in * nsub, npart * nkeep]`` of one block of bytes
    ``raw`` (uint8, ``g.block_bytes``), in ``prec.real``; ``h`` the chirp
    of :func:`channel_chirp`."""
    x = unpack(raw, g, prec)
    hc = prec(h.to(torch.complex64 if prec.low else torch.complex128))
    out = torch.empty(g.nchan, g.npart * g.nkeep, dtype=prec.real,
                      device=raw.device)
    lo, keep = g.nfilt_pos, g.nkeep
    for w in range(g.npart):
        seg = x[..., w * g.nsamp_step:w * g.nsamp_step + g.n_fft]
        spec = prec(torch.fft.fftshift(torch.fft.fft(seg, dim=-1), dim=-1))
        spec = prec(spec * hc[:, None, :])
        v = prec(torch.fft.ifft(spec.reshape(g.nchan_in, g.npol, g.nsub,
                                             g.freq_res),
                                dim=-1)[..., lo:lo + keep])
        if prec.low:
            re = v.real.to(prec.real)
            im = v.imag.to(prec.real)
        else:
            re, im = v.real, v.imag
        power = re * re + im * im
        # the bins' order inside a subband gives its samples a factor
        # (-1)^t that detection drops
        out[:, w * keep:(w + 1) * keep] = power.sum(dim=1).reshape(
            g.nchan, keep)
    return out
