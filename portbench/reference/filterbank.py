"""The coherent dedispersing filterbank and detection, plain PyTorch.

One block of 8-bit offset-binary, real-sampled, dual-pol bytes (time
major, pol fastest) to the detected power of each subband, ``PP + QQ``
(Intensity), ``[nsub, npart * nkeep]`` in time order:

1. unpack each code to ``(code - 127.5) * level_step()``;
2. each window of ``nsamp_fft`` samples, ``nsamp_step`` apart: the real FFT,
   bins ``0 .. n_fft - 1`` (Nyquist dropped), in natural order;
3. times the dedispersion chirp (``Dedispersion.C:478-556``: the phase
   ``-sign(bw) 2 pi D f^2 / (f0^2 (f0 + f))`` of each bin, DC zapped);
4. each subband's ``freq_res`` bins inverse-transformed (unscaled by the
   forward length, ``1 / freq_res`` by the inverse), keeping ``nkeep``
   samples from ``nfilt_pos`` on (``Filterbank.C:477-670``);
5. ``|x|^2`` summed over the two pols.

``Precision`` runs it in float64 (the reference) or in bfloat16 (the
control): every tensor rounded to bfloat16 as it is made, the detected
power too; FFTs, which PyTorch has no bfloat16 form of, take bfloat16
inputs in float32 and round their outputs.  What is done with the detected
power (the fold, its phases) keeps its own precision either way, so the
control is a filterbank in bfloat16 whose sums are exact.  ``"float16"``
rounds the same way, for a reading beside the control.  Imports nothing
of the program.
"""

from __future__ import annotations

import math

import torch

from .geometry import DM_DISPERSION, Geometry
from .levels import level_step


class Precision:
    """Where the reference computes: ``"float64"``, ``"bfloat16"`` or
    ``"float16"``."""

    def __init__(self, name: str):
        if name not in ("float64", "bfloat16", "float16"):
            raise ValueError(f"unknown precision {name!r}")
        self.name = name
        self.low = name != "float64"
        #: the dtype of the filterbank's real tensors
        self.real = getattr(torch, name)
        self.fft_real = torch.float32 if self.low else torch.float64

    def __call__(self, x: torch.Tensor) -> torch.Tensor:
        """``x`` rounded to this precision (complex: each part)."""
        if not self.low:
            return x
        if x.is_complex():
            return torch.complex(x.real.to(self.real).float(),
                                 x.imag.to(self.real).float())
        return x.to(self.real)

    def fft_input(self, x: torch.Tensor) -> torch.Tensor:
        return x.to(self.fft_real) if not x.is_complex() else x


def chirp(g: Geometry, dm: float, cfreq: float, bw: float,
          device) -> torch.Tensor:
    """The natural-order chirp of every subband, complex128 ``[n_fft]``."""
    nchan, ndat = g.nsub, g.freq_res
    sign = bw / abs(bw)
    chanwidth = bw / nchan
    binwidth = chanwidth / ndat
    lower = cfreq - 0.5 * bw + 0.5 * chanwidth
    per_mhz = 1e6 * dm / DM_DISPERSION
    f0 = lower + torch.arange(nchan, dtype=torch.float64,
                              device=device) * chanwidth
    coeff = -sign * 2.0 * math.pi * per_mhz / f0 ** 2
    f = torch.arange(ndat, dtype=torch.float64, device=device) * binwidth \
        - 0.5 * chanwidth
    phase = coeff[:, None] * f[None, :] ** 2 / (f0[:, None] + f[None, :])
    h = torch.polar(torch.ones_like(phase), phase).reshape(-1)
    h[0] = 0
    return h


def unpack(raw: torch.Tensor, prec: Precision) -> torch.Tensor:
    """uint8 TFP bytes ``[ndat * npol]`` -> levels ``[npol, ndat]``."""
    x = (raw.to(torch.float64) - 127.5) * level_step(8)
    return prec(x.reshape(-1, 2).t())


def detect_block(raw: torch.Tensor, g: Geometry, h: torch.Tensor,
                 prec: Precision) -> torch.Tensor:
    """Detected ``[nsub, npart * nkeep]`` of one block of bytes ``raw``
    (uint8, ``g.block_bytes``), in ``prec.real``; ``h`` the chirp."""
    x = unpack(raw, prec)
    hc = prec(h.to(torch.complex64 if prec.low else torch.complex128))
    out = torch.empty(g.nsub, g.npart * g.nkeep, dtype=prec.real,
                      device=raw.device)
    lo, keep = g.nfilt_pos, g.nkeep
    for w in range(g.npart):
        seg = x[:, w * g.nsamp_step:w * g.nsamp_step + g.nsamp_fft]
        spec = prec(torch.fft.rfft(prec.fft_input(seg), dim=-1)[:, :g.n_fft])
        spec = prec(spec * hc)
        v = prec(torch.fft.ifft(spec.reshape(2, g.nsub, g.freq_res),
                                dim=-1)[..., lo:lo + keep])
        if prec.low:
            re = v.real.to(prec.real)
            im = v.imag.to(prec.real)
            power = re * re + im * im
            out[:, w * keep:(w + 1) * keep] = power[0] + power[1]
        else:
            power = v.real * v.real + v.imag * v.imag
            out[:, w * keep:(w + 1) * keep] = power[0] + power[1]
    return out
