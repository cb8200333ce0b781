"""Narrow-band RFI rejection from the median-filtered bandpass.

Counterpart of ``dspsr_tpu/ops/rfifilter.py`` (reference ``dsp::RFIFilter``,
``Signal/General/RFIFilter.C``): the bandpass is median-filtered across
frequency, and a bin whose power exceeds the local median by a threshold is
zapped.  The hybrid fold engine (``models.load_to_fold``) multiplies the
resulting mask into the chirp; the general chain zaps each block's chunked
spectra with the weights of that block's own bandpass
(:func:`rfi_bandpass_weights`).
"""

from __future__ import annotations

import torch


def median_filter_freq(bandpass: torch.Tensor, width: int) -> torch.Tensor:
    """Running median over the last (frequency) axis, edge-replicated;
    ``width`` must be odd.

    The window values are sorted with the JAX package's odd-even
    transposition network of elementwise ``minimum``/``maximum`` over the
    ``width`` shifted views, so the medians are bit-identical to its own.
    """
    if width < 3 or width % 2 == 0:
        raise ValueError(f"median width must be odd and >= 3, got {width}")
    half = width // 2
    n = bandpass.shape[-1]
    padded = torch.cat([bandpass[..., :1].expand(*bandpass.shape[:-1], half),
                        bandpass,
                        bandpass[..., -1:].expand(*bandpass.shape[:-1], half)],
                       dim=-1)
    w = [padded[..., i:i + n] for i in range(width)]
    for r in range(width):
        for i in range(r % 2, width - 1, 2):
            lo = torch.minimum(w[i], w[i + 1])
            hi = torch.maximum(w[i], w[i + 1])
            w[i], w[i + 1] = lo, hi
    return w[half]


def rfi_bandpass_weights(spec: torch.Tensor, width: int = 21,
                         threshold: float = 4.0) -> torch.Tensor:
    """Per-bin zap weights from a block's own complex spectra ``spec [...,
    npart, nchan_sub, freq_res]`` (the filterbank's chunked spectra): the
    bandpass is the power averaged over the windows, median-filtered across
    the ``nchan_sub * freq_res`` bins; a bin above ``threshold`` times its
    median gets weight 0.  Returns float32 ``[..., 1, nchan_sub,
    freq_res]``."""
    power = spec.real * spec.real + spec.imag * spec.imag
    bp = power.mean(dim=-3, keepdim=True)
    flat = bp.reshape(*bp.shape[:-2], -1)
    med = median_filter_freq(flat, width)
    good = flat <= threshold * torch.clamp(med, min=1e-30)
    return good.to(torch.float32).reshape(bp.shape)
