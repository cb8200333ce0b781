"""Narrow-band RFI rejection from the median-filtered bandpass.

Counterpart of ``dspsr_tpu/ops/rfifilter.py`` (reference ``dsp::RFIFilter``,
``Signal/General/RFIFilter.C``): the bandpass is median-filtered across
frequency, and a bin whose power exceeds the local median by a threshold is
zapped.  The hybrid fold engine (``models.load_to_fold``) multiplies the
resulting mask into the chirp.
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
