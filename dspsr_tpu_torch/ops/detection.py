"""Polarization detection (split-complex), and the conversion of a detected
front end's planes to the target state.

Counterpart of ``dspsr_tpu/ops/detection.py`` (reference ``dsp::Detection``,
``Signal/General/Detection.C``; ``cross_detect.ic``, ``stokes_detect.ic``):

- Intensity:  PP + QQ
- PPQQ:       |p|^2, |q|^2 separately
- PP / QQ:    one polarization only
- NthPower:   (PP + QQ)^2
- Coherence:  PP, QQ, Re[p* q], Im[p* q]
- Stokes:     I=PP+QQ, Q=PP-QQ, U=2 Re[p* q], V=2 Im[p* q]

Input is a split-complex pair ``(re, im)`` of ``[nchan, npol, ndat]`` tensors
or one real tensor (undetected Nyquist data detects as v^2); output is
``[nchan, npol_out, ndat]``.  Plain PyTorch elementwise arithmetic in the
reference's order.
"""

from __future__ import annotations

import torch

from ..observation import Signal


def _split(x):
    if isinstance(x, tuple):
        return x
    return x, torch.zeros_like(x)


def detect_intensity(x) -> torch.Tensor:
    r, i = _split(x)
    return torch.sum(r * r + i * i, dim=1, keepdim=True)


def detect_ppqq(x) -> torch.Tensor:
    r, i = _split(x)
    return r * r + i * i


def detect_coherence(x) -> torch.Tensor:
    """(re,im)[nchan, 2, ndat] -> [nchan, 4, ndat]: PP, QQ, Re p*q, Im p*q."""
    r, i = _split(x)
    pr, pi = r[:, 0], i[:, 0]
    qr, qi = r[:, 1], i[:, 1]
    pp = pr * pr + pi * pi
    qq = qr * qr + qi * qi
    rpq = pr * qr + pi * qi
    ipq = pr * qi - pi * qr
    return torch.stack([pp, qq, rpq, ipq], dim=1)


def detect_stokes(x) -> torch.Tensor:
    """(re,im)[nchan, 2, ndat] -> [nchan, 4, ndat]: I, Q, U, V."""
    r, i = _split(x)
    pr, pi = r[:, 0], i[:, 0]
    qr, qi = r[:, 1], i[:, 1]
    pp = pr * pr + pi * pi
    qq = qr * qr + qi * qi
    return torch.stack([pp + qq, pp - qq, 2.0 * (pr * qr + pi * qi),
                        2.0 * (pr * qi - pi * qr)], dim=1)


def detect_nthpower(x) -> torch.Tensor:
    """Square-law total power squared: (PP+QQ)^2 (reference
    ``Signal::NthPower``, dspsr -d 3)."""
    p = detect_intensity(x)
    return p * p


def detect(x, state: Signal) -> torch.Tensor:
    """Dispatch on the requested output state (``Detection.C:42-66``)."""
    if state == Signal.INTENSITY:
        return detect_intensity(x)
    if state == Signal.NTHPOWER:
        return detect_nthpower(x)
    if state == Signal.PPQQ:
        return detect_ppqq(x)
    if state in (Signal.PP, Signal.QQ):
        r, i = _split(x)
        k = 0 if state == Signal.PP else 1
        return (r * r + i * i)[:, k:k + 1]
    if state == Signal.COHERENCE:
        return detect_coherence(x)
    if state == Signal.STOKES:
        return detect_stokes(x)
    raise ValueError(f"not a detectable state: {state}")


def from_front_planes(P: torch.Tensor, state: Signal,
                      front_np: int) -> torch.Tensor:
    """Detected front-end planes ``P [nchan, front_np, ndat]`` (1: PP+QQ or
    one pol's power; 2: PP, QQ; 4: Coherence) -> the ``state`` planes
    (``dspsr_tpu/models/load_to_fold.py:1056-1079``)."""
    two = front_np >= 2
    if state == Signal.INTENSITY:
        return P[:, 0:1] + P[:, 1:2] if two else P[:, 0:1]
    if state == Signal.NTHPOWER:
        s = P[:, 0:1] + P[:, 1:2] if two else P[:, 0:1]
        return s * s
    if state == Signal.PPQQ:
        return P[:, :2]
    if state == Signal.PP:
        return P[:, 0:1]
    if state == Signal.QQ:
        return P[:, 1:2]
    if state == Signal.COHERENCE:
        return P
    if state == Signal.STOKES:
        return torch.stack([P[:, 0] + P[:, 1], P[:, 0] - P[:, 1],
                            2.0 * P[:, 2], 2.0 * P[:, 3]], dim=1)
    raise ValueError(f"not a detectable state: {state}")
