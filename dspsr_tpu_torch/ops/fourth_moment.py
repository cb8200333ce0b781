"""Fourth-order moments of the electric field.

Counterpart of ``dspsr_tpu/ops/fourth_moment.py`` (reference
``dsp::FourthMoment``, the dspsr ``-4`` option): from the detected Stokes
vector S = (I, Q, U, V) per sample, the 10 unique second-order products
S_i S_j (i <= j) follow the 4 Stokes planes, 14 planes in all.
"""

from __future__ import annotations

import torch

#: (i, j) index pairs of the 10 unique products, in reference order
PAIRS = [(i, j) for i in range(4) for j in range(i, 4)]


def fourth_moment(stokes: torch.Tensor) -> torch.Tensor:
    """[nchan, 4, ndat] Stokes -> [nchan, 14, ndat]: S then S_i*S_j."""
    prods = [stokes[:, i] * stokes[:, j] for (i, j) in PAIRS]
    return torch.cat([stokes, torch.stack(prods, dim=1)], dim=1)
