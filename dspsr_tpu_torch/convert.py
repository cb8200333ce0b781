"""State carried across from the JAX package.

The JAX package keeps its chirp in the permuted ``[nchan_in, R1, R2]``
spectral layout of its TPU kernel (flat bin ``k = k2*R1 + k1``); the port
keeps it in natural order ``[nchan_in, n_fft]``.  These helpers turn the JAX
package's numpy arrays into the port's tensors, so its own constants,
carried fold accumulators and search rescale state can be fed to the port.
"""

from __future__ import annotations

import numpy as np
import torch

from .ops.megakernel import MegaConstants, MegaPlan, unpack_affine
from .ops.rescale import RescaleState


def constants_from_numpy(d: dict, plan: MegaPlan, device) -> MegaConstants:
    """The port's ``MegaConstants`` on ``device`` from the JAX package's
    ``MegaConstants`` arrays: ``d["gr"]``/``d["gi"]`` ``[nchan_in, R1, R2]``
    are un-permuted to natural order; ``d["unpack_scale"]`` and
    ``d["unpack_offset"]`` default to ``unpack_affine`` of the plan."""
    def natural(a):
        a = np.asarray(a, np.float32).reshape(plan.nchan_in, plan.R1, plan.R2)
        return np.ascontiguousarray(a.transpose(0, 2, 1)).reshape(
            plan.nchan_in, plan.n_fft)

    scale, offset = unpack_affine(plan.nbit, plan.twos_complement)
    return MegaConstants(
        gr=natural(d["gr"]), gi=natural(d["gi"]),
        unpack_scale=float(d.get("unpack_scale", scale)),
        unpack_offset=float(d.get("unpack_offset", offset)),
    ).to(device)


def accumulators_from_numpy(profiles, hits, device):
    """A JAX pipeline's carried ``_profiles [nchan_in, nplane, nsub, nbin]``
    and ``_hits [nchan_in, nbin]`` as float32 tensors on ``device``."""
    return _tensor(profiles, device), _tensor(hits, device)


def rescale_state_from_numpy(state, mean, inv, device):
    """A JAX ``FilPipeline``'s ``_rescale_state`` (``count``, ``total``,
    ``sumsq``, each ``[nchan, npol]``), ``_mean`` and ``_inv`` as the port's
    float32 ``(RescaleState, mean, inv)`` on ``device``, so a port pipeline
    carries on with the JAX run's levels."""
    return (RescaleState(*(_tensor(a, device) for a in state)),
            _tensor(mean, device), _tensor(inv, device))


def _tensor(a, device) -> torch.Tensor:
    """A float32 copy of array ``a`` on ``device`` (JAX arrays read as
    numpy are read-only; the copy is the port's own)."""
    return torch.tensor(np.asarray(a, np.float32), device=device)
