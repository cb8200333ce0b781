"""State carried across from the JAX package.

The JAX package keeps its chirp in the permuted ``[nchan_in, R1, R2]``
spectral layout of its TPU kernel (flat bin ``k = k2*R1 + k1``); the port
keeps it in natural order ``[nchan_in, n_fft]``.  These helpers turn the JAX
package's numpy arrays into the port's tensors, so its own constants,
carried fold accumulators (one array, or a tuple of them per source in the
hybrid engine), carried RFI response and search rescale state can be fed to
the port.
"""

from __future__ import annotations

import numpy as np
import torch

from .ops.megakernel import MegaConstants, MegaPlan, unpack_affine
from .ops.rescale import RescaleState


def _natural(a, plan: MegaPlan) -> np.ndarray:
    """A JAX-package response plane ``[nchan_in, R1, R2]`` (flat bin ``k =
    k2*R1 + k1``) in natural bin order ``[nchan_in, n_fft]``, float32."""
    a = np.asarray(a, np.float32).reshape(plan.nchan_in, plan.R1, plan.R2)
    return np.ascontiguousarray(a.transpose(0, 2, 1)).reshape(
        plan.nchan_in, plan.n_fft)


def constants_from_numpy(d: dict, plan: MegaPlan, device) -> MegaConstants:
    """The port's ``MegaConstants`` on ``device`` from the JAX package's
    ``MegaConstants`` arrays: ``d["gr"]``/``d["gi"]`` ``[nchan_in, R1, R2]``
    are un-permuted to natural order; ``d["unpack_scale"]`` and
    ``d["unpack_offset"]`` default to ``unpack_affine`` of the plan."""
    scale, offset = unpack_affine(plan.nbit, plan.twos_complement)
    return MegaConstants(
        gr=_natural(d["gr"], plan), gi=_natural(d["gi"], plan),
        unpack_scale=float(d.get("unpack_scale", scale)),
        unpack_offset=float(d.get("unpack_offset", offset)),
    ).to(device)


def response_from_numpy(resp, plan: MegaPlan, device):
    """A JAX hybrid pipeline's carried RFI response ``_rfi_resp`` (the
    chirp times the zap mask, ``(gr, gi)`` each ``[nchan_in, R1, R2]`` in
    its kernel's permuted layout) as the port's natural-order float32
    ``(gr, gi)`` ``[nchan_in, n_fft]`` on ``device``."""
    return tuple(_tensor(_natural(a, plan), device) for a in resp)


def accumulators_from_numpy(profiles, hits, device):
    """A JAX pipeline's carried ``_profiles`` and ``_hits`` as float32
    tensors on ``device``: ``[nchan_in, nplane, nsub, nbin]`` and
    ``[nchan_in, nbin]`` on the full engine, ``[nchan, npol, nbin]`` and
    ``[nchan, nbin]`` on the hybrid engine, or, with several sources, a
    tuple of those per source (each its own nbin), kept as tuples."""
    if isinstance(profiles, (tuple, list)):
        return (tuple(_tensor(p, device) for p in profiles),
                tuple(_tensor(h, device) for h in hits))
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
