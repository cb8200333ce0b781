"""Unpack description (host side) and the plain unpack of the fused steps.

Counterpart of ``dspsr_tpu/unpack/unpackers.py``.  The fused kernels unpack
in their first pass, so here live the plan (which byte layout, code width
and level map a stream has) and the plain PyTorch versions of what the
kernels compute: the CASPSR reorder, the n-bit field extraction
(``bytes_to_codes``) and the Jenet & Anderson (1998) dynamic 2-bit levels
with their excision weights (``twobit_nlow``, ``twobit_levels``,
``unpack_twobit_dynamic``).  Codes are 1, 2, 4 or 8 bits (offset binary, or
two's complement at 2, 4 and 8 bits) or float32, real-sampled or complex
(analytic), in TFP order; 8-bit real single-channel input may come in the
CASPSR layout.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from ..observation import Observation
from .twobit import TwoBitCorrection

#: Instrument-specific unpack options (reference ``Unpacker_registry.C``,
#: keyed on the machine name), as in the JAX package.
INSTRUMENT_UNPACK = {
    # CASPSR: 8-bit two's complement, four consecutive samples per pol
    # interleaved (CASPSRSingleUnpacker.C:103-151)
    "CASPSR": dict(layout="caspsr", twos_complement=True),
    # Mark5B: fixed-level (BitTable) 2-bit, no JA98 correction
    "MARK5B": dict(dynamic_twobit=False),
}

def state_counts_from_byte_counts(byte_counts, nbit: int) -> np.ndarray:
    """[256] byte-value histogram -> [1<<nbit] digitizer state histogram
    (reference ``HistUnpacker`` counts; independent of field order)."""
    byte_counts = np.asarray(byte_counts, np.int64)
    nstates = 1 << nbit
    if nbit == 8:
        return byte_counts.copy()
    per = 8 // nbit
    mask = nstates - 1
    b = np.arange(256)
    out = np.zeros(nstates, np.int64)
    for k in range(per):
        np.add.at(out, (b >> (k * nbit)) & mask, byte_counts)
    return out


def reorder_bytes_tfp(raw: torch.Tensor, layout: str,
                      npol: int) -> torch.Tensor:
    """An instrument's 8-bit byte stream in TFP sample order (the JAX
    package's ``reorder_bytes_tfp``).  CASPSR packs four consecutive
    samples of each pol together, ``[tblk, pol, 4]``: TFP sample ``(t,
    pol)`` is byte ``(t // 4)*npol*4 + pol*4 + t % 4``."""
    if layout == "tfp":
        return raw
    if layout == "caspsr":
        return raw.reshape(-1, npol, 4).transpose(1, 2).reshape(-1)
    raise ValueError(f"unknown byte layout: {layout}")


def bytes_to_codes(raw: torch.Tensor, nbit: int) -> torch.Tensor:
    """Packed uint8 bytes -> one uint8 code per sample, the most significant
    field first (reference ``BitTable::extract`` order MostToLeast; the JAX
    package's ``bytes_to_codes``): code ``i`` is bits ``(8/nbit - 1 - i %
    (8/nbit)) * nbit`` up of byte ``i // (8/nbit)``."""
    if nbit == 8:
        return raw
    per = 8 // nbit
    shifts = torch.arange(per - 1, -1, -1, device=raw.device) * nbit
    return ((raw[:, None] >> shifts.to(torch.uint8)) & ((1 << nbit) - 1)
            ).reshape(-1)


def twobit_nlow(codes: torch.Tensor, npw: int) -> torch.Tensor:
    """Low-state counts (codes 1 and 2) of each ``npw``-sample block along
    the last axis of 2-bit ``codes [..., T]``: int64 ``[..., T // npw]``."""
    low = (codes == 1) | (codes == 2)
    nw = codes.shape[-1] // npw
    return low[..., :nw * npw].reshape(*codes.shape[:-1], nw, npw).sum(-1)


def twobit_levels(codes: torch.Tensor, nlow: torch.Tensor,
                  lo_table: torch.Tensor, hi_table: torch.Tensor,
                  npw: int) -> torch.Tensor:
    """JA98 values of 2-bit ``codes [..., T]`` (reference
    ``TwoBitCorrection::dig_unpack``): ``sign * (lo or hi)[nlow]`` of each
    sample's block, with sign + for codes 2 and 3 and the low level for
    codes 1 and 2; in the tables' dtype, ``[..., (T // npw) * npw]``."""
    n = nlow.shape[-1] * npw
    c = codes[..., :n]
    low = (c == 1) | (c == 2)
    mag = torch.where(low, lo_table[nlow].repeat_interleave(npw, dim=-1),
                      hi_table[nlow].repeat_interleave(npw, dim=-1))
    return torch.where(c >= 2, mag, -mag)


def unpack_twobit_dynamic(raw: torch.Tensor, lo_table: torch.Tensor,
                          hi_table: torch.Tensor,
                          weight_table: torch.Tensor, nchan: int, npol: int,
                          ndim: int, ndat_per_weight: int):
    """Jenet & Anderson dynamic-level 2-bit unpack with excision weights
    (the JAX package's ``unpack_twobit_dynamic``; reference
    ``TwoBitCorrection::dig_unpack`` + ``ExcisionUnpacker``): TFP bytes ->
    ``(x, w)``, ``x`` FPT ``[nchan, npol, T]`` in the tables' dtype (the
    ``(re, im)`` pair of such arrays when ``ndim == 2``), ``w [nchan,
    nweights]`` the blocks' weights, the least over the channel's
    digitizers of ``weight_table[nlow]``."""
    codes = bytes_to_codes(raw, 2)
    ndig = nchan * npol * ndim
    c = codes.reshape(-1, ndig).T  # [ndig, T]
    nlow = twobit_nlow(c, ndat_per_weight)
    vals = twobit_levels(c, nlow, lo_table, hi_table, ndat_per_weight)
    x = vals.reshape(nchan, npol, ndim, -1)
    xc = (x[:, :, 0], x[:, :, 1]) if ndim == 2 else x[:, :, 0]
    w = weight_table[nlow].reshape(nchan, npol * ndim, -1).amin(dim=1)
    return xc, w


@dataclass
class UnpackPlan:
    """How a stream is unpacked (the JAX package's ``UnpackPlan``): its
    byte layout, code convention and, for 2-bit input with
    ``dynamic_twobit``, the JA98 tables (``twobit``).  NBIT 1, 2, 4, 8 and
    32 are taken; a Mark5B stream keeps fixed levels."""

    obs: Observation
    twos_complement: bool = False
    dynamic_twobit: bool = True
    ndat_per_weight: int = 512
    cutoff_sigma: float = 3.0
    #: byte layout: "tfp" or an instrument's (from INSTRUMENT_UNPACK)
    layout: str = "tfp"

    def __post_init__(self):
        inst = (self.obs.instrument or "").upper()
        opts = INSTRUMENT_UNPACK.get(inst)
        if opts is not None:
            self.layout = opts.get("layout", self.layout)
            self.twos_complement = opts.get("twos_complement",
                                            self.twos_complement)
            self.dynamic_twobit = opts.get("dynamic_twobit",
                                           self.dynamic_twobit)
        nbit = self.obs.nbit
        if nbit not in (1, 2, 4, 8, 32):
            raise ValueError(f"unsupported NBIT={nbit}")
        if self.layout not in ("tfp", "caspsr"):
            raise ValueError(f"unknown byte layout: {self.layout}")
        if self.layout == "caspsr" and (
                nbit != 8 or self.obs.nchan != 1 or self.obs.ndim != 1):
            raise ValueError("CASPSR layout is 8-bit real single-channel")
        if nbit == 2 and self.dynamic_twobit:
            self.twobit = TwoBitCorrection(self.ndat_per_weight,
                                           self.cutoff_sigma)
        else:
            self.twobit = None
