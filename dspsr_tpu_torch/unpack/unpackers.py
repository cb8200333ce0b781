"""Unpack description (host side) and the plain byte reorder.

Counterpart of ``dspsr_tpu/unpack/unpackers.py:212-294``.  The fused kernels
unpack in their first pass, so here live only the plan (which byte layout
and code type a stream has) and the plain PyTorch version of the CASPSR
reorder that the plain fused step uses.  This slice covers 8-bit codes,
offset-binary or two's complement, real-sampled or complex (analytic), in
TFP order or in the CASPSR layout.  Every other stream raises
``NotImplementedError``.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from ..observation import Observation

#: Instrument-specific unpack options (reference ``Unpacker_registry.C``,
#: keyed on the machine name), as in the JAX package.
INSTRUMENT_UNPACK = {
    # CASPSR: 8-bit two's complement, four consecutive samples per pol
    # interleaved (CASPSRSingleUnpacker.C:103-151)
    "CASPSR": dict(layout="caspsr", twos_complement=True),
    # Mark5B: fixed-level (BitTable) 2-bit, no JA98 correction
    "MARK5B": dict(dynamic_twobit=False),
}

_UNPACK_ITEM = "ROADMAP.md Queue 1 item 7 (unpack breadth)"


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


@dataclass
class UnpackPlan:
    """How a stream is unpacked.  Raises ``NotImplementedError`` for any
    stream but 8-bit codes (real or complex) in TFP or CASPSR order."""

    obs: Observation
    twos_complement: bool = False
    #: byte layout: "tfp" or an instrument's (from INSTRUMENT_UNPACK)
    layout: str = "tfp"

    def __post_init__(self):
        inst = (self.obs.instrument or "").upper()
        opts = INSTRUMENT_UNPACK.get(inst)
        if opts is not None:
            self.layout = opts.get("layout", self.layout)
            self.twos_complement = opts.get("twos_complement",
                                            self.twos_complement)
        if self.obs.nbit != 8:
            raise NotImplementedError(
                f"NBIT={self.obs.nbit}: only 8-bit input is ported (JA98 "
                "2-bit and 1/2/4/32-bit are not); see " + _UNPACK_ITEM)
        if self.layout not in ("tfp", "caspsr"):
            raise NotImplementedError(
                f"byte layout {self.layout!r}: only TFP and CASPSR are "
                "ported; see " + _UNPACK_ITEM)
        if self.layout == "caspsr" and (
                self.obs.nchan != 1 or self.obs.ndim != 1):
            raise ValueError("CASPSR layout is 8-bit real single-channel")
