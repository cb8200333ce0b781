"""Unpack description (host side).

Counterpart of ``dspsr_tpu/unpack/unpackers.py:212-294``.  The fused kernel
unpacks in its first pass, so here only the plan lives: which byte layout and
code type a stream has.  This slice covers 8-bit TFP codes, offset-binary or
two's complement, real-sampled.  Every other stream raises
``NotImplementedError``.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np

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


@dataclass
class UnpackPlan:
    """How a stream is unpacked.  Raises ``NotImplementedError`` for any
    stream but real-sampled 8-bit TFP."""

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
                f"NBIT={self.obs.nbit}: only 8-bit input is ported; see "
                + _UNPACK_ITEM)
        if self.layout != "tfp":
            raise NotImplementedError(
                f"byte layout {self.layout!r}: only TFP is ported; see "
                + _UNPACK_ITEM)
        if self.obs.ndim != 1:
            raise NotImplementedError(
                "complex (analytic) input: only real-sampled input is "
                "ported; see " + _UNPACK_ITEM)
