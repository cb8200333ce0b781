"""Unpack description (host side), the plain unpack of the fused steps and
the general chain's unpack.

Counterpart of ``dspsr_tpu/unpack/unpackers.py``.  The fused kernels unpack
in their first pass, so here live the plan (which byte layout, code width
and level map a stream has), the plain PyTorch versions of what the
kernels compute (the CASPSR reorder, the n-bit field extraction
``bytes_to_codes`` and the Jenet & Anderson (1998) dynamic 2-bit levels
with their excision weights: ``twobit_nlow``, ``twobit_levels``,
``unpack_twobit_dynamic``) and the general chain's unpack of a block into
FPT samples (``UnpackPlan.unpack``; complex input as torch ``complex64``).
Codes are 1, 2, 4 or 8 bits (offset binary, or two's complement) or
float32, real-sampled or complex (analytic), in TFP order; 8-bit real
single-channel input may come in the CASPSR layout.  As in the JAX
package, JA98 levels read every code as offset binary: its unpack never
passes ``twos_complement`` on (``unpack_twobit_dynamic``'s sign is ``code
>= 2``).
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from ..observation import Observation
from .bittable import BitTable, CodeType
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


def digitizer_histogram(raw: torch.Tensor, nbit: int, hist_size: int = 0,
                        ndig: int = 1) -> torch.Tensor:
    """Counts of each sample code of packed ``raw`` bytes (reference
    ``HistUnpacker``; the JAX package's ``digitizer_histogram``): int64
    ``[hist_size or 1 << nbit]`` on ``raw``'s device; codes past the
    histogram are not counted.  With ``ndig`` > 1 interleaved digitizers
    (chan, pol, dim order), ``[ndig, hist_size or 1 << nbit]``, a row
    each; a trailing partial sample is not counted."""
    n = hist_size or (1 << nbit)
    m = max(n, 1 << nbit)
    codes = bytes_to_codes(raw, nbit).long()
    codes = codes[: codes.numel() // ndig * ndig].reshape(-1, ndig)
    codes = codes + torch.arange(ndig, device=codes.device) * m
    hist = torch.bincount(codes.reshape(-1), minlength=ndig * m
                          ).reshape(ndig, m)[:, :n]
    return hist[0] if ndig == 1 else hist


def tfp_to_fpt(samples: torch.Tensor, nchan: int, npol: int,
               ndim: int) -> torch.Tensor:
    """Flat TFP samples (time, channel, pol, dim) -> FPT ``[nchan, npol,
    ndat]``, complex64 when ``ndim == 2``."""
    x = samples.reshape(-1, nchan, npol, ndim).permute(1, 2, 0, 3)
    if ndim == 2:
        return torch.view_as_complex(x.contiguous())
    return x[..., 0]


def _uniform_levels(codes: torch.Tensor, nbit: int,
                    twos_complement: bool) -> torch.Tensor:
    """The BitTable uniform level map (``BitTable.C:165-218``): ascending
    level index ``i`` -> ``i * step + lo``, the step taken over the full
    range; two's-complement codes wrap the index.  The JAX package computes
    it in float32 inside one compiled program, where XLA fuses the multiply
    and the add (one rounding); the table below is rounded the same way."""
    n = 1 << nbit
    table = BitTable(nbit, CodeType.TWOS_COMPLEMENT if twos_complement
                     else CodeType.OFFSET_BINARY)
    asc = np.sort(table.values.astype(np.float64))
    step = np.float32((asc[-1] - asc[0]) / (n - 1)) if n > 1 else 2.0
    idx = np.arange(n)
    if twos_complement:
        idx = np.where(idx >= n // 2, idx - n // 2, idx + n // 2)
    levels = (idx * np.float64(step) + np.float64(np.float32(asc[0]))
              ).astype(np.float32)
    return torch.from_numpy(levels).to(codes.device)[codes.long()]


def unpack_fixed(raw: torch.Tensor, nbit: int, nchan: int, npol: int,
                 ndim: int, twos_complement: bool = False) -> torch.Tensor:
    """Fixed-level unpack of TFP bytes (reference ``BitUnpacker::unpack``):
    FPT float32 ``[nchan, npol, ndat]``, complex64 when ``ndim == 2``."""
    vals = _uniform_levels(bytes_to_codes(raw, nbit), nbit, twos_complement)
    return tfp_to_fpt(vals, nchan, npol, ndim)


def unpack_float32(raw: torch.Tensor, nchan: int = 1, npol: int = 1,
                   ndim: int = 1) -> torch.Tensor:
    """Float32 TFP samples as bytes -> FPT (reference ``FloatUnpacker``)."""
    return tfp_to_fpt(raw.view(torch.float32), nchan, npol, ndim)


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


def window_weights(w: torch.Tensor, npart: int, step: int, nfft: int,
                   npw: int) -> torch.Tensor:
    """Each FFT window's weight ``[nchan, npart]`` from the unpacker's block
    weights ``w [nchan, nweights]`` (``WeightedTimeSeries::
    convolve_weights``; the JAX package's ``_stream_weights``): the least
    weight of the ``npw``-sample blocks that window ``p``'s ``nfft`` samples
    from ``p * step`` on touch, and a window whose end passes the last
    whole block takes that block's weight.  One gather on the device."""
    nweights = w.shape[1]
    start = np.arange(npart) * step
    a = np.minimum(start // npw, nweights - 1)
    b = np.maximum(np.minimum((start + nfft + npw - 1) // npw, nweights),
                   a + 1)
    idx = np.minimum(a[:, None] + np.arange((b - a).max()), b[:, None] - 1)
    return w[:, torch.from_numpy(idx).to(w.device)].amin(dim=-1)


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

    def unpack(self, raw: torch.Tensor):
        """One block of raw bytes -> ``(x, w)``: FPT samples ``x [nchan,
        npol, ndat]`` (float32, complex64 for complex input) and, for JA98
        2-bit, the blocks' weights ``w [nchan, nweights]`` (else None).
        JA98 keeps the whole weight blocks only, so ``ndat`` may fall short
        of the block's samples."""
        o = self.obs
        if o.nbit == 32:
            return unpack_float32(raw, o.nchan, o.npol, o.ndim), None
        raw = reorder_bytes_tfp(raw, self.layout, o.npol)
        if self.twobit is not None:
            lo, hi = (torch.from_numpy(t).to(raw.device)
                      for t in self.twobit.level_tables)
            wt = torch.from_numpy(self.twobit.weight_table).to(raw.device)
            x, w = unpack_twobit_dynamic(raw, lo, hi, wt, o.nchan, o.npol,
                                         o.ndim, self.ndat_per_weight)
            if isinstance(x, tuple):
                x = torch.complex(*x)
            return x, w
        return unpack_fixed(raw, o.nbit, o.nchan, o.npol, o.ndim,
                            self.twos_complement), None
