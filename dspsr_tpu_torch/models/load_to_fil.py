"""Search-mode pipeline on the fused front end: load -> (unpack, filterbank
with chirp, detect in one step) -> fscrunch -> tscrunch -> rescale ->
requantize -> SIGPROC or PSRFITS search file (the ``digifil`` workflow).

Counterpart of ``dspsr_tpu/models/load_to_fil.py`` for the configurations
the JAX package runs on its fused search front end (``build_megafil``): a
convolving filterbank (``freq_res > 1``: ``-D`` or ``-x``), Intensity, over
1/2/4/8-bit codes with fixed levels (two's complement at 2, 4 and 8 bits)
or float32 samples, real-sampled or complex, in TFP order (8-bit real
input also in the CASPSR layout), with ``-K``,
``-t``, ``-f``, ``-c``, ``-I``, ``-s`` and output nbits 1/2/4/8/32.  The
host reads raw bytes and writes packed bytes; everything between runs on
the device, one fused step a block.  A configuration that needs the JAX
package's XLA chain (JA98 2-bit input among them: its excision weights
zero detected samples there) raises ``NotImplementedError`` naming the
ROADMAP item that will port it.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional

import torch

from ..device import host_to_device, resolve_device
from ..io.psrfits import PsrfitsSearchWriter
from ..io.sigproc import SigProcWriter
# Observation and Signal are also this module's public names
from ..io.sources import Source, open_source
from ..observation import Observation, Signal
from ..ops.dedispersion import Dedispersion
from ..ops.filterbank import FilterbankPlan, update_observation
from ..ops.response import choose_nfft
from ..ops.megakernel import (
    MegaConstants, MegaPlan, build_megafil, unpack_affine)
from ..ops.rescale import (
    RescaleState, accumulate, apply_scales, state_mean_scale)
from ..ops.scrunch import (
    fscrunch, tscrunch, update_observation_fscrunch,
    update_observation_tscrunch)
from ..unpack.unpackers import UnpackPlan

_GENERAL = "ROADMAP.md Queue 1 item 8 (general chain)"


@dataclass
class FilConfig:
    """The JAX package's ``FilConfig`` (digifil's options), field for
    field; ``FilPipeline`` raises ``NotImplementedError`` for the settings
    that need the XLA chain."""

    nchan: int = 128  # -F
    frequency_resolution: Optional[int] = None  # -x
    dispersion_measure: float = 0.0  # -D (coherent dedispersing filterbank)
    tscrunch_factor: int = 1  # -t
    fscrunch_factor: int = 1  # -f
    npol_out: int = 1  # -d
    nbits: int = 8  # -b output bits
    twos_complement: bool = False  # input code convention (BitTable)
    #: 2-bit JA98 dynamic levels and excision (the JAX package runs them on
    #: its XLA chain); False: the fixed BitTable levels of the fused path
    dynamic_twobit: bool = True
    #: -I: seconds between rescale offset/scale updates; 0 = every block
    rescale_seconds: float = 0.0
    rescale_constant: bool = False  # -c freeze after first block
    #: -s: extra data scale factor applied before requantization
    scale_factor: float = 1.0
    #: select a single input polarization before the filterbank
    poln_select: Optional[int] = None
    #: -K: remove inter-channel dispersion delays (phase ramps in the chirp)
    interchannel_align: bool = False
    #: zero excision-flagged stretches (the fused front end carries none)
    apply_weights: bool = True
    #: channelizer: "fft" (dsp::Filterbank) or "polyphase"
    channelizer: str = "fft"
    pfb_ntaps: int = 8
    block_parts: int = 4
    #: minimum input samples per device block
    min_block_samples: int = 1 << 20

    def digi_params(self):
        """(mean, counts per sigma) of the output digitizer (reference
        SigProcDigitizer DIGI_MEAN / DIGI_SIGMA)."""
        if self.nbits == 8:
            return 127.5, 32.0
        if self.nbits == 4:
            return 7.5, 2.0
        if self.nbits == 2:
            return 1.5, 1.0
        if self.nbits == 1:
            return 0.5, 0.5
        if self.nbits == 32:
            return 0.0, 1.0  # float passthrough
        raise ValueError(f"unsupported output nbits={self.nbits}")

    def detection_state(self) -> Signal:
        return {1: Signal.INTENSITY, 2: Signal.PPQQ,
                4: Signal.COHERENCE}[self.npol_out]


def digitize(y: torch.Tensor, nbits: int, mean: float,
             scale: float) -> torch.Tensor:
    """Requantize ``float32[nchan, npol, ndat]`` (already ~N(0, 1)) to n-bit
    offset-binary bytes in SIGPROC sample order (time, pol, channel
    fastest), packed MSB first below 8 bits; nbits 32 gives the float32
    samples' little-endian bytes.  Quantized before the transpose, so the
    transpose moves bytes, not floats."""
    if nbits == 32:
        t = y.to(torch.float32).permute(2, 1, 0).contiguous()
        return t.view(torch.uint8).reshape(-1)
    q = torch.round(y * scale + mean).clamp_(0, (1 << nbits) - 1)
    flat = q.to(torch.uint8).permute(2, 1, 0).reshape(-1)
    if nbits == 8:
        return flat
    per = 8 // nbits
    shifts = torch.arange(per - 1, -1, -1, dtype=torch.int32,
                          device=y.device) * nbits
    g = flat.reshape(-1, per).to(torch.int32)
    return (g << shifts).sum(1).to(torch.uint8)


def _unsupported(cfg: FilConfig) -> Optional[str]:
    """Why ``cfg`` needs the XLA chain (None if it does not)."""
    checks = (
        (cfg.channelizer == "polyphase", "polyphase channelizer"),
        (cfg.npol_out != 1, f"npol_out={cfg.npol_out}"),
        (cfg.poln_select is not None, "poln_select"),
    )
    for bad, what in checks:
        if bad:
            return f"{what} runs on the XLA chain in the JAX package; see " \
                + _GENERAL
    return None


class FilPipeline:
    """Constructed search-mode pipeline over one Source, running the fused
    front end on ``device`` (``"cuda"`` by default; a CPU run must be asked
    for by name and uses the plain PyTorch front end)."""

    def __init__(self, source: Source, config: FilConfig, device="cuda"):
        self.device = resolve_device(device)
        self.source = source
        self.config = config
        self.obs_in = source.obs
        why = _unsupported(config)
        if why:
            raise NotImplementedError(why)
        self._construct()

    def _construct(self):
        cfg = self.config
        obs = self.obs_in
        real_input = obs.state == Signal.NYQUIST

        # the codes the fused front end takes (the JAX package's choice,
        # load_to_fil.py:244-248); the rest run on its XLA chain
        self.unpack_plan = UnpackPlan(obs,
                                      twos_complement=cfg.twos_complement,
                                      dynamic_twobit=cfg.dynamic_twobit)
        up = self.unpack_plan
        if up.twobit is not None or (up.twos_complement
                                     and obs.nbit not in (2, 4, 8)):
            what = ("JA98 2-bit input (its excision weights zero detected "
                    "samples)" if up.twobit is not None
                    else f"two's-complement {obs.nbit}-bit codes")
            raise NotImplementedError(
                f"{what} runs on the XLA chain in the JAX package; see "
                + _GENERAL)
        self.nchan_subband = max(1, cfg.nchan // obs.nchan)
        nchan_out = obs.nchan * self.nchan_subband

        dm = cfg.dispersion_measure
        if dm > 0:
            nfp = Dedispersion._half_smearing_samples(
                dm, obs.centre_frequency, obs.bandwidth, nchan_out, +1, 0.1)
            nfn = Dedispersion._half_smearing_samples(
                dm, obs.centre_frequency, obs.bandwidth, nchan_out, -1, 0.1)
        else:
            nfp = nfn = 0
        nfilt = nfp + nfn
        if cfg.frequency_resolution:
            freq_res = cfg.frequency_resolution
        elif nfilt == 0:
            freq_res = 1
        else:
            freq_res = choose_nfft(nfilt)
        if freq_res == 1:
            raise NotImplementedError(
                "freq_res == 1 (no -D and no -x) runs on the XLA chain in the "
                "JAX package; see " + _GENERAL)
        self.fb_plan = FilterbankPlan(
            real_input=real_input, nchan_subband=self.nchan_subband,
            freq_res=freq_res, nfilt_pos=nfp, nfilt_neg=nfn)
        self.fb_plan.validate()

        if dm > 0:
            builder = (Dedispersion.build_interchannel_aligned
                       if cfg.interchannel_align else Dedispersion.build)
            ded = builder(dm, obs.centre_frequency, obs.bandwidth, nchan_out,
                          freq_res)
            if cfg.interchannel_align:
                # the delay ramps need extra overlap cover
                self.fb_plan = FilterbankPlan(
                    real_input=real_input, nchan_subband=self.nchan_subband,
                    freq_res=freq_res, nfilt_pos=ded.impulse_pos,
                    nfilt_neg=ded.impulse_neg)
                self.fb_plan.validate()
            response = ded.phasors
        else:
            if cfg.interchannel_align:
                raise ValueError("-K needs a dispersion measure")
            response = None

        self.det_state = cfg.detection_state()
        obs_s = update_observation(obs, self.fb_plan).replace(npol=obs.npol)
        obs_d = obs_s.apply_detection(self.det_state)
        obs_d = update_observation_fscrunch(obs_d, cfg.fscrunch_factor)
        obs_d = update_observation_tscrunch(obs_d, cfg.tscrunch_factor)
        self.obs_out = obs_d.replace(nbit=cfg.nbits)
        self._digi = cfg.digi_params()

        # --- the fused front end, with its rounded overlap adopted ---
        mp = MegaPlan.from_filterbank(
            self.fb_plan, nbin=2, npol=obs.npol, npol_out=1, nbit=obs.nbit,
            nchan_in=obs.nchan,
            twos_complement=self.unpack_plan.twos_complement,
            interleave=self.unpack_plan.layout)
        if mp is None:
            raise NotImplementedError(
                f"filterbank geometry {self.fb_plan} does not factor for the "
                f"fused front end; see {_GENERAL}")
        self.megafil_plan = mp
        self.fb_plan = FilterbankPlan(
            real_input=mp.real_input, nchan_subband=mp.nsub,
            freq_res=mp.freq_res, nfilt_pos=mp.nfilt_pos,
            nfilt_neg=mp.nfilt_neg)

        # --- block geometry ---
        geom = self.fb_plan
        want = -(-cfg.min_block_samples // geom.nsamp_step)
        cap = geom.npart(self.source.total_samples)
        self.npart = min(max(want, cfg.block_parts), cap) if cap > 0 \
            else cfg.block_parts
        self.block_in_samples = geom.block_ndat(self.npart)
        self.stride_in_samples = self.npart * geom.nsamp_step

        scale, offset = unpack_affine(obs.nbit,
                                      self.unpack_plan.twos_complement)
        self.constants = MegaConstants.build(
            mp, response, unpack_scale=scale, unpack_offset=offset
        ).to(self.device)
        self._megafil = build_megafil(mp, self.constants, self.npart)

        nchan, npol = self.obs_out.nchan, self.obs_out.npol
        self._rescale_state = RescaleState.zeros(nchan, npol, self.device)
        self._mean = torch.zeros((nchan, npol), dtype=torch.float32,
                                 device=self.device)
        self._inv = torch.ones((nchan, npol), dtype=torch.float32,
                               device=self.device)
        self._blocks_done = 0
        self._since_update = 0

    def _step(self, rescale_state, mean, inv, raw, mode="cumulative"):
        """One block: fused front end -> scrunch -> rescale -> digitize.
        Returns ``(rescale_state, mean, inv, packed bytes)``.

        ``mode`` selects the Rescale update (``Signal/General/Rescale.C``):
          cumulative  accumulate, then use the running stats
          hold        use the passed mean/inv unchanged
          acc_hold    accumulate for the next interval, apply passed scales
          acc_update  interval boundary: accumulate, derive new scales,
                      reset the accumulator
        """
        cfg = self.config
        d = self._megafil(raw)
        d = fscrunch(d, cfg.fscrunch_factor)
        d = tscrunch(d, cfg.tscrunch_factor)
        if mode in ("cumulative", "acc_hold", "acc_update"):
            rescale_state = accumulate(rescale_state, d)
        if mode in ("cumulative", "acc_update"):
            mean, inv = state_mean_scale(rescale_state)
        if mode == "acc_update":
            rescale_state = RescaleState.zeros(*rescale_state.count.shape,
                                               device=self.device)
        z = apply_scales(d, mean, inv)
        dmean, dscale = self._digi
        packed = digitize(z, cfg.nbits, dmean, dscale * cfg.scale_factor)
        return rescale_state, mean, inv, packed

    def run(self, output_path: str, max_blocks: Optional[int] = None,
            total_seconds: Optional[float] = None,
            format: str = "sigproc") -> Observation:
        """Stream the whole source into a SIGPROC (.fil) or PSRFITS (.sf)
        search-mode file (digifil / digifits respectively)."""
        if format == "sigproc":
            writer = SigProcWriter(output_path, self.obs_out,
                                   self.config.nbits)
        elif format == "psrfits":
            writer = PsrfitsSearchWriter(output_path, self.obs_out,
                                         self.config.nbits)
        else:
            raise ValueError(f"unknown search output format {format!r}")
        with writer as out:
            self.run_writer(out, max_blocks=max_blocks,
                            total_seconds=total_seconds)
        return self.obs_out

    def run_writer(self, out, max_blocks: Optional[int] = None,
                   total_seconds: Optional[float] = None) -> None:
        """Stream blocks through the device step into any block writer (an
        object with ``write_block(uint8 array)``)."""
        src = self.source
        nsamp_total = src.total_samples
        if total_seconds is not None:
            nsamp_total = min(nsamp_total,
                              int(total_seconds * self.obs_in.rate))
        cfg = self.config

        start = 0
        nblocks = 0
        out_per_block = None
        interval_out = (int(cfg.rescale_seconds * self.obs_out.rate)
                        if cfg.rescale_seconds > 0 else 0)
        while start + self.block_in_samples <= nsamp_total:
            raw = src.read_samples(start, self.block_in_samples)
            if self._blocks_done == 0:
                mode = "cumulative"  # bootstrap scales from the first block
            elif cfg.rescale_constant:
                mode = "hold"
            elif interval_out:
                self._since_update += out_per_block
                if self._since_update >= interval_out:
                    mode = "acc_update"
                    self._since_update = 0
                else:
                    mode = "acc_hold"
            else:
                mode = "cumulative"
            self._rescale_state, self._mean, self._inv, packed = self._step(
                self._rescale_state, self._mean, self._inv,
                host_to_device(raw, self.device), mode)
            arr = packed.cpu().numpy()
            if out_per_block is None:
                bits_per_samp = self.obs_out.nchan * self.obs_out.npol \
                    * cfg.nbits
                out_per_block = arr.size * 8 // max(bits_per_samp, 1)
            out.write_block(arr)
            start += self.stride_in_samples
            nblocks += 1
            self._blocks_done += 1
            if max_blocks is not None and nblocks >= max_blocks:
                break


def load_to_fil(path: str, output_path: str, config: FilConfig,
                device="cuda", **run_kw) -> Observation:
    """Open, construct, run: the digifil app in a line."""
    return FilPipeline(open_source(path), config, device=device).run(
        output_path, **run_kw)


def load_to_fits(path: str, output_path: str, config: FilConfig,
                 device="cuda", **run_kw) -> Observation:
    """digifits equivalent (reference ``Signal/General/digifits.C``)."""
    return FilPipeline(open_source(path), config, device=device).run(
        output_path, format="psrfits", **run_kw)
