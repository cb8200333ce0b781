"""Search-mode pipeline: load -> unpack -> [pol select] -> filterbank
(optionally with the chirp) -> detect -> fscrunch -> tscrunch -> rescale ->
requantize -> SIGPROC or PSRFITS search file (the ``digifil`` workflow).

Counterpart of ``dspsr_tpu/models/load_to_fil.py``, with its two engines,
chosen at construction as it chooses them (``load_to_fil.py:242-265``):

- the fused front end (``build_megafil``: unpack, filterbank with chirp
  and detection in one step) for a convolving filterbank (``freq_res >
  1``: ``-D`` or ``-x``; ``-K``) with Intensity output and no pol select, over
  1/2/4/8-bit codes with fixed levels (two's complement at 2, 4 and 8
  bits) or float32 samples, real-sampled or complex, in TFP order (8-bit
  real input also in the CASPSR layout), where the geometry factors;
- the general chain everywhere else (``megafil_plan is None``): the
  unpack, pol select (``-P``), ``torch.fft`` filterbank (also ``freq_res
  == 1``, digifil with no ``-D``) or polyphase channelizer, and detection
  (``-d 1/2/4``) on ``complex64`` streams; JA98 2-bit excision weights zero
  the stretches they flag (``apply_weights``).

Both go on through ``-t``, ``-f``, ``-c``, ``-I``, ``-s`` and output nbits
1/2/4/8/32.  The host reads raw bytes and writes packed bytes; everything
between runs on the device.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional

import numpy as np
import torch

from ..device import host_to_device, resolve_device
from ..io.psrfits import PsrfitsSearchWriter
from ..io.sigproc import SigProcWriter
# Observation and Signal are also this module's public names
from ..io.sources import Source, open_source
from ..observation import Observation, Signal
from ..ops.dedispersion import Dedispersion
from ..ops.detection import detect
from ..ops.filterbank import (
    FilterbankPlan, filterbank_block, update_observation)
from ..ops.response import choose_nfft
from ..ops.megakernel import (
    MegaConstants, MegaPlan, build_megafil, unpack_affine)
from ..ops.polyphase import (
    PolyphasePlan, polyphase_filterbank_block, prototype_lowpass)
from ..ops.rescale import (
    RescaleState, accumulate, apply_scales, state_mean_scale)
from ..ops.scrunch import (
    fscrunch, poln_select, tscrunch, update_observation_fscrunch,
    update_observation_tscrunch)
from ..unpack.unpackers import UnpackPlan, window_weights


@dataclass
class FilConfig:
    """The JAX package's ``FilConfig`` (digifil's options), field for
    field."""

    nchan: int = 128  # -F
    frequency_resolution: Optional[int] = None  # -x
    dispersion_measure: float = 0.0  # -D (coherent dedispersing filterbank)
    tscrunch_factor: int = 1  # -t
    fscrunch_factor: int = 1  # -f
    npol_out: int = 1  # -d
    nbits: int = 8  # -b output bits
    twos_complement: bool = False  # input code convention (BitTable)
    #: 2-bit JA98 dynamic levels and excision (on the general chain);
    #: False: the fixed BitTable levels, which the fused front end takes
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
    #: zero excision-flagged stretches (JA98 weights; the fused front end
    #: takes no JA98 input)
    apply_weights: bool = True
    #: channelizer: "fft" (dsp::Filterbank) or "polyphase"
    #: (dsp::PolyPhaseFilterbank; incoherent only)
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


class FilPipeline:
    """Constructed search-mode pipeline over one Source, running on
    ``device`` (``"cuda"`` by default; a CPU run must be asked for by name
    and uses the fused front end's plain PyTorch version).
    ``megafil_plan`` is None on the general chain."""

    def __init__(self, source: Source, config: FilConfig, device="cuda"):
        self.device = resolve_device(device)
        self.source = source
        self.config = config
        self.obs_in = source.obs
        self._construct()

    def _construct(self):
        cfg = self.config
        obs = self.obs_in
        real_input = obs.state == Signal.NYQUIST

        self.unpack_plan = UnpackPlan(obs,
                                      twos_complement=cfg.twos_complement,
                                      dynamic_twobit=cfg.dynamic_twobit)
        up = self.unpack_plan
        if cfg.poln_select is not None \
                and not 0 <= cfg.poln_select < obs.npol:
            raise ValueError(f"poln_select={cfg.poln_select} out of range")
        npol_stream = 1 if cfg.poln_select is not None else obs.npol
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

        if cfg.channelizer == "polyphase":
            if dm > 0:
                raise ValueError(
                    "polyphase channelizer is incoherent; use the FFT "
                    "filterbank for coherent dedispersion (-D)")
            self.pfb_plan = PolyphasePlan(
                real_input=real_input, nchan_subband=self.nchan_subband,
                ntaps=cfg.pfb_ntaps)
            self.fb_plan = None
        else:
            self.pfb_plan = None
            if cfg.frequency_resolution:
                freq_res = cfg.frequency_resolution
            elif nfilt == 0:
                freq_res = 1
            else:
                freq_res = choose_nfft(nfilt)
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

        if cfg.poln_select is not None and cfg.npol_out != 1:
            raise ValueError("poln_select implies npol_out=1")
        self.det_state = cfg.detection_state()
        if self.pfb_plan is not None:
            obs_s = obs.replace(nchan=nchan_out, ndim=2,
                                state=Signal.ANALYTIC,
                                rate=obs.rate / self.pfb_plan.step)
        else:
            obs_s = update_observation(obs, self.fb_plan)
        obs_d = obs_s.replace(npol=npol_stream).apply_detection(
            self.det_state)
        obs_d = update_observation_fscrunch(obs_d, cfg.fscrunch_factor)
        obs_d = update_observation_tscrunch(obs_d, cfg.tscrunch_factor)
        self.obs_out = obs_d.replace(nbit=cfg.nbits)
        self._digi = cfg.digi_params()

        # --- the fused front end where the JAX package takes it, with its
        # rounded overlap adopted; else the general chain ---
        self.megafil_plan = None
        if (self.pfb_plan is None
                and (obs.nbit in (4, 8, 32)
                     or (obs.nbit in (1, 2) and up.twobit is None))
                and (not up.twos_complement or obs.nbit in (2, 4, 8))
                and cfg.npol_out == 1 and cfg.poln_select is None
                and self.fb_plan.freq_res > 1):
            mp = MegaPlan.from_filterbank(
                self.fb_plan, nbin=2, npol=obs.npol, npol_out=1,
                nbit=obs.nbit, nchan_in=obs.nchan,
                twos_complement=up.twos_complement, interleave=up.layout)
            if mp is not None:
                self.megafil_plan = mp
                self.fb_plan = FilterbankPlan(
                    real_input=mp.real_input, nchan_subband=mp.nsub,
                    freq_res=mp.freq_res, nfilt_pos=mp.nfilt_pos,
                    nfilt_neg=mp.nfilt_neg)

        # --- block geometry ---
        if self.pfb_plan is not None:
            geom, step = self.pfb_plan, self.pfb_plan.step
        else:
            geom, step = self.fb_plan, self.fb_plan.nsamp_step
        want = -(-cfg.min_block_samples // step)
        cap = geom.npart(self.source.total_samples)
        self.npart = min(max(want, cfg.block_parts), cap) if cap > 0 \
            else cfg.block_parts
        self.block_in_samples = geom.block_ndat(self.npart)
        self.stride_in_samples = self.npart * step

        if self.megafil_plan is not None:
            scale, offset = unpack_affine(obs.nbit, up.twos_complement)
            self.constants = MegaConstants.build(
                self.megafil_plan, response, unpack_scale=scale,
                unpack_offset=offset).to(self.device)
            self._megafil = build_megafil(self.megafil_plan, self.constants,
                                          self.npart)
        else:
            self._megafil = None
            self._pfb_h = (torch.from_numpy(prototype_lowpass(
                self.nchan_subband, cfg.pfb_ntaps)).to(self.device)
                if self.pfb_plan is not None else None)
            self._response = (torch.from_numpy(response.astype(
                np.complex64)).to(self.device) if response is not None
                else None)

        nchan, npol = self.obs_out.nchan, self.obs_out.npol
        self._rescale_state = RescaleState.zeros(nchan, npol, self.device)
        self._mean = torch.zeros((nchan, npol), dtype=torch.float32,
                                 device=self.device)
        self._inv = torch.ones((nchan, npol), dtype=torch.float32,
                               device=self.device)
        self._blocks_done = 0
        self._since_update = 0

    def _general_front(self, raw: torch.Tensor):
        """The general chain's half of a block (JAX ``load_to_fil.py:
        354-373``): unpack, pol select, polyphase or FFT filterbank, detect.
        Returns the detected ``[nchan, npol_out, ndat]`` and the unpacker's
        block weights (None unless JA98)."""
        cfg = self.config
        x, w = self.unpack_plan.unpack(raw)
        if cfg.poln_select is not None:
            x = poln_select(x, cfg.poln_select)
        if self.pfb_plan is not None:
            y = polyphase_filterbank_block(x, self._pfb_h, self.pfb_plan,
                                           self.npart)
        else:
            y = filterbank_block(x, self.fb_plan, self.npart, self._response)
        return detect(y, self.det_state), w

    def _stream_weights(self, w, nuse: int):
        """The unpacker's block weights on the output samples after the
        channelizer and the scrunches (JAX ``load_to_fil.py:299-337``): a
        window's outputs are bad when any input sample of the window was
        (``window_weights``), and a scrunched sample when any of its
        contributors was.
        ``[nchan_out, nuse]``, or None without weights."""
        if w is None or w.shape[1] == 0:
            return None
        cfg = self.config
        nchan_in = w.shape[0]
        npw = self.unpack_plan.ndat_per_weight
        if self.pfb_plan is not None:
            step, nfft = self.pfb_plan.step, self.pfb_plan.window_samples
            nkeep = 1
        else:
            step, nfft = self.fb_plan.nsamp_step, self.fb_plan.nsamp_fft
            nkeep = self.fb_plan.nkeep
        wwin = window_weights(w, self.npart, step, nfft, npw)
        ex = wwin[:, :, None].expand(nchan_in, self.npart, nkeep).reshape(
            nchan_in, -1).repeat_interleave(self.nchan_subband, dim=0)
        f = cfg.fscrunch_factor
        if f > 1:
            ex = ex.reshape(ex.shape[0] // f, f, -1).amin(dim=1)
        t = cfg.tscrunch_factor
        if t > 1:
            n = (ex.shape[-1] // t) * t
            ex = ex[:, :n].reshape(ex.shape[0], n // t, t).amin(dim=2)
        return ex[:, :nuse]

    def _local_chain(self, raw: torch.Tensor):
        """One block up to the rescale: the fused front end or the general
        chain's, then the scrunches and the excision weights (JAX
        ``parallel/search.py::_local_chain``).  Returns the detected,
        scrunched ``[nchan, npol, ndat]`` and its weights ``[nchan, ndat]``
        (None without)."""
        cfg = self.config
        if self._megafil is not None:
            d, w = self._megafil(raw), None
        else:
            d, w = self._general_front(raw)
        d = fscrunch(d, cfg.fscrunch_factor)
        d = tscrunch(d, cfg.tscrunch_factor)
        weights = (self._stream_weights(w, d.shape[-1])
                   if cfg.apply_weights else None)
        return d, weights

    def _step(self, rescale_state, mean, inv, raw, mode="cumulative"):
        """One block: the fused front end or the general chain's ->
        scrunch -> [weights] -> rescale -> digitize.  Returns
        ``(rescale_state, mean, inv, packed bytes)``.

        ``mode`` selects the Rescale update (``Signal/General/Rescale.C``):
          cumulative  accumulate, then use the running stats
          hold        use the passed mean/inv unchanged
          acc_hold    accumulate for the next interval, apply passed scales
          acc_update  interval boundary: accumulate, derive new scales,
                      reset the accumulator
        """
        cfg = self.config
        d, weights = self._local_chain(raw)
        if mode in ("cumulative", "acc_hold", "acc_update"):
            rescale_state = accumulate(rescale_state, d, weights)
        if mode in ("cumulative", "acc_update"):
            mean, inv = state_mean_scale(rescale_state)
        if mode == "acc_update":
            rescale_state = RescaleState.zeros(*rescale_state.count.shape,
                                               device=self.device)
        z = apply_scales(d, mean, inv, weights)
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
