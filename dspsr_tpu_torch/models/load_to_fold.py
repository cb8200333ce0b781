"""Fold-mode pipeline on the fused step: load -> (unpack, filterbank with
chirp, detect, fold in one step) -> archive.

Counterpart of ``dspsr_tpu/models/load_to_fold.py`` for the configurations
the JAX package runs with ``mega_mode == "full"``: a convolving filterbank
(``nchan > nchan_in``) over real-sampled 8-bit input, with any detection
state but NthPower, optional fourth moments and sample-exact
sub-integrations.  The host reads raw bytes and computes float64 phase
anchors per block; one call of the fused step folds the block on the device.
A configuration that needs the JAX package's hybrid or general engines
raises ``NotImplementedError`` naming the ROADMAP item that will port it.
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass
from typing import Optional

import numpy as np
import torch

# Observation, Signal and MJD are also this module's public names: a caller
# builds the input Observation from them without naming dspsr_tpu
from dspsr_tpu.io.sources import Source, open_source
from dspsr_tpu.observation import Observation, Signal
from dspsr_tpu.ops.dedispersion import Dedispersion
from dspsr_tpu.ops.response import choose_nfft
from dspsr_tpu.timing.mjd import MJD
from dspsr_tpu.timing.par import Ephemeris
from dspsr_tpu.timing.polyco import FixedPeriodPredictor, Polyco

from ..device import resolve_device
from ..ops.filterbank import FilterbankPlan, update_observation
from ..ops.fold import FoldPlan, choose_nbin, compute_anchors
from ..ops.megakernel import (
    MegaConstants, MegaPlan, build_megastep, unpack_affine)
from ..unpack.unpackers import UnpackPlan, state_counts_from_byte_counts


@dataclass
class FoldConfig:
    """The JAX package's ``FoldConfig`` (reference ``LoadToFold::Config``)
    without the settings of features the port lacks; the switches of those
    features stay, and ``FoldPipeline`` raises ``NotImplementedError`` when
    one is set."""

    # dispersion / channelization
    dispersion_measure: Optional[float] = None
    nchan: int = 1
    frequency_resolution: Optional[int] = None
    times_minimum_nfft: int = 0
    coherent: bool = True

    # folding
    nbin: int = 0
    folding_period: Optional[float] = None
    polyco_path: Optional[str] = None
    ephemeris_path: Optional[str] = None
    additional_pulsars: tuple = ()
    calibration_path: Optional[str] = None
    use_fft_bench: bool = False
    fft_window: Optional[str] = None
    passband: bool = False
    pdmp_stats: bool = False
    reference_phase: float = 0.0
    reference_epoch: Optional[float] = None

    # detection
    npol_out: int = 1
    detection: Optional[str] = None
    fourth_moment: bool = False
    interchannel_align: bool = False

    # cyclic spectroscopy
    cyclic_nchan: int = 0

    # input windowing
    seek_seconds: float = 0.0

    # subints
    subint_seconds: float = 0.0
    subint_turns: int = 0
    minimum_integration_length: float = 0.0
    integration_reference_epoch: Optional[float] = None
    fractional_pulses: bool = False

    # engine geometry
    block_parts: int = 4
    use_megakernel: bool = True
    min_block_samples: int = 1 << 20
    max_nfft: int = 1 << 24

    # observability
    report: bool = False
    digitizer_stats: bool = True
    dump_path: Optional[str] = None

    # unpacking (ndat_per_weight and cutoff_sigma are 2-bit settings,
    # recorded in the signal path as the JAX package records them)
    twos_complement: bool = False
    ndat_per_weight: int = 512
    cutoff_sigma: float = 3.0

    # RFI excision (not ported: setting either raises)
    rfi_filter: bool = False
    sk_enable: bool = False

    def detection_state(self) -> Signal:
        if self.detection:
            return {
                "intensity": Signal.INTENSITY, "ppqq": Signal.PPQQ,
                "pp": Signal.PP, "qq": Signal.QQ,
                "coherence": Signal.COHERENCE, "stokes": Signal.STOKES,
                "nthpower": Signal.NTHPOWER,
            }[self.detection.lower()]
        return {1: Signal.INTENSITY, 2: Signal.PPQQ, 3: Signal.NTHPOWER,
                4: Signal.STOKES}[self.npol_out]


@dataclass
class FoldResult:
    """The PhaseSeries equivalent, with the JAX package's field names, so
    ``dspsr_tpu.io.archive.save_archive`` writes it unchanged."""

    profiles: np.ndarray  # [nsub, nchan, npol, nbin]
    hits: np.ndarray  # [nsub, nchan, nbin]
    epochs: list  # MJD of each subint's first folded data
    integration_length: np.ndarray  # seconds per subint
    obs: Observation  # output-domain observation
    nbin: int = 0
    folding_period: float = 0.0
    dispersion_measure: float = 0.0
    cyclic_nlag: int = 0
    cyclic_mover: int = 1
    cyclic_npol: int = 1
    signal_path: Optional[list] = None
    digitizer_counts: Optional[np.ndarray] = None
    extra_sources: Optional[list] = None
    label: Optional[str] = None
    passband: Optional[np.ndarray] = None
    pdmp_stats: Optional[np.ndarray] = None
    pdmp_nsamp: int = 0
    predictor: Optional[object] = None
    ephemeris: Optional[object] = None

    def normalized(self) -> np.ndarray:
        """Profiles divided by hits (``Archiver.C`` raw_to_central)."""
        h = np.maximum(self.hits[:, :, None, :], 1.0)
        return self.profiles / h

    def to_stokes(self) -> "FoldResult":
        """4-pol COHERENCE (PP, QQ, Re[P*Q], Im[P*Q]) to Stokes I,Q,U,V."""
        if self.obs.state != Signal.COHERENCE:
            raise ValueError(f"not coherence data: {self.obs.state}")
        pp, qq = self.profiles[:, :, 0], self.profiles[:, :, 1]
        re, im = self.profiles[:, :, 2], self.profiles[:, :, 3]
        stokes = np.stack([pp + qq, pp - qq, 2.0 * re, 2.0 * im], axis=2)
        return dataclasses.replace(
            self, profiles=stokes, obs=self.obs.replace(state=Signal.STOKES))

    def dedispersed(self, ref_freq: float | None = None) -> np.ndarray:
        """Normalized profiles with inter-channel dispersion delays rotated
        out by an FFT phase ramp (PSRCHIVE ``Archive::dedisperse``)."""
        from dspsr_tpu.ops.dedispersion import delay_time

        prof = self.normalized()
        if self.dispersion_measure == 0 or self.folding_period <= 0:
            return prof
        obs = self.obs
        if ref_freq is None:
            ref_freq = obs.centre_frequency
        nbin = prof.shape[-1]
        k = np.fft.rfftfreq(nbin) * nbin
        out = np.empty_like(prof)
        for c in range(obs.nchan):
            dphi = delay_time(self.dispersion_measure,
                              obs.centre_frequency_of(c),
                              ref_freq) / self.folding_period
            ramp = np.exp(2j * np.pi * k * dphi)
            spec = np.fft.rfft(prof[:, c], axis=-1) * ramp
            out[:, c] = np.fft.irfft(spec, n=nbin, axis=-1)
        return out


_HYBRID = "ROADMAP.md Queue 1 item 6 (hybrid fold tail, build_megafil)"
_GENERAL = "ROADMAP.md Queue 1 item 8 (general chain)"


def _unsupported(cfg: FoldConfig) -> Optional[str]:
    """Why ``cfg`` needs an engine the port lacks (None if it does not)."""
    checks = (
        (cfg.sk_enable, "spectral kurtosis (sk_enable)", _HYBRID),
        (cfg.rfi_filter, "RFI filter (rfi_filter)", _HYBRID),
        (cfg.cyclic_nchan, "cyclic folding (cyclic_nchan)", _HYBRID),
        (cfg.calibration_path, "Jones calibration (calibration_path)",
         _HYBRID),
        (cfg.additional_pulsars, "multi-pulsar folding "
         "(additional_pulsars)", _HYBRID),
        (cfg.passband, "passband integration (passband)", _HYBRID),
        (cfg.dump_path, "detected-stream dump (dump_path)", _HYBRID),
        (cfg.pdmp_stats, "pdmp moments (pdmp_stats)", _HYBRID),
        (cfg.detection_state() == Signal.NTHPOWER, "NthPower detection",
         _HYBRID),
        (not cfg.use_megakernel, "use_megakernel=False", _GENERAL),
        (cfg.use_fft_bench, "measured FFT lengths (use_fft_bench)",
         "ROADMAP.md Queue 1 item 11"),
        (cfg.fft_window, "apodization (fft_window)",
         "ROADMAP.md Queue 1 item 7"),
    )
    for bad, what, item in checks:
        if bad:
            return f"{what}; see {item}"
    return None


class FoldPipeline:
    """Constructed, prepared fold pipeline over one Source, running the
    fused step on ``device`` (``"cuda"`` by default; a CPU run must be asked
    for by name and uses the plain PyTorch step)."""

    def __init__(self, source: Source, config: FoldConfig,
                 device="cuda"):
        self.device = resolve_device(device)
        self.source = source
        self.config = config
        self.obs_in = source.obs
        why = _unsupported(config)
        if why:
            raise NotImplementedError(why)
        self._construct()

    # ---- construction (LoadToFold::construct/prepare equivalents) ----

    def _construct(self):
        cfg = self.config
        obs = self.obs_in

        # --- predictor & DM (LoadToFold1.C:676-744) ---
        self.ephemeris = (Ephemeris.load(cfg.ephemeris_path)
                          if cfg.ephemeris_path else None)
        if cfg.folding_period:
            epoch = obs.start_time
            if cfg.reference_epoch is not None:
                epoch = MJD.from_mjd(float(cfg.reference_epoch))
            self.predictor = FixedPeriodPredictor(cfg.folding_period, epoch)
        elif cfg.polyco_path:
            from dspsr_tpu.timing.t2pred import T2Predictor, load_predictor

            self.predictor = load_predictor(cfg.polyco_path)
            if isinstance(self.predictor, T2Predictor):
                self.predictor.obsfreq = obs.centre_frequency
        elif self.ephemeris is not None:
            from dspsr_tpu.timing.polyco import SpinPredictor

            self.predictor = SpinPredictor.from_ephemeris(
                self.ephemeris, telescope=obs.telescope)
        elif obs.mode == "CAL" and obs.calfreq > 0:
            # fold at the pulsed-cal frequency (Fold.C:190-227)
            self.predictor = FixedPeriodPredictor(1.0 / obs.calfreq,
                                                  obs.start_time)
        else:
            raise ValueError("need folding_period, polyco_path, "
                             "ephemeris_path, or MODE=CAL with CALFREQ")

        if self.ephemeris is not None and not obs.coordinates:
            raj = self.ephemeris.get("RAJ")
            decj = self.ephemeris.get("DECJ")
            if raj and decj:
                self.obs_in = obs = obs.replace(coordinates=f"{raj} {decj}")

        dm = cfg.dispersion_measure
        if dm is None and self.ephemeris is not None:
            dm = self.ephemeris.dm
        if dm is None and isinstance(self.predictor, Polyco):
            dm = self.predictor.blocks[0].dm
        if dm is None:
            from dspsr_tpu.timing.t2pred import T2Predictor

            if isinstance(self.predictor, T2Predictor) \
                    and self.predictor.models:
                m = self.predictor.models[0]
                f0 = self.predictor.frequency(obs.start_time)
                if f0 > 0 and m.dispersion_constant != 0.0:
                    dm = -m.dispersion_constant * 2.41e-4 / f0
        if dm is None:
            dm = obs.dispersion_measure
        self.dm = float(dm or 0.0)

        # --- unpacker (raises for anything but real 8-bit TFP) ---
        self.unpack_plan = UnpackPlan(obs,
                                      twos_complement=cfg.twos_complement)

        # --- convolving filterbank geometry (Filterbank.C:55-263) ---
        real_input = obs.state == Signal.NYQUIST
        self.nchan_subband = max(1, cfg.nchan // obs.nchan) if cfg.nchan \
            else 1
        if self.nchan_subband == 1:
            raise NotImplementedError(
                "no filterbank stage (nchan_subband == 1): the fused fold "
                f"step needs one; see {_HYBRID}")
        nchan_out = obs.nchan * self.nchan_subband
        if cfg.coherent and self.dm > 0:
            nfp = Dedispersion._half_smearing_samples(
                self.dm, obs.centre_frequency, obs.bandwidth, nchan_out,
                +1, 0.1)
            nfn = Dedispersion._half_smearing_samples(
                self.dm, obs.centre_frequency, obs.bandwidth, nchan_out,
                -1, 0.1)
        else:
            nfp = nfn = 0
        nfilt_tot = nfp + nfn
        if cfg.frequency_resolution:
            freq_res = cfg.frequency_resolution
        elif nfilt_tot == 0:
            freq_res = 1
        elif cfg.times_minimum_nfft:
            m = 1
            while m <= nfilt_tot:
                m *= 2
            freq_res = cfg.times_minimum_nfft * m
        else:
            freq_res = choose_nfft(nfilt_tot, max_nfft=cfg.max_nfft)
        self.fb_plan = FilterbankPlan(
            real_input=real_input, nchan_subband=self.nchan_subband,
            freq_res=freq_res, nfilt_pos=nfp, nfilt_neg=nfn)
        self.fb_plan.validate()
        self.obs_stream = update_observation(obs, self.fb_plan)
        ndat_fft = freq_res

        # --- chirp (Dedispersion::match/build; LoadToFold1.C:199-241) ---
        if cfg.coherent and self.dm > 0:
            builder = (Dedispersion.build_interchannel_aligned
                       if cfg.interchannel_align else Dedispersion.build)
            self.kernel = builder(self.dm, obs.centre_frequency,
                                  obs.bandwidth, nchan_out, ndat_fft)
            if cfg.interchannel_align:
                # the -K delay ramps may need more overlap than the smear:
                # grow the FFT until they fit, then adopt their impulse
                if not cfg.frequency_resolution:
                    while (self.kernel.impulse_total >= ndat_fft
                           and ndat_fft < cfg.max_nfft):
                        ndat_fft = choose_nfft(self.kernel.impulse_total,
                                               max_nfft=cfg.max_nfft)
                        self.kernel = builder(self.dm, obs.centre_frequency,
                                              obs.bandwidth, nchan_out,
                                              ndat_fft)
                self.fb_plan = FilterbankPlan(
                    real_input=real_input, nchan_subband=self.nchan_subband,
                    freq_res=ndat_fft, nfilt_pos=self.kernel.impulse_pos,
                    nfilt_neg=self.kernel.impulse_neg)
                self.fb_plan.validate()
                self.obs_stream = update_observation(obs, self.fb_plan)
        else:
            self.kernel = None

        # --- detection ---
        self.det_state = cfg.detection_state()
        self.obs_out = self.obs_stream.apply_detection(self.det_state)
        if cfg.fourth_moment:
            if cfg.npol_out != 4:
                raise ValueError("fourth_moment requires npol_out=4 (Stokes)")
            self.obs_out = self.obs_out.replace(npol=14)

        # --- fold plan (Fold::prepare; choose_nbin Fold.C:275-382) ---
        tsamp_out = 1.0 / self.obs_out.rate
        self.nbin = choose_nbin(self.predictor.period(obs.start_time),
                                tsamp_out, cfg.nbin)
        self.folding_period = self.predictor.period(obs.start_time)

        # --- the fused step's plan, with its rounded overlap adopted ---
        det_np, det_tag = self._mega_detection()
        if not ((det_np == 1 or obs.npol == 2)
                and (self.det_state not in (Signal.PP, Signal.QQ)
                     or obs.npol == 2)):
            raise NotImplementedError(
                f"{self.det_state.value} detection of npol={obs.npol} input "
                f"is not on the fused path; see {_GENERAL}")
        mp = MegaPlan.from_filterbank(
            self.fb_plan, self.nbin, obs.npol, det_np, obs.nbit,
            nchan_in=obs.nchan, ndat_per_weight=0, detection=det_tag,
            fourth_moment=cfg.fourth_moment,
            twos_complement=self.unpack_plan.twos_complement,
            interleave=self.unpack_plan.layout)
        if mp is None:
            raise NotImplementedError(
                f"filterbank geometry {self.fb_plan} does not factor for the "
                f"fused step; see {_GENERAL}")
        self.mega_plan = mp
        self.mega_mode = "full"
        self.fb_plan = FilterbankPlan(
            real_input=mp.real_input, nchan_subband=mp.nsub,
            freq_res=mp.freq_res, nfilt_pos=mp.nfilt_pos,
            nfilt_neg=mp.nfilt_neg)

        # --- block geometry ---
        self._plan_blocks()

        # one phase anchor per overlap-save window of nkeep output samples
        self.fold_plan = FoldPlan(self.nbin, mp.nkeep)
        scale, offset = unpack_affine(obs.nbit,
                                      self.unpack_plan.twos_complement)
        resp = self.kernel.phasors if self.kernel is not None else None
        self.constants = MegaConstants.build(
            mp, resp, unpack_scale=scale, unpack_offset=offset
        ).to(self.device)
        self._megastep = build_megastep(mp, self.constants, self.npart)

        # --- accumulators: per input channel [nplane, nsub, nbin] ---
        self._profiles = torch.zeros(
            (obs.nchan, mp.nplane, mp.nsub, self.nbin), dtype=torch.float32,
            device=self.device)
        self._hits = torch.zeros((obs.nchan, self.nbin), dtype=torch.float32,
                                 device=self.device)
        self._subints: list = []
        self._current_div = 0
        self._div_samples = 0.0
        self._first_out_time: Optional[MJD] = None
        self._div_first_time: Optional[MJD] = None
        self._byte_counts = np.zeros(256, np.int64)

    def _mega_detection(self):
        """(npol_out planes before fourth moments, kernel detection tag)."""
        np_map = {Signal.INTENSITY: 1, Signal.PP: 1, Signal.QQ: 1,
                  Signal.PPQQ: 2, Signal.COHERENCE: 4, Signal.STOKES: 4}
        tag = {Signal.PP: "pp", Signal.QQ: "qq",
               Signal.COHERENCE: "coherence"}.get(self.det_state, "auto")
        return np_map[self.det_state], tag

    def signal_path(self) -> list:
        """Ordered record of the op chain with its resolved parameters
        (reference ``dsp::SignalPath``), as the JAX package records it."""
        cfg = self.config
        obs = self.obs_in
        path: list = [{
            "op": "Source", "format": obs.format,
            "file": getattr(self.source, "path", None),
            "nchan": obs.nchan, "npol": obs.npol, "nbit": obs.nbit,
        }, {
            "op": "Unpack", "nbit": obs.nbit,
            "twos_complement": cfg.twos_complement,
            "ndat_per_weight": cfg.ndat_per_weight,
            "cutoff_sigma": cfg.cutoff_sigma,
        }]
        if self.kernel is not None:
            path.append({
                "op": "Dedispersion", "dm": self.dm,
                "impulse_pos": self.kernel.impulse_pos,
                "impulse_neg": self.kernel.impulse_neg,
                "interchannel_align": cfg.interchannel_align,
            })
        path.append({
            "op": "Filterbank",
            "nchan_subband": self.fb_plan.nchan_subband,
            "freq_res": self.fb_plan.freq_res,
            "convolve_when": "During" if self.kernel is not None else "Never",
        })
        path.append({"op": "Detection", "state": self.det_state.value})
        if cfg.fourth_moment:
            path.append({"op": "FourthMoment"})
        path.append({
            "op": "Fold", "nbin": self.nbin,
            "predictor": type(self.predictor).__name__,
            "folding_period": self.folding_period,
            "reference_phase": cfg.reference_phase,
        })
        if cfg.subint_seconds > 0 or cfg.subint_turns > 0:
            path.append({"op": "Subint",
                         "seconds": cfg.subint_seconds,
                         "turns": cfg.subint_turns})
        return path

    def _plan_blocks(self):
        cfg = self.config
        p = self.fb_plan
        self.nsamp_step = p.nsamp_step
        # grow blocks toward min_block_samples, but never beyond the source
        # nor beyond a subint (so -L granularity holds at block level)
        want = -(-cfg.min_block_samples // p.nsamp_step)
        avail = self.source.total_samples
        if cfg.seek_seconds > 0 and self.obs_in.rate > 0:
            avail = max(avail - int(cfg.seek_seconds * self.obs_in.rate),
                        p.block_ndat(1))
        cap = p.npart(avail)
        if cfg.subint_seconds > 0 and self.obs_in.rate > 0:
            sub_samps = int(cfg.subint_seconds * self.obs_in.rate)
            cap = min(cap, max(p.npart(sub_samps), 1))
        if cfg.subint_turns > 0 and self.obs_in.rate > 0:
            period = self.predictor.period(self.obs_in.start_time)
            sub_samps = int(cfg.subint_turns * period * self.obs_in.rate)
            cap = min(cap, max(p.npart(sub_samps), 1))
        self.npart = min(max(want, cfg.block_parts), cap) if cap > 0 \
            else cfg.block_parts
        self.block_in_samples = p.block_ndat(self.npart)
        self.out_per_block = self.npart * p.nkeep
        self.stride_in_samples = self.npart * self.nsamp_step

    # ---- host streaming loop (SingleThread::run equivalent) ----

    def output_start_time(self, block_start_sample: int) -> MJD:
        """MJD of output sample 0 of the block starting at the given input
        sample (shifted by nfilt_pos; ``Filterbank.C:369``)."""
        t0 = self.obs_in.start_time + block_start_sample / self.obs_in.rate
        return t0 + self.fold_plan_offset_seconds()

    def fold_plan_offset_seconds(self) -> float:
        return self.fb_plan.nfilt_pos / self.obs_out.rate

    def to_device(self, a: np.ndarray) -> torch.Tensor:
        """A host array to the pipeline's device (through pinned memory on
        CUDA, copied without waiting for the device)."""
        t = torch.from_numpy(a)
        if self.device.type == "cuda":
            return t.pin_memory().to(self.device, non_blocking=True)
        return t.to(self.device)

    def run(self, max_blocks: Optional[int] = None,
            total_seconds: Optional[float] = None,
            seek_seconds: Optional[float] = None) -> FoldResult:
        """Stream all blocks through the fused step; returns the result.

        total_seconds limits input consumed (reference -T); seek_seconds
        skips that much input first (reference -S).
        """
        from dspsr_tpu.utils.report import RunReport

        src = self.source
        if seek_seconds is None:
            seek_seconds = self.config.seek_seconds
        seek = int(seek_seconds * self.obs_in.rate) if seek_seconds else 0
        nsamp_total = src.total_samples
        if total_seconds is not None:
            nsamp_total = min(nsamp_total,
                              seek + int(total_seconds * self.obs_in.rate))

        rep = RunReport(enabled=self.config.report)
        start = seek
        nblocks = 0
        out_off = 0  # global output-sample index of the next block
        tsamp_out = 1.0 / self.obs_out.rate
        nuse = self.out_per_block

        # sample-exact sub-integrations (reference TimeDivide/SubFold): a
        # block that spans a boundary is folded once per division with
        # [lo, hi) bounds
        divider = None
        if self.config.subint_seconds > 0 or self.config.subint_turns > 0:
            from dspsr_tpu.timing.timedivide import TimeDivide

            lep = self.config.integration_reference_epoch
            divider = TimeDivide(
                rate=self.obs_out.rate,
                start_time=self.output_start_time(seek),
                seconds=self.config.subint_seconds,
                turns=self.config.subint_turns,
                predictor=self.predictor,
                reference_phase=self.config.reference_phase,
                reference_epoch=(MJD.from_mjd(lep) if lep else None),
                fractional_pulses=self.config.fractional_pulses)
            if nuse >= (1 << 24):
                # the reference's fused kernel compares bounds in f32
                # (exact below 2^24); keep its limit so results agree
                raise ValueError(
                    "sub-integration bounds need out_per_block < 2^24 on "
                    "the fused path; reduce the block size")

        while start + self.block_in_samples <= nsamp_total:
            if max_blocks is not None and nblocks >= max_blocks:
                break
            segs = (divider.segments(out_off, nuse)
                    if divider is not None else [(0, nuse, 0)])
            t_out0 = self.output_start_time(start)
            with rep.stage("read"):
                raw = src.read_samples(start, self.block_in_samples)
            if self.config.digitizer_stats and self.obs_in.nbit <= 8:
                self._byte_counts += np.bincount(raw, minlength=256)
            with rep.stage("anchors"):
                phi0, dphi = compute_anchors(self.predictor, t_out0,
                                             tsamp_out, nuse,
                                             self.fold_plan.seg_len)
            phi0 = (phi0 - self.config.reference_phase) % 1.0
            start += self.stride_in_samples

            with rep.stage("device_step"):
                raw_t = self.to_device(raw)
                phi0_t = self.to_device(np.ascontiguousarray(phi0, np.float32))
                dphi_t = self.to_device(np.ascontiguousarray(dphi, np.float32))
                for (lo, hi, dv) in segs:
                    if dv < 0:
                        # data before the first division: discarded
                        # (TimeDivide::set_bounds idat_start skip)
                        continue
                    bounds = None
                    if divider is not None:
                        if dv != self._current_div:
                            self._flush_division()
                            self._current_div = dv
                        if self._div_first_time is None:
                            self._div_first_time = divider.epoch_of(
                                out_off + lo)
                        bounds = (lo, hi)
                        self._div_samples += hi - lo
                    self._profiles, self._hits = self._megastep(
                        self._profiles, self._hits, raw_t, phi0_t, dphi_t,
                        bounds)
            rep.add_samples(self.stride_in_samples)
            if self.obs_in.rate > 0:
                rep.progress(start / self.obs_in.rate,
                             nsamp_total / self.obs_in.rate)
            if self._first_out_time is None:
                self._first_out_time = t_out0
            if divider is None:
                if self._div_first_time is None:
                    self._div_first_time = t_out0
                self._div_samples += nuse
            out_off += nuse
            nblocks += 1

        self._flush_division()
        return self._finish()

    # ---- sub-integration handling ----

    def _flush_division(self):
        if self._div_samples == 0:
            return
        prof = self._profiles.cpu().numpy()
        hits = self._hits.cpu().numpy()
        # [nchan_in, nplane, nsub, nbin] -> archive [nchan_out, npol, nbin];
        # hits are per input channel and broadcast over its subbands
        nsub = self.mega_plan.nsub
        nci = prof.shape[0]
        prof = np.ascontiguousarray(prof.transpose(0, 2, 1, 3).reshape(
            nci * nsub, prof.shape[1], self.nbin))
        hits = np.repeat(hits, nsub, axis=0)
        self._subints.append(
            (prof, hits, self._div_first_time or self._first_out_time,
             self._div_samples / self.obs_out.rate))
        self._div_first_time = None
        self._profiles = torch.zeros_like(self._profiles)
        self._hits = torch.zeros_like(self._hits)
        self._div_samples = 0.0

    def _finish(self) -> FoldResult:
        if not self._subints:
            self._flush_division()
        if self.config.minimum_integration_length > 0:
            self._subints = [
                s for s in self._subints
                if s[3] >= self.config.minimum_integration_length]
        if self._subints:
            profs = np.stack([s[0] for s in self._subints])
            hits = np.stack([s[1] for s in self._subints])
        else:
            profs = np.zeros((0, self.obs_out.nchan, self.obs_out.npol,
                              self.nbin))
            hits = np.zeros((0, self.obs_out.nchan, self.nbin))
        counts = None
        if self.config.digitizer_stats and self.obs_in.nbit <= 8 \
                and self._byte_counts.any():
            counts = state_counts_from_byte_counts(self._byte_counts,
                                                   self.obs_in.nbit)
        return FoldResult(
            profiles=profs,
            hits=hits,
            epochs=[s[2] for s in self._subints],
            integration_length=np.array([s[3] for s in self._subints]),
            obs=self.obs_out,
            nbin=self.nbin,
            folding_period=self.predictor.period(self.obs_in.start_time),
            dispersion_measure=self.dm,
            signal_path=self.signal_path(),
            digitizer_counts=counts,
            predictor=self.predictor,
            ephemeris=self.ephemeris,
        )


def load_to_fold(path: str, config: FoldConfig, device="cuda",
                 **run_kw) -> FoldResult:
    """Open, construct, run: the dspsr app in a line."""
    return FoldPipeline(open_source(path), config, device=device).run(**run_kw)
