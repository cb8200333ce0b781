"""Fold-mode pipeline: load -> unpack -> (filterbank | convolution) ->
detect -> fold -> archive.

Counterpart of ``dspsr_tpu/models/load_to_fold.py`` for 1/2/4/8-bit codes
(fixed levels, or JA98 dynamic 2-bit levels whose excision weights zero
the windows they flag) and float32 samples, real-sampled or complex, in
TFP order (8-bit real input also in the CASPSR layout), optionally
apodized (``fft_window``), through a convolving
filterbank (``nchan > nchan_in``) or, without one (``nchan_subband == 1``),
the overlap-save convolution of each input channel (coherent
dedispersion, optionally with polarization calibration: a Jones response
mixed into the two pols' spectra), or no FFT stage at all, in the JAX
package's three engines, chosen once at construction as it chooses them:

- ``mega_mode == "full"``: one call of the fused fold step
  (``build_megastep``) folds the block; any detection state but NthPower,
  optional fourth moments, sample-exact sub-integrations.
- ``mega_mode == "hybrid"``: the fused front end (``build_megafil``,
  detected output, or the voltage for cyclic folding) followed by the
  reference's fold tail in plain PyTorch (detection conversion or the
  cyclic lag products, fourth moments, in-stream spectral kurtosis, the
  fold of one or more pulsars, dump, passband and pdmp extras), with the
  spectral RFI filter as a chirp handed to the front end each block.  A
  configuration the full step cannot take goes hybrid, as in the JAX
  package (``_mega_full_eligible``): the ``nsub == 1`` convolution and
  Jones calibration always do.
- ``mega_mode is None``: the general chain (the JAX package's
  ``_step_core``), where the fused front end cannot go
  (``_mega_front_eligible``: ``use_megakernel=False``, no FFT stage, JA98
  with two's complement, a detection the fused planes cannot give) or the
  geometry does not factor (``MegaPlan.from_filterbank`` returns None):
  unpack, ``torch.fft`` filterbank or convolution on ``complex64``
  streams, detection, then the hybrid engine's tail.  It launches neither
  kernel.

The host reads raw bytes and computes float64 phase anchors per block.
Every plan the JAX package runs fused (``MegaPlan.choose_r1``: R1 up to
1024, R2 up to 8192) runs on the port's kernels: past one CTA's inverse
they take the multi-pass inverse (``kernels/megastep.py::fold_passes``,
``kernels/megafil.py::inverse_passes``) and, for real input at R2 = 8192,
the long row pass (``forward_tiles``); the pipeline never falls back to
the general chain.
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass
from typing import Optional

import numpy as np
import torch

# Observation, Signal and MJD are also this module's public names: a caller
# builds the input Observation from them without naming dspsr_tpu
from ..io.sources import Source, open_source
from ..observation import Observation, Signal
from ..ops.dedispersion import Dedispersion
from ..ops.response import choose_nfft
from ..timing.mjd import MJD
from ..timing.par import Ephemeris
from ..timing.polyco import FixedPeriodPredictor, Polyco

from ..device import BlockStaging, host_to_device, resolve_device
from ..ops.convolution import (
    OverlapSavePlan, overlap_save_convolve, overlap_save_convolve_jones)
from ..ops.cyclic import CyclicPlan, fold_lag_products, lag_planes
from ..ops.detection import detect, from_front_planes
from ..ops.filterbank import (
    FilterbankPlan, apply_response_chunked, forward_spectra_chunked,
    invert_subbands, update_observation)
from ..ops.fold import FoldPlan, choose_nbin, compute_anchors, fold_block
from ..ops.fourth_moment import fourth_moment
from ..ops.apodization import WindowType, build_window
from ..ops.megakernel import (
    MegaConstants, MegaPlan, build_megafil, build_megastep, unpack_affine)
from ..ops.polncal import jones_fft_order
from ..ops.response import Response
from ..ops.rfifilter import median_filter_freq
from ..ops.spectral_kurtosis import SKPlan, expand_mask, sk_mask
from ..unpack.unpackers import (
    UnpackPlan, state_counts_from_byte_counts, window_weights)
from ..utils.report import DISABLED, RunReport


@dataclass
class FoldConfig:
    """The JAX package's ``FoldConfig`` (reference ``LoadToFold::Config``)
    without the settings of features the port lacks; the switches of those
    features stay, and ``FoldPipeline`` raises ``NotImplementedError`` when
    one is set.  Field meanings are the JAX package's."""

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

    # cyclic spectroscopy (reference -cyclic N / CyclicFold)
    cyclic_nchan: int = 0  # cyclic channels per input channel (0 = off)
    cyclic_mover: int = 1  # oversampling factor

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

    # unpacking
    twos_complement: bool = False
    #: 2-bit: JA98 dynamic output levels + excision (TwoBitCorrection; the
    #: reference's 2-bit instruments); False = the plain fixed BitTable
    #: level map, no excision weights
    dynamic_twobit: bool = True
    ndat_per_weight: int = 512
    cutoff_sigma: float = 3.0

    # narrow-band RFI zapping from the median bandpass (reference
    # RFIFilter): carried (the previous block's mask, the first block
    # primed with its own) or, with rfi_same_block, two front passes a block
    rfi_filter: bool = False
    rfi_median_width: int = 21
    rfi_threshold: float = 4.0
    rfi_same_block: bool = False

    # spectral kurtosis RFI excision (reference -skz / SKDetector)
    sk_enable: bool = False
    sk_m: int = 128
    sk_std_devs: int = 3
    sk_no_tscr: bool = False
    sk_no_fscr: bool = False
    sk_chan_start: int = 0
    sk_chan_end: int = 0
    #: -noskz_too: also fold the un-zapped stream, returned as an extra
    #: FoldResult labelled "nosk"
    sk_also_unzapped: bool = False

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
    """The PhaseSeries equivalent, with the JAX package's field names, which
    ``io.archive.save_archive`` writes.  ``extra_sources`` holds the results
    of the additional pulsars and of ``-noskz_too`` (``label="nosk"``)."""

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

    def cyclic_spectra(self) -> np.ndarray:
        """Phase-resolved cyclic spectra ``[nsubint, nchan, npol, nbin,
        nchan_cyclic]`` from the folded lag planes (reference
        ``CyclicFoldEngine::synch``; ``ops.cyclic.cyclic_spectra``)."""
        from ..ops.cyclic import cyclic_spectra

        if not self.cyclic_nlag:
            raise ValueError("not a cyclic fold result")
        return np.stack([
            cyclic_spectra(self.normalized()[s].astype(np.float64),
                           self.cyclic_nlag, self.cyclic_mover,
                           self.cyclic_npol)
            for s in range(self.profiles.shape[0])])

    def dedispersed(self, ref_freq: float | None = None) -> np.ndarray:
        """Normalized profiles with inter-channel dispersion delays rotated
        out by an FFT phase ramp (PSRCHIVE ``Archive::dedisperse``)."""
        from ..ops.dedispersion import delay_time

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


_JONES = "ROADMAP.md Queue 1 item 6.3 (Jones calibration)"

#: output samples per phase-anchor segment on the general chain (the JAX
#: package's ``FoldConfig.seg_len`` default); the fused engines anchor every
#: window (``nkeep``)
SEG_LEN = 2048


def _power(x: torch.Tensor) -> torch.Tensor:
    """``|x|^2`` elementwise (``x * x`` for a real stream)."""
    return x.real * x.real + x.imag * x.imag if x.is_complex() else x * x


def _min_pow2_over(n: int) -> int:
    """Smallest power of two above the kernel length ``n`` (the least valid
    overlap-save transform, which ``times_minimum_nfft`` multiplies)."""
    m = 1
    while m <= n:
        m *= 2
    return m


class FoldPipeline:
    """Constructed, prepared fold pipeline over one Source, running on
    ``device`` (``"cuda"`` by default; a CPU run must be asked for by name
    and uses the fused kernels' plain PyTorch versions).  ``mega_mode``
    names the engine: ``"full"``, ``"hybrid"`` or None (the general
    chain)."""

    #: the report of the running ``run`` (``FoldConfig.report``), which a
    #: sub-integration's flush records into
    _report: RunReport = DISABLED

    def __init__(self, source: Source, config: FoldConfig,
                 device="cuda"):
        self.device = resolve_device(device)
        self.source = source
        self.config = config
        self.obs_in = source.obs
        # on a card, ``run`` copies block n+1 while block n's step runs
        self._staging = (BlockStaging(self.device)
                         if self.device.type == "cuda" else None)
        self._construct()

    # ---- construction (LoadToFold::construct/prepare equivalents) ----

    def _source_dm(self, spec) -> Optional[float]:
        """DM recorded for an additional source (None = primary DM)."""
        if isinstance(spec, (int, float)):
            return None
        s = str(spec)
        try:
            if s.endswith(".par"):
                return Ephemeris.load(s).dm
            from ..timing.t2pred import load_predictor

            p = load_predictor(s)
            if isinstance(p, Polyco) and p.blocks:
                return p.blocks[0].dm
        except Exception:
            return None
        return None

    def _best_nfft(self, nfilt_tot: int) -> int:
        """``--fft-bench``: the FFT length of least measured cost a useful
        sample, timed on this pipeline's device (``utils.optimalfft``)."""
        from ..utils.optimalfft import FFTBench, OptimalFFT

        return OptimalFFT(FFTBench(self.device)).get_best_ndat(
            nfilt_tot, max_nfft=self.config.max_nfft)

    def _make_predictor(self, spec):
        """Predictor from a multi-pulsar spec: a period in seconds, a polyco
        or TEMPO2 predictor path, or a .par ephemeris path."""
        obs = self.obs_in
        if isinstance(spec, (int, float)):
            return FixedPeriodPredictor(float(spec), obs.start_time)
        s = str(spec)
        if s.endswith(".par"):
            from ..timing.polyco import SpinPredictor

            return SpinPredictor.from_ephemeris(Ephemeris.load(s),
                                                telescope=obs.telescope)
        from ..timing.t2pred import T2Predictor, load_predictor

        p = load_predictor(s)
        if isinstance(p, T2Predictor):
            p.obsfreq = obs.centre_frequency
        return p

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
            from ..timing.t2pred import T2Predictor, load_predictor

            self.predictor = load_predictor(cfg.polyco_path)
            if isinstance(self.predictor, T2Predictor):
                self.predictor.obsfreq = obs.centre_frequency
        elif self.ephemeris is not None:
            from ..timing.polyco import SpinPredictor

            self.predictor = SpinPredictor.from_ephemeris(
                self.ephemeris, telescope=obs.telescope)
        elif obs.mode == "CAL" and obs.calfreq > 0:
            # fold at the pulsed-cal frequency (Fold.C:190-227)
            self.predictor = FixedPeriodPredictor(1.0 / obs.calfreq,
                                                  obs.start_time)
        else:
            raise ValueError("need folding_period, polyco_path, "
                             "ephemeris_path, or MODE=CAL with CALFREQ")

        # extra pulsars folded in the same pass (one Fold per source,
        # LoadToFold1.C:1155-1242); -noskz_too folds the un-zapped stream as
        # one more source with the primary predictor
        self.predictors = [self.predictor]
        for spec in cfg.additional_pulsars or ():
            self.predictors.append(self._make_predictor(spec))
        self._presk_index = None
        if cfg.sk_enable and cfg.sk_also_unzapped:
            self._presk_index = len(self.predictors)
            self.predictors.append(self.predictor)

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
            from ..timing.t2pred import T2Predictor

            if isinstance(self.predictor, T2Predictor) \
                    and self.predictor.models:
                m = self.predictor.models[0]
                f0 = self.predictor.frequency(obs.start_time)
                if f0 > 0 and m.dispersion_constant != 0.0:
                    dm = -m.dispersion_constant * 2.41e-4 / f0
        if dm is None:
            dm = obs.dispersion_measure
        self.dm = float(dm or 0.0)

        # --- unpacker ---
        self.unpack_plan = UnpackPlan(
            obs, twos_complement=cfg.twos_complement,
            dynamic_twobit=cfg.dynamic_twobit,
            ndat_per_weight=cfg.ndat_per_weight,
            cutoff_sigma=cfg.cutoff_sigma)
        up = self.unpack_plan

        # --- convolving filterbank geometry (Filterbank.C:55-263), or the
        # nsub == 1 overlap-save convolution (Convolution.C:105-221) ---
        real_input = obs.state == Signal.NYQUIST
        self.nchan_subband = max(1, cfg.nchan // obs.nchan) if cfg.nchan \
            else 1
        coherent = cfg.coherent and self.dm > 0
        nchan_out = obs.nchan * self.nchan_subband
        if coherent:
            nfp = Dedispersion._half_smearing_samples(
                self.dm, obs.centre_frequency, obs.bandwidth, nchan_out,
                +1, 0.1)
            nfn = Dedispersion._half_smearing_samples(
                self.dm, obs.centre_frequency, obs.bandwidth, nchan_out,
                -1, 0.1)
        else:
            nfp = nfn = 0
        nfilt_tot = nfp + nfn
        if self.nchan_subband > 1:
            if cfg.frequency_resolution:
                freq_res = cfg.frequency_resolution
            elif nfilt_tot == 0:
                freq_res = 1
            elif cfg.times_minimum_nfft:
                freq_res = cfg.times_minimum_nfft * _min_pow2_over(nfilt_tot)
            elif cfg.use_fft_bench:
                freq_res = self._best_nfft(nfilt_tot)
            else:
                freq_res = choose_nfft(nfilt_tot, max_nfft=cfg.max_nfft)
            self.fb_plan = FilterbankPlan(
                real_input=real_input, nchan_subband=self.nchan_subband,
                freq_res=freq_res, nfilt_pos=nfp, nfilt_neg=nfn)
            self.fb_plan.validate()
            self.conv_plan = None
            self.obs_stream = update_observation(obs, self.fb_plan)
            ndat_fft = freq_res
        else:
            # JAX load_to_fold.py:487-509
            if cfg.frequency_resolution:
                n_fft = cfg.frequency_resolution
            elif cfg.times_minimum_nfft and nfilt_tot > 0:
                n_fft = cfg.times_minimum_nfft * _min_pow2_over(nfilt_tot)
            elif cfg.use_fft_bench and nfilt_tot > 0:
                n_fft = self._best_nfft(nfilt_tot)
            else:
                n_fft = choose_nfft(nfilt_tot, max_nfft=cfg.max_nfft)
            self.fb_plan = None
            self.conv_plan = (OverlapSavePlan(real_input, n_fft, nfp, nfn)
                              if coherent else None)
            if self.conv_plan is not None:
                self.conv_plan.validate()
            rate = obs.rate / (2 if real_input else 1)
            self.obs_stream = obs.replace(
                state=Signal.ANALYTIC, ndim=2,
                rate=rate if (self.conv_plan or not real_input) else obs.rate,
            ) if (self.conv_plan or obs.state == Signal.ANALYTIC) else obs
            ndat_fft = n_fft

        # --- chirp (Dedispersion::match/build; LoadToFold1.C:199-241) ---
        if coherent:
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
                if self.fb_plan is not None:
                    self.fb_plan = FilterbankPlan(
                        real_input=real_input,
                        nchan_subband=self.nchan_subband, freq_res=ndat_fft,
                        nfilt_pos=self.kernel.impulse_pos,
                        nfilt_neg=self.kernel.impulse_neg)
                    self.fb_plan.validate()
                    self.obs_stream = update_observation(obs, self.fb_plan)
                else:
                    self.conv_plan = OverlapSavePlan(
                        real_input, ndat_fft, self.kernel.impulse_pos,
                        self.kernel.impulse_neg)
                    self.conv_plan.validate()
        else:
            self.kernel = None

        # --- polarization calibration (PolnCalibration.C; the matrix
        # convolution of Convolution.C:425-436; JAX load_to_fold.py:573-607)
        self.jones = None
        self._jones_resp = None
        if cfg.calibration_path:
            from ..ops.polncal import PolnCalibration, jones_product

            if self.fb_plan is not None:
                raise NotImplementedError(
                    "Jones calibration inside the convolving filterbank: the "
                    "JAX package refuses it too (calibrate at the input "
                    f"channelization, nchan_subband == 1); see {_JONES}")
            if obs.npol != 2:
                raise ValueError("Jones calibration needs npol=2 input")
            epoch = obs.start_time.days + obs.start_time.fracday()
            cal = PolnCalibration.load(cfg.calibration_path, epoch_mjd=epoch)
            if self.conv_plan is None:
                # pure-calibration convolution (no dedispersion)
                self.conv_plan = OverlapSavePlan(
                    real_input, cfg.frequency_resolution or 256, 0, 0)
                self.conv_plan.validate()
                self.obs_stream = obs.replace(
                    state=Signal.ANALYTIC, ndim=2,
                    rate=obs.rate / (2 if real_input else 1))
            scalar = (Response(self.kernel.phasors, self.kernel.impulse_pos,
                               self.kernel.impulse_neg)
                      if self.kernel is not None else None)
            # natural order [nchan, n_fft, 2, 2], the chirp multiplied in
            self._jones_resp = jones_product(
                scalar, cal.match(obs, nchan_out, self.conv_plan.n_fft))
            self.jones = self._jones_resp.phasors

        # --- cyclic fold (CyclicFold.C; folds lag products, not power) ---
        self.cyclic_plan = (CyclicPlan(cfg.cyclic_nchan, cfg.cyclic_mover)
                            if cfg.cyclic_nchan else None)
        if self.cyclic_plan is not None \
                and self.obs_stream.state == Signal.NYQUIST:
            # the JAX package fails on its first block here: its lag
            # products unpack the stream as a split-complex pair
            raise ValueError("cyclic folding needs complex voltages: add "
                             "an FFT stage (-F or a DM) for real input")

        # --- detection ---
        self.det_state = cfg.detection_state()
        self.obs_out = self.obs_stream.apply_detection(self.det_state)
        if self.cyclic_plan is not None:
            self.obs_out = self.obs_stream.replace(
                npol=self.obs_stream.npol * self.cyclic_plan.nlag * 2,
                ndim=1)
        if cfg.fourth_moment:
            if cfg.npol_out != 4:
                raise ValueError("fourth_moment requires npol_out=4 (Stokes)")
            if self.cyclic_plan is not None:
                raise ValueError("fourth moments of cyclic lag products")
            self.obs_out = self.obs_out.replace(npol=14)

        # --- spectral kurtosis (SpectralKurtosis.C; after detection) ---
        self.sk_plan = SKPlan(
            cfg.sk_m, cfg.sk_std_devs, detect_tscr=not cfg.sk_no_tscr,
            detect_fscr=not cfg.sk_no_fscr, chan_start=cfg.sk_chan_start,
            chan_end=cfg.sk_chan_end) if cfg.sk_enable else None

        # --- fold plans (Fold::prepare; choose_nbin Fold.C:275-382): each
        # source its own nbin from its own period ---
        tsamp_out = 1.0 / self.obs_out.rate
        self.nbins = [choose_nbin(p.period(obs.start_time), tsamp_out,
                                  cfg.nbin) for p in self.predictors]
        self.nbin = self.nbins[0]
        self.folding_period = self.predictor.period(obs.start_time)
        # each source's DM for its archive; the chirp stays at the primary
        self.source_dms = [None]
        for spec in cfg.additional_pulsars or ():
            self.source_dms.append(self._source_dm(spec))
        if self._presk_index is not None:
            self.source_dms.append(None)

        # --- the engine (JAX load_to_fold.py:659-719): the fused plan, with
        # its rounded overlap adopted (nsub == 1 runs as a one-subband
        # geometry), or the general chain ---
        self.mega_plan = None
        self.mega_mode = None
        if self._mega_front_eligible():
            det_np, det_tag = self._mega_detection()
            geom = self.fb_plan or FilterbankPlan(
                real_input=real_input, nchan_subband=1,
                freq_res=self.conv_plan.n_fft,
                nfilt_pos=self.conv_plan.nfilt_pos,
                nfilt_neg=self.conv_plan.nfilt_neg)
            mp = MegaPlan.from_filterbank(
                geom, self.nbin, obs.npol, det_np, obs.nbit,
                nchan_in=obs.nchan,
                # JA98 dynamic levels only; fixed-level 2-bit is affine
                ndat_per_weight=(cfg.ndat_per_weight
                                 if up.twobit is not None else 0),
                detection=det_tag, fourth_moment=cfg.fourth_moment,
                twos_complement=up.twos_complement, interleave=up.layout)
            if mp is not None:
                self.mega_plan = mp
                self.mega_mode = ("full" if self._mega_full_eligible()
                                  else "hybrid")
                if self.fb_plan is not None:
                    self.fb_plan = FilterbankPlan(
                        real_input=mp.real_input, nchan_subband=mp.nsub,
                        freq_res=mp.freq_res, nfilt_pos=mp.nfilt_pos,
                        nfilt_neg=mp.nfilt_neg)
                else:
                    self.conv_plan = OverlapSavePlan(
                        mp.real_input, mp.n_fft, mp.nfilt_pos, mp.nfilt_neg)
        if cfg.rfi_filter and self.fb_plan is None \
                and self.mega_mode != "hybrid":
            # the general chain zaps the filterbank's chunked spectra; with
            # no filterbank it has nothing to zap, and the JAX package
            # refuses rather than run unfiltered
            raise NotImplementedError(
                "the RFI filter without a filterbank stage needs the fused "
                "hybrid engine, which this configuration cannot take; add "
                "channelization (-F)")

        # --- block geometry ---
        self._plan_blocks()

        # one phase anchor per overlap-save window of nkeep output samples
        # on the fused engines, per SEG_LEN samples on the general chain
        # (halved while longer than the block, which the cyclic lags
        # shorten)
        seg = self.mega_plan.nkeep if self.mega_plan is not None else SEG_LEN
        while seg > 1 and seg > self.out_per_block:
            seg //= 2
        self.fold_plan = FoldPlan(self.nbin, seg)
        self.fold_plans = [FoldPlan(nb, seg) for nb in self.nbins]
        resp = self.kernel.phasors if self.kernel is not None else None
        # the apodization taper of each window (Convolution.C:379-387)
        win = None
        if cfg.fft_window:
            plan = self.fb_plan or self.conv_plan
            if plan is None:
                raise ValueError("fft_window needs an FFT stage")
            win = build_window(WindowType(cfg.fft_window), plan.nsamp_fft)
        if self.mega_mode is None:
            self._build_general(win)
        else:
            mp = self.mega_plan
            if mp.npw:
                scale, offset = 1.0, 0.0  # JA98 dynamic levels in the kernel
            else:
                scale, offset = unpack_affine(obs.nbit, up.twos_complement)
            unpack = dict(unpack_scale=scale, unpack_offset=offset,
                          twobit=up.twobit, window=win)
            if self.mega_mode == "full":
                self.constants = MegaConstants.build(mp, resp, **unpack).to(
                    self.device)
                # the step's channel transpose is a span of the run's report
                self._megastep = build_megastep(
                    mp, self.constants, self.npart,
                    report=lambda: self._report)
            else:
                self._build_hybrid(resp, unpack)

        # --- accumulators ---
        if self.mega_mode == "full":
            # per input channel [nplane, nsub, nbin] and per input channel
            # hits, broadcast over its subbands at the end
            self._profiles = torch.zeros(
                (obs.nchan, mp.nplane, mp.nsub, self.nbin),
                dtype=torch.float32, device=self.device)
            self._hits = torch.zeros((obs.nchan, self.nbin),
                                     dtype=torch.float32, device=self.device)
        else:
            # [nchan_out, npol, nbin] per source (a tuple when there are
            # several, each with its own nbin)
            nchan, npol = self.obs_out.nchan, self.obs_out.npol
            profs = tuple(torch.zeros((nchan, npol, nb), dtype=torch.float32,
                                      device=self.device)
                          for nb in self.nbins)
            hits = tuple(torch.zeros((nchan, nb), dtype=torch.float32,
                                     device=self.device)
                         for nb in self.nbins)
            self._profiles, self._hits = ((profs, hits) if len(profs) > 1
                                          else (profs[0], hits[0]))
        self._subints: list = []
        self._current_div = 0
        self._div_samples = 0.0
        self._first_out_time: Optional[MJD] = None
        self._div_first_time: Optional[MJD] = None
        self._byte_counts = np.zeros(256, np.int64)
        self._passband = None
        self._pdmp_stats = None
        self._pdmp_nsamp = 0
        #: [zapped, total] SK cells and RFI bins over the run (hybrid)
        self._zap = {"sk": [0, 0], "rfi": [0, 0]}

    def _mega_detection(self):
        """(npol_out planes before fourth moments, kernel detection tag)."""
        np_map = {Signal.INTENSITY: 1, Signal.PP: 1, Signal.QQ: 1,
                  Signal.NTHPOWER: 1, Signal.PPQQ: 2, Signal.COHERENCE: 4,
                  Signal.STOKES: 4}
        tag = {Signal.PP: "pp", Signal.QQ: "qq",
               Signal.COHERENCE: "coherence"}.get(self.det_state, "auto")
        return np_map[self.det_state], tag

    def _mega_front_eligible(self) -> bool:
        """Can the fused front end take this configuration at all
        (``load_to_fold.py:1083-1125`` of the JAX package, without its
        environment switch and its TPU-only row-length gate)?  An FFT
        stage, two's complement only at 2/4/8 bits and never with JA98
        levels (whose tables index offset-binary codes), and a detection
        the fused planes give from the input's pols."""
        cfg = self.config
        obs = self.obs_in
        up = self.unpack_plan
        det_np, _ = self._mega_detection()
        return (cfg.use_megakernel
                and (self.fb_plan is not None or self.conv_plan is not None)
                and obs.state in (Signal.NYQUIST, Signal.ANALYTIC)
                and (not up.twos_complement or obs.nbit in (2, 4, 8))
                and not (up.twos_complement and up.twobit is not None)
                and (det_np == 1 or obs.npol == 2)
                and (self.det_state not in (Signal.PP, Signal.QQ)
                     or obs.npol == 2))

    def _mega_full_eligible(self) -> bool:
        """Can the fused fold step take the whole block
        (``load_to_fold.py:1127-1144`` of the JAX package)?  Anything the
        hybrid tail handles sends the configuration to the hybrid engine."""
        cfg = self.config
        return (self.fb_plan is not None
                and self.jones is None
                and self.sk_plan is None
                and self.cyclic_plan is None
                and not cfg.rfi_filter
                and self.det_state != Signal.NTHPOWER
                and not cfg.dump_path
                and not cfg.additional_pulsars
                and not cfg.passband
                and not cfg.pdmp_stats)

    def _hybrid_front_mode(self):
        """(npol_out, detection) of the hybrid front end: the per-pol
        powers or coherence products the tail needs, which
        ``ops.detection.from_front_planes`` turns into the target state
        (``load_to_fold.py:861-884``).  Cyclic folding takes the voltage
        output instead (``_build_hybrid``), for which the plan's detection
        is immaterial."""
        if self.obs_in.npol == 1 or self.cyclic_plan is not None:
            return 1, "auto"
        if (self.det_state in (Signal.COHERENCE, Signal.STOKES)
                or self.config.fourth_moment):
            return 4, "coherence"
        # PPQQ planes serve PPQQ, PP, QQ and the SK per-pol powers
        if (self.det_state in (Signal.PPQQ, Signal.PP, Signal.QQ)
                or self.sk_plan is not None):
            return 2, "auto"
        return 1, "auto"

    def _build_hybrid(self, resp, unpack: dict):
        """The hybrid engine's front end (``_build_hybrid_step`` of the JAX
        package, unsharded): ``build_megafil`` with the per-window weights
        (JA98 excision, else ones), the passband tap when the passband or
        the RFI filter needs it, the chirp as an argument when the RFI
        filter multiplies a mask into it, and the Jones response in the
        constants; ``unpack`` is ``MegaConstants.build``'s unpack map, JA98
        tables and window."""
        cfg = self.config
        np_out, det_tag = self._hybrid_front_mode()
        self.front_plan = dataclasses.replace(
            self.mega_plan, npol_out=np_out, detection=det_tag,
            fourth_moment=False)
        # with a Jones response the chirp rides in it, and the scalar slot
        # (which the RFI mask multiplies) is ones (JAX load_to_fold.py:758)
        self.constants = MegaConstants.build(
            self.front_plan, None if self.jones is not None else resp,
            jones=self.jones, **unpack).to(self.device)
        rfi = bool(cfg.rfi_filter)
        self._rfi_2pass = rfi and cfg.rfi_same_block
        self._front = build_megafil(
            self.front_plan, self.constants, self.npart, return_weights=True,
            output="voltage" if self.cyclic_plan is not None else "detected",
            passband=cfg.passband or rfi, response_as_args=rfi)
        # the bare chirp the RFI mask multiplies
        self._bare = (self.constants.gr, self.constants.gi)
        #: carried RFI response (chirp x mask), natural bin order; the first
        #: block is primed with its own mask (run)
        self._rfi_resp = self._bare if rfi and not self._rfi_2pass else None
        self._rfi_primed = False

    def _zap_mask(self, pb: torch.Tensor) -> torch.Tensor:
        """The RFI zap mask ``[nchan_in, n_fft]`` from a block's passband
        ``[nchan_in*nsub, npol, freq_res]`` (``zap_mask_perm`` of the JAX
        package, in natural bin order): the passband median-filtered across
        each input channel's band per (input channel, pol); a bin is zapped
        when any pol exceeds ``rfi_threshold`` times its median.  The median
        stays within each input channel, so a channel group's mask is the
        band's rows of that group."""
        p = self.front_plan
        npol = self.obs_in.npol
        nchan_in = pb.shape[0] // p.nsub
        flat = pb.reshape(nchan_in, p.nsub, npol, p.freq_res).permute(
            0, 2, 1, 3).reshape(nchan_in, npol, p.n_fft)
        med = median_filter_freq(flat, self.config.rfi_median_width)
        good = (flat <= self.config.rfi_threshold
                * torch.clamp(med, min=1e-30)).to(torch.float32)
        mask = torch.amin(good, dim=1)  # [nchan_in, n_fft]
        self._count_zap("rfi", mask)
        return mask

    def _zap_response(self, pb: torch.Tensor):
        """Chirp x zap mask (:meth:`_zap_mask`) from a block's passband."""
        mask = self._zap_mask(pb)
        return self._bare[0] * mask, self._bare[1] * mask

    def _count_zap(self, kind: str, keep: torch.Tensor) -> None:
        z = self._zap[kind]
        z[0] = z[0] + (keep.numel() - keep.sum())
        z[1] += keep.numel()

    def zapped_share(self) -> dict:
        """Share of the SK cells and of the RFI filter's bins zapped over
        the run so far (``None`` where a filter is off)."""
        return {k: (float(v[0]) / v[1] if v[1] else None)
                for k, v in self._zap.items()}

    def _hybrid_block(self, raw: torch.Tensor):
        """One block through the fused front end and the per-block half of
        the tail (:meth:`_block_tail`): ``(d, weights, w_presk, extras)``.
        Advances the carried RFI response."""
        return self._block_tail(*self._hybrid_front(raw))

    def _hybrid_front(self, raw: torch.Tensor):
        """One block through the fused front end: ``(d, power, weights,
        pb)`` for the tail.  Advances the carried RFI response; the
        two-pass RFI filter (``rfi_same_block``) carries nothing from block
        to block, so the sharded pipeline's time shards call this too."""
        if self._rfi_2pass:
            out = self._two_pass(self._front, raw, *self._bare)
        else:
            out = self._front(raw, *(self._rfi_resp or ()))
        if self._rfi_resp is not None:
            # this block's mask applies from the next block on
            self._rfi_resp = self._zap_response(out[2])
        return self._front_planes(out)

    def _two_pass(self, front, raw, gr, gi, extra=()):
        """The state-free two-pass RFI filter on one block: a pass of
        ``front`` with the bare chirp ``(gr, gi)`` measures the block's
        passband, whose zap mask (:meth:`_zap_mask`, channel-local)
        multiplies the chirp of a second pass over this same block
        (RFIFilter.C's same-interval semantics).  ``extra`` is the
        per-call Jones response, if any.  Returns the second pass's
        outputs."""
        mask = self._zap_mask(front(raw, gr, gi, *extra)[2])
        return front(raw, gr * mask, gi * mask, *extra)

    def _front_planes(self, out):
        """A hybrid front end's outputs ``(data, wwin[, pb])`` as the tail's
        ``(d, power, weights, pb)``: the per-window weights over each
        window's nkeep outputs and over the input channel's subbands (the
        cyclic lags end the block nlag - 1 samples early), the detected
        state from the front planes (the voltage itself for cyclic
        folding), and the per-pol power SK reads."""
        p = self.front_plan
        data, wwin = out[0], out[1]
        pb = out[2] if len(out) > 2 else None
        nchan_out, ndat_out = data.shape[0], self.out_per_block
        weights = wwin.repeat_interleave(p.nsub, dim=0)[:, :, None].expand(
            nchan_out, self.npart, p.nkeep).reshape(nchan_out, -1)[
                :, :ndat_out]
        if self.cyclic_plan is not None:
            # the voltage, whose lag products the fold builds (_fold)
            d = data
            power = _power(data) if self.sk_plan is not None else None
        else:
            d = from_front_planes(data, self.det_state, p.npol_out)
            power = data[:, :2] if p.npol_out >= 2 else data[:, :1]
        return d, power, weights, pb

    def shard_front(self, front_plan: MegaPlan, cst: MegaConstants):
        """The hybrid front end of one channel group for the
        channel-sharded mesh (``_build_hybrid_step(chan_sharded=True)`` of
        the JAX package, up to its tail): ``step(raw, gr, gi, jones) ->
        (d, power, weights, pb)`` for the tail (:meth:`_block_tail`).
        ``front_plan`` is the front plan with the group's ``nchan_in``;
        ``cst`` its constants, whose chirp slot is ones.  ``gr``/``gi`` are
        the group's rows of the band's chirp (ones under a Jones response,
        which carries the chirp), ``jones`` its rows of the Jones response
        (None without one), handed to ``build_megafil`` on each call
        (``response_as_args``, ``jones_as_args``).  The RFI filter runs in
        its state-free two-pass form (the sharded pipeline sets
        ``rfi_same_block``, :meth:`_two_pass`) on the group's chirp rows."""
        cfg = self.config
        rfi = bool(cfg.rfi_filter)
        if rfi and not cfg.rfi_same_block:
            raise ValueError("a sharded RFI filter runs in two passes a "
                             "block (rfi_same_block)")
        jones_args = self.jones is not None
        chirp_args = rfi or not jones_args
        front = build_megafil(
            front_plan, cst, self.npart, return_weights=True,
            output="voltage" if self.cyclic_plan is not None else "detected",
            passband=cfg.passband or rfi, response_as_args=chirp_args,
            jones_as_args=jones_args)

        def step(raw, gr, gi, jones=None):
            extra = (jones,) if jones_args else ()
            if rfi:
                out = self._two_pass(front, raw, gr, gi, extra)
            else:
                out = front(raw, *((gr, gi) if chirp_args else ()), *extra)
            return self._front_planes(out)

        return step

    def _build_general(self, win) -> None:
        """The general chain's constants on the device: the apodization
        taper ``win`` (or None) and the response, complex64 — the chirp in
        natural order for the filterbank, in FFT bin order (the Jones
        response as its four terms) for the convolution."""
        dev = self.device
        self._apod = (torch.from_numpy(win).to(dev) if win is not None
                      else None)
        complex_input = self.obs_in.state != Signal.NYQUIST
        resp = None
        if self.jones is not None:
            resp = tuple(t.to(dev) for t in jones_fft_order(
                self._jones_resp, complex_input=complex_input))
        elif self.kernel is not None:
            ph = self.kernel.phasors
            if self.conv_plan is not None:
                ph = Response(ph).fft_order(complex_input=complex_input)
            resp = torch.from_numpy(
                np.ascontiguousarray(ph, dtype=np.complex64)).to(dev)
        self._resp = resp

    def _general_block(self, raw: torch.Tensor):
        """One block through the general chain (the JAX package's
        ``_step_core``, unsharded) and the per-block half of the tail:
        ``(d, weights, w_presk, extras)``."""
        return self._block_tail(*self._general_front(raw))

    def _general_front(self, raw: torch.Tensor, chan_ix: int = 0,
                       n_chan_shards: int = 1):
        """One block through the general chain up to its tail: ``(d, power,
        weights, pb)`` for :meth:`_block_tail`.  The passband is read from
        the forward spectra, the RFI filter zaps each block with its own
        bandpass, and SK power and cyclic lag products come from the
        voltage ``y``.  On a channel shard (``chan_ix`` of
        ``n_chan_shards``) only its output channels go on, as in the JAX
        package's ``_step_core``: the forward transform covers the block,
        and its spectra (with the filterbank; else the input channels) are
        sliced before the response and the inverse."""
        cfg = self.config
        x, w = self.unpack_plan.unpack(raw)
        local = self.obs_out.nchan // n_chan_shards
        rows = slice(chan_ix * local, (chan_ix + 1) * local)
        resp = self._resp
        pb = None
        if self.fb_plan is not None:
            spec = forward_spectra_chunked(x, self.fb_plan, self.npart,
                                           self._apod)
            if cfg.passband:
                pb = _power(spec).sum(2)
            rfi = ((cfg.rfi_median_width, cfg.rfi_threshold)
                   if cfg.rfi_filter else None)
            spec = apply_response_chunked(
                spec[rows], None if resp is None else resp[rows],
                rfi_zap=rfi,
                nchan_sub_present=min(self.fb_plan.nchan_subband, local))
            y = invert_subbands(spec, self.fb_plan)
        else:
            # one output channel an input channel: slice the input
            x = x[rows]
            if self.conv_plan is None:
                y = x
            elif self.jones is not None:
                y = overlap_save_convolve_jones(
                    x, tuple(r[rows] for r in resp), self.conv_plan,
                    self.npart, self._apod)
            else:
                y = overlap_save_convolve(x, resp[rows], self.conv_plan,
                                          self.npart, self._apod)
        ndat = y.shape[-1]
        if self.cyclic_plan is not None:
            ndat -= self.cyclic_plan.nlag - 1
        weights = self._stream_weights(w, ndat, chan_ix, n_chan_shards)
        d = y if self.cyclic_plan is not None else detect(y, self.det_state)
        power = _power(y) if self.sk_plan is not None else None
        return d, power, weights, pb

    def _stream_weights(self, w, nuse: int, chan_ix: int = 0,
                        n_chan_shards: int = 1) -> torch.Tensor:
        """The unpacker's block weights on the output samples, ``[nchan_out,
        nuse]`` (JAX ``load_to_fold.py:1513-1563``): an output sample is bad
        when any input sample of the FFT window that made it was
        (``window_weights``).  Ones without weights (or with a block
        shorter than one weight span).  On a channel shard (``chan_ix`` of
        ``n_chan_shards``), the shard's output channels only, from the
        input channels that make them."""
        nchan = self.obs_out.nchan // n_chan_shards
        if w is None or w.shape[1] == 0:
            return torch.ones((nchan, nuse), dtype=torch.float32,
                              device=self.device)
        if n_chan_shards > 1:
            nsub = self.obs_out.nchan // self.obs_in.nchan
            nrows = max(nchan // nsub, 1)
            start = (chan_ix * nchan) // nsub
            w = w[start:start + nrows]
        nchan_in, nweights = w.shape
        npw = self.config.ndat_per_weight
        plan = self.fb_plan or self.conv_plan
        if plan is not None:
            nkeep = plan.nkeep if self.fb_plan is not None else plan.nkeep_c
            wwin = window_weights(w, self.npart, plan.nsamp_step,
                                  plan.nsamp_fft, npw)
            expanded = wwin[:, :, None].expand(
                nchan_in, self.npart, nkeep).reshape(nchan_in, -1)
        else:
            # no FFT stage: output sample j is input sample j
            expanded = w[:, :, None].expand(nchan_in, nweights,
                                            npw).reshape(nchan_in, -1)
        return expanded[:, :nuse].repeat_interleave(nchan // nchan_in, dim=0)

    def _block_tail(self, d, power, weights, pb, sk_pooled=None,
                    chan_offset: int = 0):
        """The per-block half of the tail both non-full engines share:
        fourth moments of the detected ``d``, the SK mask from the per-pol
        ``power`` (over the block's ``weights.shape[1]`` output samples),
        and the dump, passband (``pb``) and pdmp extras.  Returns ``(d,
        weights, w_presk, extras)``: ``weights`` after the SK mask,
        ``w_presk`` those before it (``-noskz_too``).  On a channel shard
        whose first output channel is ``chan_offset``, ``sk_pooled`` are
        the band's frequency-scrunched SK sums (``sk_fscr_sums`` of every
        shard, added)."""
        cfg = self.config
        nchan_out, ndat_out = weights.shape
        if cfg.fourth_moment:
            d = fourth_moment(d)
        w_presk = weights if self._presk_index is not None else None
        if self.sk_plan is not None:
            M = self.sk_plan.M
            skm = sk_mask(power, self.sk_plan, ndat_out // M, sk_pooled,
                          self.obs_out.nchan, chan_offset)
            self._count_zap("sk", skm)
            skw = expand_mask(skm, M)
            if skw.shape[-1] < ndat_out:
                # the trailing partial SK cell keeps weight 1
                skw = torch.cat([skw, torch.ones(
                    (nchan_out, ndat_out - skw.shape[-1]),
                    dtype=torch.float32, device=skw.device)], dim=-1)
            weights = weights * skw
        extras = {}
        if cfg.dump_path or cfg.pdmp_stats:
            # the folded stream itself: the detected planes, or the lag
            # planes
            dd = (lag_planes(d, self.cyclic_plan.nlag)
                  if self.cyclic_plan is not None else d)
        if cfg.dump_path:
            extras["dump"] = dd.permute(2, 0, 1).contiguous()
        if cfg.passband:
            extras["passband"] = pb
        if cfg.pdmp_stats:
            # pdmp extras: moments S1..S4 of the detected stream per
            # (chan, pol) (Stats.C)
            extras["pdmp"] = torch.stack(
                [torch.sum(dd ** k, dim=2) for k in (1, 2, 3, 4)], dim=-1)
        return d, weights, w_presk, extras

    def _fold_tail_d(self, profiles, hits, d, weights, w_presk, phi0, dphi,
                     bounds=None):
        """Fold the block's detected stream into the accumulators of every
        source (``_fold_tail_d`` of the JAX package, after its per-block
        half): ``bounds`` ``(lo, hi)`` zero the weights of output samples
        outside the division's span; the ``-noskz_too`` source folds
        ``w_presk``.  ``phi0``/``dphi`` are ``[nsrc, nseg]`` with several
        sources."""
        if bounds is not None:
            idx = torch.arange(weights.shape[1], device=d.device)
            span = ((idx >= bounds[0]) & (idx < bounds[1])).to(torch.float32)
            weights = weights * span[None, :]
            if w_presk is not None:
                w_presk = w_presk * span[None, :]
        if not isinstance(profiles, tuple):
            return self._fold(profiles, hits, d, weights, phi0, dphi,
                              self.fold_plan)
        ps, hs = [], []
        for s in range(len(profiles)):
            w = w_presk if s == self._presk_index else weights
            p_, h_ = self._fold(profiles[s], hits[s], d, w, phi0[s],
                                dphi[s], self.fold_plans[s])
            ps.append(p_)
            hs.append(h_)
        return tuple(ps), tuple(hs)

    def _fold(self, profiles, hits, d, weights, phi0, dphi, plan):
        """One source's fold of the block: the detected planes
        (``fold_block``) or the voltage's lag products
        (``fold_lag_products``)."""
        if self.cyclic_plan is not None:
            return fold_lag_products(profiles, hits, d, self.cyclic_plan.nlag,
                                     weights, phi0, dphi, plan)
        return fold_block(profiles, hits, d, weights, phi0, dphi, plan)

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
        if self.fb_plan is not None:
            path.append({
                "op": "Filterbank",
                "nchan_subband": self.fb_plan.nchan_subband,
                "freq_res": self.fb_plan.freq_res,
                "convolve_when": ("During" if self.kernel is not None
                                  else "Never"),
            })
        if self.conv_plan is not None:
            path.append({"op": "Convolution", "n_fft": self.conv_plan.n_fft,
                         "matrix": self.jones is not None})
        if cfg.calibration_path:
            path.append({"op": "PolnCalibration",
                         "database": cfg.calibration_path})
        if cfg.rfi_filter:
            path.append({"op": "RFIFilter",
                         "median_width": cfg.rfi_median_width,
                         "threshold": cfg.rfi_threshold})
        if self.sk_plan is not None:
            path.append({"op": "SpectralKurtosis", "m": cfg.sk_m,
                         "std_devs": cfg.sk_std_devs})
        if self.cyclic_plan is not None:
            path.append({"op": "CyclicFold", "nlag": self.cyclic_plan.nlag,
                         "mover": self.cyclic_plan.mover})
        else:
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
        p = self.fb_plan or self.conv_plan
        if p is None:
            # no FFT stage (JAX load_to_fold.py:1244-1253): one block of
            # the sample budget (and the source), whole 4096s
            block = min(cfg.min_block_samples, self.source.total_samples)
            block = max((block // 4096) * 4096, 4096)
            self.nsamp_step = self.block_in_samples = block
            self.npart = 1
            self.out_per_block = block
        else:
            self.nsamp_step = p.nsamp_step
            # grow blocks toward min_block_samples, but never beyond the
            # source nor beyond a subint (so -L granularity holds at block
            # level)
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
            nkeep = p.nkeep if self.fb_plan is not None else p.nkeep_c
            self.out_per_block = self.npart * nkeep
        if self.cyclic_plan is not None:
            # the lag products consume nlag - 1 samples of each block
            self.out_per_block -= self.cyclic_plan.nlag - 1
        self.stride_in_samples = self.npart * self.nsamp_step
        #: input samples a block shares with the next (its halo, sharded)
        self.nsamp_overlap = self.block_in_samples - self.stride_in_samples

    # ---- host streaming loop (SingleThread::run equivalent) ----

    def output_start_time(self, block_start_sample: int) -> MJD:
        """MJD of output sample 0 of the block starting at the given input
        sample (shifted by nfilt_pos; ``Filterbank.C:369``)."""
        t0 = self.obs_in.start_time + block_start_sample / self.obs_in.rate
        return t0 + self.fold_plan_offset_seconds()

    def fold_plan_offset_seconds(self) -> float:
        p = self.fb_plan or self.conv_plan
        return (p.nfilt_pos if p is not None else 0) / self.obs_out.rate

    def to_device(self, a: np.ndarray) -> torch.Tensor:
        """A host array to the pipeline's device (through pinned memory on
        CUDA, copied without waiting for the device)."""
        return host_to_device(a, self.device)

    def run(self, max_blocks: Optional[int] = None,
            total_seconds: Optional[float] = None,
            seek_seconds: Optional[float] = None) -> FoldResult:
        """Stream all blocks through the engine; returns the result.

        total_seconds limits input consumed (reference -T); seek_seconds
        skips that much input first (reference -S).
        """
        src = self.source
        if seek_seconds is None:
            seek_seconds = self.config.seek_seconds
        seek = int(seek_seconds * self.obs_in.rate) if seek_seconds else 0
        nsamp_total = src.total_samples
        if total_seconds is not None:
            nsamp_total = min(nsamp_total,
                              seek + int(total_seconds * self.obs_in.rate))

        rep = self._report = RunReport(enabled=self.config.report,
                                       device=self.device)
        start = seek
        nblocks = 0
        out_off = 0  # global output-sample index of the next block
        tsamp_out = 1.0 / self.obs_out.rate
        nuse = self.out_per_block
        seg = self.fold_plan.seg_len
        # the anchors cover the trailing partial segment, so every one of
        # the block's nuse output samples folds
        nuse_pad = -(-nuse // seg) * seg

        # sample-exact sub-integrations (reference TimeDivide/SubFold): a
        # block that spans a boundary is folded once per division with
        # [lo, hi) bounds
        divider = None
        if self.config.subint_seconds > 0 or self.config.subint_turns > 0:
            from ..timing.timedivide import TimeDivide

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
            if self.mega_mode == "full" and nuse >= (1 << 24):
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
            rep.begin_block()
            with rep.stage("read"):
                try:
                    raw = src.read_samples(start, self.block_in_samples)
                except EOFError:
                    # a live ring ended the stream: report the blocks it
                    # delivered (the caller finishes with _finish())
                    rep.report()
                    self._report = DISABLED
                    raise
            if self.config.digitizer_stats and self.obs_in.nbit <= 8:
                with rep.stage("byte_counts"):
                    self._byte_counts += np.bincount(raw, minlength=256)
            with rep.stage("anchors"):
                pairs = [compute_anchors(p, t_out0, tsamp_out, nuse_pad, seg)
                         for p in self.predictors]
                phi0 = np.stack([a for a, _ in pairs])
                dphi = np.stack([b for _, b in pairs])
                if len(pairs) == 1:
                    phi0, dphi = phi0[0], dphi[0]
            phi0 = (phi0 - self.config.reference_phase) % 1.0
            start += self.stride_in_samples

            # enqueue: the copies and the step, each a device span; a
            # sub-integration's flush between two steps is one too.  On a
            # card the copies run on the staging's own stream, and the
            # step's stream waits for them in an ``h2d_wait`` span
            with rep.stage("enqueue"):
                arrays = (raw, np.ascontiguousarray(phi0, np.float32),
                          np.ascontiguousarray(dphi, np.float32))
                if self._staging is None:
                    with rep.device("h2d"):
                        raw_t, phi0_t, dphi_t = map(self.to_device, arrays)
                else:
                    raw_t, phi0_t, dphi_t = self._staging.put(arrays, rep)
                if self.mega_mode != "full":
                    with rep.device("step"):
                        blk = self._tail_block(raw_t)
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
                    with rep.device("step"):
                        if self.mega_mode == "full":
                            self._profiles, self._hits = self._megastep(
                                self._profiles, self._hits, raw_t, phi0_t,
                                dphi_t, bounds)
                        else:
                            self._profiles, self._hits = self._fold_tail_d(
                                self._profiles, self._hits, *blk[:3],
                                phi0_t, dphi_t, bounds)
                if self._staging is not None:
                    self._staging.release()
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
        self._report = DISABLED
        rep.report()  # -r: the stages' host and device seconds
        return self._finish()

    def _tail_block(self, raw_t: torch.Tensor):
        """A block of the hybrid or general engine up to its fold tail
        (RFI priming, dump, passband and pdmp moments taken)."""
        if self.mega_mode == "hybrid":
            if self._rfi_resp is not None and not self._rfi_primed:
                # the first block is zapped with its own mask
                # (RFIFilter.C:44-102): one front pass with the bare chirp
                # measures its passband
                self._rfi_resp = self._zap_response(
                    self._front(raw_t, *self._rfi_resp)[-1])
                self._rfi_primed = True
            blk = self._hybrid_block(raw_t)
        else:
            blk = self._general_block(raw_t)
        self._take_extras(blk[3])
        return blk

    def _take_extras(self, extras: dict) -> None:
        """Write a block's dump and add its passband and pdmp moments to the
        run's (float64 on the host, as the JAX package keeps them)."""
        if "dump" in extras:
            self._write_dump(extras["dump"].cpu().numpy())
        if "passband" in extras:
            pb = extras["passband"].cpu().numpy().astype(np.float64)
            self._passband = (pb if self._passband is None
                              else self._passband + pb)
        if "pdmp" in extras:
            mm = extras["pdmp"].cpu().numpy().astype(np.float64)
            self._pdmp_stats = (mm if self._pdmp_stats is None
                                else self._pdmp_stats + mm)
            self._pdmp_nsamp += self.out_per_block

    def _write_dump(self, tfp: np.ndarray):
        """Append TFP float32 samples to the dump DADA file (Dump op)."""
        import os

        from ..io.dada import format_ascii_header, header_from_observation

        path = self.config.dump_path
        if not os.path.exists(path):
            # the detected stream starts at the output-domain epoch (with
            # the nfilt_pos shift)
            obs = self.obs_out.replace(nbit=32,
                                       start_time=self.output_start_time(0))
            hdr = header_from_observation(obs, extra={"DUMP": "detected"})
            with open(path, "wb") as f:
                f.write(format_ascii_header(hdr))
        with open(path, "ab") as f:
            f.write(tfp.tobytes())

    # ---- sub-integration handling ----

    def _flush_division(self):
        """Close the open sub-integration: its accumulators copied back to
        the host and zeroed (the running report's ``d2h`` span), and
        appended."""
        if self._div_samples == 0:
            return
        rep = self._report
        with rep.stage("flush"):
            with rep.device("d2h"):
                prof, hits = self._copy_back()
            self._append_division(prof, hits)

    def _copy_back(self):
        """The accumulators on the host, then zeroed on the device."""
        if isinstance(self._profiles, tuple):
            prof = tuple(p.cpu().numpy() for p in self._profiles)
            hits = tuple(h.cpu().numpy() for h in self._hits)
            self._profiles = tuple(torch.zeros_like(p)
                                   for p in self._profiles)
            self._hits = tuple(torch.zeros_like(h) for h in self._hits)
        else:
            prof = self._profiles.cpu().numpy()
            hits = self._hits.cpu().numpy()
            self._profiles = torch.zeros_like(self._profiles)
            self._hits = torch.zeros_like(self._hits)
        return prof, hits

    def _append_division(self, prof, hits) -> None:
        if self.mega_mode == "full":
            # [nchan_in, nplane, nsub, nbin] -> archive [nchan_out, npol,
            # nbin]; hits are per input channel and broadcast over its
            # subbands
            nsub = self.mega_plan.nsub
            nci = prof.shape[0]
            prof = np.ascontiguousarray(prof.transpose(0, 2, 1, 3).reshape(
                nci * nsub, prof.shape[1], self.nbin))
            hits = np.repeat(hits, nsub, axis=0)
        self._subints.append(
            (prof, hits, self._div_first_time or self._first_out_time,
             self._div_samples / self.obs_out.rate))
        self._div_first_time = None
        self._div_samples = 0.0

    def _finish(self) -> FoldResult:
        if not self._subints:
            self._flush_division()
        if self.config.minimum_integration_length > 0:
            self._subints = [
                s for s in self._subints
                if s[3] >= self.config.minimum_integration_length]
        counts = None
        if self.config.digitizer_stats and self.obs_in.nbit <= 8 \
                and self._byte_counts.any():
            counts = state_counts_from_byte_counts(self._byte_counts,
                                                   self.obs_in.nbit)

        def stacks(s=None):
            """(profiles, hits) of source ``s`` (None: the only one) over
            the sub-integrations."""
            nbin = self.nbins[s or 0]
            if not self._subints:
                return (np.zeros((0, self.obs_out.nchan, self.obs_out.npol,
                                  nbin)),
                        np.zeros((0, self.obs_out.nchan, nbin)))
            pick = (lambda x: x) if s is None else (lambda x: x[s])
            return (np.stack([pick(sub[0]) for sub in self._subints]),
                    np.stack([pick(sub[1]) for sub in self._subints]))

        def result(profs, hits, predictor, extras=None, nbin=None, dm=None,
                   label=None):
            return FoldResult(
                label=label,
                profiles=profs,
                hits=hits,
                epochs=[s[2] for s in self._subints],
                integration_length=np.array([s[3] for s in self._subints]),
                obs=self.obs_out,
                nbin=self.nbin if nbin is None else nbin,
                folding_period=predictor.period(self.obs_in.start_time),
                dispersion_measure=self.dm if dm is None else dm,
                cyclic_nlag=(self.cyclic_plan.nlag if self.cyclic_plan
                             else 0),
                cyclic_mover=(self.cyclic_plan.mover if self.cyclic_plan
                              else 1),
                cyclic_npol=(self.obs_stream.npol if self.cyclic_plan
                             else 1),
                signal_path=self.signal_path(),
                digitizer_counts=counts,
                extra_sources=extras,
                passband=self._passband,
                pdmp_stats=self._pdmp_stats,
                pdmp_nsamp=self._pdmp_nsamp,
                predictor=predictor,
                ephemeris=self.ephemeris,
            )

        if len(self.predictors) == 1:
            return result(*stacks(), self.predictor)
        # one FoldResult per source, each with its own nbin and DM
        extras = [result(*stacks(s), self.predictors[s], nbin=self.nbins[s],
                         dm=self.source_dms[s],
                         label="nosk" if s == self._presk_index else None)
                  for s in range(1, len(self.predictors))]
        return result(*stacks(0), self.predictor, extras=extras)


def load_to_fold(path: str, config: FoldConfig, device="cuda",
                 **run_kw) -> FoldResult:
    """Open, construct, run: the dspsr app in a line."""
    return FoldPipeline(open_source(path), config, device=device).run(**run_kw)
