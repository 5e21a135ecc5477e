"""Typed configuration for the whole pipeline (PyTorch port).

The same dataclasses, derived properties and ``resolve_vocoder_mode`` as the
JAX package's ``realtime_yukarin_tpu/config.py``, kept as a copy so that the
port imports nothing of the JAX package.  Every quantity that shapes a
tensor is static, derived from the configuration: sample rates, the frame
hop, chunk sizes and the model receptive fields that set the streaming
halos.  ``tests/test_torch_config.py`` holds every field and derived
property equal to the JAX ``Config``, apart from what the port alone has:
the fourth and fifth vocoder modes, ``"hifigan"``
(:class:`VocoderHiFiGANConfig`, the ``vocoder_hifigan`` section, and
``vocoder_hifigan_params_path``) and ``"bigvgan"``
(:class:`VocoderBigVGANConfig`, ``vocoder_bigvgan`` and
``vocoder_bigvgan_params_path``).
"""

from __future__ import annotations

import dataclasses
import json
import math
import pathlib
from typing import Any, Mapping

try:  # pyyaml is present in the image, but keep a JSON fallback.
    import yaml

    _HAVE_YAML = True
except Exception:  # pragma: no cover
    _HAVE_YAML = False


# Fraction of Nyquist above which synthesis harmonics are masked
# (anti-aliasing guard band).  Lives here so DspConfig can derive the
# harmonic-bank size from it; dsp.primitives re-exports it.
HARMONIC_NYQUIST_FRACTION = 0.95


# the synthesis stages (models/vocoders.py); "hifigan" and "bigvgan" are
# the port's alone
VOCODER_MODES = ("dsp", "ddsp", "wave", "hifigan", "bigvgan")


def _check_mode(mode: str) -> str:
    if mode not in VOCODER_MODES:
        raise ValueError(f"vocoder_mode must be {'|'.join(VOCODER_MODES)}, "
                         f"got {mode!r}")
    return mode


def resolve_vocoder_mode(use_neural_vocoder: bool,
                         vocoder_mode: str | None) -> str:
    """Shared mode resolution for APIs that kept the legacy boolean:
    explicit ``vocoder_mode`` wins; else the boolean selects ddsp/dsp."""
    if vocoder_mode is not None:
        return _check_mode(vocoder_mode)
    return "ddsp" if use_neural_vocoder else "dsp"


@dataclasses.dataclass(frozen=True)
class DspConfig:
    """WORLD-equivalent analysis/synthesis parameters."""

    sample_rate: int = 24000              # internal processing rate
    # Client-facing rates (reference config: separate input/output sample
    # rates).  None = same as sample_rate.  When they differ, the fused
    # streaming step resamples on-device at its edges (dsp/resample.py):
    # a 16 kHz mic client is served at 16 kHz in / 24 kHz (or 48 kHz…) out
    # while analysis/models/synthesis all run at sample_rate.
    input_rate: int | None = None
    output_rate: int | None = None
    frame_period_ms: float = 5.0          # hop between feature frames
    # Spectral envelope resolution.  A matmul DFT (ops/dft.py) has no
    # power-of-two constraint, so the default is chosen for the MXU, not
    # the FFT: n=1022 gives spec_bins = n//2+1 = 512 = 4x128 lanes, so
    # every [.., K] @ [K, Q] analysis/decode matmul tiles exactly; K=513
    # (n=1024) pads every such operand to 640 lanes (~1.56x FLOPs on the
    # [K, K] quefrency bases).  Resolution cost: 23.48 vs 23.44 Hz/bin.
    # COMPAT: spec_bins is a model-shape parameter — SRNet, the
    # discriminator, and every envelope tensor are sized by it, so
    # checkpoints/.npz snapshots trained under fft_size=1024 (513 bins,
    # the pre-2026-08 default and the WORLD-conventional size) do NOT
    # load under the 1022 default.  Pin ``dsp: {fft_size: 1024}`` in the
    # YAML to load them; the strict loader detects the 513<->512 mismatch
    # and names this knob (models/voice_changer.py:unflatten_params).
    fft_size: int = 1022
    f0_floor: float = 71.0
    f0_ceil: float = 800.0
    # --- F0 estimator (YIN/CMND reformulation of DIO; SURVEY.md §7 hard (a))
    f0_window: int = 640                  # correlation integration window W
    # The period search runs on a decimated grid (WORLD's Dio low-passes +
    # downsamples before candidate search): 24 kHz -> 8 kHz cuts the
    # difference-function matmul FLOPs ~4x at <2-cent accuracy cost
    # (parabolic refinement is sub-sample on the coarse grid too).
    # 1 = full-rate search (the pre-decimation behavior).
    f0_decimation: int = 3
    cmnd_threshold: float = 0.14          # first-dip acceptance threshold
    # When no dip clears cmnd_threshold (jittery/noisy frames), the
    # fallback picks the SMALLEST lag whose local dip is within this
    # margin of the global CMND minimum — the cumulative-mean
    # normalization systematically deepens far dips, so a bare argmin
    # prefers 2x the true period on jittery voices (measured on the
    # formant fixture: dp(tau_true)-dp(2 tau) = 0.01..0.06).
    fallback_dip_margin: float = 0.08
    # Voiced/unvoiced DECISION: min CMND above this => unvoiced.  0.45
    # (round 5, was 0.30): the dip depth degrades ~linearly with in-band
    # noise, and 0.30 silenced 31% of truly-voiced frames at 20 dB SNR
    # white noise.  Measured on the formant fixture: 0.45 restores
    # recall 0.96 at SNR 20 (0 octave errors, false voicing 0.06->0.10
    # only under noise) while every CLEAN seed stays bit-for-bit at
    # recall 1.00 / false 0.02 (clean voiced dips sit well under 0.30,
    # clean unvoiced dips well above 0.45, so the decision boundary
    # moves through empty space).  Probed 0.60/0.75: recall gains
    # continue but reverb false-voicing and octave errors climb.
    voicing_threshold: float = 0.45
    # Lattice-emission confidence scale: r = clip(1 - min_dip/scale).
    # Deliberately SEPARATE from the decision threshold and kept at the
    # old 0.30: the Viterbi emission weighting, octave-descent margins
    # and diplophonia behavior were all tuned against this scale, and a
    # frame whose best dip is 0.3-0.45 should be VOICED but contribute
    # ~zero contour-hold confidence.
    voicing_confidence_scale: float = 0.30
    # Octave-down verification (the role of Dio/Harvest multi-candidate
    # voting, upstream:mmorise/World src/dio.cpp): a weak fundamental under
    # a strong even-harmonic stack puts the first CMND dip at HALF the true
    # period; if the dip near lag 2*tau is deeper by this margin, descend.
    # Frame-local by construction, so streaming stays bit-exact.
    octave_margin: float = 0.015
    # Subharmonic (octave-UP) correction inside the full-rate refinement
    # (dsp/f0.py:refine_f0_from_power): jitter decorrelates long lags, so
    # on shimmery/jittery voices the CMND stage sometimes lands on 2x the
    # true period (measured on the formant fixture: 13/91 frames).  The
    # window-ACF-corrected periodicity p is phase-blind, and
    # p(tau/2)/p(tau) ~= (E_even - E_odd)/(E_even + E_odd) of the
    # candidate's harmonic stack — >= 1 - margin means there is NO odd-
    # harmonic energy, i.e. tau is a doubled period: halve it.  A real
    # weak-fundamental signal keeps measurable odd energy and fails the
    # test (the weakfund fixture sits at ~0.965).
    octave_up_margin: float = 0.01
    # Candidate-lattice contour selection (the role of Harvest's
    # candidate voting / contour DP, upstream:mmorise/World
    # src/harvest.cpp): after the 3-tap median, each voiced frame is
    # re-decided by a bounded Viterbi over the frame's top-K CMND dip
    # candidates within its +-f0_snap_halo window (dsp/f0.py:
    # viterbi_snap) — emission = dip depth + octave_margin per octave of
    # lag (the same smaller-lag preference the octave-down verification
    # encodes), transition = f0_trans_weight per octave of frame-to-
    # frame jump.  Fixes short runs (<= halo) of octave/diplophonia
    # errors that a 3-tap median cannot.  Costs ``f0_snap_halo`` extra
    # frames of algorithmic lookahead in streaming (at 5 ms frames:
    # 15 ms).  0 disables the snap (the low-latency profile).
    f0_snap_halo: int = 3
    # LEFT half of the Viterbi window, None = symmetric (= f0_snap_halo).
    # Unlike the right half, left context is FREE in streaming — those
    # frames' candidates are already cached — so a low-latency profile
    # can run an asymmetric window: measured on the five formant seeds,
    # f0_snap_halo=0 (no lookahead) costs 0-7 octave-slip frames
    # symmetric, but f0_snap_left=6 with f0_snap_halo=0 restores ZERO
    # octave slips on every seed at zero added latency (a causal
    # contour DP — the decision for frame i uses frames [i-6, i]).
    # Probed alternatives (VERDICT r4 #3): symmetric halo-1 (5 ms
    # lookahead) still slipped up to 2 frames/utterance.
    f0_snap_left: int | None = None
    # Top-K CMND dips kept per frame for the lattice (fixed shape).
    f0_cand_k: int = 4
    # RELATIVE per-octave lag penalty on lattice emissions: candidate
    # cost = dip * (1+f0_rel_bias)^octaves_above_lag_min (+ the additive
    # octave_margin term).  This is the weak-fundamental vs diplophonia
    # separator: a true half-chosen period (weakfund) explains ~all the
    # residual (dip -> ~0), so even x1.5 inflation keeps it far below
    # the half-period dip; genuine-but-weak period doubling leaves the
    # doubled dip only marginally deeper (x0.8-0.95 of the true one),
    # so the relative penalty keeps the contour on the perceptual F0.
    # An ABSOLUTE margin cannot do both (measured on the weakfund and
    # seed-3 formant fixtures; see tests/test_dsp_golden.py).
    f0_rel_bias: float = 0.4
    # Per-frame cap on lattice emissions: bounds any single frame's vote
    # in the window DP, so a couple of confidently-wrong frames (half-
    # empty onset windows locking onto a dominant harmonic) cannot
    # outvote several weakly-right clean frames.
    f0_emis_cap: float = 0.05
    # --- full-rate voicing revision (the role of D4C's LoveTrain band
    # evidence, upstream:mmorise/World src/d4c.cpp): after the lattice
    # snap, per-frame and frame-local (streaming stays exact):
    # DEMOTE a voiced frame when the minimum energy over the
    # ``voicing_blocks`` hop-blocks centered on it falls below this
    # fraction of their mean — i.e. part of the window is silent, so the
    # frame is not confidently voiced (silence-adjacent boundary frames
    # whose wide spectral window leaks periodicity).  Voiced speech
    # never dips this low: between glottal pulses the formant ringing
    # keeps 5 ms blocks within ~x30 of the mean (measured on the formant
    # fixture: min ratio ~1e-2 voiced vs < 1e-4 for boundary frames).
    # Blocks are HOP-ALIGNED and non-overlapping: the energies come from
    # one [F+blocks, hop] reshape-style framing instead of a second
    # [F, fft+2*hop] frame materialization, and the half-window (5 hops
    # = 600 samples) stays inside the fft analysis halo, so the revision
    # adds no lookahead.  The outer margin beyond the confidence label's
    # +-22 ms is 72 samples < 1 block, so a confidently-voiced frame can
    # never contain a fully-silent block (recall-safe by construction).
    voicing_block_ratio: float = 0.003
    voicing_blocks: int = 10
    # RESCUE a CMND-unvoiced frame when its lattice candidate shows high
    # LOW-BAND periodicity (breathy/jittery voicing keeps a periodic
    # low band while high-band turbulence drags the full-band CMND above
    # the voicing threshold) and the low band carries a meaningful share
    # of the frame energy (excludes fricatives).
    voicing_rescue_plow: float = 0.8
    voicing_low_band_hz: float = 1000.0
    voicing_low_frac: float = 0.1

    @property
    def voicing_energy_win(self) -> int:
        """Samples spanned by the hop-aligned block-energy confidence
        window (``voicing_blocks`` hops, centered)."""
        return self.voicing_blocks * self.hop
    # Viterbi path cost per octave of frame-to-frame log-f0 movement.
    # Sized against CMND depth differences: a 1-octave jump must buy at
    # least this much total dip-depth advantage over the window to win
    # (real vibrato moves ~0.05 oct/frame = 0.03 cost; a diplophonia
    # episode's doubled-period dips are ~0.1-0.2 deeper per frame, so
    # entering+leaving costs ~1.2 and brief episodes stay on the true
    # contour — tests/test_dsp_golden.py seed-3 formant gate).
    f0_trans_weight: float = 0.6
    # --- envelope (CheapTrick-equivalent: fixed window + f0-adaptive lifter)
    # relative floor: per-frame power is clamped to peak * 10^(db/10).
    # Keeping the log dynamic range modest makes the envelope robust to
    # float32 FFT noise on TPU (absolute floors amplify fp noise in silent
    # bins into huge log-domain errors).
    envelope_floor_db: float = -70.0
    # --- aperiodicity
    num_ap_bands: int = 5
    # --- mel-cepstrum
    mcep_order: int = 59                  # mc has mcep_order+1 coefficients
    mcep_alpha: float = 0.466             # frequency-warping factor @24kHz
    # --- synthesis (harmonic + noise, DDSP-style; SURVEY.md §3.4 reborn)
    # Harmonic-bank size.  None (default) derives the count that covers
    # the full anti-alias band at the WORST-case pitch f0_floor:
    # ceil(HARMONIC_NYQUIST_FRACTION * (fs/2) / f0_floor) = 161 at the
    # 24 kHz / 71 Hz defaults.  WORLD's synthesis excites the entire
    # envelope at any F0 (upstream:mmorise/World src/synthesis.cpp, per-
    # period minimum-phase impulses cover all of Nyquist); the old fixed
    # 128 silently truncated the voiced spectrum at 128*f0 for f0 below
    # ~89 Hz (VERDICT r4 missing #4).  Cost is linear in the count
    # (Pallas bank unroll): ~+26% on the harmonic branch.  COMPAT: the
    # vocoder control net's harm_head is sized by this — checkpoints
    # trained under the old fixed cap need `dsp: {max_harmonics: 128}`
    # pinned (the strict loader names this knob on mismatch).
    max_harmonics: int | None = None

    @property
    def num_harmonics(self) -> int:
        if self.max_harmonics is not None:
            return self.max_harmonics
        return int(math.ceil(HARMONIC_NYQUIST_FRACTION
                             * (self.sample_rate / 2.0) / self.f0_floor))

    @property
    def hop(self) -> int:
        return int(round(self.sample_rate * self.frame_period_ms / 1000.0))

    @property
    def in_rate(self) -> int:
        return self.input_rate or self.sample_rate

    @property
    def out_rate(self) -> int:
        return self.output_rate or self.sample_rate

    @property
    def spec_bins(self) -> int:
        return self.fft_size // 2 + 1

    @property
    def lag_min(self) -> int:
        return max(2, int(math.floor(self.sample_rate / self.f0_ceil)))

    @property
    def lag_max(self) -> int:
        return int(math.ceil(self.sample_rate / self.f0_floor))

    @property
    def num_lags(self) -> int:
        return self.lag_max - self.lag_min + 1

    # --- decimated F0 search grid (dsp/f0.py; lag_min/lag_max above stay
    # full-rate — the aperiodicity stage autocorrelates at full rate)
    @property
    def f0_fs_d(self) -> int:
        assert self.sample_rate % self.f0_decimation == 0, (
            self.sample_rate, self.f0_decimation)
        return self.sample_rate // self.f0_decimation

    @property
    def f0_window_d(self) -> int:
        return self.f0_window // self.f0_decimation

    @property
    def lag_min_d(self) -> int:
        return max(2, int(math.floor(self.f0_fs_d / self.f0_ceil)))

    @property
    def lag_max_d(self) -> int:
        return int(math.ceil(self.f0_fs_d / self.f0_floor))

    @property
    def f0_frame_len_d(self) -> int:
        """Decimated analysis slice per F0 frame: window + max lag."""
        return self.f0_window_d + self.lag_max_d

    @property
    def f0_aa_half(self) -> int:
        """Anti-alias FIR half-width in full-rate samples (0 = no filter)."""
        return 0 if self.f0_decimation == 1 else 6 * self.f0_decimation

    @property
    def f0_frame_len(self) -> int:
        """Full-rate analysis slice per F0 frame: the decimated slice plus
        the anti-alias filter support (drives the streaming halo)."""
        return (self.f0_decimation * self.f0_frame_len_d
                + 2 * self.f0_aa_half)

    @property
    def mc_dim(self) -> int:
        return self.mcep_order + 1

    @property
    def f0_snap_left_eff(self) -> int:
        """Effective LEFT Viterbi half-window (symmetric when unset)."""
        return (self.f0_snap_halo if self.f0_snap_left is None
                else self.f0_snap_left)

    @property
    def f0_edge_frames(self) -> int:
        """Trailing analysis frames whose F0 is still provisional in
        streaming: 1 (median3 right neighbor) + f0_snap_halo (octave-snap
        RIGHT lookahead; the left half-window costs cache, not latency).
        Drives StreamGeometry's halo arithmetic."""
        return 1 + self.f0_snap_halo

    @property
    def f0_left_frames(self) -> int:
        """Leading raw-F0/candidate cache frames the streaming layer must
        carry for the Viterbi's LEFT half-window (+1 for the median's
        left neighbor)."""
        return 1 + self.f0_snap_left_eff


@dataclasses.dataclass(frozen=True)
class AcousticModelConfig:
    """Stage-1 mel-cepstrum conversion net (yukarin AcousticConverter equiv)."""

    hidden: int = 256
    num_blocks: int = 6
    kernel_size: int = 5                  # odd => symmetric receptive field
    use_f0_input: bool = True

    @property
    def context_frames(self) -> int:
        """One-sided receptive-field context in frames (halo size)."""
        return self.num_blocks * (self.kernel_size // 2)


@dataclasses.dataclass(frozen=True)
class SuperResolutionConfig:
    """Stage-2 spectral super-resolution net (become-yukarin equiv):
    frequency-mixing dense layers + gated time convolutions (MXU-native)."""

    hidden: int = 512
    num_blocks: int = 4
    kernel_size: int = 3

    @property
    def context_frames(self) -> int:
        """One-sided time receptive field (only the time convs widen it)."""
        return self.num_blocks * (self.kernel_size // 2)


@dataclasses.dataclass(frozen=True)
class VocoderNNConfig:
    """Neural vocoder (DDSP-style control net; BASELINE config #4)."""

    hidden: int = 256
    num_blocks: int = 4
    kernel_size: int = 3

    @property
    def context_frames(self) -> int:
        return self.num_blocks * (self.kernel_size // 2)


@dataclasses.dataclass(frozen=True)
class VocoderWaveConfig:
    """Learned frame->waveform decoder (Vocos/WaveNeXt-style iSTFT head).

    The third vocoder mode (``vocoder_mode: wave``): unlike the DDSP
    control net (which can only rescale the fixed harmonic+noise
    renderer's controls), this head predicts complex short-time spectra
    that are iSTFT/overlap-added ONTO the DSP renderer's output — an
    additive residual spanning the full signal space (phase, transients,
    inter-harmonic structure).  Zero-init heads keep it exactly equal to
    the DSP renderer at init.  Phase coherence: the head combines hidden
    features with cos/sin(m * frame-boundary fundamental phase) for
    m = 1..phase_harmonics, so residual harmonics up to that order can be
    phase-locked to the excitation."""

    hidden: int = 256
    num_blocks: int = 4
    kernel_size: int = 3
    phase_harmonics: int = 12
    # Learnable FRACTIONAL phase tracks: extra comb heads whose phase is
    # r_j * excitation phase with r_j a trainable ratio (init spread on
    # half-integers).  Integer combs can only phase-lock residuals to
    # harmonics; real voices also carry coherent NON-harmonic partials
    # (subglottal/nasal side resonances — the corpus fixture's 1.62*f0
    # component), which an OLA of phase-free bins can place in band but
    # never keep phase-coherent.  A constant ratio keeps streaming
    # exactness (r * boundary_phase is as chunk-continuous as the
    # boundary phase itself).  0 disables.
    phase_fractional: int = 4

    @property
    def context_frames(self) -> int:
        return self.num_blocks * (self.kernel_size // 2)


def _tuples(v):
    """Lists (as JSON and YAML give them) as tuples, nested: a frozen
    config stays hashable."""
    return tuple(_tuples(x) for x in v) if isinstance(v, (list, tuple)) \
        else v


@dataclasses.dataclass(frozen=True)
class VocoderHiFiGANConfig:
    """The HiFi-GAN V1 generator (Kong, Kim & Bae 2020, arXiv:2010.05646;
    ``config_v1.json`` of github.com/jik876/hifi-gan), the fourth vocoder
    mode (``vocoder_mode: hifigan``; the port's alone): a 7-tap conv to
    ``upsample_initial_channel`` channels, then per rate u a transposed
    conv (stride u, kernel k_u, channels halved) and the mean of one
    ResBlock1 per ``resblock_kernel_sizes`` entry (dilated convs), then a
    7-tap conv to one channel and tanh.  The widths are V1's; the rates
    multiply to this system's hop of 120 (V1's 8·8·2·2 is hop 256), with
    V1's k_u = 2u.  ResBlock1 (V1's ``resblock: "1"``) is the only block
    there is, so it is no field.  The streaming halo is the generator's
    receptive field (:meth:`halo_frames`), never a knob.

    The layer walk is shared with :class:`VocoderBigVGANConfig`: each
    conditioning row spans :meth:`frames_per_row` frames (one here), and
    an activation reads ``ACT_REACH`` rows on either side of its own (none
    for the leaky ReLU)."""

    upsample_initial_channel: int = 512
    upsample_rates: tuple = (5, 4, 3, 2)
    upsample_kernel_sizes: tuple = (10, 8, 6, 4)
    resblock_kernel_sizes: tuple = (3, 7, 11)
    resblock_dilation_sizes: tuple = ((1, 3, 5), (1, 3, 5), (1, 3, 5))

    ACT_REACH = 0       # a pointwise activation: reads its own row alone

    def __post_init__(self):
        for f in ("upsample_rates", "upsample_kernel_sizes",
                  "resblock_kernel_sizes", "resblock_dilation_sizes"):
            object.__setattr__(self, f, _tuples(getattr(self, f)))
        if not (1 <= len(self.upsample_rates) <= 6
                and len(self.upsample_rates)
                == len(self.upsample_kernel_sizes)):
            raise ValueError("1 to 6 upsampling stages (the profiling "
                             "markers name six), one kernel size each")
        if len(self.resblock_kernel_sizes) != len(
                self.resblock_dilation_sizes):
            raise ValueError("one dilation list per resblock kernel size")
        if any(k % 2 == 0 for k in self.resblock_kernel_sizes):
            raise ValueError("resblock kernels must be odd (SAME padding)")
        if self.upsample_initial_channel % 2 ** len(self.upsample_rates):
            raise ValueError("upsample_initial_channel must halve at every "
                             "stage")

    @property
    def samples_per_frame(self) -> int:
        """Output samples a conditioning row: the rates' product."""
        return math.prod(self.upsample_rates)

    def channels(self, stage: int) -> int:
        """Channels after upsampling stage ``stage`` (0-based)."""
        return self.upsample_initial_channel // 2 ** (stage + 1)

    def frames_per_row(self, hop: int) -> int:
        """Frames of ``hop`` samples that one conditioning row spans: the
        rates' product over the hop.  ValueError where it is no whole
        number."""
        if self.samples_per_frame % hop:
            raise ValueError(
                f"the upsample rates {self.upsample_rates} give "
                f"{self.samples_per_frame} samples a row, not a whole "
                f"number of frames of {hop}")
        return self.samples_per_frame // hop

    @property
    def context_frames(self) -> int:
        """One-sided receptive field in conditioning rows: the input rows
        on either side of a row that its output samples read, through every
        layer (conv_pre, each transposed conv and the widest resblock
        chain with its activations, and conv_post), from the layer list
        alone (:meth:`_walk` of row 0's samples, unclamped).  Rows are
        frames where a row spans one frame (:meth:`halo_frames`)."""
        lo, hi = self._walk(0, self.samples_per_frame)[0]
        return max(-lo, hi - 1)

    def halo_frames(self, hop: int) -> int:
        """:attr:`context_frames` in frames of ``hop`` samples: whole
        rows, so a streamed window's halo keeps its rows aligned."""
        return self.frames_per_row(hop) * self.context_frames

    def cone(self, T: int, out_ctx: int | None = None,
             hop: int | None = None) -> tuple:
        """The rows each layer boundary computes over a window of T frames
        of ``hop`` samples (a row a frame by default) for the output
        samples kept: frames [out_ctx, T - out_ctx - 1)
        (``models/vocoder_hifigan.py:hifigan_vocode``'s), or the whole
        window for None.  The window holds T // :meth:`frames_per_row`
        conditioning rows (a trailing frame short of a row is not read).
        Half-open (lo, hi) in the boundary's own samples, input first:
        conv_pre's input rows, then per stage its transposed conv's input
        (conv_pre's kept output or the last stage's) and its rows (the
        transposed conv's cropped output, which the stage's resblocks run
        over), then, where the activation reads a neighbourhood,
        activation_post's input, then conv_post's input and the kept
        samples.  Each is the rows the next one reads, clamped to the
        window's own (so the whole window when every row is kept); a
        range not at the window's edge holds, besides what is read on, the
        rows a SAME conv or an edge-padded activation corrupts at a
        slice's edge."""
        hop = hop or self.samples_per_frame
        rows = T // self.frames_per_row(hop)
        if out_ctx is None:
            return self._walk(0, rows * self.samples_per_frame, rows)
        return self._walk(out_ctx * hop, (T - out_ctx - 1) * hop, rows)

    def _walk(self, lo: int, hi: int, T: int | None = None) -> tuple:
        """:meth:`cone` of output samples [lo, hi) over T rows, by walking
        the layer list backward; unclamped for T None (an infinite
        window).  Each activation widens a range by ``ACT_REACH``."""
        a = self.ACT_REACH
        reach = max(sum((d + 1) * (k - 1) // 2 + 2 * a      # the MRF
                        for d in ds)
                    for k, ds in zip(self.resblock_kernel_sizes,
                                     self.resblock_dilation_sizes))
        n = None if T is None else T * self.samples_per_frame

        def clamp(lo, hi):
            return (lo, hi) if n is None else (max(lo, 0), min(hi, n))
        ranges = [(lo, hi), clamp(lo - 3, hi + 3)]          # conv_post
        if a:
            lo, hi = ranges[-1]
            ranges.append(clamp(lo - a, hi + a))        # activation_post
        for u, k in reversed(list(zip(self.upsample_rates,
                                      self.upsample_kernel_sizes))):
            lo, hi = ranges[-1]
            ranges.append(clamp(lo - reach, hi + reach))    # the resblocks
            lo, hi = ranges[-1]
            n = None if n is None else n // u
            p = (k - u) // 2          # output o = i*u - p + j, 0 <= j < k
            ranges.append(clamp(-(-(lo + p - k + 1) // u),
                                (hi - 1 + p) // u + 1))
        lo, hi = ranges[-1]
        ranges.append(clamp(lo - 3, hi + 3))                # conv_pre
        return tuple(reversed(ranges))


@dataclasses.dataclass(frozen=True)
class VocoderBigVGANConfig(VocoderHiFiGANConfig):
    """The BigVGAN v2 generator (Lee et al., "BigVGAN: A Universal Neural
    Vocoder with Large-Scale Training", ICLR 2023, arXiv:2206.04658; the
    widths of ``configs/bigvgan_v2_24khz_100band_256x.json`` of
    github.com/NVIDIA/BigVGAN), the fifth vocoder mode (``vocoder_mode:
    bigvgan``; the port's alone).  HiFi-GAN's layer list with AMPBlock1
    (``resblock: "1"``) in place of ResBlock1: every activation an
    anti-aliased SnakeBeta with log-scale parameters (2x polyphase
    upsample by a 12-tap Kaiser-windowed sinc, the snake, the same filter
    back down at stride 2: ``ops/bigvgan_act.py``), whose filters read 5
    rows on either side (``ACT_REACH``); no activation before a transposed
    conv; an activation after the last stage (``activation_post``); and
    conv_post without bias, clamped to [-1, 1] where V1 takes tanh.  The
    block, the activation and the final layer are the only ones there are,
    so they are no fields.

    The published rates (4, 4, 2, 2, 2, 2) multiply to 256; here six rates
    multiply to 240, two frames of this system's hop of 120 (no six whole
    rates of at least 2 multiply to 120), with BigVGAN's k_u = 2u: each
    conditioning row is the mean of an aligned pair of frames
    (:meth:`frames_per_row`)."""

    upsample_initial_channel: int = 1536
    upsample_rates: tuple = (5, 3, 2, 2, 2, 2)
    upsample_kernel_sizes: tuple = (10, 6, 4, 4, 4, 4)
    resblock_kernel_sizes: tuple = (3, 7, 11)
    resblock_dilation_sizes: tuple = ((1, 3, 5), (1, 3, 5), (1, 3, 5))

    ACT_REACH = 5       # Up2, the snake, Down2: 5 input rows either side


@dataclasses.dataclass(frozen=True)
class StreamingConfig:
    """Chunked-streaming geometry.

    The reference exposed per-stage ``extra_time`` halos as config; here
    every halo is *derived* from the model receptive fields
    (streaming/state.py StreamGeometry), so the only user knob is the
    chunk hop itself — a halo knob independent of the receptive fields
    could only be mis-set."""

    chunk_ms: float = 100.0               # 0.1 s hops (BASELINE config #2)

    def chunk_samples(self, dsp: DspConfig) -> int:
        n = int(round(dsp.sample_rate * self.chunk_ms / 1000.0))
        hop = dsp.hop
        return (n // hop) * hop           # align chunks to the frame grid

    def chunk_frames(self, dsp: DspConfig) -> int:
        return self.chunk_samples(dsp) // dsp.hop


@dataclasses.dataclass(frozen=True)
class ServingConfig:
    """Batched multi-stream serving (BASELINE config #5).  Mesh axis names
    are a code convention (parallel/mesh.py), not configuration."""

    num_streams: int = 64


@dataclasses.dataclass(frozen=True)
class Config:
    dsp: DspConfig = dataclasses.field(default_factory=DspConfig)
    acoustic: AcousticModelConfig = dataclasses.field(
        default_factory=AcousticModelConfig)
    super_resolution: SuperResolutionConfig = dataclasses.field(
        default_factory=SuperResolutionConfig)
    vocoder_nn: VocoderNNConfig = dataclasses.field(
        default_factory=VocoderNNConfig)
    vocoder_wave: VocoderWaveConfig = dataclasses.field(
        default_factory=VocoderWaveConfig)
    vocoder_hifigan: VocoderHiFiGANConfig = dataclasses.field(
        default_factory=VocoderHiFiGANConfig)
    vocoder_bigvgan: VocoderBigVGANConfig = dataclasses.field(
        default_factory=VocoderBigVGANConfig)
    streaming: StreamingConfig = dataclasses.field(
        default_factory=StreamingConfig)
    serving: ServingConfig = dataclasses.field(default_factory=ServingConfig)
    # Paths (reference: stage1/stage2 model + config + f0 statistics files).
    # params_path holds the full parameter tree (one msgpack, the training
    # checkpoint format); the per-stage paths override individual subtrees
    # so stages trained separately can be mixed — mirroring the reference's
    # separate stage-1/stage-2 model files.  The statistics paths are
    # F0Statistics .npz files overriding params["f0_stats"].
    # Consumed by models.voice_changer.load_all_params (both CLIs).
    params_path: str | None = None
    stage1_params_path: str | None = None
    stage2_params_path: str | None = None
    vocoder_params_path: str | None = None
    vocoder_wave_params_path: str | None = None
    vocoder_hifigan_params_path: str | None = None
    vocoder_bigvgan_params_path: str | None = None
    input_statistics_path: str | None = None
    target_statistics_path: str | None = None
    # Synthesis stage selection (BASELINE config #4):
    #   "dsp"  — fixed harmonic+noise renderer (WORLD-synthesis role)
    #   "ddsp" — DDSP control net rescaling the DSP renderer's controls
    #   "wave" — learned iSTFT residual head (full waveform freedom)
    #   "hifigan" — the HiFi-GAN V1 generator (the port's alone)
    #   "bigvgan" — the BigVGAN v2 generator (the port's alone)
    # ``use_neural_vocoder: true`` is the legacy spelling of "ddsp".
    vocoder_mode: str = "dsp"
    use_neural_vocoder: bool = False
    # Audio device names for the live mic/speaker front-end (reference
    # config's input/output device settings): a name substring or index
    # resolved by runtime/live_audio.py, None = system default.  Consumed
    # by ``cli.serve --live``.
    input_device: str | None = None
    output_device: str | None = None
    # model compute dtype ("bfloat16" doubles MXU throughput; params stay
    # float32, heads cast back — identity-at-init is exact either way)
    compute_dtype: str = "bfloat16"
    seed: int = 0

    @property
    def resolved_vocoder_mode(self) -> str:
        """The effective synthesis mode, honoring the legacy boolean."""
        mode = _check_mode(self.vocoder_mode)
        if self.use_neural_vocoder and mode == "dsp":
            return "ddsp"
        return mode

    # ------------------------------------------------------------------
    @classmethod
    def from_dict(cls, d: Mapping[str, Any]) -> "Config":
        def build(klass, sub):
            names = {f.name for f in dataclasses.fields(klass)}
            unknown = set(sub) - names
            if unknown:
                raise ValueError(
                    f"unknown {klass.__name__} keys: {sorted(unknown)}")
            return klass(**sub)

        kw: dict[str, Any] = {}
        nested = {
            "dsp": DspConfig,
            "acoustic": AcousticModelConfig,
            "super_resolution": SuperResolutionConfig,
            "vocoder_nn": VocoderNNConfig,
            "vocoder_wave": VocoderWaveConfig,
            "vocoder_hifigan": VocoderHiFiGANConfig,
            "vocoder_bigvgan": VocoderBigVGANConfig,
            "streaming": StreamingConfig,
            "serving": ServingConfig,
        }
        for key, value in d.items():
            if key in nested:
                kw[key] = build(nested[key], value)
            else:
                kw[key] = value
        names = {f.name for f in dataclasses.fields(cls)}
        unknown = set(kw) - names
        if unknown:
            raise ValueError(f"unknown Config keys: {sorted(unknown)}")
        return cls(**kw)

    @classmethod
    def from_yaml(cls, path: str | pathlib.Path) -> "Config":
        text = pathlib.Path(path).read_text()
        if _HAVE_YAML:
            data = yaml.safe_load(text) or {}
        else:  # pragma: no cover
            data = json.loads(text)
        return cls.from_dict(data)

    def to_dict(self) -> dict[str, Any]:
        return dataclasses.asdict(self)
