"""Analysis facade — the reference's ``Vocoder.encode`` role (PyTorch port
of ``dsp/world.py``)."""

from __future__ import annotations

import dataclasses

import torch

from benchmark.reference.config import DspConfig
from benchmark.reference.dsp.aperiodicity import (
    band_aperiodicity_from_power)
from benchmark.reference.dsp.envelope import (log_envelope_and_mcep,
                                                     power_spectrogram)
from benchmark.reference.dsp.f0 import (f0_raw_and_candidates,
                                               refine_f0_from_power,
                                               viterbi_snap,
                                               voicing_revision)
from benchmark.reference.dsp.framing import median3


@dataclasses.dataclass
class AcousticFeature:
    """f0 [.., F], power envelope [.., F, K], band aperiodicity [.., F, B],
    mel-cepstrum [.., F, M+1]."""
    f0: torch.Tensor
    env: torch.Tensor
    ap: torch.Tensor
    mc: torch.Tensor

    @property
    def voiced(self) -> torch.Tensor:
        return self.f0 > 0


def analyze(wave: torch.Tensor, num_frames: int, cfg: DspConfig,
            center_offset: int = 0) -> AcousticFeature:
    """wave [T] -> AcousticFeature with F = num_frames frames (Dio +
    StoneMask / CheapTrick / D4C roles) from one power spectrogram."""
    raw, cand_f0, cand_cost = f0_raw_and_candidates(wave, num_frames, cfg,
                                                    center_offset)
    f0, choice = viterbi_snap(median3(raw), cand_f0, cand_cost, cfg)
    P = power_spectrogram(wave, num_frames, cfg, center_offset)
    f0 = voicing_revision(wave, f0, choice, num_frames, cfg, center_offset,
                          P=P)
    return analyze_given_f0(wave, f0, num_frames, cfg, center_offset,
                            refine=True, P=P)


def analyze_given_f0(wave: torch.Tensor, f0: torch.Tensor, num_frames: int,
                     cfg: DspConfig, center_offset: int = 0,
                     refine: bool = False,
                     P: torch.Tensor | None = None) -> AcousticFeature:
    """Envelope / aperiodicity / mel-cepstrum for frames whose (median-
    filtered) F0 is given; frame-local given f0.  ``refine=True`` applies
    the StoneMask-role refinement first.  Pass the shared power
    spectrogram via ``P`` where the caller already holds it."""
    if P is None:
        P = power_spectrogram(wave, num_frames, cfg, center_offset)
    if refine:
        f0 = refine_f0_from_power(P, f0, cfg)
    L, mc = log_envelope_and_mcep(P, f0, cfg)
    ap = band_aperiodicity_from_power(P, f0, cfg)
    return AcousticFeature(f0=f0, env=torch.exp(L), ap=ap, mc=mc)
