"""The parameter set and the F0 transform: ``{"stage1": AcousticNet,
"stage2": SRNet, "vocoder": VocoderControlNet, "vocoder_wave":
WaveDecoderNet, "f0_stats": {src_mean, src_std, tgt_mean, tgt_std}}``."""

from __future__ import annotations

import torch
import torch.nn as nn

from benchmark.reference.config import Config
from benchmark.reference.models.acoustic import AcousticNet
from benchmark.reference.models.super_resolution import SRNet
from benchmark.reference.models.vocoder_nn import VocoderControlNet
from benchmark.reference.models.vocoder_wave import WaveDecoderNet

NETS = ("stage1", "stage2", "vocoder", "vocoder_wave")
DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16,
          "float8_e4m3fn": torch.float8_e4m3fn}


def stage_nets(cfg: Config) -> dict[str, nn.Module]:
    """Uninitialised modules of every stage, in ``NETS`` order."""
    return {"stage1": AcousticNet(cfg.acoustic, cfg.dsp.mc_dim),
            "stage2": SRNet(cfg.super_resolution, cfg.dsp.spec_bins),
            "vocoder": VocoderControlNet(cfg.vocoder_nn, cfg.dsp),
            "vocoder_wave": WaveDecoderNet(cfg.vocoder_wave, cfg.dsp)}


def convert_f0_stats(f0: torch.Tensor, stats: dict) -> torch.Tensor:
    """Voiced-masked log-linear F0 moment matching; unvoiced stays 0."""
    voiced = f0 > 0
    logf0 = torch.log(torch.clamp(f0, min=1e-6))
    out = torch.exp((logf0 - stats["src_mean"])
                    / torch.clamp(stats["src_std"], min=1e-6)
                    * stats["tgt_std"] + stats["tgt_mean"])
    return torch.where(voiced, out, torch.zeros_like(out))


def compute_dtype(cfg: Config) -> torch.dtype:
    """The learned stages' compute precision, by ``cfg.compute_dtype``'s
    name (float8 is emulated with per-tensor scaling, ``acoustic.cast``)."""
    return DTYPES[cfg.compute_dtype]
