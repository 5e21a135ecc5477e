"""Stage-2 spectral super-resolution (PyTorch port of
``models/super_resolution.py``).

Frequency-mixing dense layers plus gated time convolutions over the log
envelope; the zero-initialised head makes it the identity at init.
"""

from __future__ import annotations

import torch
import torch.nn as nn
import torch.nn.functional as Fn

from benchmark.reference.config import (DspConfig,
                                               SuperResolutionConfig)
from benchmark.reference.models.acoustic import cast, conv1d_valid


def _dense(x: torch.Tensor, layer: nn.Linear, dtype) -> torch.Tensor:
    return Fn.linear(cast(x, dtype), cast(layer.weight, dtype),
                     cast(layer.bias, dtype))


class SRNet(nn.Module):
    """[(B,) T, K] log-power -> [(B,) T, K] refined log-power (residual)."""

    ZERO_INIT = ("head",)

    def __init__(self, cfg: SuperResolutionConfig, spec_bins: int):
        super().__init__()
        self.cfg = cfg
        h = cfg.hidden
        self.freq_in = nn.Linear(spec_bins, h)
        self.time_conv = nn.ModuleList(
            nn.Conv1d(h, 2 * h, cfg.kernel_size)
            for _ in range(cfg.num_blocks))
        self.freq_mix = nn.ModuleList(
            nn.Linear(h, h) for _ in range(cfg.num_blocks))
        self.head = nn.Linear(h, spec_bins)

    def flax_layers(self) -> dict[str, nn.Module]:
        """flax path -> layer, the names of ``flatten_params``."""
        layers = {"freq_in": self.freq_in, "head": self.head}
        for i in range(self.cfg.num_blocks):
            layers[f"time_conv_{i}"] = self.time_conv[i]
            layers[f"freq_mix_{i}"] = self.freq_mix[i]
        return layers

    def forward(self, logE: torch.Tensor, dtype: torch.dtype
                ) -> torch.Tensor:
        h = _dense(logE, self.freq_in, dtype)
        pad = self.cfg.kernel_size // 2                       # SAME, odd k
        for conv, mix in zip(self.time_conv, self.freq_mix):
            r = conv1d_valid(h, conv, dtype, padding=pad)
            a, b = torch.chunk(r, 2, dim=-1)
            h = h + _dense(a * torch.sigmoid(b), mix, dtype)
        return logE + _dense(h, self.head, dtype).float()


def refine_envelope(net: SRNet, env: torch.Tensor,
                    sr_cfg: SuperResolutionConfig, dsp_cfg: DspConfig,
                    dtype=torch.float32) -> torch.Tensor:
    """Apply stage 2 in the power domain.  env: [T, K] or [B, T, K]."""
    logE = torch.log(torch.clamp(env, min=1e-12))
    return torch.exp(net(logE, dtype))
