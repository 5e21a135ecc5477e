"""Patch discriminator for adversarial stage-2 training (PyTorch port of
``models/discriminator.py``).

A dense frequency embedding (one [K] -> [hidden] product per frame), then
stride-2 time convolutions, ending in one logit per time patch.  The input
is the log-power envelope, the domain the SR net works in.  It exists only
in training.
"""

from __future__ import annotations

import torch
import torch.nn as nn
import torch.nn.functional as Fn

from realtime_yukarin_tpu_torch.config import DspConfig, SuperResolutionConfig
from realtime_yukarin_tpu_torch.models.initializers import init_module
from realtime_yukarin_tpu_torch.ops.conv import conv1d
from realtime_yukarin_tpu_torch.parallel.mesh import (batch_mean,
                                                      column_parallel,
                                                      model_shard)


def conv1d_same_strided(x: torch.Tensor, conv: nn.Conv1d) -> torch.Tensor:
    """flax ``nn.Conv(padding="SAME", strides=s)`` on [B, T, C]: ceil(T/s)
    outputs, the (k - 1 + ...) padding split with the smaller half first —
    (1, 2) for k = 5, s = 2 and even T, (2, 2) for odd T.  The backward
    sums in a fixed order (``ops/conv.py``)."""
    T = x.shape[-2]
    k, s = conv.kernel_size[0], conv.stride[0]
    out = -(-T // s)
    total = max((out - 1) * s + k - T, 0)
    xt = Fn.pad(x.transpose(-1, -2), (total // 2, total - total // 2))
    if model_shard(conv) is None:
        y = conv1d(xt, conv.weight, stride=s) + conv.bias[:, None]
    else:
        y = column_parallel(conv, xt, lambda z: conv1d(
            z, conv.weight, stride=s), dim=1) + conv.bias[:, None]
    return y.transpose(-1, -2)


def dense(x: torch.Tensor, layer: nn.Linear) -> torch.Tensor:
    """``layer(x)``, column-split when its weight is a model shard."""
    if model_shard(layer) is None:
        return layer(x)
    return column_parallel(layer, x, lambda z: Fn.linear(z, layer.weight),
                           dim=-1) + layer.bias


class EnvelopeDiscriminator(nn.Module):
    """[B, T, K] log-envelope -> [B, ceil(T / 2**num_down)] patch logits."""

    ZERO_INIT = ()

    def __init__(self, spec_bins: int, hidden: int = 256, num_down: int = 3,
                 kernel_size: int = 5):
        super().__init__()
        self.freq_in = nn.Linear(spec_bins, hidden)
        self.down = nn.ModuleList(
            nn.Conv1d(hidden, hidden, kernel_size, stride=2)
            for _ in range(num_down))
        self.head = nn.Linear(hidden, 1)

    def flax_layers(self) -> dict[str, nn.Module]:
        """flax path -> layer, the names of ``flatten_params``."""
        layers = {"freq_in": self.freq_in, "head": self.head}
        for i, conv in enumerate(self.down):
            layers[f"down_{i}"] = conv
        return layers

    def forward(self, logE: torch.Tensor) -> torch.Tensor:
        h = Fn.leaky_relu(dense(logE.float(), self.freq_in), 0.2)
        for conv in self.down:
            h = Fn.leaky_relu(conv1d_same_strided(h, conv), 0.2)
        return dense(h, self.head)[..., 0]


def init_discriminator(sr_cfg: SuperResolutionConfig, dsp: DspConfig,
                       generator: torch.Generator, hidden: int = 256
                       ) -> EnvelopeDiscriminator:
    """A freshly initialised discriminator (flax's initialisers; its head
    is not zero-initialised).  ``sr_cfg`` is accepted for the JAX
    package's signature."""
    return init_module(EnvelopeDiscriminator(dsp.spec_bins, hidden),
                       generator)


# ---------------------------------------------------------------------------
# Hinge-GAN losses
# ---------------------------------------------------------------------------

def d_hinge_loss(real_logits: torch.Tensor, fake_logits: torch.Tensor,
                 mesh=None) -> torch.Tensor:
    """Means over the global batch when ``mesh`` splits it
    (:func:`~realtime_yukarin_tpu_torch.parallel.mesh.batch_mean`)."""
    return (batch_mean(torch.relu(1.0 - real_logits), mesh)
            + batch_mean(torch.relu(1.0 + fake_logits), mesh))


def g_hinge_loss(fake_logits: torch.Tensor, mesh=None) -> torch.Tensor:
    return -batch_mean(fake_logits, mesh)
