"""flax's default initialisers for the port's modules."""

from __future__ import annotations

import math

import torch
import torch.nn as nn


def lecun_normal_(weight: torch.Tensor, fan_in: int,
                  generator: torch.Generator) -> None:
    """flax's default kernel init: truncated normal, variance 1/fan_in."""
    std = math.sqrt(1.0 / fan_in) / 0.87962566103423978
    nn.init.trunc_normal_(weight, 0.0, std, -2.0 * std, 2.0 * std,
                          generator=generator)


def init_module(net: nn.Module, generator: torch.Generator) -> nn.Module:
    """Lecun-normal kernels and zero biases (where a layer has one) for
    every layer of
    ``net.flax_layers()``, in their order; the layers named in
    ``net.ZERO_INIT`` (the zero-initialised heads) get zero kernels.
    Returns ``net``."""
    for name, layer in net.flax_layers().items():
        w = layer.weight
        with torch.no_grad():
            if name in net.ZERO_INIT:
                w.zero_()
            else:
                lecun_normal_(w, w[0].numel(), generator)
            if layer.bias is not None:
                layer.bias.zero_()
    return net
