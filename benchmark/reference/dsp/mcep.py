"""Mel-cepstrum encode/decode as matmuls (PyTorch port of ``dsp/mcep.py``):
a warped-cosine basis fit — encode is one product with the precomputed
pseudo-inverse, decode one product with the basis."""

from __future__ import annotations

import math

import torch

from benchmark.reference.config import DspConfig
from benchmark.reference.dsp import primitives as prim
from benchmark.reference.ops.dft import device_const


def encode_mcep(env: torch.Tensor, cfg: DspConfig) -> torch.Tensor:
    """[..., K] power envelope -> [..., M+1] mel-cepstrum."""
    logE = torch.log(torch.clamp(env, min=prim.POWER_FLOOR))
    return encode_mcep_from_log(logE, cfg)


def encode_mcep_from_log(logE: torch.Tensor, cfg: DspConfig) -> torch.Tensor:
    """[..., K] LOG power envelope -> [..., M+1] mel-cepstrum."""
    A = device_const(prim.mcep_basis, cfg.spec_bins, cfg.mcep_order,
                     cfg.mcep_alpha, like=logE, index=1)
    logE = torch.clamp(logE, min=math.log(prim.POWER_FLOOR))
    return logE @ A.T


def decode_mcep(mc: torch.Tensor, cfg: DspConfig) -> torch.Tensor:
    """[..., M+1] mel-cepstrum -> [..., K] smooth power envelope."""
    B = device_const(prim.mcep_basis, cfg.spec_bins, cfg.mcep_order,
                     cfg.mcep_alpha, like=mc, index=0)
    return torch.exp(mc @ B.T)
