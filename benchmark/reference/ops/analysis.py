"""The analysis front-end's two products in plain float32 PyTorch: the
windowed power spectrum and the envelope cepstrum chain, as the basis
matmuls of ``ops/dft.py``.  The names are the program's, so the copied
DSP modules call them unchanged."""

from __future__ import annotations

import torch

from benchmark.reference.dsp import primitives as prim
from benchmark.reference.ops import dft


def power_spectrum_fused(frames: torch.Tensor, n: int) -> torch.Tensor:
    """|rfft(hann * frames)|^2 as two matmuls.  frames [R, n]."""
    window = dft.device_const(prim.hann, n, like=frames)
    return dft.power_spectrum(frames * window, n)


def envelope_cepstrum_fused(P: torch.Tensor, lift_half: torch.Tensor,
                            n: int, floor_db: float) -> torch.Tensor:
    """Lifted half cepstrum of the floored log of the smoothed power."""
    Ps = dft.quefrency_filter(P, lift_half, n)
    floor = torch.clamp(Ps.amax(dim=1, keepdim=True)
                        * 10.0 ** (floor_db / 10.0), min=prim.POWER_FLOOR)
    L = torch.log(torch.maximum(Ps, floor))
    C = dft.device_const(dft.cepstrum_basis, n, like=L)
    return (L @ C) * lift_half
