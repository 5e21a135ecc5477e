"""The harmonic bank in plain PyTorch: sum_h lerp(aL, aR)[n] sin(h phi[n])
per frame row, by materialising sin(h phi) (autograd differentiates it)."""

from __future__ import annotations

import torch


def harmonic_bank(amps_l: torch.Tensor, amps_r: torch.Tensor,
                  phi: torch.Tensor, frac: torch.Tensor) -> torch.Tensor:
    """amps_l/amps_r [R, H] at each frame's edges, phi [R, hop] the
    fundamental phase, frac [hop] the interpolation weight -> [R, hop]."""
    H = amps_l.shape[1]
    h_idx = torch.arange(1, H + 1, dtype=phi.dtype, device=phi.device)
    s = torch.sin(phi[:, :, None] * h_idx)
    yl = torch.einsum("rnh,rh->rn", s, amps_l)
    yr = torch.einsum("rnh,rh->rn", s, amps_r)
    return yl * (1.0 - frac) + yr * frac
