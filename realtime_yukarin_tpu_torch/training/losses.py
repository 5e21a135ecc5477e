"""Training losses (PyTorch port of ``training/losses.py``): plain
regression losses for both conversion stages and a multi-resolution STFT
loss for the neural vocoders.  ``torch.fft.rfft`` computes the STFT here,
as the JAX package computes it with ``jnp.fft`` outside any kernel.

Given a ``mesh`` whose data group splits the batch, each loss is the
global batch's: its means and norms are built from partial sums
all-reduced over the data group with an identity backward
(``parallel/mesh.py:sum_over_data``).  The spectral convergence is a ratio of
norms over the whole batch, so averaging per-rank losses would be another
objective."""

from __future__ import annotations

import torch

from realtime_yukarin_tpu_torch.dsp.framing import hann
from realtime_yukarin_tpu_torch.parallel.mesh import (batch_mean,
                                                      data_parallel,
                                                      sum_over_data)


def mc_l1(pred: torch.Tensor, target: torch.Tensor, mesh=None
          ) -> torch.Tensor:
    return batch_mean(torch.abs(pred - target), mesh)


def log_env_l2(pred_env: torch.Tensor, target_env: torch.Tensor, mesh=None
               ) -> torch.Tensor:
    lp = torch.log(torch.clamp(pred_env, min=1e-12))
    lt = torch.log(torch.clamp(target_env, min=1e-12))
    return batch_mean((lp - lt) ** 2, mesh)


def f0_l2(pred_f0: torch.Tensor, target_f0: torch.Tensor) -> torch.Tensor:
    both = (pred_f0 > 0) & (target_f0 > 0)
    d = (torch.log(torch.clamp(pred_f0, min=1.0))
         - torch.log(torch.clamp(target_f0, min=1.0)))
    return (torch.sum(torch.where(both, d ** 2, torch.zeros_like(d)))
            / torch.clamp(both.sum(), min=1))


def _stft_mag(x: torch.Tensor, fft: int, hop: int) -> torch.Tensor:
    T = x.shape[-1]
    n = max((T - fft) // hop + 1, 1)
    idx = (torch.arange(n, device=x.device)[:, None] * hop
           + torch.arange(fft, device=x.device))
    # a signal shorter than one frame repeats its last sample, as JAX's
    # clamped gather does
    frames = x[..., torch.clamp(idx, max=T - 1)] * hann(fft, like=x)
    return torch.abs(torch.fft.rfft(frames, dim=-1))


def multi_resolution_stft(pred: torch.Tensor, target: torch.Tensor,
                          ffts=(512, 1024, 2048), mesh=None) -> torch.Tensor:
    """Spectral convergence + log-magnitude L1, averaged over resolutions.

    Magnitude only by design: the renderer's phase track is reset-relative,
    while a recording's pulse timing is arbitrary."""
    total = 0.0
    for fft in ffts:
        hop = fft // 4
        mp = _stft_mag(pred, fft, hop)
        mt = _stft_mag(target, fft, hop)
        log_l1 = torch.abs(torch.log(mp + 1e-6) - torch.log(mt + 1e-6))
        if data_parallel(mesh):
            # one all-reduce of the three partial sums
            s = sum_over_data(torch.stack([torch.sum((mp - mt) ** 2),
                                           torch.sum(mt ** 2),
                                           torch.sum(log_l1)]), mesh)
            sc = torch.sqrt(s[0]) / (torch.sqrt(s[1]) + 1e-6)
            lm = s[2] / (log_l1.numel() * mesh.data_size)
        else:
            sc = (torch.linalg.vector_norm(mp - mt)
                  / (torch.linalg.vector_norm(mt) + 1e-6))
            lm = torch.mean(log_l1)
        total = total + sc + lm
    return total / len(ffts)
