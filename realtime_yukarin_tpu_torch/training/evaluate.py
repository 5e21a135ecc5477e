"""Evaluation metrics for voice conversion quality (PyTorch port of
``training/evaluate.py``).

* **MCD** (mel-cepstral distortion, dB): 10·sqrt(2)/ln 10 ·
  ||mc_pred[1:] - mc_tgt[1:]||_2 per frame, averaged.
* Voiced-frame **log-F0 RMSE** and the **V/UV error rate**.

Frame-major [..., F, M+1] / [..., F] tensors; results are 0-d tensors.
"""

from __future__ import annotations

import math

import torch

_MCD_CONST = 10.0 * math.sqrt(2.0) / math.log(10.0)


def mcd_db(mc_pred: torch.Tensor, mc_tgt: torch.Tensor) -> torch.Tensor:
    """Mel-cepstral distortion in dB (0th/energy coefficient excluded)."""
    d = mc_pred[..., 1:] - mc_tgt[..., 1:]
    per_frame = torch.sqrt(torch.sum(d * d, dim=-1))
    return _MCD_CONST * torch.mean(per_frame)


def f0_metrics(f0_pred: torch.Tensor, f0_tgt: torch.Tensor
               ) -> dict[str, torch.Tensor]:
    """log-F0 RMSE over frames voiced in both + V/UV disagreement rate."""
    vp, vt = f0_pred > 0, f0_tgt > 0
    both = vp & vt
    d = (torch.log(torch.clamp(f0_pred, min=1.0))
         - torch.log(torch.clamp(f0_tgt, min=1.0)))
    rmse = torch.sqrt(torch.sum(torch.where(both, d * d, torch.zeros_like(d)))
                      / torch.clamp(both.sum(), min=1))
    vuv_err = torch.mean((vp != vt).float())
    return {"logf0_rmse": rmse, "vuv_error": vuv_err}
