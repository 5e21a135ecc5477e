"""Log-linear F0 moment matching (PyTorch port of ``models/f0_stats.py``).

The source speaker's F0 is converted outside the networks by matching
log-domain moments of the two speakers:

    log f0' = (log f0 - mu_src) / sigma_src * sigma_tgt + mu_tgt

A statistics file is an ``.npz`` with the scalars ``mean`` and ``std``
(the JAX package's layout; ``training/corpus.py`` writes one per speaker).
"""

from __future__ import annotations

import dataclasses
import pathlib

import numpy as np
import torch


@dataclasses.dataclass(frozen=True)
class F0Statistics:
    mean: float      # mean of log-f0 over voiced frames
    std: float       # std of log-f0 over voiced frames

    @classmethod
    def from_f0(cls, f0: np.ndarray) -> "F0Statistics":
        voiced = f0[f0 > 0]
        if voiced.size == 0:
            raise ValueError(
                "no voiced frames — cannot estimate F0 statistics")
        logs = np.log(voiced)
        return cls(mean=float(logs.mean()), std=float(logs.std()))

    @classmethod
    def load(cls, path: str | pathlib.Path) -> "F0Statistics":
        with np.load(path, allow_pickle=False) as d:
            return cls(mean=float(d["mean"]), std=float(d["std"]))

    def save(self, path: str | pathlib.Path) -> None:
        np.savez(path, mean=self.mean, std=self.std)


def convert_f0(f0: torch.Tensor, src: F0Statistics, tgt: F0Statistics
               ) -> torch.Tensor:
    """Voiced-masked log-linear moment matching; unvoiced stays 0."""
    voiced = f0 > 0
    logf0 = torch.log(torch.clamp(f0, min=1e-6))
    conv = torch.exp((logf0 - src.mean) / max(src.std, 1e-6) * tgt.std
                     + tgt.mean)
    return torch.where(voiced, conv, torch.zeros_like(conv))


def f0_stats_params(src: F0Statistics, tgt: F0Statistics,
                    device="cpu") -> dict[str, torch.Tensor]:
    """The parameter tree's ``f0_stats`` subtree for these statistics
    (float32 scalars, as the JAX package's model-load step installs)."""
    return {k: torch.tensor(v, dtype=torch.float32, device=device)
            for k, v in (("src_mean", src.mean), ("src_std", src.std),
                         ("tgt_mean", tgt.mean), ("tgt_std", tgt.std))}
