"""DTW time alignment of paired source/target utterances for corpus
preparation (PyTorch port of ``training/align.py``).

* The cost matrix is one float32 matrix product: squared euclidean
  distance ``C = |x|^2 + |y|^2 - 2 x @ y.T``, clamped at 0 (the JAX
  formula; ``torch.cdist`` switches formula above 25 rows and returns the
  square root).  The port never enables TF32, so the product is full
  float32 on the card.
* The DP uses the step set {(1,0), (1,1), (1,2)}: every source frame
  advances one row and the target index 0, 1 or 2 columns, so each row
  depends only on the row before.  The cost matrix is copied to the host
  once and the loop runs there over rows, each row vectorised (and
  batched over any leading dims): on the card each row would be a handful
  of tiny launches, and this is corpus preparation, not the serving path.
  A CUDA and a CPU preparation then run the same DP on the host, and only
  their cost matrices differ.  Ties take the fewest columns back, as
  ``jnp.argmin`` takes the first index.
* The backtrack walks the per-row choices on the host.
"""

from __future__ import annotations

import numpy as np
import torch

from realtime_yukarin_tpu_torch.dsp.world import AcousticFeature

_BIG = 1e30


def cost_matrix(x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    """Squared euclidean distances [..., Fx, Fy] of x [..., Fx, M] and
    y [..., Fy, M], in float32."""
    x = x.float()
    y = y.float()
    xx = torch.sum(x * x, dim=-1, keepdim=True)             # [..., Fx, 1]
    yy = torch.sum(y * y, dim=-1)[..., None, :]             # [..., 1, Fy]
    xy = torch.matmul(x, y.transpose(-1, -2))
    return torch.clamp(xx + yy - 2.0 * xy, min=0.0)


def dtw_choices(C: torch.Tensor) -> torch.Tensor:
    """The forward DP over a cost matrix C [..., Fx, Fy]: for rows 1..Fx-1
    the columns each cell's best predecessor lies back, int8 [..., Fx-1,
    Fy].  The start is pinned at (0, 0)."""
    Fx, Fy = C.shape[-2:]
    # prev row behind two columns of _BIG: row[j - s] is buf[2 + j - s]
    buf = torch.full((*C.shape[:-2], Fy + 2), _BIG, dtype=C.dtype,
                     device=C.device)
    buf[..., 2] = C[..., 0, 0]
    choices = torch.empty((*C.shape[:-2], max(Fx - 1, 0), Fy),
                          dtype=torch.int8, device=C.device)
    for i in range(1, Fx):
        c0, c1, c2 = buf[..., 2:], buf[..., 1:-1], buf[..., :-2]
        take1 = c1 < c0                   # strict: a tie keeps fewer steps
        best = torch.where(take1, c1, c0)
        take2 = c2 < best
        choices[..., i - 1, :] = torch.where(take2, 2, take1.to(torch.int8))
        buf[..., 2:] = C[..., i, :] + torch.where(take2, c2, best)
    return choices


def backtrack(choices: np.ndarray, Fy: int) -> np.ndarray:
    """Path [..., Fx] from the end (Fx-1, Fy-1) back through host choices
    [..., Fx-1, Fy]."""
    lead = choices.shape[:-2]
    Fx = choices.shape[-2] + 1
    flat = choices.reshape(-1, Fx - 1, Fy)
    rows = np.arange(flat.shape[0])
    idx = np.empty((flat.shape[0], Fx), np.int64)
    j = np.full(flat.shape[0], Fy - 1, np.int64)
    idx[:, Fx - 1] = j
    for i in range(Fx - 2, -1, -1):
        j = j - flat[rows, i, j]
        idx[:, i] = j
    return idx.reshape(*lead, Fx)


def dtw_path(x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    """Monotonic alignment path: for each source frame i the aligned
    target frame idx[i] (idx[0] = 0, idx[-1] = Fy-1, steps of 0/1/2), as
    int64 on x's device.

    x: [..., Fx, M] source features; y: [..., Fy, M] target features.
    Leading dims are a batch of equal-length pairs (what the JAX package's
    ``batched_dtw_path`` computes)."""
    C = cost_matrix(x, y)
    choices = dtw_choices(C.cpu()).numpy()
    idx = backtrack(choices, C.shape[-1])
    return torch.from_numpy(idx).to(x.device)


def path_cost(C: np.ndarray, idx: np.ndarray) -> float:
    """The summed cost of a path under a cost matrix [Fx, Fy] (float64)."""
    return float(np.asarray(C, np.float64)[np.arange(len(idx)), idx].sum())


def warp_rows(values: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """Rows of ``values`` ([Fy, ...]) at ``idx`` ([Fx]) -> [Fx, ...]."""
    return values.index_select(0, idx)


def align_pair(src_mc: torch.Tensor, tgt: AcousticFeature
               ) -> AcousticFeature:
    """Every target feature warped onto the source timeline, aligned on
    mel-cepstra without the 0th (energy) coefficient."""
    idx = dtw_path(src_mc[:, 1:], tgt.mc[:, 1:])
    return AcousticFeature(f0=warp_rows(tgt.f0, idx),
                           env=warp_rows(tgt.env, idx),
                           ap=warp_rows(tgt.ap, idx),
                           mc=warp_rows(tgt.mc, idx))
