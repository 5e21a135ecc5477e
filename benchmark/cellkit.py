"""What the cells share: both sides' configurations and weights, the
control's precision, the comparison's numbers and the statistics of a
window."""

from __future__ import annotations

import contextlib
import numpy as np
import torch

from benchmark import weights as bench_weights
from benchmark.reference.config import Config as RefConfig
from benchmark.reference.models.voice_changer import stage_nets as ref_nets

# the control: the configuration's precision one step down, everywhere
CONTROL_DTYPE = "float8_e4m3fn"     # for the bfloat16 learned stages


def program_config(cell):
    from realtime_yukarin_tpu_torch.config import Config
    return Config.from_dict(cell.config["config"])


def reference_config(cell, control: bool = False) -> RefConfig:
    """The reference computes in float32 (the control in float8 for the
    learned stages, TF32 for the float32 rest: :func:`control_precision`)."""
    return RefConfig.from_dict({**cell.config["config"],
                                "compute_dtype": (CONTROL_DTYPE if control
                                                  else "float32")})


def make_weights(ctx):
    return bench_weights.make_weights(
        reference_config(ctx.cell), ctx.cell.config["weights"],
        ctx.torch_seed(1), ctx.device)


def program_params(weights: dict, cfg) -> dict:
    from realtime_yukarin_tpu_torch.models.voice_changer import stage_nets
    return bench_weights.load_into(stage_nets(cfg), weights)


def reference_params(weights: dict, ref_cfg, device) -> dict:
    params = bench_weights.load_into(ref_nets(ref_cfg), weights)
    for k, v in params.items():
        if isinstance(v, torch.nn.Module):
            v.to(device).eval().requires_grad_(False)
    return params


@contextlib.contextmanager
def control_precision(on: bool):
    """TF32 for float32 matmuls and convolutions while ``on``."""
    saved = (torch.backends.cuda.matmul.allow_tf32,
             torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = on
    torch.backends.cudnn.allow_tf32 = on
    try:
        yield
    finally:
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = saved


def weighted_quantile(values, weights, q: float) -> float:
    """The q-quantile of ``values`` each counted ``weights`` times (the
    lower of the two middle values, no interpolation)."""
    v = np.asarray(values, np.float64)
    w = np.asarray(weights, np.float64)
    order = np.argsort(v)
    cum = np.cumsum(w[order])
    return float(v[order][np.searchsorted(cum, q * cum[-1])])


def gaps(out: np.ndarray, ref: np.ndarray, live: np.ndarray,
         start: np.ndarray, event_chunks: int) -> dict:
    """How far the program's output lies from the reference's, chunk by
    chunk: each chunk's RMS error over the reference's RMS level across
    every compared sample of every lane (a lane's own level would blow up
    for one still near silence).  out, ref [T, K, S]: K lanes' outputs on
    T ticks; live [T, K]: whether lane k advanced on tick t; start [K]:
    the tick of lane k's join, from which it is compared.  Returns the
    compared chunks' errors at the quantiles 0.5, 0.75 and 0.9 and at
    most, the worst lane's RMS error over the level, and the mean error of
    the chunks that the lane masks decide: the first ``event_chunks`` live
    chunks from each lane's join (the reset mask's) and from each resume
    after a pause (the live mask's): ``mask_err_mean``."""
    T, K = live.shape
    compared = np.arange(T)[:, None] >= np.asarray(start)[None]
    o, r = out.astype(np.float64), ref.astype(np.float64)
    level = max(float(np.sqrt((r[compared] ** 2).mean())), 1e-12)
    sq = ((o - r) ** 2).mean(axis=-1)                       # [T, K]
    err = np.sqrt(sq) / level
    chunks = err[compared]
    q50, q75, q90 = np.quantile(chunks, [0.5, 0.75, 0.9])
    lanes = max(np.sqrt(sq[compared[:, k], k].mean())
                for k in range(K)) / level
    on = live & compared
    resumed = np.zeros_like(on)
    resumed[1:] = on[1:] & ~live[:-1] & compared[:-1]
    masked = np.zeros_like(on)
    for k in range(K):
        ticks = np.flatnonzero(on[:, k])
        for i in [0, *np.flatnonzero(resumed[ticks, k])]:
            masked[ticks[i: i + event_chunks], k] = True
    return {"chunk_err_q50": float(q50), "chunk_err_q75": float(q75),
            "chunk_err_q90": float(q90), "chunk_err_max": float(chunks.max()),
            "stream_err_max": float(lanes),
            "mask_err_mean": float(err[masked].mean())}


def by_segment(times, values, width: float = 5.0) -> list[float]:
    """The median of ``values`` in each ``width``-second segment of
    ``times`` (seconds from the window's start), rounded for a log line:
    shows whether a run sped up or slowed down inside its window."""
    t, v = np.asarray(times), np.asarray(values)
    if t.size == 0:
        return []
    seg = (t // width).astype(int)
    return [round(float(np.median(v[seg == k])), 4)
            for k in range(seg.max() + 1) if (seg == k).any()]
