"""Streams stepped side by side in plain PyTorch: the reference a served
lane or a live stream is judged against.

Each stream starts from the state after an infinite silence (recomputed
here), takes its chunks in order, and keeps its state on a tick it does
not advance; its noise is the permutation its key names.
"""

from __future__ import annotations

import numpy as np
import torch

from benchmark.reference.streaming.pipeline import streaming_step
from benchmark.reference.streaming.state import (StreamCarry,
                                                 StreamGeometry, tree_map)


def replay(params: dict, cfg, keys: torch.Tensor, chunks: np.ndarray,
           live: np.ndarray, device, use_sr: bool = True, mode: str = "dsp"
           ) -> np.ndarray:
    """Step K streams through T ticks.

    keys [K, 3] int64 noise permutations; chunks [T, K, S] float32 input of
    every tick; live [T, K] bool: whether stream k advances at tick t (a
    stream that does not emits zeros).  Returns the outputs [T, K,
    chunk_out_samples] as a host array."""
    T, K = live.shape
    geo = StreamGeometry.from_config(cfg, use_sr, vocoder_mode=mode)
    with torch.no_grad():
        init = StreamCarry.init(cfg, geo, params, device, vocoder_mode=mode)
        carries = tree_map(lambda x: x.expand(K, *x.shape).clone(), init)
        keys = keys.to(device)
        x_all = torch.as_tensor(chunks, dtype=torch.float32, device=device)
        live_all = torch.as_tensor(live, device=device)
        out = torch.zeros((T, K, geo.chunk_out_samples), device=device)
        for t in np.flatnonzero(live.any(axis=1)):
            m = live_all[t]
            y, new = streaming_step(params, carries, x_all[t], keys, cfg,
                                    use_sr, vocoder_mode=mode)
            carries = tree_map(
                lambda n, o: torch.where(
                    m.reshape(m.shape + (1,) * (n.ndim - 1)), n, o),
                new, carries)
            out[t] = torch.where(m[:, None], y, 0.0)
        return out.cpu().numpy()
