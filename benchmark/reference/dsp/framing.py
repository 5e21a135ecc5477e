"""Static-shape framing utilities (PyTorch port of ``dsp/framing.py``).

Frame i of a signal is centered at ``center_offset + i*hop`` and
out-of-range samples are zero — the golden reference's convention, so
streamed and offline paths agree exactly on the interior.
"""

from __future__ import annotations

import torch
import torch.nn.functional as Fn

from benchmark.reference.dsp import primitives as prim
from benchmark.reference.ops.dft import device_const


def hann(n: int, like: torch.Tensor) -> torch.Tensor:
    """Periodic Hann window on ``like``'s device and dtype."""
    return device_const(prim.hann, n, like=like)


def extract_centered_frames(x: torch.Tensor, num_frames: int, hop: int,
                            frame_len: int, center_offset: int = 0
                            ) -> torch.Tensor:
    """[..., T] -> [..., F, frame_len]; frame i is centered at
    center_offset + i*hop, zero-padded outside [0, T)."""
    T = x.shape[-1]
    start0 = center_offset - frame_len // 2
    need_end = start0 + (num_frames - 1) * hop + frame_len
    pad_left = max(0, -start0)
    pad_right = max(0, need_end - T)
    if pad_left or pad_right:
        x = Fn.pad(x, (pad_left, pad_right))
    y = x[..., start0 + pad_left: need_end + pad_left]
    return y.unfold(-1, frame_len, hop)


def lerp_rows(values: torch.Tensor, pos: torch.Tensor) -> torch.Tensor:
    """Row-wise linear interpolation.

    values: [F, K] or [F, K, C] (C channels share the positions);
    pos: [F, H] fractional indices, clipped to [0, K-1] -> [F, H] /
    [F, H, C].  A gather of the two neighbours plus a lerp; at
    ``lo == K-1`` the weight ``t`` is 0, matching the clamped gather.
    """
    K = values.shape[1]
    squeeze = values.ndim == 2
    V = values[:, :, None] if squeeze else values
    pos = torch.clamp(pos, 0.0, K - 1.0)
    lo = torch.floor(pos)
    t = (pos - lo).to(V.dtype)
    lo_i = lo.to(torch.int64)
    hi_i = torch.clamp(lo_i + 1, max=K - 1)
    C = V.shape[2]
    vlo = torch.gather(V, 1, lo_i[:, :, None].expand(-1, -1, C))
    vhi = torch.gather(V, 1, hi_i[:, :, None].expand(-1, -1, C))
    out = vlo * (1.0 - t)[:, :, None] + vhi * t[:, :, None]
    return out[:, :, 0] if squeeze else out


def median3(x: torch.Tensor, dim: int = -1) -> torch.Tensor:
    """3-tap median filter along ``dim``, edge-replicated."""
    x = torch.movedim(x, dim, -1)
    a = torch.cat([x[..., :1], x[..., :-1]], dim=-1)
    c = torch.cat([x[..., 1:], x[..., -1:]], dim=-1)
    med = torch.maximum(torch.minimum(a, x),
                        torch.minimum(torch.maximum(a, x), c))
    return torch.movedim(med, -1, dim)
