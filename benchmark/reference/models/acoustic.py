"""Stage-1 acoustic conversion network (PyTorch port of
``models/acoustic.py``).

A 1-D GLU/residual conv stack over time mapping source mel-cepstrum (+ F0)
to a mel-cepstrum residual; the head is zero-initialised, so an untrained
net is the identity mapping.  Public functions keep the JAX package's
``[T, C]`` / ``[B, T, C]`` layout; the modules transpose to ``[B, C, T]``
only around ``conv1d``.  Parameters stay float32 and are cast to the
compute dtype at use, as flax does (``dtype=bfloat16`` on the default
path); training runs them in float32.

Streaming: every block carries its last (kernel-1) input frames across
steps, so each layer computes exactly the Fc fresh frames per chunk (VALID
conv over the cache + the new frames) — the same outputs as the full
SAME-padded forward on the interior.
"""

from __future__ import annotations

import torch
import torch.nn as nn
import torch.nn.functional as Fn

from benchmark.reference.config import AcousticModelConfig


def cast(x: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    """``x`` in the compute precision ``dtype``: a cast for the float
    types; for a float8 type each tensor is scaled by its largest
    magnitude onto the type's range, rounded to it and brought back to
    float32 (the per-tensor scaled float8 of a quantised deployment)."""
    if dtype.itemsize != 1:
        return x.to(dtype)
    amax = torch.clamp(x.detach().abs().amax(), min=1e-12).float()
    scale = torch.finfo(dtype).max / amax
    return (x.float() * scale).to(dtype).float() / scale


def conv1d_valid(x: torch.Tensor, conv: nn.Conv1d, dtype: torch.dtype,
                 padding: int = 0) -> torch.Tensor:
    """[(B,) T, C_in] -> [(B,) T + 2*padding - (k-1), C_out]: input and
    kernel cast to ``dtype`` before the conv, bias added in ``dtype``
    (flax's order) by :func:`cast`."""
    xt = cast(x.transpose(-1, -2), dtype)

    xt = xt if x.ndim == 3 else xt[None]
    y = Fn.conv1d(xt, cast(conv.weight, dtype), padding=padding)
    y = (y if x.ndim == 3 else y[0]).transpose(-1, -2)
    return y + cast(conv.bias, dtype)


class GLUConvBlock(nn.Module):
    def __init__(self, hidden: int, kernel: int):
        super().__init__()
        self.conv = nn.Conv1d(hidden, 2 * hidden, kernel)
        self.proj = nn.Conv1d(hidden, hidden, 1)

    def forward(self, z_in: torch.Tensor, dtype: torch.dtype,
                padding: int = 0) -> torch.Tensor:
        """[(B,) T, H] -> [(B,) T + 2*padding - (k-1), H]: gated conv, 1x1
        projection, residual at the centers."""
        k = self.conv.kernel_size[0]
        h = conv1d_valid(z_in, self.conv, dtype, padding)
        a, b = torch.chunk(h, 2, dim=-1)
        h = conv1d_valid(a * torch.sigmoid(b), self.proj, dtype)
        half = (k - 1) // 2 - padding
        return z_in[..., half: z_in.shape[-2] - half, :] + h


class AcousticNet(nn.Module):
    """[(B,) T, D_in] -> mel-cepstrum residual [(B,) T, mc_dim] (float32)."""

    ZERO_INIT = ("head",)

    def __init__(self, cfg: AcousticModelConfig, mc_dim: int):
        super().__init__()
        d_in = mc_dim + (2 if cfg.use_f0_input else 0)
        self.cfg = cfg
        self.stem = nn.Conv1d(d_in, cfg.hidden, 1)
        self.blocks = nn.ModuleList(
            GLUConvBlock(cfg.hidden, cfg.kernel_size)
            for _ in range(cfg.num_blocks))
        self.head = nn.Conv1d(cfg.hidden, mc_dim, 1)

    def flax_layers(self) -> dict[str, nn.Module]:
        """flax path -> layer, the names of ``flatten_params``."""
        layers = {"stem": self.stem, "head": self.head}
        for i, b in enumerate(self.blocks):
            layers[f"block_{i}/conv"] = b.conv
            layers[f"block_{i}/proj"] = b.proj
        return layers

    def forward(self, x: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
        """Full-window forward with SAME zero padding."""
        z = conv1d_valid(x, self.stem, dtype)
        pad = self.cfg.kernel_size // 2
        for block in self.blocks:
            z = block(z, dtype, padding=pad)
        return conv1d_valid(z, self.head, dtype).float()


def acoustic_inputs(mc: torch.Tensor, f0: torch.Tensor,
                    model_cfg: AcousticModelConfig) -> torch.Tensor:
    """Net input [..., T, D_in]: mc, then (log-f0 on voiced frames,
    voiced flag) when the net is F0-conditioned."""
    feats = [mc]
    if model_cfg.use_f0_input:
        voiced = (f0 > 0).to(mc.dtype)
        logf0 = torch.where(f0 > 0, torch.log(torch.clamp(f0, min=1.0)),
                            torch.zeros_like(f0))
        feats += [logf0[..., None], voiced[..., None]]
    return torch.cat(feats, dim=-1)


def convert_mc(net: AcousticNet, mc: torch.Tensor, f0: torch.Tensor,
               model_cfg: AcousticModelConfig, dtype=torch.float32
               ) -> torch.Tensor:
    """Apply stage 1 offline: mc' = mc + net(mc, f0) on [T, ...] or
    [B, T, ...] (SAME zero padding at the window's edges)."""
    return mc + net(acoustic_inputs(mc, f0, model_cfg), dtype)


def convert_mc_streamed(net: AcousticNet, mc_new: torch.Tensor,
                        f0_new: torch.Tensor, caches: tuple,
                        model_cfg: AcousticModelConfig,
                        dtype=torch.float32) -> tuple[torch.Tensor, tuple]:
    """Advance the stage-1 stack by the Fc newest input frames.

    mc_new/f0_new: features of input frames [F - Fc, F), optionally with
    one leading stream dim; caches: per-block [(N,) k-1, hidden] input
    tails.  Returns (residual [(N,) Fc, mc_dim] float32 for output frames
    [F - ctx - Fc, F - ctx), new caches)."""
    x = acoustic_inputs(mc_new, f0_new, model_cfg)
    z = conv1d_valid(x, net.stem, dtype)
    new_caches = []
    for cache, block in zip(caches, net.blocks):
        z_in = torch.cat([cache, z], dim=-2)
        new_caches.append(z_in[..., -(model_cfg.kernel_size - 1):, :])
        z = block(z_in, dtype)
    out = conv1d_valid(z, net.head, dtype)
    return out.float(), tuple(new_caches)


def stage1_cache_init(net: AcousticNet, mc_sil_row: torch.Tensor,
                      f0_sil_row: torch.Tensor,
                      model_cfg: AcousticModelConfig, dtype=torch.float32
                      ) -> tuple[tuple, torch.Tensor]:
    """Per-block caches equal to an infinite all-silence history (k-1
    copies of each layer's constant interior value), and the interior
    residual row [mc_dim] (float32)."""
    k = model_cfg.kernel_size
    x = acoustic_inputs(mc_sil_row[None], f0_sil_row[None], model_cfg)
    z = conv1d_valid(x, net.stem, dtype)                      # [1, H]
    caches = []
    for block in net.blocks:
        caches.append(z.repeat(k - 1, 1))
        z = block(z.repeat(k, 1), dtype)                      # [1, H]
    res = conv1d_valid(z, net.head, dtype)
    return tuple(caches), res[0].float()
