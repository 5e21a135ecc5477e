"""A 1-D convolution whose backward sums in a fixed order.

cuDNN's default backward algorithms for a convolution's weight and input
gradients accumulate with atomics: on the H100 two runs of one training
step parted in the last bits of every convolution's gradient, and Adam's
per-element normalisation carried that into the trained weights.  cuDNN's
deterministic algorithms cost a float32 training step 3.5x its device time
there (FFT convolutions with 5 GiB of workspace).  So the forward stays
cuDNN's (its forward algorithms sum in a fixed order) and the backward is
written out: the weight gradient as one matmul of the output gradient
against the unfolded input, the input gradient as one matmul scattered back
by ``fold`` (col2im, which gathers: each input sample sums its windows in
order).  Where no gradient is asked for, the plain ``conv1d`` runs.
"""

from __future__ import annotations

import torch
import torch.nn.functional as Fn


class _Conv1d(torch.autograd.Function):
    """``Fn.conv1d(x, w, stride=stride, padding=padding)`` (no bias,
    dilation 1) with the backward of the module docstring."""

    @staticmethod
    def forward(ctx, x, w, stride: int, padding: int):
        ctx.save_for_backward(x, w)
        ctx.stride, ctx.padding = stride, padding
        return Fn.conv1d(x, w, stride=stride, padding=padding)

    @staticmethod
    def backward(ctx, g):
        x, w = ctx.saved_tensors
        s, p = ctx.stride, ctx.padding
        O, C, k = w.shape
        B, _, T = x.shape
        L = g.shape[-1]
        Tp = T + 2 * p
        dx = dw = None
        if ctx.needs_input_grad[1]:
            xp = Fn.pad(x, (p, p)) if p else x
            cols = xp.unfold(-1, k, s)                        # [B, C, L, k]
            dw = (g.transpose(0, 1).reshape(O, B * L)
                  @ cols.permute(0, 2, 1, 3).reshape(B * L, C * k)
                  ).reshape(O, C, k)
        if ctx.needs_input_grad[0]:
            dcols = w.reshape(O, C * k).t() @ g               # [B, C*k, L]
            dxp = Fn.fold(dcols, output_size=(1, Tp), kernel_size=(1, k),
                          stride=(1, s))[:, :, 0]             # [B, C, Tp]
            dx = dxp[..., p: p + T] if p else dxp
        return dx, dw, None, None


def conv1d(x: torch.Tensor, w: torch.Tensor, stride: int = 1,
           padding: int = 0) -> torch.Tensor:
    """``Fn.conv1d(x, w, stride=stride, padding=padding)`` on [B, C, T]
    (no bias), differentiated without atomics."""
    if torch.is_grad_enabled() and (x.requires_grad or w.requires_grad):
        return _Conv1d.apply(x, w, stride, padding)
    return Fn.conv1d(x, w, stride=stride, padding=padding)
