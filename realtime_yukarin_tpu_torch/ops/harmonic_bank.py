"""Harmonic-bank rendering and its gradient: the CUDA kernels and their
plain versions.

Port of ``realtime_yukarin_tpu/ops/pallas_synth.py``.  :func:`harmonic_bank`
is a ``torch.autograd.Function``: on CUDA tensors its forward launches
``csrc/harmonic_bank.cu`` (one sincos per sample, then the Chebyshev
recurrence over the H harmonics) and its backward launches
``csrc/harmonic_bank_bwd.cu`` (the same recurrences for sines and cosines);
on CPU tensors they are :func:`harmonic_bank_plain` — the einsum form of
``harmonic_bank_xla`` — and :func:`harmonic_bank_bwd_plain`.  Training
differentiates the multi-resolution STFT loss through this Function.
"""

from __future__ import annotations

import torch

from realtime_yukarin_tpu_torch.ops import cuda


def harmonic_bank_plain(amps_l: torch.Tensor, amps_r: torch.Tensor,
                        phi: torch.Tensor, frac: torch.Tensor
                        ) -> torch.Tensor:
    """sum_h lerp(aL, aR)[n] * sin(h * phi[n]) per row, by materializing
    sin(h * phi) as [R, hop, H]."""
    H = amps_l.shape[1]
    h_idx = torch.arange(1, H + 1, dtype=phi.dtype, device=phi.device)
    s = torch.sin(phi[:, :, None] * h_idx)
    yl = torch.einsum("rnh,rh->rn", s, amps_l)
    yr = torch.einsum("rnh,rh->rn", s, amps_r)
    return yl * (1.0 - frac) + yr * frac


def harmonic_bank_bwd_plain(amps_l: torch.Tensor, amps_r: torch.Tensor,
                            phi: torch.Tensor, frac: torch.Tensor,
                            g: torch.Tensor):
    """The bank's vector-Jacobian product by its four formulas on a
    materialized sin/cos(h * phi) [R, hop, H].

    g [R, hop] is the output cotangent; ``frac`` broadcasts to [R, hop].
    Returns (d_aL [R, H], d_aR [R, H], d_phi [R, hop], d_frac [R, hop]),
    d_frac per row as the kernel writes it."""
    H = amps_l.shape[1]
    h_idx = torch.arange(1, H + 1, dtype=phi.dtype, device=phi.device)
    ang = phi[:, :, None] * h_idx
    s, c = torch.sin(ang), torch.cos(ang)
    frac = torch.broadcast_to(frac, phi.shape)
    d_al = torch.einsum("rn,rnh->rh", g * (1.0 - frac), s)
    d_ar = torch.einsum("rn,rnh->rh", g * frac, s)
    a_inst = (amps_l[:, None, :] * (1.0 - frac)[:, :, None]
              + amps_r[:, None, :] * frac[:, :, None])         # [R, hop, H]
    d_phi = g * torch.einsum("rnh,rnh->rn", a_inst * h_idx, c)
    d_frac = g * torch.einsum("rnh,rh->rn", s, amps_r - amps_l)
    return d_al, d_ar, d_phi, d_frac


def _check(amps_l, amps_r, phi, frac, *more) -> torch.device:
    R, H = amps_l.shape
    hop = phi.shape[1]
    dev = phi.device
    for t, name, shape in ((amps_l, "amps_l", (R, H)),
                           (amps_r, "amps_r", (R, H)),
                           (phi, "phi", (R, hop)), (frac, "frac", (hop,)),
                           *((t, "g", (R, hop)) for t in more)):
        cuda.check(t, name, shape, dev)
    if dev.type not in ("cpu", "cuda"):
        raise ValueError(f"harmonic_bank: no kernel for device {dev}")
    return dev


def _bank_forward(amps_l, amps_r, phi, frac) -> torch.Tensor:
    dev = phi.device
    if dev.type == "cpu":
        return harmonic_bank_plain(amps_l, amps_r, phi, frac)
    R, H = amps_l.shape
    hop = phi.shape[1]
    out = torch.empty((R, hop), dtype=torch.float32, device=dev)
    cuda.HARMONIC_BANK.launch(amps_l.data_ptr(), amps_r.data_ptr(),
                              phi.data_ptr(), frac.data_ptr(),
                              out.data_ptr(), R, H, hop)
    return out


def _bank_backward(amps_l, amps_r, phi, frac, g):
    dev = phi.device
    if dev.type == "cpu":
        return harmonic_bank_bwd_plain(amps_l, amps_r, phi, frac, g)
    R, H = amps_l.shape
    hop = phi.shape[1]
    if hop > 1024:
        raise ValueError(f"harmonic_bank_bwd: hop {hop} above the kernel's "
                         f"1024 threads per row")
    d_al, d_ar = (torch.empty((R, H), dtype=torch.float32, device=dev)
                  for _ in range(2))
    d_phi, d_frac = (torch.empty((R, hop), dtype=torch.float32, device=dev)
                     for _ in range(2))
    cuda.HARMONIC_BANK_BWD.launch(
        amps_l.data_ptr(), amps_r.data_ptr(), phi.data_ptr(),
        frac.data_ptr(), g.data_ptr(), d_al.data_ptr(), d_ar.data_ptr(),
        d_phi.data_ptr(), d_frac.data_ptr(), R, H, hop)
    return d_al, d_ar, d_phi, d_frac


def harmonic_bank_bwd(amps_l: torch.Tensor, amps_r: torch.Tensor,
                      phi: torch.Tensor, frac: torch.Tensor, g: torch.Tensor):
    """The bank's gradient for R frame rows: kernel 4 on CUDA tensors,
    :func:`harmonic_bank_bwd_plain` on CPU tensors.

    amps_l/amps_r [R, H]; phi [R, hop]; frac [hop] shared by every row;
    g [R, hop] the cotangent of the output.  Returns (d_aL, d_aR, d_phi,
    d_frac), d_frac per row [R, hop].  The kernel runs one block of
    ``hop`` threads per row, so hop is at most 1024 on CUDA."""
    _check(amps_l, amps_r, phi, frac, g)
    return _bank_backward(amps_l, amps_r, phi, frac, g)


class _HarmonicBank(torch.autograd.Function):
    """Forward: kernel 1 (or the plain forward on the CPU); backward:
    kernel 4 (or the plain backward on the CPU)."""

    @staticmethod
    def forward(ctx, amps_l, amps_r, phi, frac):
        ctx.save_for_backward(amps_l, amps_r, phi, frac)
        return _bank_forward(amps_l, amps_r, phi, frac)

    @staticmethod
    def backward(ctx, g):
        amps_l, amps_r, phi, frac = ctx.saved_tensors
        d_al, d_ar, d_phi, d_frac = _bank_backward(
            amps_l, amps_r, phi, frac, g.contiguous())
        need = ctx.needs_input_grad
        return (d_al if need[0] else None, d_ar if need[1] else None,
                d_phi if need[2] else None,
                d_frac.sum(0) if need[3] else None)


def harmonic_bank(amps_l: torch.Tensor, amps_r: torch.Tensor,
                  phi: torch.Tensor, frac: torch.Tensor) -> torch.Tensor:
    """Render the harmonic bank for R frame rows (differentiable).

    amps_l/amps_r: [R, H] amplitudes at each frame's left/right edge;
    phi: [R, hop] per-sample fundamental phase; frac: [hop] interpolation
    weight shared by every row.  Returns [R, hop] float32.
    """
    _check(amps_l, amps_r, phi, frac)
    return _HarmonicBank.apply(amps_l, amps_r, phi, frac)
