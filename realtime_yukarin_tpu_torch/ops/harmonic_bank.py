"""Harmonic-bank rendering and its gradient: the CUDA kernels and their
plain versions.

Port of ``realtime_yukarin_tpu/ops/pallas_synth.py``.  :func:`harmonic_bank`
is a ``torch.autograd.Function``: on CUDA tensors its forward launches
``csrc/harmonic_bank.cu`` (sincos per sample, then the Chebyshev recurrence
over the harmonics) and its backward launches ``csrc/harmonic_bank_bwd.cu``
(the same recurrences for sines and cosines, the sums over samples through
a shared-memory transpose); on CPU tensors they are
:func:`harmonic_bank_plain` — the einsum form of ``harmonic_bank_xla`` — and
:func:`harmonic_bank_bwd_plain`.  Training differentiates the
multi-resolution STFT loss through this Function.  Both kernels take their
tiling from :func:`bank_plan`, on CUDA tensors only (the plain versions have
no shared-memory limit).

A cost count (``utils/cost.py``) sees each call as one launch of its
kernel, by :func:`bank_forward_cost` and :func:`bank_backward_cost`, on
either device.
"""

from __future__ import annotations

import functools
from typing import NamedTuple

import torch

from realtime_yukarin_tpu_torch.ops import cuda
from realtime_yukarin_tpu_torch.utils import cost

WARP = 32
# A segment of a row's harmonics is whole groups of GROUP harmonics; the
# last segment also takes H % GROUP.
GROUP = 32
SAMPLES_PER_LANE = (1, 2, 4)     # the kernels' instantiations
# Warps per block (rows x segments x sample warps), each kernel's
# __launch_bounds__: the backward's threads take up to 175 registers (4
# samples per lane, all four outputs), so it allows fewer.
MAX_WARPS = {False: 16, True: 8}
SMEM_BYTES = 227 * 1024          # shared memory a block may use (H100)
# Floats of shared memory per warp: per harmonic, aL and aR (forward) or
# h aL, h aR and aR - aL (backward); the backward's transpose rows, 32 of
# 2 x 32 + 4 floats.
N_CONST = {False: 2, True: 3}
RED_FLOATS = {False: 0, True: GROUP * (2 * WARP + 4)}
# Each warp's constants run in whole trips of 8 harmonics, then 8 more
# zeros: the kernels load a trip's constants a trip ahead.
CAP_PAD = 8
# Warps per launch the plans aim for, from tools/torch_bank_ab.py --sweep
# on the H100: the forward takes one warp per 32-sample chunk while that
# stays within 8 warps per SM (132 SMs), the backward splits rows into
# harmonic segments up to about 2 warps per SM.
FWD_TARGET_WARPS = 8 * 132
BWD_TARGET_WARPS = 2 * 132

def segment_bounds(H: int, segments: int) -> list[tuple[int, int]]:
    """[h0, h1) of each segment: whole 32-groups [s F / S, (s + 1) F / S)
    of the F = H // 32 full groups, the last segment running to H (the
    kernels' ``segment_bounds``)."""
    F = H // GROUP
    return [(GROUP * (s * F // segments),
             H if s == segments - 1 else GROUP * ((s + 1) * F // segments))
            for s in range(segments)]


class BankPlan(NamedTuple):
    """How the bank kernels tile R rows: a row is ``segments`` x
    ``sample_warps`` warps (segment s of its harmonics, chunks t, t + T,
    ... of 32 x ``samples_per_lane`` samples), ``rows_per_block`` rows per
    block.  The forward takes one segment, the backward one sample warp and
    one row per block."""
    samples_per_lane: int
    segments: int
    sample_warps: int
    rows_per_block: int

    @property
    def chunk(self) -> int:
        return WARP * self.samples_per_lane

    @property
    def warps(self) -> int:
        return self.segments * self.sample_warps * self.rows_per_block

    def launch_args(self, backward: bool) -> tuple[int, ...]:
        """The launcher's trailing ints: (spl, sample warps, rows) for the
        forward, (spl, segments) for the backward."""
        if backward:
            return self.samples_per_lane, self.segments
        return (self.samples_per_lane, self.sample_warps,
                self.rows_per_block)

    def smem_bytes(self, H: int, backward: bool) -> int:
        """Dynamic shared memory of one block, as the launchers size it."""
        longest = max(h1 - h0 for h0, h1 in segment_bounds(H, self.segments))
        cap = -(-longest // 8) * 8 + CAP_PAD
        xch = 2 * self.chunk if self.segments > 1 else 0
        return 4 * self.warps * (N_CONST[backward] * cap
                                 + RED_FLOATS[backward] + xch)

    def slots(self, R: int, H: int, hop: int) -> dict[str, list]:
        """Where each piece of work lands, as the kernels index it (block
        warp w is row w // (S T), sample warp w // S % T, segment w % S).

        "harmonic": (row, h, block, warp, lane) for each d_aL / d_aR total
        a lane stores (lane t of a segment's warp adds harmonic h0 + g0 + t
        of each 32-group g0 over the warp's lanes); "sample": (row,
        segment, n, block, warp, lane, trip, slot) for each sample a
        segment's warps read; "write": (row, n, block, warp, lane) for each
        output sample (y, or d_phi and d_frac) a row's segment-0 warps
        write.
        """
        S, T = self.segments, self.sample_warps
        per_row = S * T
        bounds = segment_bounds(H, S)
        trips = -(-hop // (T * self.chunk))
        out = {"harmonic": [], "sample": [], "write": []}
        for block in range(-(-R // self.rows_per_block)):
            for warp in range(self.warps):
                row = block * self.rows_per_block + warp // per_row
                t, seg = warp // S % T, warp % S
                if row >= R:
                    continue
                h0, h1 = bounds[seg]
                if t == 0:
                    for g0 in range(0, h1 - h0, GROUP):
                        for lane in range(min(GROUP, h1 - h0 - g0)):
                            out["harmonic"].append((row, h0 + g0 + lane,
                                                    block, warp, lane))
                for trip in range(trips):
                    n0 = (trip * T + t) * self.chunk
                    for slot in range(self.samples_per_lane):
                        for lane in range(WARP):
                            n = n0 + slot * WARP + lane
                            if n >= hop:
                                continue
                            out["sample"].append((row, seg, n, block, warp,
                                                  lane, trip, slot))
                            if seg == 0:
                                out["write"].append((row, n, block, warp,
                                                     lane))
        return out


@functools.lru_cache(maxsize=256)
def bank_plan(R: int, H: int, hop: int, backward: bool = False) -> BankPlan:
    """The tiling the bank kernels take for R rows of H harmonics and hop
    samples (tools/torch_bank_ab.py --sweep times the alternatives).

    Forward: the fewest samples per lane (1, 2, 4) whose one warp per
    chunk keeps R rows within FWD_TARGET_WARPS (else 4), every chunk its
    own sample warp, 4 / T rows per block.  Backward: 4 samples per lane
    (fewer when hop is short), the rows split into as many harmonic
    segments as bring them to BWD_TARGET_WARPS (at most one per full
    32-group), one row per block.  Raises ValueError for the shapes the
    kernels do not take (no harmonics or samples, or more shared memory
    than a block has)."""
    if H < 1 or hop < 1 or R < 0:
        raise ValueError(f"harmonic_bank: no kernel for R={R}, H={H}, "
                         f"hop={hop} (needs H >= 1, hop >= 1)")

    def chunks(spl):
        return -(-hop // (WARP * spl))

    fits = [k for k in SAMPLES_PER_LANE if WARP * k < hop + WARP]
    if backward:
        spl = fits[-1]
        segments = max(1, min(H // GROUP, MAX_WARPS[True],
                              -(-BWD_TARGET_WARPS // max(R, 1))))
        plan = BankPlan(spl, segments, 1, 1)
    else:
        spl = next((k for k in fits
                    if max(R, 1) * chunks(k) <= FWD_TARGET_WARPS), fits[-1])
        T = min(chunks(spl), MAX_WARPS[False])
        plan = BankPlan(spl, 1, T, max(1, 4 // T))
    if plan.smem_bytes(H, backward) > SMEM_BYTES:
        raise ValueError(f"harmonic_bank: H={H} harmonics need "
                         f"{plan.smem_bytes(H, backward)} bytes of shared "
                         f"memory, above the kernels' {SMEM_BYTES}")
    return plan


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
    if H < 1 or hop < 1:
        raise ValueError(f"harmonic_bank: no kernel for R={R}, H={H}, "
                         f"hop={hop} (needs H >= 1, hop >= 1)")
    return dev


def bank_forward_cost(R: int, H: int, hop: int) -> tuple[int, int]:
    """(FLOPs, bytes) of one forward launch: per row, sample and harmonic
    two multiply-adds (the left and right sums) and the recurrence's
    multiply-add, 6 FLOP; aL, aR, phi, frac and the output each moved
    once."""
    return 6 * R * hop * H, 4 * (2 * R * H + 2 * R * hop + hop)


def bank_backward_cost(R: int, H: int, hop: int, phase: bool = True
                       ) -> tuple[int, int]:
    """(FLOPs, bytes) of one backward launch.  All four outputs: 7
    multiply-adds per row, sample and harmonic (d_aL and d_aR 2, the sine
    and cosine recurrences 2, d_phi 2 with h aL and h aR formed once per
    row, d_frac 1), 14 FLOP.  Without ``phase`` (d_aL and d_aR only: the
    sines alone), 3, 6 FLOP.  Each input and output moved once."""
    if phase:
        return 14 * R * hop * H, 4 * (4 * R * H + 4 * R * hop + hop)
    return 6 * R * hop * H, 4 * (4 * R * H + 2 * R * hop + hop)


def _bank_forward(amps_l, amps_r, phi, frac) -> torch.Tensor:
    dev = phi.device
    R, H = amps_l.shape
    hop = phi.shape[1]
    with cost.kernel("harmonic_bank", (R, H, hop),
                     *bank_forward_cost(R, H, hop)):
        if dev.type == "cpu":
            return harmonic_bank_plain(amps_l, amps_r, phi, frac)
        tiling = bank_plan(R, H, hop).launch_args(False)
        out = torch.empty((R, hop), dtype=torch.float32, device=dev)
        cuda.HARMONIC_BANK.launch(amps_l.data_ptr(), amps_r.data_ptr(),
                                  phi.data_ptr(), frac.data_ptr(),
                                  out.data_ptr(), R, H, hop, *tiling)
        return out


def _bank_backward(amps_l, amps_r, phi, frac, g, phase: bool = True):
    """(d_aL, d_aR, d_phi, d_frac); without ``phase`` the kernel computes
    d_aL and d_aR only (sines, no cosines) and d_phi, d_frac are None."""
    dev = phi.device
    R, H = amps_l.shape
    hop = phi.shape[1]
    with cost.kernel("harmonic_bank_bwd", (R, H, hop, phase),
                     *bank_backward_cost(R, H, hop, phase)):
        if dev.type == "cpu":
            d_al, d_ar, d_phi, d_frac = harmonic_bank_bwd_plain(
                amps_l, amps_r, phi, frac, g)
            return (d_al, d_ar) + ((d_phi, d_frac) if phase
                                   else (None, None))
        tiling = bank_plan(R, H, hop, backward=True).launch_args(True)
        d_al, d_ar = (torch.empty((R, H), dtype=torch.float32, device=dev)
                      for _ in range(2))
        d_phi = d_frac = None
        if phase:
            d_phi, d_frac = (torch.empty((R, hop), dtype=torch.float32,
                                         device=dev) for _ in range(2))
        cuda.HARMONIC_BANK_BWD.launch(
            amps_l.data_ptr(), amps_r.data_ptr(), phi.data_ptr(),
            frac.data_ptr(), g.data_ptr(), d_al.data_ptr(), d_ar.data_ptr(),
            d_phi.data_ptr() if phase else None,
            d_frac.data_ptr() if phase else None, R, H, hop, *tiling)
        return d_al, d_ar, d_phi, d_frac


def harmonic_bank_bwd(amps_l: torch.Tensor, amps_r: torch.Tensor,
                      phi: torch.Tensor, frac: torch.Tensor, g: torch.Tensor):
    """The bank's gradient for R frame rows: kernel 4 on CUDA tensors,
    :func:`harmonic_bank_bwd_plain` on CPU tensors.

    amps_l/amps_r [R, H]; phi [R, hop]; frac [hop] shared by every row;
    g [R, hop] the cotangent of the output.  Returns (d_aL, d_aR, d_phi,
    d_frac), d_frac per row [R, hop].  On CUDA tensors the kernel's sincos
    is accurate to 9e-8 for arguments up to 2e4 rad and it takes sin and
    cos of up to max(H, 4) phi, so |phi| must stay below 2e4 / max(H, 4)
    rad (124 at H = 161); the main paths wrap phi per frame (below 2 pi
    plus one frame's advance).  Raises ValueError for shapes the kernel
    does not take (:func:`bank_plan`)."""
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
        need = ctx.needs_input_grad
        # a training step asks for the amplitudes' gradients only: the
        # kernel then runs the sines alone
        d_al, d_ar, d_phi, d_frac = _bank_backward(
            amps_l, amps_r, phi, frac, g.contiguous(),
            phase=need[2] or need[3])
        return (d_al if need[0] else None, d_ar if need[1] else None,
                d_phi if need[2] else None,
                d_frac.sum(0) if need[3] else None)


def harmonic_bank(amps_l: torch.Tensor, amps_r: torch.Tensor,
                  phi: torch.Tensor, frac: torch.Tensor) -> torch.Tensor:
    """Render the harmonic bank for R frame rows (differentiable).

    amps_l/amps_r: [R, H] amplitudes at each frame's left/right edge;
    phi: [R, hop] per-sample fundamental phase; frac: [hop] interpolation
    weight shared by every row.  Returns [R, hop] float32.  On CUDA tensors
    the kernel's sincos is accurate to 9e-8 for arguments up to 2e4 rad and
    it takes sin and cos of 4 phi, so |phi| must stay below 5e3 rad (the
    backward's limit, 2e4 / max(H, 4) rad, is the stricter); the main
    paths wrap phi per frame (below 2 pi plus one frame's advance).  Raises
    ValueError for shapes the kernels do not take (:func:`bank_plan`).
    """
    _check(amps_l, amps_r, phi, frac)
    return _HarmonicBank.apply(amps_l, amps_r, phi, frac)
