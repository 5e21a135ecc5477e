"""Streaming polyphase resampling as one static banded matrix product
(PyTorch port of ``dsp/resample.py``).

Rational L/M resampling by a windowed-sinc (Kaiser) filter.  Per chunk the
map from the input window (carried history + the new chunk) to the output
chunk is a fixed banded linear operator, since ``chunk_out * M`` is a
multiple of ``L`` by construction: the whole resampler is one precomputed
[history + chunk_in, chunk_out] float32 matrix, and each step is one
``torch.matmul`` against it.  The streaming state is the last ``history``
input samples.

Delay convention: the emitted stream is y[n] = ideal[n - delay_out], with
zero history at t < 0.  The input-side plan rounds its delay up to a whole
frame hop, so the delayed stream stays on the analysis frame grid and
streamed == offline holds exactly.

The plan and the matrix (NumPy) are the JAX package's, value for value.
"""

from __future__ import annotations

import dataclasses
import functools
import math

import numpy as np
import torch

from benchmark.reference.ops.dft import device_const

KAISER_BETA = 8.6          # ~ -90 dB stopband
HALF_WIDTH = 24            # kernel half-width in input samples
ROLLOFF = 0.9475           # passband edge as a fraction of Nyquist


@dataclasses.dataclass(frozen=True)
class ResamplePlan:
    """Static geometry of a fixed-chunk streaming resampler."""

    rate_in: int
    rate_out: int
    chunk_in: int            # input samples consumed per step
    chunk_out: int           # output samples emitted per step
    delay_out: int           # emitted[n] = ideal[n - delay_out]
    history: int             # carried input samples (left context)

    @property
    def identity(self) -> bool:
        return self.rate_in == self.rate_out


def make_plan(rate_in: int, rate_out: int, chunk_in: int,
              align_delay_to: int = 1) -> ResamplePlan:
    """Build the plan for fixed ``chunk_in``-sample steps.

    ``align_delay_to``: round the delay up to a multiple (the input-side
    resampler uses the frame hop).  Requires chunk_in * L % M == 0."""
    if rate_in == rate_out:
        return ResamplePlan(rate_in, rate_out, chunk_in, chunk_in, 0, 0)
    g = math.gcd(rate_in, rate_out)
    L, M = rate_out // g, rate_in // g
    if chunk_in * L % M:
        raise ValueError(
            f"chunk_in={chunk_in} not resamplable {rate_in}->{rate_out}: "
            f"chunk*L/M = {chunk_in * L / M} not integer")
    chunk_out = chunk_in * L // M
    d = -(-(HALF_WIDTH * L) // M)               # ceil(HW·L/M)
    delay_out = -(-d // align_delay_to) * align_delay_to
    history = HALF_WIDTH + (delay_out * M + L - 1) // L + 1
    return ResamplePlan(rate_in, rate_out, chunk_in, chunk_out, delay_out,
                        history)


def _kernel(t: np.ndarray, cutoff: float) -> np.ndarray:
    """Windowed-sinc interpolation kernel, unit passband gain; ``cutoff``
    in (0, 1] relative to the input Nyquist."""
    w = np.where(np.abs(t) < HALF_WIDTH,
                 np.i0(KAISER_BETA
                       * np.sqrt(np.maximum(0.0, 1 - (t / HALF_WIDTH) ** 2)))
                 / np.i0(KAISER_BETA), 0.0)
    return cutoff * np.sinc(cutoff * t) * w


@functools.lru_cache(maxsize=16)
def _matrix_np(plan: ResamplePlan) -> np.ndarray:
    """[history + chunk_in, chunk_out] banded operator for one step: output
    column n reads input position p = (n - delay_out)·M/L relative to the
    chunk's first input sample, i.e. buffer row history + p.

    Only the band is evaluated: the kernel is zero at |t| >= HALF_WIDTH,
    so column n has non-zero rows only in (history + p - HALF_WIDTH,
    history + p + HALF_WIDTH).  Each entry there is the same float64
    expression as a dense evaluation's, so the matrix is the same value
    for value; only a zero's sign may differ.  That is 2*HALF_WIDTH + 2
    rows of each column instead of all history + chunk_in of them."""
    g = math.gcd(plan.rate_in, plan.rate_out)
    L, M = plan.rate_out // g, plan.rate_in // g
    cutoff = ROLLOFF * min(1.0, L / M)
    n_rows = plan.history + plan.chunk_in
    n = np.arange(plan.chunk_out)[None, :]
    p = (n - plan.delay_out) * (M / L)          # input pos rel. chunk start
    # rows floor(p) + history - HALF_WIDTH ... + 2*HALF_WIDTH + 1 cover the
    # open interval above
    rows = (np.floor(p).astype(np.int64) + (plan.history - HALF_WIDTH)
            + np.arange(2 * HALF_WIDTH + 2)[:, None])     # [W, chunk_out]
    inside = (rows >= 0) & (rows < n_rows)
    values = _kernel(p - (rows - plan.history), cutoff).astype(np.float32)
    out = np.zeros((n_rows, plan.chunk_out), np.float32)
    out[rows[inside], np.broadcast_to(n, rows.shape)[inside]] = \
        values[inside]
    return out


def _matrix(plan: ResamplePlan, like: torch.Tensor) -> torch.Tensor:
    return device_const(_matrix_np, plan, like=like)


def init_carry(plan: ResamplePlan, device) -> torch.Tensor | None:
    """Zero history (float32 on ``device``); None for an identity plan.
    The plan's matrix is built and uploaded here, when a stream is made,
    so that its first step does not pay for it."""
    if plan.identity:
        return None
    carry = torch.zeros((plan.history,), device=device)
    _matrix(plan, carry)
    return carry


def resample_chunk(carry: torch.Tensor | None, chunk: torch.Tensor,
                   plan: ResamplePlan
                   ) -> tuple[torch.Tensor, torch.Tensor | None]:
    """One streaming step: [..., chunk_in] -> [..., chunk_out], carry
    [..., history] (one history per leading index)."""
    if plan.identity:
        return chunk, carry
    buf = torch.cat([carry, chunk.to(carry)], dim=-1)
    y = torch.matmul(buf, _matrix(plan, buf))
    return y, buf[..., -plan.history:]


def resample_signal(x: torch.Tensor, plan: ResamplePlan) -> torch.Tensor:
    """One-shot equivalent of the streaming resampler (zero history): x is
    padded to a whole number of chunks, cut into each step's window
    (history + chunk) and resampled by one batched product; the output is
    trimmed to floor(T·L/M) samples."""
    if plan.identity:
        return x
    T = x.shape[-1]
    g = math.gcd(plan.rate_in, plan.rate_out)
    T_out = T * (plan.rate_out // g) // (plan.rate_in // g)
    k = -(-T // plan.chunk_in)
    xp = torch.nn.functional.pad(
        x, (plan.history, k * plan.chunk_in - T))
    windows = xp.unfold(-1, plan.history + plan.chunk_in, plan.chunk_in)
    ys = torch.matmul(windows, _matrix(plan, x))
    return ys.reshape(k * plan.chunk_out)[:T_out]
