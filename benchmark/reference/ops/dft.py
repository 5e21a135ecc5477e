"""DFT-as-matmul bases and device ops (PyTorch port of ``ops/dft.py``).

The float64 host bases are copies of the JAX package's (a test holds them
equal).  The device ops are plain float32 matrix products against those
bases; on the card they run in full float32 (``torch.backends.cuda.matmul
.allow_tf32`` is False by default and the port never turns it on: TF32
would shift F0 by tens of cents).  The two hot analysis chains of the
streaming step are hand-written CUDA kernels instead (ops/analysis.py).
"""

from __future__ import annotations

import functools
import math

import numpy as np
import torch



# ---------------------------------------------------------------------------
# Host-side bases (float64, cast at use site)
# ---------------------------------------------------------------------------

@functools.lru_cache(maxsize=None)
def rfft_bases(n: int) -> tuple[np.ndarray, np.ndarray]:
    """(cos [n, n//2+1], sin [n, n//2+1]): rfft_k = x@cos - j * x@sin."""
    assert n % 2 == 0, f"DFT bases assume even n (Nyquist bin), got {n}"
    k = np.arange(n // 2 + 1)
    t = np.arange(n)
    ang = 2.0 * np.pi * np.outer(t, k) / n
    return np.cos(ang), np.sin(ang)


@functools.lru_cache(maxsize=None)
def cepstrum_basis(n: int) -> np.ndarray:
    """[K, Q]: half real cepstrum from one-sided log spectrum.

    c_q = (1/n) [L_0 + 2 sum_{0<k<n/2} L_k cos(2 pi k q / n) + L_{n/2} cos(pi q)]
    for q = 0..n/2 (the cepstrum of a symmetric spectrum is symmetric).
    """
    assert n % 2 == 0, f"DFT bases assume even n (Nyquist bin), got {n}"
    K = n // 2 + 1
    w = np.full(K, 2.0)
    w[0] = w[-1] = 1.0
    q = np.arange(K)
    k = np.arange(K)
    basis = np.cos(2.0 * np.pi * np.outer(k, q) / n) * w[:, None] / n
    return basis                                     # [K(k), Q(q)]


@functools.lru_cache(maxsize=None)
def cepstrum_inverse_basis(n: int) -> np.ndarray:
    """[Q, K]: one-sided log spectrum back from the half cepstrum.

    L_k = c_0 + 2 sum_{0<q<n/2} c_q cos(2 pi k q / n) + c_{n/2} cos(pi k)
    """
    assert n % 2 == 0, f"DFT bases assume even n (Nyquist bin), got {n}"
    K = n // 2 + 1
    u = np.full(K, 2.0)
    u[0] = u[-1] = 1.0
    q = np.arange(K)
    k = np.arange(K)
    return np.cos(2.0 * np.pi * np.outer(q, k) / n) * u[:, None]  # [Q, K]


@functools.lru_cache(maxsize=None)
def stacked_rfft_basis(n: int, tile_bins: int, depth: int, row: int
                       ) -> np.ndarray:
    """[tiles, depth, row]: the rfft bases in the power-spectrum kernel's
    layout (csrc/power_spectrum.cu).

    Bin j's cos and sin columns are stacked columns 2j and 2j+1; the
    stacked columns are cut into tiles of ``tile_bins`` bins, each stored
    as one contiguous [depth, row] block (depth zero-padded from n, the
    row zero-padded from 2 * tile_bins columns against shared-memory bank
    conflicts), so any depth slice of a tile is one contiguous span."""
    assert n % 2 == 0 and n <= depth, (n, depth)
    cos, sin = rfft_bases(n)
    K = n // 2 + 1
    tiles = -(-K // tile_bins)
    stacked = np.zeros((depth, tiles * 2 * tile_bins))
    stacked[:n, 0:2 * K:2] = cos
    stacked[:n, 1:2 * K:2] = sin
    out = np.zeros((tiles, depth, row))
    out[:, :, :2 * tile_bins] = stacked.reshape(
        depth, tiles, 2 * tile_bins).transpose(1, 0, 2)
    return out


@functools.lru_cache(maxsize=None)
def sliced_cepstrum_basis(n: int, width: int, slices: int) -> np.ndarray:
    """[slices, slices * width, width]: ``cepstrum_inverse_basis(n)`` (D) in
    the envelope-cepstrum kernel's layout (csrc/envelope_cepstrum.cu).

    Slice c holds output columns [c * width, (c + 1) * width) over the
    whole depth, both zero-padded from K = n/2 + 1 to slices * width, so
    any run of depth rows of a slice is one contiguous span.  The kernel
    needs no other basis: ``cepstrum_basis(n)`` is D / n (the same cosines
    and end weights)."""
    K = n // 2 + 1
    kp = slices * width
    assert kp >= K, (n, width, slices)
    padded = np.zeros((kp, kp))
    padded[:K, :K] = cepstrum_inverse_basis(n)
    return np.ascontiguousarray(
        padded.reshape(kp, slices, width).transpose(1, 0, 2))


@functools.lru_cache(maxsize=None)
def prefix_sum_matrix(n: int) -> np.ndarray:
    """[n, n] ones where row <= col: (d @ M)[l] = sum_{j<=l} d[j]."""
    return np.triu(np.ones((n, n), np.float64))


@functools.lru_cache(maxsize=None)
def autocorr_weights(n: int) -> np.ndarray:
    """[K]: weights turning a one-sided power spectrum into autocorrelation:
    r_l = sum_k w_k P_k cos(2 pi k l / n)  ==  irfft(P_two_sided)[l]."""
    assert n % 2 == 0, f"DFT bases assume even n (Nyquist bin), got {n}"
    K = n // 2 + 1
    w = np.full(K, 2.0 / n)
    w[0] = w[-1] = 1.0 / n
    return w


@functools.lru_cache(maxsize=None)
def irfft_bases(n: int) -> tuple[np.ndarray, np.ndarray]:
    """(A [K, n], B [K, n]): irfft(X, n) = Re(X) @ A + Im(X) @ B."""
    assert n % 2 == 0, f"DFT bases assume even n (Nyquist bin), got {n}"
    K = n // 2 + 1
    w = np.full(K, 2.0 / n)
    w[0] = w[-1] = 1.0 / n
    k = np.arange(K)
    t = np.arange(n)
    ang = 2.0 * np.pi * np.outer(k, t) / n
    return np.cos(ang) * w[:, None], -np.sin(ang) * w[:, None]


# ---------------------------------------------------------------------------
# Host constants on the device
# ---------------------------------------------------------------------------

@functools.lru_cache(maxsize=None)
def _const(make, args: tuple, index, device: str, dtype: torch.dtype
           ) -> torch.Tensor:
    value = make(*args)
    if index is not None:
        value = value[index]
    return torch.as_tensor(np.asarray(value), dtype=dtype, device=device)


def device_const(make, *args, like: torch.Tensor, index=None
                 ) -> torch.Tensor:
    """``make(*args)[index]`` (a host NumPy constant) on ``like``'s device
    and dtype, uploaded once per (constant, device, dtype)."""
    t = _const(make, args, index, str(like.device), like.dtype)
    return t


# ---------------------------------------------------------------------------
# Device ops
# ---------------------------------------------------------------------------

def power_spectrum(frames: torch.Tensor, n: int) -> torch.Tensor:
    """|rfft(frames, n)|^2 via two matmuls.  frames [..., n]."""
    cos = device_const(rfft_bases, n, like=frames, index=0)
    sin = device_const(rfft_bases, n, like=frames, index=1)
    re = frames @ cos
    im = frames @ sin
    return re * re + im * im


def quefrency_filter(L: torch.Tensor, lift_half: torch.Tensor, n: int
                     ) -> torch.Tensor:
    """rfft(lift * irfft(L)).real for symmetric lifters, as two matmuls.

    L [..., K] one-sided spectrum; lift_half [..., K] the lifter at
    quefrencies q = 0..n/2.  With lift = sinc(f0 q / fs) this is
    frequency-domain rectangular smoothing of full width f0 Hz.
    """
    C = device_const(cepstrum_basis, n, like=L)
    D = device_const(cepstrum_inverse_basis, n, like=L)
    return ((L @ C) * lift_half) @ D


def irfft_real(re: torch.Tensor, im: torch.Tensor, n: int,
               out_len: int | None = None) -> torch.Tensor:
    """irfft from split re/im one-sided spectra, as two matmuls;
    ``out_len`` keeps only the first time samples."""
    A = device_const(irfft_bases, n, like=re, index=0)
    B = device_const(irfft_bases, n, like=re, index=1)
    if out_len is not None:
        A, B = A[:, :out_len], B[:, :out_len]
    return re @ A + im @ B


def cross_correlation(a: torch.Tensor, b: torch.Tensor, n: int, out_len: int
                      ) -> torch.Tensor:
    """c[l] = sum_n a[n] b[n+l] for l in [0, out_len), rows batched.

    a, b: [..., n] zero-padded so the circular correlation is linear.
    irfft(conj(rfft(a)) * rfft(b)) as six matmuls.
    """
    cos = device_const(rfft_bases, n, like=a, index=0)
    sin = device_const(rfft_bases, n, like=a, index=1)
    re_a = a @ cos
    im_a = a @ sin                                   # -Im(rfft(a))
    re_b = b @ cos
    im_b = b @ sin                                   # -Im(rfft(b))
    re = re_a * re_b + im_a * im_b
    im = im_a * re_b - re_a * im_b
    return irfft_real(re, im, n, out_len)


def autocorr_at_lag(P: torch.Tensor, lag: torch.Tensor, n: int
                    ) -> torch.Tensor:
    """r(lag) = irfft(two_sided(P))[lag] for per-row (possibly fractional)
    lags.  P [..., K]; lag broadcastable to P's batch shape.  Row-local:
    each row is its own contraction, so the result does not depend on how
    many rows share the call (streamed == offline)."""
    K = P.shape[-1]
    w = device_const(autocorr_weights, n, like=P)
    k = torch.arange(K, dtype=P.dtype, device=P.device)
    ang = (2.0 * math.pi / n) * lag[..., None] * k
    return torch.sum(P * w * torch.cos(ang), dim=-1)
