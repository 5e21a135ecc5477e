"""Fused analysis front-end: two CUDA kernels and their plain versions.

Port of ``realtime_yukarin_tpu/ops/pallas_analysis.py``:

* :func:`power_spectrum_fused` launches ``csrc/power_spectrum.cu`` —
  Hann window, the two rfft basis products and ``re^2 + im^2`` in one
  kernel; frames are read once and only P is written.
* :func:`envelope_cepstrum_fused` launches ``csrc/envelope_cepstrum.cu`` —
  the CheapTrick-role quefrency chain (cepstrum product, f0-adaptive
  lifter, inverse product, relative floor + log, cepstrum product +
  lifter) with its intermediates kept in shared memory.

Each has two designs, chosen by the row count alone: the cluster design
(``csrc/power_spectrum.cu``, ``csrc/envelope_cepstrum.cu``) for the
streaming widths, and from ``POWER_WIDE_ROWS`` / ``CEPSTRUM_WIDE_ROWS``
rows up the batch-width design (``csrc/power_spectrum_wide.cu``,
``csrc/envelope_cepstrum_wide.cu``): radix-2 folds of the even and odd
bases (two for the power spectrum, one for each product of the cepstrum),
then a register-blocked float32 GEMM.  Both run on CUDA by default
(the TPU build made them opt-in after an A/B there; the port has no
switch) and take their plain versions — the chains of
``power_spectrum_xla`` / ``envelope_cepstrum_xla`` — only for CPU tensors.
Every design computes in plain float32.

The plans below pick the design, decide its tiling and pass it to the
launchers, which refuse a layout or a tiling they were not built for; the
constants in each design's layout are uploaded once per (n, device) with
their pointers.

A cost count (``utils/cost.py``) sees each call as one launch of its
kernel, by :func:`power_spectrum_cost` and :func:`envelope_cepstrum_cost`
(the multiply-adds of the design the row count picks), on either device.
"""

from __future__ import annotations

import functools
from typing import NamedTuple

import numpy as np
import torch

from realtime_yukarin_tpu_torch.dsp import primitives as prim
from realtime_yukarin_tpu_torch.ops import cuda, dft
from realtime_yukarin_tpu_torch.utils import cost

CLUSTER = 8              # CTAs per thread-block cluster (portable maximum)
SMEM_BYTES = 232_448     # dynamic shared memory one CTA may use on an H100

# power spectrum (csrc/power_spectrum.cu)
DEPTH = 1024             # padded depth: 896 < n <= 1024
TILE_BINS = 32           # bins per CTA tile (64 stacked columns)
BASIS_ROW = 72           # floats per stored basis row (8 zero columns)
CLUSTER_ROWS = 64        # one cluster per row tile of at most 64 rows

# envelope cepstrum (csrc/envelope_cepstrum.cu)
# rows per cluster -> (rows per thread, warps of 8 splitting each chunk's
# depth; the other warps split the rows).  4 rows up to R = 64, 8 up to
# 128, 32 above: the fastest of 4 ... 64 rows in timings on an H100 at
# R = 20, 100, 800 and 1280
ROW_GROUPS = {4: (4, 8), 8: (8, 8), 32: (8, 2)}


# The batch-width designs (csrc/*_wide.cu) take R rows from these counts
# up.  Both designs' mean time per launch, CUDA events over 30 calls, on an
# H100 80GB HBM3 at 700 W, n = 1022, cluster / wide in us:
#   R        128    256    288    320    352    600    800    960   1024
#   power   22.7   32.6   36.6   45.1   41.7   60.9   77.0   88.4   93.9
#           38.2   38.4   38.3   38.5   38.3   38.1   38.1   38.9   39.2
#   ceps.   33.6   44.7   47.2  132.3   47.4   87.2   89.0   92.6  132.6
#          112.9  113.3  115.0  124.9  114.9  114.3  114.3  115.5  116.0
#   R       1088   1216   1280   2048  10240
#   power   97.9  107.6  111.8  170.8  806.5
#           38.5   39.0   38.5   39.1  204.9
#   ceps.  132.4  134.9  133.8  218.9  963.8
#          116.1  115.9  115.6  115.7  387.0
# (the wide designs are flat up to one CTA per SM: 2,112 rows for the power
# spectrum, 4,224 for the cepstrum; the cluster cepstrum's time jumps with
# how its clusters of 8 land on the card)
POWER_WIDE_ROWS = 320
CEPSTRUM_WIDE_ROWS = 1024
WIDE_CHUNK = 16          # folded depth rows per pipeline stage (both)
# power spectrum (csrc/power_spectrum_wide.cu)
WIDE_ROWS = 64           # rows per CTA
WIDE_BINS = 64           # base bins per CTA (and their mirrors n/2 - k)
# envelope cepstrum (csrc/envelope_cepstrum_wide.cu)
WIDE_CEP_ROWS = 32       # rows per CTA: the whole chain of a row group
WARP_COLUMNS = 64        # even (and as many odd) columns per warp of a
                         # depth group (two groups split each chunk)
WIDE_CEP_WARPS = (4, 5)  # warps per group built: K = 512, K = 513
WIDE_CEP_STAGES = 3      # basis chunks in flight


def _spans(total: int, size: int, padded: int | None = None
           ) -> list[tuple[int, int]]:
    """[start, end) runs of ``size`` over ``padded`` (default ``total``),
    clipped to ``total``."""
    return [(s, min(total, s + size))
            for s in range(0, total if padded is None else padded, size)]


class PowerPlan(NamedTuple):
    row_tile: int        # rows per cluster
    depth_slice: int     # samples per CTA (one of CLUSTER depth slices)

    def spans(self, R: int, n: int) -> dict[str, list[tuple[int, int]]]:
        """Each CTA's rows x bins x samples is one entry per axis; the
        kernel's work is their product."""
        K = n // 2 + 1
        return {"rows": _spans(R, self.row_tile),
                "bins": _spans(K, TILE_BINS),
                "depth": _spans(n, self.depth_slice, DEPTH)}


def _round_up(count: int, size: int = WIDE_CHUNK) -> int:
    return -(-count // size) * size


class WidePowerPlan(NamedTuple):
    rows: int            # rows per CTA
    bins: int            # base bins per CTA (each with its mirror n/2 - k)
    chunk: int           # folded depth rows per pipeline stage

    def spans(self, R: int, n: int) -> dict[str, list[tuple[int, int]]]:
        """Each CTA's rows x base bins k = 0 .. n/4 (each also gives bin
        n/2 - k), and the chunks of the folded depth u = 0 .. n/4 (row u
        takes samples t = 2u and 2u + 1, each with n - t)."""
        half = n // 2
        return {"rows": _spans(R, self.rows),
                "bins": _spans(half // 2 + 1, self.bins),
                "depth": _spans(half // 2 + 1, self.chunk,
                                _round_up(half // 2 + 1, self.chunk))}


def _check_frame_size(n: int) -> None:
    if n % 2 or not DEPTH - DEPTH // CLUSTER < n <= DEPTH:
        raise ValueError(f"power_spectrum_fused: the kernel takes even "
                         f"n in ({DEPTH - DEPTH // CLUSTER}, {DEPTH}], "
                         f"got {n}")


@functools.lru_cache(maxsize=None)
def cluster_power_plan(R: int, n: int) -> PowerPlan:
    """The cluster design's tiles for R frames of n: as few row tiles of
    at most ``CLUSTER_ROWS`` rows as cover R, evenly filled."""
    _check_frame_size(n)
    tiles = max(1, -(-R // CLUSTER_ROWS))
    return PowerPlan(max(1, -(-R // tiles)), DEPTH // CLUSTER)


WIDE_POWER_PLAN = WidePowerPlan(WIDE_ROWS, WIDE_BINS, WIDE_CHUNK)


@functools.lru_cache(maxsize=None)
def power_plan(R: int, n: int) -> PowerPlan | WidePowerPlan:
    """The power-spectrum kernel's design for R frames of n: the wide
    design from ``POWER_WIDE_ROWS`` rows, the cluster design below."""
    _check_frame_size(n)
    if R >= POWER_WIDE_ROWS:
        return WIDE_POWER_PLAN
    return cluster_power_plan(R, n)


class CepstrumPlan(NamedTuple):
    rows: int            # rows per cluster
    width: int           # output columns per CTA (one of CLUSTER slices)

    @property
    def rows_per_thread(self) -> int:
        return ROW_GROUPS[self.rows][0]

    @property
    def depth_warps(self) -> int:
        return ROW_GROUPS[self.rows][1]

    def spans(self, R: int, K: int) -> dict[str, list[tuple[int, int]]]:
        """Clusters' rows, CTAs' output columns, basis chunks' depth (a
        chunk is one CTA's column slice of the product's input)."""
        kp = CLUSTER * self.width
        return {"rows": _spans(R, self.rows),
                "columns": _spans(K, self.width, kp),
                "depth": _spans(K, self.width, kp)}


def _cepstrum_smem(rows: int, width: int) -> int:
    """Bytes of shared memory: the CTA's basis slice, the full rows, the
    CTA's columns, the depth warps' partial sums (in the columns' place
    when one warp takes the whole depth), the row maxima and floors, the
    barriers."""
    wd = ROW_GROUPS[rows][1]
    floats = (CLUSTER * width * width + rows * CLUSTER * width
              + rows * width * (1 + wd if wd > 1 else 1) + 2 * rows)
    return 4 * floats + 8 * (CLUSTER + 1)


class WideCepstrumPlan(NamedTuple):
    rows: int            # rows per CTA (the whole chain)
    columns: int         # even (and odd) output columns, padded
    chunk: int           # folded depth rows per pipeline stage

    def spans(self, R: int, K: int) -> dict[str, list[tuple[int, int]]]:
        """CTAs' rows; the output columns, which every CTA computes
        whole (the even ones from one folded operand, the odd ones from
        the other); the chunks of the folded depth a = 0 .. n/4."""
        half = K - 1
        return {"rows": _spans(R, self.rows),
                "columns": [(0, K)],
                "depth": _spans(half // 2 + 1, self.chunk,
                                _round_up(half // 2 + 1, self.chunk))}


def _wide_cepstrum_smem(K: int, columns: int) -> int:
    """Bytes of shared memory: the basis ring, Y [K][rows] and D
    [depth][rows], the row maxima per warp and the floors, the
    barriers."""
    depth = _round_up((K - 1) // 2 + 1)
    warps = 2 * columns // WARP_COLUMNS
    floats = (WIDE_CEP_STAGES * WIDE_CHUNK * 2 * columns
              + (K + depth + warps + 1) * WIDE_CEP_ROWS)
    return 4 * floats + 8 * WIDE_CEP_STAGES


def wide_cepstrum_plan(K: int) -> WideCepstrumPlan | None:
    """The wide design's layout for K bins, or None where it has no
    build (``WIDE_CEP_WARPS``) or its shared memory would not fit."""
    warps = -(-((K + 1) // 2) // WARP_COLUMNS)
    columns = warps * WARP_COLUMNS
    if (warps not in WIDE_CEP_WARPS
            or _wide_cepstrum_smem(K, columns) > SMEM_BYTES):
        return None
    return WideCepstrumPlan(WIDE_CEP_ROWS, columns, WIDE_CHUNK)


@functools.lru_cache(maxsize=None)
def cluster_cepstrum_plan(R: int, K: int) -> CepstrumPlan:
    """The cluster design's rows per cluster by R (``ROW_GROUPS``), fewer
    where the CTA's basis slice and rows would not fit in shared
    memory."""
    width = max(64, -(-K // (CLUSTER * 8)) * 8)
    want = 4 if R <= 64 else 8 if R <= 128 else 32
    fits = [r for r in ROW_GROUPS
            if r <= want and _cepstrum_smem(r, width) <= SMEM_BYTES]
    if not fits:
        raise ValueError(f"envelope_cepstrum_fused: K = {K} bins do not fit "
                         f"the kernel's shared memory")
    return CepstrumPlan(max(fits), width)


@functools.lru_cache(maxsize=None)
def cepstrum_plan(R: int, K: int) -> CepstrumPlan | WideCepstrumPlan:
    """The envelope-cepstrum kernel's design for R rows of K bins: the wide
    design from ``CEPSTRUM_WIDE_ROWS`` rows where K has one, the cluster
    design otherwise."""
    wide = wide_cepstrum_plan(K) if R >= CEPSTRUM_WIDE_ROWS else None
    return wide if wide is not None else cluster_cepstrum_plan(R, K)


class _Consts(NamedTuple):
    tensors: tuple       # keeps the uploads alive
    ptrs: tuple


@functools.lru_cache(maxsize=None)
def power_basis(n: int) -> np.ndarray:
    """[tiles, DEPTH, BASIS_ROW]: the power-spectrum kernel's only constant, the
    Hann window folded into ``dft.stacked_rfft_basis`` along the
    depth, so frames go to shared memory as they are."""
    window = np.zeros(DEPTH)
    window[:n] = prim.hann(n)
    return (dft.stacked_rfft_basis(n, TILE_BINS, DEPTH, BASIS_ROW)
            * window[None, :, None])


@functools.lru_cache(maxsize=None)
def wide_power_basis(n: int) -> np.ndarray:
    """[base-bin tiles, UD, 4 WIDE_BINS]: the wide power-spectrum kernel's
    only constant, the windowed rfft bases folded twice.

    Over the samples: the periodic Hann window w and the cosine are even
    about n/2 and the sine odd, so re = e @ (w cos) and im = o @ (w sin)
    over t = 0 .. n/2 for e[t] = x[t] + x[n - t], o[t] = x[t] - x[n - t]
    (t = 0 and n/2 pair with themselves: x[t] once, and their sine rows are
    zero).  Over the bins: bin n/2 - k's cosine is (-1)^t bin k's and its
    sine -(-1)^t bin k's, so the even-t and odd-t halves of each sum at the
    base bins k = 0 .. n/4 give both bins.  Row u of a tile holds its base
    bins' w cos at t = 2u, w cos at 2u + 1, w sin at 2u and w sin at
    2u + 1; zero past n/2, past n/4 + 1 bins and in the padding to a whole
    number of ``WIDE_CHUNK`` rows."""
    half = n // 2
    K2 = half // 2 + 1
    cos, sin = dft.rfft_bases(n)
    window = prim.hann(n)[: half + 1, None]
    cw, sw = cos[: half + 1, :K2] * window, sin[: half + 1, :K2] * window
    sw[0] = sw[half] = 0.0
    parts = (cw[0::2], cw[1::2], sw[0::2], sw[1::2])
    tiles = -(-K2 // WIDE_BINS)
    out = np.zeros((tiles, _round_up(half // 2 + 1), 4 * WIDE_BINS))
    for i in range(tiles):
        b0, b1 = i * WIDE_BINS, min(K2, (i + 1) * WIDE_BINS)
        for j, part in enumerate(parts):
            out[i, : len(part), j * WIDE_BINS: j * WIDE_BINS + b1 - b0] = \
                part[:, b0:b1]
    return out


@functools.lru_cache(maxsize=None)
def wide_cepstrum_basis(n: int, columns: int) -> np.ndarray:
    """[QD, 2 columns]: the wide envelope-cepstrum kernel's only constant,
    ``cepstrum_inverse_basis(n)`` (M, with C = M / n) folded about a = n/4.
    Row a = 0 .. n/4 holds M[a][2j] (the even columns, which the folded
    S[a] = x[a] + x[n/2 - a] feeds) in its first ``columns`` and
    M[a][2j + 1] (the odd ones, fed by D[a] = x[a] - x[n/2 - a]) in the
    rest; the odd row of the self-paired a = n/4 is zero; zero past n/4
    (QD is n/4 + 1 rounded up to ``WIDE_CHUNK``) and past K."""
    half = n // 2
    depth = half // 2 + 1
    M = dft.cepstrum_inverse_basis(n)[:depth]
    even, odd = M[:, 0::2], M[:, 1::2].copy()
    if half % 2 == 0:
        odd[half // 2] = 0.0
    out = np.zeros((_round_up(depth), 2 * columns))
    out[:depth, : even.shape[1]] = even
    out[:depth, columns: columns + odd.shape[1]] = odd
    return out


@functools.lru_cache(maxsize=None)
def _wide_power_consts(n: int, device: str) -> _Consts:
    basis = torch.as_tensor(wide_power_basis(n), dtype=torch.float32,
                            device=device)
    return _Consts((basis,), (basis.data_ptr(),))


@functools.lru_cache(maxsize=None)
def _wide_cepstrum_consts(n: int, columns: int, device: str) -> _Consts:
    F = torch.as_tensor(wide_cepstrum_basis(n, columns), dtype=torch.float32,
                        device=device)
    return _Consts((F,), (F.data_ptr(),))


@functools.lru_cache(maxsize=None)
def _power_consts(n: int, device: str) -> _Consts:
    basis = torch.as_tensor(power_basis(n), dtype=torch.float32,
                            device=device)
    return _Consts((basis,), (basis.data_ptr(),))


@functools.lru_cache(maxsize=None)
def _cepstrum_consts(n: int, width: int, device: str) -> _Consts:
    D = torch.as_tensor(dft.sliced_cepstrum_basis(n, width, CLUSTER),
                        dtype=torch.float32, device=device)
    return _Consts((D,), (D.data_ptr(),))


def power_spectrum_plain(frames: torch.Tensor, n: int) -> torch.Tensor:
    """|rfft(hann * frames)|^2 as two matmuls.  frames [R, n]."""
    window = dft.device_const(prim.hann, n, like=frames)
    return dft.power_spectrum(frames * window, n)


def power_spectrum_cost(R: int, n: int) -> tuple[int, int]:
    """(FLOPs, bytes) of one launch of the design R rows take, 2 FLOP per
    multiply-add (the folds' sums, the squares and the sum are not
    counted).  Cluster: the two n-deep basis products; frames, the window,
    both bases and P each moved once.  Wide: the twice-folded products, the
    cosines over t = 0 .. n/2 and the sines over 0 < t < n/2 at the base
    bins k = 0 .. n/4 (n (n/4 + 1) multiply-adds a row, about a quarter of
    the cluster design's); frames, the folded bases and P each moved
    once."""
    K = n // 2 + 1
    if R >= POWER_WIDE_ROWS:
        K2 = n // 4 + 1
        return 2 * R * n * K2, 4 * (R * n + n * K2 + R * K)
    return 4 * R * n * K, 4 * (R * n + n + 2 * n * K + R * K)


def envelope_cepstrum_cost(R: int, K: int) -> tuple[int, int]:
    """(FLOPs, bytes) of one launch of the design R rows take.  Cluster:
    the three K x K basis products; P, the lifter and the output, and two
    K x K bases, each moved once.  Wide: the three folded products (the
    even columns n/4 + 1 deep, the odd ones as deep less the self pair's
    zero row, about K^2 / 2 multiply-adds a row each); P, the lifter, the
    output and the folded basis, each moved once."""
    if R >= CEPSTRUM_WIDE_ROWS and wide_cepstrum_plan(K) is not None:
        half = K - 1
        depth = half // 2 + 1
        macs = ((K + 1) // 2 * depth
                + K // 2 * (depth - (1 if half % 2 == 0 else 0)))
        return 6 * R * macs, 4 * (3 * R * K + macs)
    return 6 * R * K * K, 4 * (3 * R * K + 2 * K * K)


def power_spectrum_fused(frames: torch.Tensor, n: int) -> torch.Tensor:
    """|rfft(hann * frames)|^2.  frames [R, n] float32 -> [R, n//2+1]."""
    R = frames.shape[0]
    K = n // 2 + 1
    dev = frames.device
    cuda.check(frames, "frames", (R, n), dev)
    if dev.type not in ("cpu", "cuda"):
        raise ValueError(f"power_spectrum_fused: no kernel for device {dev}")
    with cost.kernel("power_spectrum", (R, K), *power_spectrum_cost(R, n)):
        if dev.type == "cpu":
            return power_spectrum_plain(frames, n)
        return power_spectrum_launch(frames, n, power_plan(R, n))


def power_spectrum_launch(frames: torch.Tensor, n: int,
                          plan: PowerPlan | WidePowerPlan) -> torch.Tensor:
    """Launch the design ``plan`` names on CUDA frames [R, n] (checked by
    the caller): what :func:`power_spectrum_fused` does with
    ``power_plan(R, n)``, and what ``chip_smoke.py`` times either design
    with."""
    R, K, dev = frames.shape[0], n // 2 + 1, frames.device
    out = torch.empty((R, K), dtype=torch.float32, device=dev)
    if isinstance(plan, WidePowerPlan):
        consts = _wide_power_consts(n, str(dev))
        cuda.hold(*consts.tensors)
        cuda.POWER_SPECTRUM_WIDE.launch(frames.data_ptr(), consts.ptrs[0],
                                        out.data_ptr(), R, n, K, *plan)
        return out
    if frames.data_ptr() % 8:
        raise ValueError("power_spectrum_fused: frames must be 8-byte "
                         "aligned (the kernel copies them 8 bytes at a "
                         "time)")
    consts = _power_consts(n, str(dev))
    cuda.hold(*consts.tensors)
    (basis,) = consts.ptrs
    cuda.POWER_SPECTRUM.launch(frames.data_ptr(), basis, out.data_ptr(),
                               R, n, K, plan.row_tile, CLUSTER, DEPTH,
                               TILE_BINS, BASIS_ROW)
    return out


def envelope_cepstrum_plain(P: torch.Tensor, lift_half: torch.Tensor,
                            n: int, floor_db: float) -> torch.Tensor:
    """Lifted half cepstrum of the floored log of the smoothed power."""
    Ps = dft.quefrency_filter(P, lift_half, n)
    floor = torch.clamp(Ps.amax(dim=1, keepdim=True)
                        * 10.0 ** (floor_db / 10.0), min=prim.POWER_FLOOR)
    L = torch.log(torch.maximum(Ps, floor))
    C = dft.device_const(dft.cepstrum_basis, n, like=L)
    return (L @ C) * lift_half


def envelope_cepstrum_fused(P: torch.Tensor, lift_half: torch.Tensor,
                            n: int, floor_db: float) -> torch.Tensor:
    """P [R, K] + lifter [R, K] (float32) -> lifted half cepstrum [R, K]."""
    R, K = P.shape
    dev = P.device
    cuda.check(P, "P", (R, n // 2 + 1), dev)
    cuda.check(lift_half, "lift_half", (R, K), dev)
    if dev.type not in ("cpu", "cuda"):
        raise ValueError(
            f"envelope_cepstrum_fused: no kernel for device {dev}")
    with cost.kernel("envelope_cepstrum", (R, K),
                     *envelope_cepstrum_cost(R, K)):
        if dev.type == "cpu":
            return envelope_cepstrum_plain(P, lift_half, n, floor_db)
        return envelope_cepstrum_launch(P, lift_half, n, floor_db,
                                        cepstrum_plan(R, K))


def envelope_cepstrum_launch(P: torch.Tensor, lift_half: torch.Tensor,
                             n: int, floor_db: float,
                             plan: CepstrumPlan | WideCepstrumPlan
                             ) -> torch.Tensor:
    """Launch the design ``plan`` names on CUDA P and lifter [R, K]
    (checked by the caller): what :func:`envelope_cepstrum_fused` does
    with ``cepstrum_plan(R, K)``, and what ``chip_smoke.py`` times either
    design with."""
    (R, K), dev = P.shape, P.device
    gain = 10.0 ** (floor_db / 10.0)
    out = torch.empty((R, K), dtype=torch.float32, device=dev)
    if isinstance(plan, WideCepstrumPlan):
        consts = _wide_cepstrum_consts(n, plan.columns, str(dev))
        cuda.hold(*consts.tensors)
        cuda.ENVELOPE_CEPSTRUM_WIDE.launch(
            P.data_ptr(), lift_half.data_ptr(), consts.ptrs[0],
            out.data_ptr(), R, K, *plan, gain, prim.POWER_FLOOR)
        return out
    consts = _cepstrum_consts(n, plan.width, str(dev))
    cuda.hold(*consts.tensors)
    (D,) = consts.ptrs
    cuda.ENVELOPE_CEPSTRUM.launch(P.data_ptr(), lift_half.data_ptr(), D,
                                  out.data_ptr(), R, K, plan.width, CLUSTER,
                                  plan.rows_per_thread, plan.depth_warps,
                                  gain, prim.POWER_FLOOR)
    return out
