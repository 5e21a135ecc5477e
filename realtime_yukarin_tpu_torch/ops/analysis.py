"""Fused analysis front-end: two CUDA kernels and their plain versions.

Port of ``realtime_yukarin_tpu/ops/pallas_analysis.py``:

* :func:`power_spectrum_fused` launches ``csrc/power_spectrum.cu`` —
  Hann window, the two rfft basis products and ``re^2 + im^2`` in one
  kernel; frames are read once and only P is written.
* :func:`envelope_cepstrum_fused` launches ``csrc/envelope_cepstrum.cu`` —
  the CheapTrick-role quefrency chain (cepstrum product, f0-adaptive
  lifter, inverse product, relative floor + log, cepstrum product +
  lifter) with its intermediates kept in shared memory.

Both run on CUDA by default (the TPU build made them opt-in after an A/B
there; the port has no switch) and take their plain versions — the chains
of ``power_spectrum_xla`` / ``envelope_cepstrum_xla`` — only for CPU
tensors.  Both compute in plain float32.

The plans below decide the kernels' tiling and pass it to the launchers,
which refuse a layout or a tiling they were not built for; the constants in
each kernel's layout are uploaded once per (n, device) with their pointers.

A cost count (``utils/cost.py``) sees each call as one launch of its
kernel, by :func:`power_spectrum_cost` and :func:`envelope_cepstrum_cost`,
on either device.
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


@functools.lru_cache(maxsize=None)
def power_plan(R: int, n: int) -> PowerPlan:
    """The power-spectrum kernel's tiles for R frames of n: as few row
    tiles of at most ``CLUSTER_ROWS`` rows as cover R, evenly filled."""
    if n % 2 or not DEPTH - DEPTH // CLUSTER < n <= DEPTH:
        raise ValueError(f"power_spectrum_fused: the kernel takes even "
                         f"n in ({DEPTH - DEPTH // CLUSTER}, {DEPTH}], "
                         f"got {n}")
    tiles = max(1, -(-R // CLUSTER_ROWS))
    return PowerPlan(max(1, -(-R // tiles)), DEPTH // CLUSTER)


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


@functools.lru_cache(maxsize=None)
def cepstrum_plan(R: int, K: int) -> CepstrumPlan:
    """Rows per cluster by R (``ROW_GROUPS``), fewer where the CTA's
    basis slice and rows would not fit in shared memory."""
    width = max(64, -(-K // (CLUSTER * 8)) * 8)
    want = 4 if R <= 64 else 8 if R <= 128 else 32
    fits = [r for r in ROW_GROUPS
            if r <= want and _cepstrum_smem(r, width) <= SMEM_BYTES]
    if not fits:
        raise ValueError(f"envelope_cepstrum_fused: K = {K} bins do not fit "
                         f"the kernel's shared memory")
    return CepstrumPlan(max(fits), width)


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
    """(FLOPs, bytes) of one launch: the two basis products, 2 FLOP per
    multiply-add (the squares and the sum are not counted); frames, the
    window, both bases and P each moved once."""
    K = n // 2 + 1
    return 4 * R * n * K, 4 * (R * n + n + 2 * n * K + R * K)


def envelope_cepstrum_cost(R: int, K: int) -> tuple[int, int]:
    """(FLOPs, bytes) of one launch: the three K x K basis products;
    P, the lifter and the output, and two K x K bases, each moved once."""
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
        plan = power_plan(R, n)
        if frames.data_ptr() % 8:
            raise ValueError("power_spectrum_fused: frames must be 8-byte "
                             "aligned (the kernel copies them 8 bytes at a "
                             "time)")
        consts = _power_consts(n, str(dev))
        cuda.hold(*consts.tensors)
        (basis,) = consts.ptrs
        out = torch.empty((R, K), dtype=torch.float32, device=dev)
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
        plan = cepstrum_plan(R, K)
        consts = _cepstrum_consts(n, plan.width, str(dev))
        cuda.hold(*consts.tensors)
        (D,) = consts.ptrs
        out = torch.empty((R, K), dtype=torch.float32, device=dev)
        cuda.ENVELOPE_CEPSTRUM.launch(P.data_ptr(), lift_half.data_ptr(), D,
                                      out.data_ptr(), R, K, plan.width,
                                      CLUSTER, plan.rows_per_thread,
                                      plan.depth_warps,
                                      10.0 ** (floor_db / 10.0),
                                      prim.POWER_FLOOR)
        return out
