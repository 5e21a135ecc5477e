// Windowed power spectrum for Hopper (sm_90a).
//
// Replaces: realtime_yukarin_tpu/ops/pallas_analysis.py `_power_kernel`
// (launched by `_power_fused_rows`, public `power_spectrum_fused`).
//
// Computes P[r,k] = (sum_t w[t] x[r,t] cos[t,k])^2 + (sum_t w[t] x[r,t] sin[t,k])^2,
// i.e. |rfft(hann * frames)|^2 as one product against one constant basis
// (ops/analysis.py `power_basis`): the Hann window is folded into the rfft
// bases, and bin j's cos and sin columns are stacked columns 2j and 2j+1,
// so the real and the imaginary sum of a bin land in one thread's
// accumulators and the square is a register epilogue.  The depth is
// zero-padded from n (1022 or 1024) to 1024 and the basis is stored
// tile-contiguous, [tile of 32 bins][1024][72] (64 stacked columns, 8 zero
// columns against shared-memory bank conflicts), so any depth slice of a
// bin tile is one contiguous span that a single `cp.async.bulk` brings
// into shared memory, completing on an mbarrier.
//
// Bound on an H100 SXM: at the streaming step's R = 20 frames the work is
// ~41.9 MFLOP and ~4.3 MB, almost all of it the two bases, so it is
// memory-bound at ~1.3 us (3.35 TB/s).  At R = 1280 it is ~2.68 GFLOP,
// ~40 us of float32 FMA (67 TFLOP/s).
//
// Design: at the streaming width the bound is latency, not arithmetic, so
// the kernel fills the SMs by splitting the depth across a thread-block
// cluster.  Grid: 8 depth slices x the bin tiles (16 at K = 512) x the row
// tiles of at most 64 rows (the wrapper's `power_plan`: one at R = 20, two
// at R = 100, 20 at R = 1280), one cluster of 8 CTAs per bin tile and row
// tile.  Each CTA issues one bulk copy of its 36 KB basis tile and, while it
// flies, its whole [rows, 128] frames slice as 8-byte `cp.async` (rows of
// n = 1022 floats are only 8-byte aligned), zero-filled past R and n: one
// round trip, then float32 FMA (lane = one bin, 8 warps = 8 row groups).
// The 8 partial (re, im) tiles are reduced over distributed shared memory:
// each CTA owns a share of the rows and every CTA sends it that share of its
// partials by one bulk copy (`cp.async.bulk.shared::cluster`) completing on
// the owner's mbarrier; the owner adds the 8 in rank order, squares and
// writes only P.  Split cluster barriers (arrive early, wait late) keep
// every CTA's barriers and shared memory alive while the others use them.
// Numerics: float32, as the plain version.  This design takes R below
// ops/analysis.py `POWER_WIDE_ROWS` (the single stream's 4 and 20 rows,
// make_batch's 100, the quality recipe's 120 and 160); from there the
// batch-width design of csrc/power_spectrum_wide.cu does (two folds and a
// register-blocked GEMM, no depth split).  A 3xTF32 tensor-core variant
// measured slower than the plain version's device time at R = 1280.

#include <cooperative_groups.h>
#include <cuda_runtime.h>

#include <cstdint>
#include <utility>

namespace cg = cooperative_groups;

namespace {

constexpr int DEPTH = 1024;       // padded depth (n <= 1024)
constexpr int SLICES = 8;         // depth slices of 128 = the cluster size
constexpr int SLICE = DEPTH / SLICES;
constexpr int TILE_BINS = 32;     // bins per tile (64 stacked columns)
constexpr int LD = 72;            // stacked columns per stored basis row
constexpr int SLICE_BYTES = SLICE * LD * 4;
constexpr int MAX_ROW_TILE = 64;  // rows per cluster, at most

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint64_t* bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(
                   smem_addr(bar)),
               "r"(count)
               : "memory");
}

__device__ __forceinline__ void expect_bytes(uint64_t* bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::
                   "r"(smem_addr(bar)),
               "r"(bytes)
               : "memory");
}

// One thread: expect `bytes` on `bar` and copy them from global memory.
__device__ __forceinline__ void bulk_load(void* dst, const void* src,
                                          uint32_t bytes, uint64_t* bar) {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
  expect_bytes(bar, bytes);
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1], %2, [%3];\n" ::"r"(smem_addr(dst)),
      "l"(src), "r"(bytes), "r"(smem_addr(bar))
      : "memory");
}

__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "WAIT_%=:\n"
      "mbarrier.try_wait.parity.shared::cta.b64 p, [%0], %1;\n"
      "@!p bra WAIT_%=;\n"
      "}\n" ::"r"(smem_addr(bar)),
      "r"(parity)
      : "memory");
}

// this CTA's shared memory -> the same offsets `dst` and `bar` in CTA
// `rank` of the cluster, completing on that CTA's `bar`
__device__ __forceinline__ void bulk_send(const void* src, void* dst,
                                          uint32_t bytes, uint64_t* bar,
                                          uint32_t rank) {
  uint32_t d, b;
  asm volatile("mapa.shared::cluster.u32 %0, %1, %2;\n"
               : "=r"(d) : "r"(smem_addr(dst)), "r"(rank));
  asm volatile("mapa.shared::cluster.u32 %0, %1, %2;\n"
               : "=r"(b) : "r"(smem_addr(bar)), "r"(rank));
  asm volatile(
      "cp.async.bulk.shared::cluster.shared::cta.mbarrier::complete_tx::bytes "
      "[%0], [%1], %2, [%3];\n" ::"r"(d),
      "r"(smem_addr(src)), "r"(bytes), "r"(b)
      : "memory");
}

// split cluster barrier: every thread of the cluster arrives, then waits.
// Not `.aligned`: warps reach it after single-thread sends and mbarrier
// spins, so their threads need not arrive together.
__device__ __forceinline__ void cluster_arrive() {
  asm volatile("barrier.cluster.arrive.release;\n" ::: "memory");
}

__device__ __forceinline__ void cluster_wait() {
  asm volatile("barrier.cluster.wait.acquire;\n" ::: "memory");
}

// 8 bytes global -> shared, zero-filled when !valid (src is not read then)
__device__ __forceinline__ void cp_async8(float* dst, const float* src,
                                          bool valid) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 8, %2;\n" ::"r"(
                   smem_addr(dst)),
               "l"(src), "r"(valid ? 8 : 0)
               : "memory");
}

// ---------------------------------------------------------------------------
// Streaming width: cluster split of the depth, FFMA, DSMEM reduction
// ---------------------------------------------------------------------------

constexpr int CL_THREADS = 256;   // 8 warps = 8 row groups; lane = bin
constexpr int CL_WARPS = CL_THREADS / 32;

template <int RPT>   // rows per thread: a row tile of RT <= 8 * RPT rows
__global__ void __cluster_dims__(SLICES, 1, 1) __launch_bounds__(CL_THREADS)
power_spectrum_kernel(const float* __restrict__ frames,
                      const float* __restrict__ basis,
                      float* __restrict__ out, int R, int n, int K, int RT) {
  // this cluster's row tile: rows [blockIdx.z RT, +RT) of R
  frames += static_cast<size_t>(blockIdx.z) * RT * n;
  out += static_cast<size_t>(blockIdx.z) * RT * K;
  R = min(RT, R - static_cast<int>(blockIdx.z) * RT);
  constexpr int RP = CL_WARPS * RPT;   // rows staged, zero past R
  constexpr int RR = RPT;       // rows each rank reduces: ceil(R / 8) <= RR
  extern __shared__ __align__(16) unsigned char smem[];
  float* B = reinterpret_cast<float*>(smem);                  // [128][LD]
  float* X = B + SLICE * LD;                                  // [RP][128]
  float2* recv = reinterpret_cast<float2*>(X + RP * SLICE);   // [8][RR][32]
  uint64_t* bar = reinterpret_cast<uint64_t*>(recv + SLICES * RR * TILE_BINS);
  uint64_t* rbar = bar + 1;
  cg::cluster_group cluster = cg::this_cluster();
  const int s = static_cast<int>(cluster.block_rank());       // depth slice
  const int tile = blockIdx.y;
  const int tid = threadIdx.x;
  const int rr = (R + SLICES - 1) / SLICES;   // rank q reduces rows
  const int mine = max(0, min(R, (s + 1) * rr) - s * rr);   // [q rr, +rr)

  if (tid == 0) {
    mbar_init(bar, 1);
    mbar_init(rbar, 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
    bulk_load(B, basis + (static_cast<size_t>(tile) * DEPTH + s * SLICE) * LD,
              SLICE_BYTES, bar);
    if (mine) expect_bytes(rbar, SLICES * mine * TILE_BINS * 8);
  }
  cluster_arrive();   // barriers initialised; waited for before any send
#pragma unroll
  for (int i = 0; i < RP * (SLICE / 2) / CL_THREADS; ++i) {
    const int e = tid + CL_THREADS * i;
    const int r = e / (SLICE / 2), c2 = 2 * (e % (SLICE / 2));
    const int t = s * SLICE + c2;
    const bool ok = r < R && t < n;   // n is even: t < n implies t + 1 < n
    cp_async8(X + r * SLICE + c2,
              frames + (ok ? static_cast<size_t>(r) * n + t : 0), ok);
  }
  asm volatile("cp.async.commit_group;\n" ::: "memory");
  asm volatile("cp.async.wait_all;\n" ::: "memory");
  __syncthreads();
  mbar_wait(bar, 0);

  const int lane = tid % 32, g = tid / 32;
  float re[RPT], im[RPT];
#pragma unroll
  for (int i = 0; i < RPT; ++i) re[i] = im[i] = 0.f;
#pragma unroll 2
  for (int d = 0; d < SLICE; d += 4) {
    float2 b[4];
#pragma unroll
    for (int dd = 0; dd < 4; ++dd)
      b[dd] = *reinterpret_cast<const float2*>(B + (d + dd) * LD + 2 * lane);
    float4 x[RPT];
#pragma unroll
    for (int i = 0; i < RPT; ++i)
      x[i] = *reinterpret_cast<const float4*>(
          X + (g + CL_WARPS * i) * SLICE + d);
#pragma unroll
    for (int i = 0; i < RPT; ++i) {
      re[i] = fmaf(x[i].x, b[0].x, re[i]);
      im[i] = fmaf(x[i].x, b[0].y, im[i]);
      re[i] = fmaf(x[i].y, b[1].x, re[i]);
      im[i] = fmaf(x[i].y, b[1].y, im[i]);
      re[i] = fmaf(x[i].z, b[2].x, re[i]);
      im[i] = fmaf(x[i].z, b[2].y, im[i]);
      re[i] = fmaf(x[i].w, b[3].x, re[i]);
      im[i] = fmaf(x[i].w, b[3].y, im[i]);
    }
  }
  __syncthreads();   // X is read no more: it now holds this slice's partials
  float2* part = reinterpret_cast<float2*>(X);                // [RP][32]
#pragma unroll
  for (int i = 0; i < RPT; ++i)
    part[(g + CL_WARPS * i) * TILE_BINS + lane] = make_float2(re[i], im[i]);
  // every warp's rows of part, visible to the bulk copies that warp 0
  // issues below (they span other warps' rows)
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
  __syncthreads();
  cluster_wait();     // every rank's barriers are live
  // rank q's rows of this slice's partials -> rank q's recv[s]
  if (tid < SLICES) {
    const int q = tid, nq = max(0, min(R, (q + 1) * rr) - q * rr);
    if (nq)
      bulk_send(part + q * rr * TILE_BINS, recv + s * RR * TILE_BINS,
                nq * TILE_BINS * 8, rbar, q);
  }
  if (mine) mbar_wait(rbar, 0);
  cluster_arrive();   // every slice's rows for this rank have landed
  for (int e = tid; e < mine * TILE_BINS; e += CL_THREADS) {
    const int r = e / TILE_BINS, j = e % TILE_BINS;
    float2 acc = recv[r * TILE_BINS + j];
#pragma unroll
    for (int q = 1; q < SLICES; ++q) {
      const float2 p = recv[(q * RR + r) * TILE_BINS + j];
      acc.x += p.x;
      acc.y += p.y;
    }
    const int bin = tile * TILE_BINS + j;
    if (bin < K)
      out[static_cast<size_t>(s * rr + r) * K + bin] =
          acc.x * acc.x + acc.y * acc.y;
  }
  cluster_wait();     // every send has landed: no DSMEM access after this
}

template <int RPT>
int launch_cluster(const float* frames, const float* basis, float* out,
                   int R, int n, int K, int RT, int tiles,
                   cudaStream_t stream) {
  const size_t smem = (static_cast<size_t>(SLICE) * LD +
                       static_cast<size_t>(CL_WARPS * RPT) * SLICE +
                       static_cast<size_t>(SLICES) * RPT * TILE_BINS * 2) * 4 +
                      16;
  auto kernel = power_spectrum_kernel<RPT>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  kernel<<<dim3(SLICES, tiles, (R + RT - 1) / RT), CL_THREADS, smem,
           stream>>>(frames, basis, out, R, n, K, RT);
  return static_cast<int>(cudaGetLastError());
}

template <int... RPT>
int launch_rows(std::integer_sequence<int, RPT...>, const float* frames,
                const float* basis, float* out, int R, int n, int K, int RT,
                int tiles, cudaStream_t stream) {
  int code = static_cast<int>(cudaErrorInvalidValue);
  // the first RPT + 1 with RT <= 8 (RPT + 1) rows
  (void)((RT <= CL_WARPS * (RPT + 1)
              ? (code = launch_cluster<RPT + 1>(frames, basis, out, R, n, K,
                                                RT, tiles, stream),
                 true)
              : false) ||
         ...);
  return code;
}

}  // namespace

// frames [R, n] float32 (n even, 896 < n <= 1024), basis the windowed
// stacked basis of ops/analysis.py `power_basis(n)`, out [R, K].  The row
// tile (<= 64 rows per cluster) comes from the wrapper's plan
// (ops/analysis.py `power_plan`), and so does the layout the basis was
// built in -- cluster size, padded depth, bins per tile, floats per basis
// row -- which must be this kernel's, or the launch is refused.
extern "C" int power_spectrum_forward(const void* frames, const void* basis,
                                      void* out, int R, int n, int K,
                                      int row_tile, int cluster, int depth,
                                      int tile_bins, int basis_row,
                                      void* stream) {
  if (cluster != SLICES || depth != DEPTH || tile_bins != TILE_BINS ||
      basis_row != LD)
    return static_cast<int>(cudaErrorInvalidValue);
  if (R == 0) return 0;
  if (n % 2 != 0 || n <= DEPTH - SLICE || n > DEPTH || K != n / 2 + 1 ||
      row_tile < 1 || row_tile > MAX_ROW_TILE)
    return static_cast<int>(cudaErrorInvalidValue);
  const auto* f = static_cast<const float*>(frames);
  const auto* b = static_cast<const float*>(basis);
  auto* o = static_cast<float*>(out);
  auto s = static_cast<cudaStream_t>(stream);
  const int tiles = (K + TILE_BINS - 1) / TILE_BINS;
  return launch_rows(
      std::make_integer_sequence<int, MAX_ROW_TILE / CL_WARPS>(), f, b, o,
      R, n, K, row_tile, tiles, s);
}

extern "C" const char* power_spectrum_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
