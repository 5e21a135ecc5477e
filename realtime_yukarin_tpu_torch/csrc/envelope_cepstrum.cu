// Envelope cepstrum (the CheapTrick-role quefrency chain) for Hopper (sm_90a).
//
// Replaces: realtime_yukarin_tpu/ops/pallas_analysis.py `_cepstrum_kernel`
// (launched by `_cepstrum_fused_rows`, public `envelope_cepstrum_fused`).
//
// Computes, per row of the power spectrogram P [R, K] with its lifter
// lift [R, K] and the square bases C [K, K] (cepstrum) and D [K, K]
// (inverse cepstrum):
//   Ps  = ((P @ C) * lift) @ D                     pitch-adaptive smoothing
//   L   = log(max(Ps, max(rowmax(Ps) * gain, power_floor)))
//   out = (L @ C) * lift                           lifted half cepstrum
//
// Bound on an H100 SXM: at the streaming step's R = 20 rows the work is
// ~31.5 MFLOP and ~2.2 MB (the two bases plus P, lift and out), memory-bound
// at ~0.66 us.  At R = 1280 it is ~2.01 GFLOP, compute-bound at ~30 us of
// float32 FMA.
//
// Design: the columns of every product are split across a thread-block
// cluster of 8 CTAs, so each basis byte is read once per row group, not once
// per few-row block.  C = D / n (the same cosines and end weights), so one
// basis serves all three products: CTA c owns output columns [c W, (c + 1) W)
// (W = 64 at K = 512, 72 at K = 513) and keeps the column slice of D it
// needs, [KP = 8 W][W] (stored slice-contiguous and zero-padded by the
// wrapper), resident in shared memory -- 8 bulk copies (`cp.async.bulk`) of
// W depth rows at launch, each completing on its own mbarrier, so the first
// product starts on the first chunk while the others land.  A cluster owns
// a group of RG rows (the wrapper's `cepstrum_plan`: 4 up to R = 64, 8 up to
// 128, 32 above where shared memory holds them).  P's rows arrive by
// `cp.async`, all in flight at once.  A product's full [RG, KP] input is kept
// as 8 column slices [8][RG][W], so each CTA hands its output slice to all 8
// CTAs of the cluster as 8 bulk copies into their shared memory
// (distributed shared memory, `cp.async.bulk.shared::cluster`), completing
// on the receivers' mbarriers: intermediates never touch device memory, as
// in the TPU kernel, and no thread spends time on the exchange.  Split
// cluster barriers (arrive early, wait late) order the exchanges.  The row
// max before the floor is a per-CTA warp reduction followed by a max over
// the 8 ranks' partial maxima read over DSMEM; each CTA takes the log of its
// own slice before handing it out.  Products are float32 FMA: lane l owns
// the column pair 2l, 2l + 1 (and 2l + 64, 2l + 65 when W > 64), each
// thread 4 or 8 rows of it; the 8 warps split the rows and the depth of each
// chunk, their partial sums added in a fixed order through shared memory.
// A row of the input is read four depths at a time as a broadcast float4.
// This design takes R below ops/analysis.py `CEPSTRUM_WIDE_ROWS`; from
// there the batch-width design of csrc/envelope_cepstrum_wide.cu does (a
// folded, register-blocked float32 GEMM, the chain of 32 rows in one CTA).
// 3xTF32 tensor-core products measured slower at batch widths.  A cluster
// whose CTAs cannot be co-resident fails at launch and the wrapper raises.

#include <cfloat>
#include <cooperative_groups.h>
#include <cuda_runtime.h>

#include <cstdint>

namespace cg = cooperative_groups;

namespace {

constexpr int CL = 8;          // CTAs per cluster = column slices
constexpr int THREADS = 256;
constexpr int WARPS = THREADS / 32;

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

// global -> this CTA's shared memory, completing on `bar`
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

// split cluster barrier: every thread of the cluster arrives, then waits.
// Not `.aligned`: warps reach it after single-thread sends and mbarrier
// spins, so their threads need not arrive together.
__device__ __forceinline__ void cluster_arrive() {
  asm volatile("barrier.cluster.arrive.release;\n" ::: "memory");
}

__device__ __forceinline__ void cluster_wait() {
  asm volatile("barrier.cluster.wait.acquire;\n" ::: "memory");
}

// 16 or 4 bytes global -> shared, zero-filled when !valid
__device__ __forceinline__ void cp_async16(float* dst, const float* src,
                                           bool valid) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                   smem_addr(dst)),
               "l"(src), "r"(valid ? 16 : 0)
               : "memory");
}

__device__ __forceinline__ void cp_async4(float* dst, const float* src,
                                          bool valid) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(
                   smem_addr(dst)),
               "l"(src), "r"(valid ? 4 : 0)
               : "memory");
}

// This CTA's column slice of D, [KP][W], resident in shared memory: loaded
// once as CL chunks of W depth rows, chunk c by one bulk copy completing on
// bar[c], and read by all three products.
struct Basis {
  float* buf;          // [CL][W * W]
  uint64_t* bar;       // [CL]
  int W;

  __device__ void load(const float* D) const {
    for (int c = 0; c < CL; ++c)
      bulk_load(buf + static_cast<size_t>(c) * W * W,
                D + static_cast<size_t>(c) * W * W, W * W * 4, &bar[c]);
  }

  __device__ const float* chunk(int c) const {
    mbar_wait(&bar[c], 0);
    return buf + static_cast<size_t>(c) * W * W;
  }
};

// Warp w = (wd, wr): wr = w % WR owns rows wr, wr + WR, ... (RPT of them),
// wd = w / WR the depth groups of four wd, wd + WD, ... of every chunk;
// lane l the column pairs l and l + 32 (CPL of them).
// acc[i][2m + h] = that warp's share of sum_k X[row i][k] D[k][2 (l +
// 32 m) + h], X the input kept as [CL][RG][W].
template <int RPT, int WD, int CPL>
__device__ __forceinline__ void product(const Basis& basis, const float* X,
                                        float (&acc)[RPT][2 * CPL]) {
  constexpr int WR = WARPS / WD, RG = WR * RPT;
  const int tid = threadIdx.x, lane = tid % 32, w = tid / 32;
  const int wr = w % WR, wd = w / WR;
  const int W = basis.W;
#pragma unroll
  for (int i = 0; i < RPT; ++i)
#pragma unroll
    for (int j = 0; j < 2 * CPL; ++j) acc[i][j] = 0.f;
  for (int ch = 0; ch < CL; ++ch) {
    const float* B = basis.chunk(ch);
    const float* Xs = X + ch * RG * W;
#pragma unroll 2
    for (int d = 4 * wd; d < W; d += 4 * WD) {
      float4 x[RPT];
#pragma unroll
      for (int i = 0; i < RPT; ++i)
        x[i] = *reinterpret_cast<const float4*>(Xs + (wr + WR * i) * W + d);
      float2 b[4][CPL];
#pragma unroll
      for (int dd = 0; dd < 4; ++dd)
#pragma unroll
        for (int m = 0; m < CPL; ++m) {
          const int pj = lane + 32 * m;
          b[dd][m] = (m == 0 || 2 * pj < W)
                         ? *reinterpret_cast<const float2*>(
                               B + (d + dd) * W + 2 * pj)
                         : make_float2(0.f, 0.f);
        }
#pragma unroll
      for (int dd = 0; dd < 4; ++dd)
#pragma unroll
        for (int i = 0; i < RPT; ++i) {
          const float xv = dd == 0 ? x[i].x
                         : dd == 1 ? x[i].y
                         : dd == 2 ? x[i].z : x[i].w;
#pragma unroll
          for (int m = 0; m < CPL; ++m) {
            acc[i][2 * m] = fmaf(xv, b[dd][m].x, acc[i][2 * m]);
            acc[i][2 * m + 1] = fmaf(xv, b[dd][m].y, acc[i][2 * m + 1]);
          }
        }
    }
  }
}

// The warps' partial sums -> red[wd][RG][W]; read back with `summed`.
template <int RPT, int WD, int CPL>
__device__ __forceinline__ void park(float* red, int W,
                                     const float (&acc)[RPT][2 * CPL]) {
  constexpr int WR = WARPS / WD, RG = WR * RPT;
  const int lane = threadIdx.x % 32, w = threadIdx.x / 32;
  float* dst = red + (w / WR) * RG * W;
#pragma unroll
  for (int i = 0; i < RPT; ++i)
#pragma unroll
    for (int m = 0; m < CPL; ++m) {
      const int pj = lane + 32 * m;
      if (m == 0 || 2 * pj < W)
        *reinterpret_cast<float2*>(dst + (w % WR + WR * i) * W + 2 * pj) =
            make_float2(acc[i][2 * m], acc[i][2 * m + 1]);
    }
  __syncthreads();
}

// Element (r, j) of the product: the depth warps' partials in order.
template <int WD>
__device__ __forceinline__ float summed(const float* red, int RG, int W,
                                        int r, int j) {
  float v = red[r * W + j];
#pragma unroll
  for (int k = 1; k < WD; ++k) v += red[(k * RG + r) * W + j];
  return v;
}

template <int RPT, int WD, int CPL>
__global__ void __cluster_dims__(CL, 1, 1) __launch_bounds__(THREADS)
envelope_cepstrum_kernel(const float* __restrict__ P,
                         const float* __restrict__ lift,
                         const float* __restrict__ Ds,
                         float* __restrict__ out, int R, int K, int W,
                         float gain, float power_floor) {
  constexpr int RG = (WARPS / WD) * RPT;
  constexpr int JM = 2 * CPL;      // columns per lane in the epilogues
  constexpr int RW = (RG + WARPS - 1) / WARPS;   // rows per warp there
  const int KP = CL * W;
  const uint32_t slice_bytes = RG * W * 4;
  extern __shared__ __align__(16) unsigned char smem[];
  float* D_buf = reinterpret_cast<float*>(smem);        // [CL][W][W]
  float* X = D_buf + CL * W * W;                        // [CL][RG][W]
  float* loc = X + RG * KP;                             // [RG][W]
  float* red = WD > 1 ? loc + RG * W : loc;             // [WD][RG][W]
  float* rmax = loc + RG * W + (WD > 1 ? WD * RG * W : 0);   // [RG]
  float* rfloor = rmax + RG;                            // [RG]
  uint64_t* bar = reinterpret_cast<uint64_t*>(rfloor + RG);  // [CL]
  uint64_t* xbar = bar + CL;                            // exchanges
  cg::cluster_group cluster = cg::this_cluster();
  const int c = static_cast<int>(cluster.block_rank());
  const int row0 = blockIdx.y * RG;
  const int tid = threadIdx.x, lane = tid % 32, w = tid / 32;
  const Basis basis{D_buf, bar, W};
  const float inv_n = 1.f / static_cast<float>(2 * (K - 1));   // C = D / n

  if (tid == 0) {
    for (int s = 0; s < CL; ++s) mbar_init(&bar[s], 1);
    mbar_init(xbar, 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
    basis.load(Ds + static_cast<size_t>(c) * KP * W);
    expect_bytes(xbar, CL * slice_bytes);        // the first exchange
  }
  // this thread's lifter values for the epilogues, (row w + 8 i, column
  // lane + 32 m), loaded now so that the products hide their latency
  float lf[RW][JM];
#pragma unroll
  for (int i = 0; i < RW; ++i)
#pragma unroll
    for (int m = 0; m < JM; ++m) {
      const int r = w + WARPS * i, j = lane + 32 * m, k = c * W + j;
      const int gr = row0 + r;
      lf[i][m] = (r < RG && j < W && gr < R && k < K)
                     ? lift[static_cast<size_t>(gr) * K + k] : 0.f;
    }
  // P's rows as [CL][RG][W], zero past R and K, all copies in flight
  if (K % 4 == 0 && reinterpret_cast<uintptr_t>(P) % 16 == 0) {
    for (int e = tid; e < RG * KP / 4; e += THREADS) {
      const int r = e / (KP / 4), k = 4 * (e % (KP / 4)), gr = row0 + r;
      const bool ok = gr < R && k < K;
      cp_async16(X + (k / W) * RG * W + r * W + k % W,
                 P + (ok ? static_cast<size_t>(gr) * K + k : 0), ok);
    }
  } else {
    for (int e = tid; e < RG * KP; e += THREADS) {
      const int r = e / KP, k = e % KP, gr = row0 + r;
      const bool ok = gr < R && k < K;
      cp_async4(X + (k / W) * RG * W + r * W + k % W,
                P + (ok ? static_cast<size_t>(gr) * K + k : 0), ok);
    }
  }
  asm volatile("cp.async.commit_group;\n" ::: "memory");
  asm volatile("cp.async.wait_all;\n" ::: "memory");
  __syncthreads();

  float acc[RPT][2 * CPL];

  // 1. cepstrum of the linear power, times the lifter -> loc -> every X
  product<RPT, WD, CPL>(basis, X, acc);
  cluster_arrive();                 // this CTA reads its X no more
  park<RPT, WD, CPL>(red, W, acc);
#pragma unroll
  for (int i = 0; i < RW; ++i) {
    const int r = w + WARPS * i;
    if (r >= RG) break;
#pragma unroll
    for (int m = 0; m < JM; ++m) {
      const int j = lane + 32 * m;
      if (j < W)
        loc[r * W + j] = summed<WD>(red, RG, W, r, j) * inv_n * lf[i][m];
    }
  }
  // every warp's rows of loc, visible to the bulk copies that warp 0
  // issues below (they send the whole slice)
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
  __syncthreads();
  cluster_wait();                   // every X of the cluster may be written
  if (tid < CL) bulk_send(loc, X + c * RG * W, slice_bytes, xbar, tid);
  mbar_wait(xbar, 0);
  if (tid == 0) expect_bytes(xbar, CL * slice_bytes);   // the second
  cluster_arrive();                 // every slice of mine has landed

  // 2. back to the (smoothed) power spectrum -> loc, with row maxima
  product<RPT, WD, CPL>(basis, X, acc);
  cluster_wait();                   // loc has reached every CTA: reusable
  park<RPT, WD, CPL>(red, W, acc);
#pragma unroll
  for (int i = 0; i < RW; ++i) {
    const int r = w + WARPS * i;
    if (r >= RG) break;
    float mx = -FLT_MAX;
#pragma unroll
    for (int m = 0; m < JM; ++m) {
      const int j = lane + 32 * m;
      if (j < W) {
        const float v = summed<WD>(red, RG, W, r, j);
        loc[r * W + j] = v;
        if (c * W + j < K) mx = fmaxf(mx, v);
      }
    }
#pragma unroll
    for (int off = 16; off > 0; off /= 2)
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
    if (lane == 0) rmax[r] = mx;
  }
  cluster.sync();                   // maxima visible, every X read
  // 3. per-row relative floor from the 8 ranks' maxima, then the log of
  // this CTA's slice, handed to every CTA
  if (tid < RG) {
    float mx = -FLT_MAX;
#pragma unroll
    for (int p = 0; p < CL; ++p)
      mx = fmaxf(mx, cluster.map_shared_rank(rmax, p)[tid]);
    rfloor[tid] = fmaxf(mx * gain, power_floor);
  }
  __syncthreads();
  for (int e = tid; e < RG * W; e += THREADS) {
    const int r = e / W, k = c * W + e % W;
    loc[e] = k < K ? logf(fmaxf(loc[e], rfloor[r])) : 0.f;
  }
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
  __syncthreads();
  if (tid < CL) bulk_send(loc, X + c * RG * W, slice_bytes, xbar, tid);
  mbar_wait(xbar, 1);
  cluster_arrive();                 // every slice of mine has landed

  // 4. cepstrum of the log envelope, times the lifter -> out
  product<RPT, WD, CPL>(basis, X, acc);
  cluster_wait();                   // no DSMEM access after this point
  park<RPT, WD, CPL>(red, W, acc);
#pragma unroll
  for (int i = 0; i < RW; ++i) {
    const int r = w + WARPS * i, gr = row0 + r;
    if (r >= RG || gr >= R) break;
#pragma unroll
    for (int m = 0; m < JM; ++m) {
      const int j = lane + 32 * m, k = c * W + j;
      if (j < W && k < K)
        out[static_cast<size_t>(gr) * K + k] =
            summed<WD>(red, RG, W, r, j) * inv_n * lf[i][m];
    }
  }
}

template <int RPT, int WD, int CPL>
int launch(const float* P, const float* lift, const float* D, float* out,
           int R, int K, int W, float gain, float power_floor,
           cudaStream_t stream) {
  constexpr int RG = (WARPS / WD) * RPT;
  const size_t floats = static_cast<size_t>(CL) * W * W +
                        static_cast<size_t>(RG) * CL * W +
                        static_cast<size_t>(RG) * W * (WD > 1 ? 1 + WD : 1) +
                        2 * RG;
  const size_t smem = floats * 4 + (CL + 1) * 8;
  auto kernel = envelope_cepstrum_kernel<RPT, WD, CPL>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  kernel<<<dim3(CL, (R + RG - 1) / RG), THREADS, smem, stream>>>(
      P, lift, D, out, R, K, W, gain, power_floor);
  return static_cast<int>(cudaGetLastError());
}

// The plan's (rows per thread, warps splitting the depth): the three that
// ops/analysis.py `ROW_GROUPS` may choose are built, any other is refused.
template <int CPL>
int launch_plan(int rpt, int wd, const float* P, const float* lift,
                const float* D, float* out, int R, int K, int W, float gain,
                float power_floor, cudaStream_t s) {
  if (rpt == 4 && wd == 8)
    return launch<4, 8, CPL>(P, lift, D, out, R, K, W, gain, power_floor, s);
  if (rpt == 8 && wd == 8)
    return launch<8, 8, CPL>(P, lift, D, out, R, K, W, gain, power_floor, s);
  if (rpt == 8 && wd == 2)
    return launch<8, 2, CPL>(P, lift, D, out, R, K, W, gain, power_floor, s);
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // namespace

// P, lift, out [R, K]; D the column-sliced inverse-cepstrum basis of
// ops/dft.py `sliced_cepstrum_basis(n, W, slices)`, [slices][slices W][W].
// The cepstrum basis is D / n (C[k][q] = w[k] cos(2 pi k q / n) / n,
// D[k][q] = w[k] cos(2 pi k q / n)), so one basis serves all three
// products.  W (a multiple of 8, 64 <= W <= 128, 8 W >= K), the rows per
// thread and the warps splitting the depth come from the wrapper's plan
// (ops/analysis.py `cepstrum_plan`); slices must be this kernel's cluster
// size.
extern "C" int envelope_cepstrum_forward(const void* P, const void* lift,
                                         const void* D, void* out, int R,
                                         int K, int W, int slices,
                                         int rows_per_thread,
                                         int depth_warps, float gain,
                                         float power_floor, void* stream) {
  if (slices != CL) return static_cast<int>(cudaErrorInvalidValue);
  if (R == 0) return 0;
  if (W % 8 != 0 || CL * W < K || W < 64 || W > 128)
    return static_cast<int>(cudaErrorInvalidValue);
  const auto* p = static_cast<const float*>(P);
  const auto* l = static_cast<const float*>(lift);
  const auto* d = static_cast<const float*>(D);
  auto* o = static_cast<float*>(out);
  auto s = static_cast<cudaStream_t>(stream);
  const int rpt = rows_per_thread, wd = depth_warps;
  return W <= 64
             ? launch_plan<1>(rpt, wd, p, l, d, o, R, K, W, gain, power_floor, s)
             : launch_plan<2>(rpt, wd, p, l, d, o, R, K, W, gain, power_floor, s);
}

extern "C" const char* envelope_cepstrum_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
