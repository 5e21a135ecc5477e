// Windowed power spectrum for Hopper (sm_90a), the batch-width design.
//
// Replaces: realtime_yukarin_tpu/ops/pallas_analysis.py `_power_kernel`
// (launched by `_power_fused_rows`, public `power_spectrum_fused`) at and
// above ops/analysis.py `POWER_WIDE_ROWS` rows; below it
// csrc/power_spectrum.cu (the cluster design) takes the call.
//
// Computes P[r,k] = (sum_t w[t] x[r,t] cos(2 pi t k / n))^2
//                 + (sum_t w[t] x[r,t] sin(2 pi t k / n))^2,
// |rfft(hann * frames)|^2, for frames [R, n] (n even, K = n/2 + 1 bins).
//
// Bound on an H100 SXM (the unfolded count, 4 R n K FLOP, and each operand
// moved once): at the 20 ms profile's 512 lanes (R = 2,048 rows of
// n = 1,022) ~4.29 GFLOP, ~64 us of float32 FMA (67 TFLOP/s); at the default
// profile's 512 lanes (R = 10,240) ~21.5 GFLOP, ~320 us.  The two folds
// below leave a quarter of those multiply-adds (ops/analysis.py
// `power_spectrum_cost` counts them), so the kernel's own floor is ~16 and
// ~80 us.
//
// Design: two radix-2 folds, then a register-blocked float32 GEMM.
// * The first fold, over the samples.  The periodic Hann window and the
//   cosine are even about n/2, the sine odd: with e[t] = x[t] + x[n - t] and
//   o[t] = x[t] - x[n - t] for 0 < t < n/2 (t = 0 and n/2 pair with
//   themselves: e = x, and their sine terms are zero), re[k] = sum_{t<=n/2}
//   e[t] w[t] cos(2 pi t k / n) and im[k] = sum o[t] w[t] sin(...).
// * The second, over the bins.  cos(2 pi t (n/2 - k) / n) = (-1)^t cos(...)
//   and sin(...) = -(-1)^t sin(...), so with the even-t and odd-t halves of
//   each sum, re[k] = Ae + Ao and re[n/2 - k] = Ae - Ao (im likewise, up to
//   a sign that the square drops), for k = 0 .. n/4: a quarter of the
//   unfolded multiply-adds, exact in real arithmetic.
// * The folded, windowed bases are one constant (ops/analysis.py
//   `wide_power_basis`): per tile of 64 base bins and folded depth row u,
//   [w cos at t = 2u | w cos at 2u + 1 | w sin at 2u | w sin at 2u + 1],
//   zero past n/2, past n/4 + 1 bins and in the sine rows of t = 0 and n/2;
//   the depth is padded to a whole number of 16-row chunks (16 KB each, one
//   contiguous span).
// * Tiling.  A CTA of 256 threads owns 64 rows x 64 base bins (128 bins of
//   P); each thread 8 rows x 4 base bins x (Ae, Ao, Be, Bo): 128
//   accumulators, twelve 16-byte shared loads (broadcast across a warp's
//   4 x 8 threads) per 128 FMAs.  Two groups of 128 threads take the two
//   halves of every chunk and their sums are added once in the epilogue
//   (each accumulator sums 128 folded terms).  No depth split across CTAs.
// * Loads overlap the FMAs.  The basis comes by `cp.async.bulk` (one
//   thread, 16 KB a chunk) into a ring of 4 stages on mbarriers, refilled as
//   soon as a chunk is consumed.  The frames must be folded before the
//   product reads them, so they come through registers: each thread loads
//   its 8 + 8 samples of the next chunk (x[t] and x[n - t], a warp's 32
//   consecutive t of one row) before the FMAs of the current chunk, and
//   folds and stores them to the other of two shared buffers after them,
//   transposed to [part][u][rows].
// * Epilogue: the second group parks its sums in shared memory, the first
//   adds them, forms both bins of each pair, squares and writes only P.
// Numerics: float32 FMA, no TF32, no fast math.

#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int BM = 64;               // rows per CTA
constexpr int BB = 64;               // base bins per CTA (128 bins of P)
constexpr int DK = 16;               // folded depth rows per chunk
constexpr int STAGES = 4;            // basis chunks in flight
constexpr int GROUP = 128;           // threads per depth group
constexpr int THREADS = 2 * GROUP;   // two groups: the halves of a chunk
constexpr int LDA = BM + 4;          // floats per staged depth row
constexpr int PART = DK * LDA + 16;  // one of the four staged parts (+16:
                                     // even- and odd-t stores, other banks)
constexpr int CHUNK = DK * 4 * BB;   // floats of one basis chunk

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint64_t* bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(
                   smem_addr(bar)),
               "r"(count)
               : "memory");
}

// One thread: expect `bytes` on `bar` and copy them from global memory.
__device__ __forceinline__ void bulk_load(void* dst, const void* src,
                                          uint32_t bytes, uint64_t* bar) {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::
                   "r"(smem_addr(bar)),
               "r"(bytes)
               : "memory");
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

// acc[i][4 q + j] += a_i b[j] for the rows a0 (0-3), a1 (4-7)
__device__ __forceinline__ void fma_part(float (&acc)[8][16], int q,
                                         float4 a0, float4 a1, float4 b) {
  const float a[8] = {a0.x, a0.y, a0.z, a0.w, a1.x, a1.y, a1.z, a1.w};
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    acc[i][4 * q + 0] = fmaf(a[i], b.x, acc[i][4 * q + 0]);
    acc[i][4 * q + 1] = fmaf(a[i], b.y, acc[i][4 * q + 1]);
    acc[i][4 * q + 2] = fmaf(a[i], b.z, acc[i][4 * q + 2]);
    acc[i][4 * q + 3] = fmaf(a[i], b.w, acc[i][4 * q + 3]);
  }
}

}  // namespace

namespace wide {

// Grid: (tiles of 64 base bins, row tiles of 64).  UD: the basis' folded
// depth (rows u; sample t = 2u or 2u + 1).
__global__ void __launch_bounds__(THREADS, 1)
power_spectrum_kernel(const float* __restrict__ frames,
                      const float* __restrict__ basis,
                      float* __restrict__ out, int R, int n, int K, int UD) {
  extern __shared__ __align__(128) unsigned char smem[];
  float* Bs = reinterpret_cast<float*>(smem);   // [STAGES][DK][4 BB]
  float* As = Bs + STAGES * CHUNK;              // [2][ee, eo, oe, oo][DK][LDA]
  uint64_t* full = reinterpret_cast<uint64_t*>(As + 8 * PART);
  const int tid = threadIdx.x;
  const int half = n / 2, K2 = half / 2 + 1;
  const int bin0 = blockIdx.x * BB, row0 = blockIdx.y * BM;
  const float* B = basis + static_cast<size_t>(blockIdx.x) * UD * 4 * BB;
  const int NC = UD / DK;

  if (tid == 0) {
    for (int s = 0; s < STAGES; ++s) mbar_init(&full[s], 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
    for (int s = 0; s < STAGES && s < NC; ++s)
      bulk_load(Bs + s * CHUNK, B + static_cast<size_t>(s) * CHUNK,
                CHUNK * 4, &full[s]);
  }

  // staging: sample t = 2 DK c + dl of chunk c, rows rq + 8 m
  const int dl = tid % (2 * DK), rq = tid / (2 * DK);
  float xf[8], xb[8];
  auto load = [&](int c) {
    const int t = 2 * DK * c + dl;
    const bool fwd = t <= half, pair = t > 0 && t < half;
#pragma unroll
    for (int m = 0; m < 8; ++m) {
      const int r = row0 + rq + 8 * m;
      // every address valid (clamped), the unused values dropped after
      const float* x = frames + static_cast<size_t>(r < R ? r : 0) * n;
      const float a = __ldg(x + (fwd ? t : 0));
      const float b = __ldg(x + (pair ? n - t : 0));
      xf[m] = r < R && fwd ? a : 0.f;
      xb[m] = r < R && pair ? b : 0.f;
    }
  };
  auto store = [&](int buf) {
    float* E = As + buf * 4 * PART + (dl % 2) * PART + (dl / 2) * LDA + rq;
    float* O = E + 2 * PART;
#pragma unroll
    for (int m = 0; m < 8; ++m) {
      E[8 * m] = xf[m] + xb[m];
      O[8 * m] = xf[m] - xb[m];   // the sine rows of self pairs are zero
    }
  };
  load(0);
  store(0);
  __syncthreads();   // barriers initialised, the first chunk staged

  // product: depth group g; warp tile 4 x 8 threads of 8 rows x 4 base
  // bins, rows 4 ty + (0..3) and 32 + 4 ty + (0..3), base bins 4 tx +
  // (0..3); acc[i][4 q + j], q = Ae, Ao, Be, Bo
  const int g = tid / GROUP, l = tid % GROUP, wg = l / 32, lane = l % 32;
  const int ty = (wg / 2) * 4 + lane / 8, tx = (wg % 2) * 8 + lane % 8;
  float acc[8][16];
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int j = 0; j < 16; ++j) acc[i][j] = 0.f;

  for (int c = 0; c < NC; ++c) {
    if (c + 1 < NC) load(c + 1);
    mbar_wait(&full[c % STAGES], (c / STAGES) & 1);
    const float* A = As + (c & 1) * 4 * PART + g * (DK / 2) * LDA + 4 * ty;
    const float* Bc = Bs + (c % STAGES) * CHUNK + g * (DK / 2) * 4 * BB +
                      4 * tx;
#pragma unroll
    for (int d = 0; d < DK / 2; ++d) {
      const float* a = A + d * LDA;
      const float* b = Bc + d * 4 * BB;
#pragma unroll
      for (int q = 0; q < 4; ++q)
        fma_part(acc, q, *reinterpret_cast<const float4*>(a + q * PART),
                 *reinterpret_cast<const float4*>(a + q * PART + 32),
                 *reinterpret_cast<const float4*>(b + q * BB));
    }
    if (c + 1 < NC) store((c + 1) & 1);
    __syncthreads();   // this chunk's stage and buffer are read no more
    if (tid == 0 && c + STAGES < NC)
      bulk_load(Bs + (c % STAGES) * CHUNK,
                B + static_cast<size_t>(c + STAGES) * CHUNK, CHUNK * 4,
                &full[c % STAGES]);
  }

  // the second group's sums -> shared memory (no copy is in flight), the
  // first adds them, forms bins k and n/2 - k, squares and writes P
  float* red = reinterpret_cast<float*>(smem);  // [128][GROUP]
  if (g == 1) {
#pragma unroll
    for (int i = 0; i < 8; ++i)
#pragma unroll
      for (int j = 0; j < 16; ++j) red[(16 * i + j) * GROUP + l] = acc[i][j];
  }
  __syncthreads();
  if (g != 0) return;
  const bool vec =
      (K2 & 3) == 0 && (reinterpret_cast<uintptr_t>(out) & 15) == 0 &&
      (K & 3) == 0;
  const int k0 = bin0 + 4 * tx;
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const int r = row0 + (i < 4 ? 4 * ty + i : 32 + 4 * ty + i - 4);
    float lo[4], hi[4];
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      float v[4];
#pragma unroll
      for (int q = 0; q < 4; ++q)
        v[q] = acc[i][4 * q + j] + red[(16 * i + 4 * q + j) * GROUP + l];
      const float re0 = v[0] + v[1], im0 = v[2] + v[3];
      const float re1 = v[0] - v[1], im1 = v[2] - v[3];
      lo[j] = re0 * re0 + im0 * im0;
      hi[j] = re1 * re1 + im1 * im1;
    }
    if (r >= R) continue;
    float* o = out + static_cast<size_t>(r) * K;
    if (vec && k0 < K2) {
      *reinterpret_cast<float4*>(o + k0) =
          make_float4(lo[0], lo[1], lo[2], lo[3]);
    } else {
#pragma unroll
      for (int j = 0; j < 4; ++j)
        if (k0 + j < K2) o[k0 + j] = lo[j];
    }
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int k = k0 + j;
      if (k < K2 && half - k != k) o[half - k] = hi[j];
    }
  }
}

}  // namespace wide

// frames [R, n] float32 (n even, 896 < n <= 1024), basis the folded,
// windowed basis of ops/analysis.py `wide_power_basis(n)`, out [R, K].  The
// layout -- rows and base bins per CTA, folded depth rows per chunk -- comes
// from the wrapper's plan (ops/analysis.py `power_plan`) and must be this
// kernel's, or the launch is refused.
extern "C" int power_spectrum_wide_forward(const void* frames,
                                           const void* basis, void* out,
                                           int R, int n, int K, int rows,
                                           int bins, int chunk,
                                           void* stream) {
  if (rows != BM || bins != BB || chunk != DK)
    return static_cast<int>(cudaErrorInvalidValue);
  if (R == 0) return 0;
  if (n % 2 != 0 || n <= 896 || n > 1024 || K != n / 2 + 1)
    return static_cast<int>(cudaErrorInvalidValue);
  const int K2 = n / 4 + 1;
  const int UD = (n / 4 + 1 + DK - 1) / DK * DK;
  const size_t smem =
      static_cast<size_t>(STAGES * CHUNK + 8 * PART) * 4 + STAGES * 8;
  auto kernel = wide::power_spectrum_kernel;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  kernel<<<dim3((K2 + BB - 1) / BB, (R + BM - 1) / BM), THREADS, smem,
           static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(frames), static_cast<const float*>(basis),
      static_cast<float*>(out), R, n, K, UD);
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* power_spectrum_wide_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
