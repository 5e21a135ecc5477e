// Harmonic bank forward for Hopper (sm_90a).
//
// Replaces: realtime_yukarin_tpu/ops/pallas_synth.py `_kernel` (the Pallas
// TPU body launched by `_harmonic_bank_impl`, public `harmonic_bank`).
//
// Computes, per frame row r and sample n (h = 1..H):
//   y[r,n] = (1-frac[n]) * sum_h aL[r,h] sin(h phi[r,n])
//          +    frac[n]  * sum_h aR[r,h] sin(h phi[r,n])
// from the Chebyshev recurrence sin((h+K) phi) = 2 cos(K phi) sin(h phi)
// - sin((h-K) phi): two FMAs for the sums and one for the recurrence per
// harmonic.
//
// Bound on an H100 SXM: 6 float32 operations per (row, sample, harmonic).
// At the streaming step's shape (R = 20 rows, hop 120, H = 161) that is
// ~2.3 MFLOP, ~0.035 us, and ~55 KB: the launch itself dominates.  At the
// training batch's R = 800 it is 92.7 MFLOP, 1.38 us at 67 TFLOP/s, and at
// R = 1280 (64 streams) 2.2 us: operations-bound.
//
// The first design ran one block per row and one thread per sample: a
// single 161-step dependent chain per thread with two shared-memory loads
// per three FMAs.  This design:
// - A warp takes one (row, sample warp).  Lane l holds samples
//   n0 + 32 j + l, j < SPL (samples per lane); sample warp t of T takes the
//   row's chunks of 32 SPL samples t, t + T, ...  The wrapper's plan gives
//   small R one warp per 32 samples (R = 20: 80 warps, each a 41-step
//   chain) and large R 4 samples per lane (R = 800: 800 warps).  Splitting
//   a row's harmonics over warps instead, which needs their sums to meet in
//   shared memory, was slower at every R measured on the H100.
// - Each sample runs K = 4 interleaved recurrences with the step 4 phi
//   (chain m carries harmonics m + 1, m + 5, ...): a quarter of the
//   dependent chain, 4 x the independent FMAs, and, being a quarter as
//   long, closer to float64 than one recurrence over all harmonics
//   (chip_smoke.py prints both versions' distance from float64).
//   A trip makes two steps with the older and newer sines' roles swapped
//   (a leapfrog), so the recurrence needs no register moves.
// - The amplitudes are staged once per warp in shared memory, in whole
//   trips of 8 harmonics with zeros past H, and each trip's are
//   read as float4 broadcasts a trip ahead: one load serves the K chains x
//   the lane's samples, and no trip waits on shared memory.
// - Every global load a warp needs is issued before the first is used, and
//   sin and cos come from a branch-free reduction and polynomial
//   (sincos_reduced below) rather than sincosf, whose inlined slow path
//   for huge arguments lengthened every launch on the H100.
// Left and right sums stay separate until one lerp per sample: the
// [R, hop, H] interpolated amplitude tensor of the plain version never
// exists.  `frac` is the one [hop] row every frame shares.  Built WITHOUT --use_fast_math:
// phi reaches tens of radians, where __sinf/__cosf lose accuracy.

#include <cuda_runtime.h>

namespace {

constexpr int WARP = 32;
constexpr int MAX_WARPS = 16;    // warps per block (rows x sample warps):
                                 // up to 128 registers a thread
constexpr int N_CONST = 2;       // aL, aR per harmonic
constexpr int K = 4;             // interleaved recurrences per sample
// floats of zeros past the amplitudes rounded up to whole trips of 2K
// harmonics, for the loads a trip ahead
constexpr int PAD = 8;           // 2 K
constexpr int STAGE = 8;         // amplitude loads per lane in flight

// The lane's samples n0 + 32 j + lane of one chunk: phase and frac, zero
// past the row's end.
template <int SPL>
__device__ __forceinline__ void load_samples(
    const float* __restrict__ phi, const float* __restrict__ frac, size_t r,
    int hop, int n0, int lane, float (&p)[SPL], float (&f)[SPL]) {
#pragma unroll
  for (int j = 0; j < SPL; ++j) {
    const int n = n0 + j * WARP + lane;
    p[j] = n < hop ? phi[r * hop + n] : 0.0f;
    f[j] = n < hop ? frac[n] : 0.0f;
  }
}

// sin and cos of x, branch-free: x = j pi/2 + r with pi/2 in three float
// parts applied by FMA (exact products), |r| <= pi/4, minimax polynomials
// (Cephes' sinf/cosf), then j's quadrant.  Within 9e-8 of float64 for
// |x| <= 2e4 rad (4 phi stays below 200 on the main paths).  sincosf
// gives the same accuracy but inlines a Payne-Hanek path for huge
// arguments at every call site.
__device__ __forceinline__ void sincos_reduced(float x, float& sx,
                                               float& cx) {
  const float j = rintf(x * 0.636619747f);
  float r = fmaf(j, -1.57079637e+00f, x);
  r = fmaf(j, 4.37113883e-08f, r);
  r = fmaf(j, 1.71512451e-15f, r);
  const float z = r * r;
  const float s = fmaf(fmaf(fmaf(-1.9515295891e-4f, z, 8.3321608736e-3f), z,
                            -1.6666654611e-1f), z * r, r);
  const float c = fmaf(fmaf(fmaf(2.443315711809948e-5f, z,
                                 -1.388731625493765e-3f), z,
                            4.166664568298827e-2f), z * z,
                       fmaf(-0.5f, z, 1.0f));
  const int q = static_cast<int>(j) & 3;
  const float ss = (q & 1) ? c : s;
  const float cc = (q & 1) ? s : c;
  sx = (q & 2) ? -ss : ss;
  cx = ((q + 1) & 2) ? -cc : cc;
}

// One step of the K chains of every sample over harmonics h .. h + K - 1
// (amplitudes a, b): the sums take the newer sines `cur`, and `old`
// becomes the next ones, cK cur - old.  Two calls with the arrays' roles
// swapped make two steps with no register moves.
template <int SPL>
__device__ __forceinline__ void step(const float4 a, const float4 b,
                                     const float (&cK)[SPL],
                                     const float (&cur)[SPL][K],
                                     float (&old)[SPL][K],
                                     float (&acc_l)[SPL][K],
                                     float (&acc_r)[SPL][K]) {
  const float av[K] = {a.x, a.y, a.z, a.w};
  const float bv[K] = {b.x, b.y, b.z, b.w};
#pragma unroll
  for (int j = 0; j < SPL; ++j) {
#pragma unroll
    for (int m = 0; m < K; ++m) {
      acc_l[j][m] = fmaf(av[m], cur[j][m], acc_l[j][m]);
      acc_r[j][m] = fmaf(bv[m], cur[j][m], acc_r[j][m]);
      old[j][m] = fmaf(cK[j], cur[j][m], -old[j][m]);
    }
  }
}

__device__ __forceinline__ float4 ld4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}

template <int SPL>
__global__ void __launch_bounds__(MAX_WARPS * WARP)
harmonic_bank_kernel(const float* __restrict__ amps_l,
                     const float* __restrict__ amps_r,
                     const float* __restrict__ phi,
                     const float* __restrict__ frac, float* __restrict__ out,
                     int R, int H, int hop, int T, int cap) {
  constexpr int CHUNK = WARP * SPL;
  extern __shared__ float4 smem4[];
  float* smem = reinterpret_cast<float*>(smem4);
  const int warp = threadIdx.x / WARP;
  const int lane = threadIdx.x % WARP;
  // warp = row_local * T + t
  const int t = warp % T;
  const int row = blockIdx.x * (blockDim.x / WARP / T) + warp / T;
  if (row >= R) return;   // the last block's spare warps (no barriers here)
  const size_t r = row;

  // Every global load the first chunk needs is issued before any result
  // is used: one round trip to memory, not one per loop trip.
  float p[SPL], f[SPL];
  load_samples<SPL>(phi, frac, r, hop, t * CHUNK, lane, p, f);
  // this warp's amplitudes, zero past H
  float* al = smem + warp * N_CONST * cap;
  float* ar = al + cap;
  for (int base = 0; base < cap; base += STAGE * WARP) {
    float a[STAGE], b[STAGE];
#pragma unroll
    for (int u = 0; u < STAGE; ++u) {
      const int i = base + u * WARP + lane;
      a[u] = i < H ? amps_l[r * H + i] : 0.0f;
      b[u] = i < H ? amps_r[r * H + i] : 0.0f;
    }
#pragma unroll
    for (int u = 0; u < STAGE; ++u) {
      const int i = base + u * WARP + lane;
      if (i < cap) {
        al[i] = a[u];
        ar[i] = b[u];
      }
    }
  }
  __syncwarp();

  for (int n0 = t * CHUNK; n0 < hop; n0 += T * CHUNK) {
    // K interleaved recurrences per sample: chain m carries harmonics
    // m + 1, m + 1 + K, ... with the step K phi
    float s[SPL][K], sp[SPL][K], cK[SPL], acc_l[SPL][K], acc_r[SPL][K];
#pragma unroll
    for (int j = 0; j < SPL; ++j) {
      float s1, c1, sK, cKj;
      sincos_reduced(p[j], s1, c1);
      sincos_reduced(static_cast<float>(K) * p[j], sK, cKj);
      cK[j] = 2.0f * cKj;
      // w[i] = sin((1 - K + i) phi), i < 2K, by the step-1 recurrence
      // both ways from sin(0) = 0 and sin(phi)
      float w[2 * K];
      w[K - 1] = 0.0f;
      w[K] = s1;
      const float c2 = 2.0f * c1;
#pragma unroll
      for (int i = K + 1; i < 2 * K; ++i) w[i] = fmaf(c2, w[i - 1], -w[i - 2]);
#pragma unroll
      for (int i = K - 2; i >= 0; --i) w[i] = fmaf(c2, w[i + 1], -w[i + 2]);
#pragma unroll
      for (int m = 0; m < K; ++m) {
        s[j][m] = w[K + m];
        sp[j][m] = w[m];
        acc_l[j][m] = 0.0f;
        acc_r[j][m] = 0.0f;
      }
    }
    // whole trips of 2K harmonics (zero amplitudes past H), each trip's
    // amplitudes loaded a trip ahead (the rows carry PAD more zeros)
    float4 a0 = ld4(al), b0 = ld4(ar), a1 = ld4(al + K), b1 = ld4(ar + K);
#pragma unroll 2
    for (int h = 0; h < H; h += 2 * K) {
      const float4 a2 = ld4(al + h + 2 * K), b2 = ld4(ar + h + 2 * K);
      const float4 a3 = ld4(al + h + 3 * K), b3 = ld4(ar + h + 3 * K);
      step<SPL>(a0, b0, cK, s, sp, acc_l, acc_r);
      step<SPL>(a1, b1, cK, sp, s, acc_l, acc_r);
      a0 = a2;
      b0 = b2;
      a1 = a3;
      b1 = b3;
    }
#pragma unroll
    for (int j = 0; j < SPL; ++j) {
      const int n = n0 + j * WARP + lane;
      const float yl =
          (acc_l[j][0] + acc_l[j][1]) + (acc_l[j][2] + acc_l[j][3]);
      const float yr =
          (acc_r[j][0] + acc_r[j][1]) + (acc_r[j][2] + acc_r[j][3]);
      if (n < hop) out[r * hop + n] = yl * (1.0f - f[j]) + yr * f[j];
    }
    if (n0 + T * CHUNK < hop) {
      load_samples<SPL>(phi, frac, r, hop, n0 + T * CHUNK, lane, p, f);
    }
  }
}

template <int SPL>
cudaError_t launch(const void* amps_l, const void* amps_r, const void* phi,
                   const void* frac, void* out, int R, int H, int hop, int T,
                   int rows, int cap, size_t smem, cudaStream_t stream) {
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        harmonic_bank_kernel<SPL>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
    if (e != cudaSuccess) return e;
  }
  const int blocks = (R + rows - 1) / rows;
  harmonic_bank_kernel<SPL><<<blocks, rows * T * WARP, smem, stream>>>(
      static_cast<const float*>(amps_l), static_cast<const float*>(amps_r),
      static_cast<const float*>(phi), static_cast<const float*>(frac),
      static_cast<float*>(out), R, H, hop, T, cap);
  return cudaGetLastError();
}

}  // namespace

// spl: samples per lane (1, 2 or 4); sample_warps: warps that split a
// row's chunks of 32 spl samples; rows: rows per block.  The wrapper's plan
// (ops/harmonic_bank.py:bank_plan) chooses them; anything else is refused.
extern "C" int harmonic_bank_forward(const void* amps_l, const void* amps_r,
                                     const void* phi, const void* frac,
                                     void* out, int R, int H, int hop,
                                     int spl, int sample_warps, int rows,
                                     void* stream) {
  if (R == 0) return 0;
  if (H < 1 || hop < 1 || sample_warps < 1 || rows < 1 ||
      sample_warps * rows > MAX_WARPS ||
      (sample_warps - 1) * WARP * spl >= hop) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const int cap = (H + 2 * K - 1) / (2 * K) * (2 * K) + PAD;
  const size_t smem = sizeof(float) * static_cast<size_t>(sample_warps) *
                      rows * N_CONST * cap;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  cudaError_t e;
  switch (spl) {
    case 1:
      e = launch<1>(amps_l, amps_r, phi, frac, out, R, H, hop, sample_warps,
                    rows, cap, smem, st);
      break;
    case 2:
      e = launch<2>(amps_l, amps_r, phi, frac, out, R, H, hop, sample_warps,
                    rows, cap, smem, st);
      break;
    case 4:
      e = launch<4>(amps_l, amps_r, phi, frac, out, R, H, hop, sample_warps,
                    rows, cap, smem, st);
      break;
    default:
      e = cudaErrorInvalidValue;
  }
  return static_cast<int>(e);
}

extern "C" const char* harmonic_bank_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
