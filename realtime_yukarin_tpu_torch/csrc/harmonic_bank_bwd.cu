// Harmonic bank backward for Hopper (sm_90a).
//
// Replaces: realtime_yukarin_tpu/ops/pallas_synth.py `_bwd_kernel` (the
// Pallas TPU body launched by `_harmonic_bank_bwd_impl`, the custom VJP
// `_hb_bwd` of `harmonic_bank`).
//
// Given the forward's inputs and the output cotangent g[r,n], computes per
// frame row r and sample n, with s_h = sin(h phi[r,n]), c_h = cos(h phi[r,n])
// and h = 1..H:
//   d_aL[r,h]   = sum_n g (1-frac[n]) s_h
//   d_aR[r,h]   = sum_n g frac[n] s_h
//   d_phi[r,n]  = g sum_h lerp(aL, aR)[h] h c_h
//   d_frac[r,n] = g sum_h (aR - aL)[h] s_h
// from ONE sincosf per sample and the Chebyshev recurrences
//   s_{h+1} = 2c s_h - s_{h-1},   c_{h+1} = 2c c_h - c_{h-1},
// so the [R, hop, H] tensor of sines the plain version builds never exists.
// `frac` is the one [hop] row every frame shares; d_frac is written per row
// (the wrapper sums it over rows when the caller needs it).
//
// Bound on an H100 SXM: ~15 float32 operations per (row, sample, harmonic)
// (two FMAs for the amplitude sums, two for the recurrences, one for the
// lerp, a multiply and an FMA for d_phi, one FMA for d_frac).  At the
// training batch's shape (R = 800 rows, hop 120, H = 161) that is 232 MFLOP,
// 3.5 us at 67 TFLOP/s, against 3.6 MB of inputs and outputs, 1.1 us at
// 3.35 TB/s: operations-bound.
//
// Simple design: one block per frame row, one thread per sample (hop <=
// 1024).  The row's left and right amplitudes are staged once in shared
// memory (every thread reads the same h: broadcasts).  Each thread carries
// s and c in registers and accumulates d_phi and d_frac.  The two sums over
// samples for each harmonic are warp-shuffle reductions; lane 0 of each warp
// stores its warp's partial in shared memory ([warps][2][H]), and after the
// harmonic loop the block adds the warps' partials and writes d_aL and d_aR
// once.  The 2H warp reductions (ten shuffles per harmonic per warp), not
// the FMAs, set its time.  Built WITHOUT --use_fast_math: phi reaches tens
// of radians, where __sinf/__cosf lose accuracy.

#include <cuda_runtime.h>

namespace {

__global__ void harmonic_bank_bwd_kernel(const float* __restrict__ amps_l,
                                         const float* __restrict__ amps_r,
                                         const float* __restrict__ phi,
                                         const float* __restrict__ frac,
                                         const float* __restrict__ g,
                                         float* __restrict__ d_al,
                                         float* __restrict__ d_ar,
                                         float* __restrict__ d_phi,
                                         float* __restrict__ d_frac,
                                         int H, int hop) {
  extern __shared__ float smem[];
  float* al = smem;                        // [H]
  float* ar = smem + H;                    // [H]
  float* part = smem + 2 * H;              // [warps][2][H] warp partials
  const int warps = blockDim.x / 32;
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const size_t r = blockIdx.x;
  for (int h = threadIdx.x; h < H; h += blockDim.x) {
    al[h] = amps_l[r * H + h];
    ar[h] = amps_r[r * H + h];
  }
  __syncthreads();

  // threads past the row's end contribute zeros to the warp sums
  const int n = threadIdx.x;
  const bool live = n < hop;
  float s_cur = 0.0f, c_cur = 1.0f, gv = 0.0f, f = 0.0f;
  if (live) {
    sincosf(phi[r * hop + n], &s_cur, &c_cur);
    gv = g[r * hop + n];
    f = frac[n];
  }
  const float c2 = 2.0f * c_cur;
  const float gl = gv * (1.0f - f);
  const float gr = gv * f;
  float s_prev = 0.0f, c_prev = 1.0f, acc_phi = 0.0f, acc_frac = 0.0f;
  float* part_l = part + warp * 2 * H;
  float* part_r = part_l + H;
  for (int h = 0; h < H; ++h) {
    float pl = gl * s_cur;
    float pr = gr * s_cur;
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) {
      pl += __shfl_xor_sync(0xffffffffu, pl, off);
      pr += __shfl_xor_sync(0xffffffffu, pr, off);
    }
    if (lane == 0) {
      part_l[h] = pl;
      part_r[h] = pr;
    }
    const float a_l = al[h];
    const float a_r = ar[h];
    const float a_inst = fmaf(a_r, f, a_l * (1.0f - f));
    acc_phi = fmaf(a_inst * static_cast<float>(h + 1), c_cur, acc_phi);
    acc_frac = fmaf(a_r - a_l, s_cur, acc_frac);
    const float s_next = fmaf(c2, s_cur, -s_prev);
    const float c_next = fmaf(c2, c_cur, -c_prev);
    s_prev = s_cur;
    s_cur = s_next;
    c_prev = c_cur;
    c_cur = c_next;
  }
  if (live) {
    d_phi[r * hop + n] = acc_phi * gv;
    d_frac[r * hop + n] = acc_frac * gv;
  }
  __syncthreads();
  for (int h = threadIdx.x; h < H; h += blockDim.x) {
    float sl = 0.0f, sr = 0.0f;
    for (int w = 0; w < warps; ++w) {
      sl += part[w * 2 * H + h];
      sr += part[w * 2 * H + H + h];
    }
    d_al[r * H + h] = sl;
    d_ar[r * H + h] = sr;
  }
}

}  // namespace

extern "C" int harmonic_bank_bwd_forward(const void* amps_l,
                                         const void* amps_r,
                                         const void* phi, const void* frac,
                                         const void* g, void* d_al,
                                         void* d_ar, void* d_phi,
                                         void* d_frac, int R, int H, int hop,
                                         void* stream) {
  if (R == 0) return 0;
  // hop <= 1024 (one thread per sample) is checked by the Python wrapper
  const int threads = ((hop + 31) / 32) * 32;
  const size_t smem = (2 + 2 * static_cast<size_t>(threads / 32))
                      * static_cast<size_t>(H) * sizeof(float);
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        harmonic_bank_bwd_kernel,
        cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  harmonic_bank_bwd_kernel<<<R, threads, smem,
                             static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(amps_l), static_cast<const float*>(amps_r),
      static_cast<const float*>(phi), static_cast<const float*>(frac),
      static_cast<const float*>(g), static_cast<float*>(d_al),
      static_cast<float*>(d_ar), static_cast<float*>(d_phi),
      static_cast<float*>(d_frac), H, hop);
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* harmonic_bank_bwd_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
