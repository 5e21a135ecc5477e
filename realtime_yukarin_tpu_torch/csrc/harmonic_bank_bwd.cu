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
//   d_phi[r,n]  = g ((1-frac[n]) sum_h h aL c_h + frac[n] sum_h h aR c_h)
//   d_frac[r,n] = g sum_h (aR - aL)[h] s_h
// from the Chebyshev recurrences s_{h+K} = 2 cos(K phi) s_h - s_{h-K} (and
// the same for c), so the [R, hop, H] tensor of sines the plain version
// builds never exists.  `frac` is the one [hop] row every frame shares;
// d_frac is written per row (the wrapper sums it over rows when the caller
// needs it).  With d_phi and d_frac null the kernel computes d_aL and d_aR
// alone, from the sines alone: the launch of a training step, where only
// the amplitudes carry a gradient.
//
// Bound on an H100 SXM: 14 float32 operations (7 FMAs) per (row, sample,
// harmonic): 2 for the d_aL and d_aR partials, 2 for the sine and cosine
// recurrences, 2 for d_phi (h aL and h aR formed once per row), 1 for
// d_frac.  At the training batch's shape (R = 800 rows, hop 120, H = 161)
// that is 216 MFLOP, 3.23 us at 67 TFLOP/s, against 3.6 MB of inputs and
// outputs, 1.1 us at 3.35 TB/s: operations-bound.  The launch of a
// training step (d_aL and d_aR alone) does 3 FMAs: 1.38 us.
//
// The first design (one thread per sample, one block per row) spent its
// time in 2H warp all-reduces per row, ten shuffles per harmonic per warp.
// This design:
// - A warp takes one (row, harmonic segment).  Lane l holds samples
//   n0 + 32 j + l, j < SPL (samples per lane); rows longer than 32 SPL
//   samples run in chunks.  A lane first sums its own samples' terms of
//   d_aL and d_aR with FMAs.
// - Those per-lane partials of each group of 32 harmonics are summed over
//   the lanes through shared memory: each lane writes its (d_aL, d_aR)
//   pair of every harmonic into row h of a [32][68] transpose (one 64-bit
//   store per harmonic), then lane t adds row t in lane order with 128-bit
//   reads and stores harmonic g0 + t: 32 lanes' totals in one coalesced
//   store, deterministic, no atomics.  A transpose butterfly of shuffles
//   (31 per sum per 32 harmonics) was built and measured first: it needs
//   two selects per shuffle and 64 partials in registers (184 registers at
//   4 samples per lane), and on the H100 it ran no faster.
// - Each sample runs K = 4 interleaved pairs of recurrences with the step
//   4 phi (chain m carries harmonics k0 + m, k0 + m + 4, ...): a quarter of
//   the dependent chain and, being a quarter as long, closer to float64
//   than one recurrence over all harmonics (chip_smoke.py prints both
//   versions' distance from float64).  A trip makes
//   two steps with the older and newer values' roles swapped (a
//   leapfrog): the recurrences need no register moves.
// - The row's per-harmonic constants h aL, h aR and aR - aL are staged once
//   per warp in shared memory, in whole trips of 8 harmonics with zeros
//   past the segment, and each trip's are read as float4 broadcasts a trip
//   ahead.
// - A row's harmonics may be split into S segments of whole 32-groups (the
//   last segment also takes H % 32), one warp each, so that small R still
//   fills the card (the wrapper's plan: 3 at R = 100, none at R = 800).
//   A segment starts at its first harmonic k0 from sin and cos of k0 phi.
//   d_phi and d_frac sum over every harmonic: a row's S warps (one block)
//   meet once per chunk in shared memory and warp 0 adds the segments in a
//   fixed order.
// - sin and cos come from a branch-free reduction and polynomial
//   (sincos_reduced below).
// Built WITHOUT --use_fast_math: phi reaches tens of radians and k0 phi
// thousands, where __sinf/__cosf lose accuracy.

#include <cuda_runtime.h>

namespace {

constexpr int WARP = 32;
constexpr int GROUP = 32;        // harmonics per segment unit
constexpr int MAX_WARPS = 8;     // warps per block: one row's segments
constexpr int N_CONST = 3;       // h aL, h aR, aR - aL per harmonic
constexpr int K = 4;             // interleaved recurrences per sample
// floats of zeros past a segment's constants rounded up to whole trips
// of 2K harmonics, for the loads a trip ahead
constexpr int PAD = 8;             // 2 K
// Per warp, the lanes' (d_aL, d_aR) partials of one 32-group of
// harmonics: row t holds harmonic t's pairs for lanes 0..31, LD floats
// apart (64 + 4: the 128-bit reads of 8 lanes hit 32 distinct banks).
constexpr int LD = 2 * WARP + 4;
constexpr int STAGE = 8;         // amplitude loads per lane in flight

// sin and cos of x, branch-free: x = j pi/2 + r with pi/2 in three float
// parts applied by FMA (exact products), |r| <= pi/4, minimax polynomials
// (Cephes' sinf/cosf), then j's quadrant.  Within 9e-8 of float64 for
// |x| <= 2e4 rad (k0 phi stays below 1e4 on the main paths).  sincosf
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

// One step of the K chain pairs of every sample over harmonics
// h .. h + K - 1 (constants x = {h aL, h aR, aR - aL} of those harmonics):
// the sums take the newer sines and cosines `s`, `c`; `so`, `co` become
// the next ones, cK s - so and cK c - co.  Two calls with the arrays'
// roles swapped make two steps with no register moves.  Each harmonic's
// (d_aL, d_aR) partial over the lane's samples goes to row m of the
// transpose rows from red_row0.  Without PHASE (no d_phi, d_frac) only
// the sines and the two partials are computed.
template <int SPL, bool PHASE>
__device__ __forceinline__ void step(
    const float4 (&x)[N_CONST], const float (&cK)[SPL],
    const float (&gl)[SPL], const float (&gr)[SPL], const float (&s)[SPL][K],
    float (&so)[SPL][K], const float (&c)[SPL][K], float (&co)[SPL][K],
    float (&acl)[SPL], float (&acr)[SPL], float (&acf)[SPL],
    float* __restrict__ red_row0, int lane) {
  const float xl[K] = {x[0].x, x[0].y, x[0].z, x[0].w};
  const float xr[K] = {x[1].x, x[1].y, x[1].z, x[1].w};
  const float xd[K] = {x[2].x, x[2].y, x[2].z, x[2].w};
#pragma unroll
  for (int m = 0; m < K; ++m) {
    float2 lr = make_float2(0.0f, 0.0f);
#pragma unroll
    for (int j = 0; j < SPL; ++j) {
      lr.x = fmaf(gl[j], s[j][m], lr.x);
      lr.y = fmaf(gr[j], s[j][m], lr.y);
      so[j][m] = fmaf(cK[j], s[j][m], -so[j][m]);
      if constexpr (PHASE) {
        acl[j] = fmaf(xl[m], c[j][m], acl[j]);
        acr[j] = fmaf(xr[m], c[j][m], acr[j]);
        acf[j] = fmaf(xd[m], s[j][m], acf[j]);
        co[j][m] = fmaf(cK[j], c[j][m], -co[j][m]);
      }
    }
    // harmonics past the segment's end (the last float4's tail) land in
    // rows no lane reads
    *reinterpret_cast<float2*>(red_row0 + m * LD + 2 * lane) = lr;
  }
}

// The constants of harmonics h .. h + K - 1: three float4 broadcasts.
__device__ __forceinline__ void ld_const(const float* kal, int cap, int h,
                                         float4 (&x)[N_CONST]) {
#pragma unroll
  for (int i = 0; i < N_CONST; ++i) {
    x[i] = *reinterpret_cast<const float4*>(kal + i * cap + h);
  }
}

// Segment `seg` of S: whole 32-groups [seg F / S, (seg + 1) F / S) of the
// F = H / 32 full groups; the last segment runs to H.
__device__ __forceinline__ void segment_bounds(int H, int S, int seg,
                                               int& h0, int& h1) {
  const int F = H / GROUP;
  h0 = GROUP * (seg * F / S);
  h1 = seg == S - 1 ? H : GROUP * ((seg + 1) * F / S);
}

// The lane's samples n0 + 32 j + lane of one chunk: phase, cotangent and
// frac, zero past the row's end (so their terms of every sum are zero).
template <int SPL>
__device__ __forceinline__ void load_samples(
    const float* __restrict__ phi, const float* __restrict__ g,
    const float* __restrict__ frac, size_t r, int hop, int n0, int lane,
    float (&p)[SPL], float (&gv)[SPL], float (&f)[SPL]) {
#pragma unroll
  for (int j = 0; j < SPL; ++j) {
    const int n = n0 + j * WARP + lane;
    const bool live = n < hop;
    p[j] = live ? phi[r * hop + n] : 0.0f;
    gv[j] = live ? g[r * hop + n] : 0.0f;
    f[j] = live ? frac[n] : 0.0f;
  }
}

template <int SPL, bool PHASE>
__global__ void __launch_bounds__(MAX_WARPS * WARP)
harmonic_bank_bwd_kernel(const float* __restrict__ amps_l,
                         const float* __restrict__ amps_r,
                         const float* __restrict__ phi,
                         const float* __restrict__ frac,
                         const float* __restrict__ g,
                         float* __restrict__ d_al, float* __restrict__ d_ar,
                         float* __restrict__ d_phi,
                         float* __restrict__ d_frac, int R, int H, int hop,
                         int S, int cap) {
  constexpr int CHUNK = WARP * SPL;
  extern __shared__ float4 smem4[];
  float* smem = reinterpret_cast<float*>(smem4);
  const int warp = threadIdx.x / WARP;
  const int lane = threadIdx.x % WARP;
  const int seg = warp;               // a block is one row's S segments
  const size_t r = blockIdx.x;
  int h0, h1;
  segment_bounds(H, S, seg, h0, h1);
  const int len = h1 - h0;

  // Every global load the first chunk needs is issued before any result
  // is used: one round trip to memory, not one per loop trip.
  float p[SPL], gv[SPL], f[SPL];
  load_samples<SPL>(phi, g, frac, r, hop, 0, lane, p, gv, f);
  // this warp's constants, zero past its segment
  float* kal = smem + warp * N_CONST * cap;
  float* kar = kal + cap;
  float* kd = kar + cap;
  for (int base = 0; PHASE && base < cap; base += STAGE * WARP) {
    float a[STAGE], b[STAGE];
#pragma unroll
    for (int u = 0; u < STAGE; ++u) {
      const int i = base + u * WARP + lane;
      a[u] = i < len ? amps_l[r * H + h0 + i] : 0.0f;
      b[u] = i < len ? amps_r[r * H + h0 + i] : 0.0f;
    }
#pragma unroll
    for (int u = 0; u < STAGE; ++u) {
      const int i = base + u * WARP + lane;
      if (i < cap) {
        const float k = static_cast<float>(h0 + i + 1);
        kal[i] = k * a[u];
        kar[i] = k * b[u];
        kd[i] = b[u] - a[u];
      }
    }
  }
  __syncwarp();
  // this warp's transpose rows [GROUP][LD]
  float* red = smem + S * N_CONST * cap + warp * GROUP * LD;
  // the row's segment partials of d_phi and d_frac: [S][2][CHUNK]
  float* xch = smem + S * (N_CONST * cap + GROUP * LD);
  float* out_l = d_al + r * H + h0;
  float* out_r = d_ar + r * H + h0;

  for (int n0 = 0; n0 < hop; n0 += CHUNK) {
    // K interleaved recurrence pairs per sample: chain m carries the sines
    // and cosines of harmonics k0 + m, k0 + m + K, ... with the step K phi
    float s[SPL][K], sp[SPL][K], c[SPL][K], cp[SPL][K], cK[SPL], gl[SPL],
        gr[SPL], acl[SPL], acr[SPL], acf[SPL];
#pragma unroll
    for (int j = 0; j < SPL; ++j) {
      float s1, c1, sk, ck, sK, cKj;
      sincos_reduced(p[j], s1, c1);
      sincos_reduced(static_cast<float>(K) * p[j], sK, cKj);
      cK[j] = 2.0f * cKj;
      // ws[i], wc[i] = sin, cos((k0 - K + i) phi), i < 2K, by the step-1
      // recurrences both ways from k0 phi
      float ws[2 * K], wc[2 * K];
      if (h0 == 0) {
        sk = s1;
        ck = c1;
        ws[K - 1] = 0.0f;
        wc[K - 1] = 1.0f;
      } else {
        sincos_reduced(static_cast<float>(h0 + 1) * p[j], sk, ck);
        ws[K - 1] = fmaf(sk, c1, -ck * s1);   // sin((k0 - 1) phi)
        wc[K - 1] = fmaf(ck, c1, sk * s1);    // cos((k0 - 1) phi)
      }
      ws[K] = sk;
      wc[K] = ck;
      const float c2 = 2.0f * c1;
#pragma unroll
      for (int i = K + 1; i < 2 * K; ++i) {
        ws[i] = fmaf(c2, ws[i - 1], -ws[i - 2]);
        wc[i] = fmaf(c2, wc[i - 1], -wc[i - 2]);
      }
#pragma unroll
      for (int i = K - 2; i >= 0; --i) {
        ws[i] = fmaf(c2, ws[i + 1], -ws[i + 2]);
        wc[i] = fmaf(c2, wc[i + 1], -wc[i + 2]);
      }
#pragma unroll
      for (int m = 0; m < K; ++m) {
        s[j][m] = ws[K + m];
        sp[j][m] = ws[m];
        c[j][m] = wc[K + m];
        cp[j][m] = wc[m];
      }
      gl[j] = gv[j] * (1.0f - f[j]);
      gr[j] = gv[j] * f[j];
      acl[j] = 0.0f;
      acr[j] = 0.0f;
      acf[j] = 0.0f;
    }
    const bool first = n0 == 0;
    for (int g0 = 0; g0 < len; g0 += GROUP) {
      const int g1 = min(g0 + GROUP, len);
      // whole trips of 2K harmonics (zero constants past the segment; their
      // partials land in rows no lane reads), each trip's constants loaded
      // a trip ahead (the rows carry PAD more zeros)
      float4 x0[N_CONST] = {}, x1[N_CONST] = {}, x2[N_CONST] = {},
             x3[N_CONST] = {};
      if (PHASE) {
        ld_const(kal, cap, g0, x0);
        ld_const(kal, cap, g0 + K, x1);
      }
#pragma unroll 2
      for (int h = g0; h < g1; h += 2 * K) {
        if (PHASE) {
          ld_const(kal, cap, h + 2 * K, x2);
          ld_const(kal, cap, h + 3 * K, x3);
        }
        step<SPL, PHASE>(x0, cK, gl, gr, s, sp, c, cp, acl, acr, acf,
                         red + (h - g0) * LD, lane);
        step<SPL, PHASE>(x1, cK, gl, gr, sp, s, cp, c, acl, acr, acf,
                         red + (h + K - g0) * LD, lane);
#pragma unroll
        for (int i = 0; i < N_CONST; ++i) {
          x0[i] = x2[i];
          x1[i] = x3[i];
        }
      }
      __syncwarp();
      // lane t adds harmonic g0 + t's 32 lane pairs, in lane order
      if (lane < g1 - g0) {
        const float* row_t = red + lane * LD;
        float tl = 0.0f, tr = 0.0f;
#pragma unroll
        for (int q = 0; q < 2 * WARP; q += 4) {
          const float4 v = *reinterpret_cast<const float4*>(row_t + q);
          tl += v.x;
          tr += v.y;
          tl += v.z;
          tr += v.w;
        }
        float* dl = out_l + g0 + lane;
        float* dr = out_r + g0 + lane;
        if (first) {
          *dl = tl;
          *dr = tr;
        } else {   // a later chunk of samples: this lane stored it before
          *dl += tl;
          *dr += tr;
        }
      }
      __syncwarp();   // the next group overwrites the rows
    }

    float vphi[SPL], vfrac[SPL];
#pragma unroll
    for (int j = 0; j < SPL; ++j) {
      vphi[j] = fmaf(f[j], acr[j], (1.0f - f[j]) * acl[j]);
      vfrac[j] = acf[j];
    }
    if (PHASE && S > 1) {
      float* mine = xch + seg * 2 * CHUNK;
#pragma unroll
      for (int j = 0; j < SPL; ++j) {
        mine[j * WARP + lane] = vphi[j];
        mine[CHUNK + j * WARP + lane] = vfrac[j];
      }
      __syncthreads();
      if (seg == 0) {
#pragma unroll
        for (int j = 0; j < SPL; ++j) {
          float a = 0.0f, b = 0.0f;
          for (int t = 0; t < S; ++t) {
            a += xch[t * 2 * CHUNK + j * WARP + lane];
            b += xch[t * 2 * CHUNK + CHUNK + j * WARP + lane];
          }
          vphi[j] = a;
          vfrac[j] = b;
        }
      }
      __syncthreads();   // the next chunk overwrites the exchange
    }
    if (PHASE && seg == 0) {
#pragma unroll
      for (int j = 0; j < SPL; ++j) {
        const int n = n0 + j * WARP + lane;
        if (n < hop) {
          d_phi[r * hop + n] = vphi[j] * gv[j];
          d_frac[r * hop + n] = vfrac[j] * gv[j];
        }
      }
    }
    if (n0 + CHUNK < hop) {
      load_samples<SPL>(phi, g, frac, r, hop, n0 + CHUNK, lane, p, gv, f);
    }
  }
}

template <int SPL, bool PHASE>
cudaError_t launch(const void* amps_l, const void* amps_r, const void* phi,
                   const void* frac, const void* g, void* d_al, void* d_ar,
                   void* d_phi, void* d_frac, int R, int H, int hop, int S,
                   int cap, size_t smem, cudaStream_t stream) {
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        harmonic_bank_bwd_kernel<SPL, PHASE>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
    if (e != cudaSuccess) return e;
  }
  harmonic_bank_bwd_kernel<SPL, PHASE><<<R, S * WARP, smem, stream>>>(
      static_cast<const float*>(amps_l), static_cast<const float*>(amps_r),
      static_cast<const float*>(phi), static_cast<const float*>(frac),
      static_cast<const float*>(g), static_cast<float*>(d_al),
      static_cast<float*>(d_ar), static_cast<float*>(d_phi),
      static_cast<float*>(d_frac), R, H, hop, S, cap);
  return cudaGetLastError();
}

}  // namespace

// spl: samples per lane (1, 2 or 4); segments: warps per row, one block
// per row (1, or at most H / 32).  The wrapper's plan
// (ops/harmonic_bank.py:bank_plan) chooses them; anything else is refused.
extern "C" int harmonic_bank_bwd_forward(const void* amps_l,
                                         const void* amps_r,
                                         const void* phi, const void* frac,
                                         const void* g, void* d_al,
                                         void* d_ar, void* d_phi,
                                         void* d_frac, int R, int H, int hop,
                                         int spl, int segments,
                                         void* stream) {
  if (R == 0) return 0;
  if (H < 1 || hop < 1 || segments < 1 || segments > MAX_WARPS ||
      segments > (H / GROUP > 1 ? H / GROUP : 1)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  int longest = 0;
  for (int seg = 0; seg < segments; ++seg) {
    const int F = H / GROUP;
    const int h0 = GROUP * (seg * F / segments);
    const int h1 =
        seg == segments - 1 ? H : GROUP * ((seg + 1) * F / segments);
    if (h1 - h0 > longest) longest = h1 - h0;
  }
  const int cap = (longest + 2 * K - 1) / (2 * K) * (2 * K) + PAD;
  const size_t smem =
      sizeof(float) *
      (static_cast<size_t>(segments) * (N_CONST * cap + GROUP * LD) +
       (segments > 1 ? static_cast<size_t>(segments) * 2 * WARP * spl : 0));
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  // d_phi and d_frac both null: only d_aL and d_aR (what autograd asks for
  // when the phase and frac need no gradient)
  const bool phase = d_phi != nullptr;
  if ((d_frac != nullptr) != phase) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
#define RY_LAUNCH(SPL_, PHASE_)                                              \
  launch<SPL_, PHASE_>(amps_l, amps_r, phi, frac, g, d_al, d_ar, d_phi,      \
                       d_frac, R, H, hop, segments, cap, smem, st)
  cudaError_t e;
  switch (spl) {
    case 1:
      e = phase ? RY_LAUNCH(1, true) : RY_LAUNCH(1, false);
      break;
    case 2:
      e = phase ? RY_LAUNCH(2, true) : RY_LAUNCH(2, false);
      break;
    case 4:
      e = phase ? RY_LAUNCH(4, true) : RY_LAUNCH(4, false);
      break;
    default:
      e = cudaErrorInvalidValue;
  }
#undef RY_LAUNCH
  return static_cast<int>(e);
}

extern "C" const char* harmonic_bank_bwd_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
