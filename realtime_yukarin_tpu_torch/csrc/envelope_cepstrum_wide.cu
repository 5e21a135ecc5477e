// Envelope cepstrum (the CheapTrick-role quefrency chain) for Hopper
// (sm_90a), the batch-width design.
//
// Replaces: realtime_yukarin_tpu/ops/pallas_analysis.py `_cepstrum_kernel`
// (launched by `_cepstrum_fused_rows`, public `envelope_cepstrum_fused`) at
// and above ops/analysis.py `CEPSTRUM_WIDE_ROWS` rows; below it
// csrc/envelope_cepstrum.cu (the cluster design) takes the call.
//
// Computes, per row of the power spectrogram P [R, K] with its lifter
// lift [R, K] (n = 2 (K - 1)), with M[a][b] = u[a] cos(2 pi a b / n),
// u = 1 at a = 0 and a = n/2 and 2 between (ops/dft.py: the cepstrum basis
// is M / n, the inverse cepstrum basis M):
//   Ps  = ((P @ M / n) * lift) @ M                  pitch-adaptive smoothing
//   L   = log(max(Ps, max(rowmax(Ps) * gain, power_floor)))
//   out = (L @ M / n) * lift                        lifted half cepstrum
//
// Bound on an H100 SXM (the unfolded count of ops/analysis.py
// `envelope_cepstrum_cost`, 6 R K^2 FLOP): at the 20 ms profile's 512 lanes
// (R = 2,048 rows of K = 512) ~3.22 GFLOP, ~48 us of float32 FMA; at the
// default profile's 512 lanes (R = 10,240) ~16.1 GFLOP, ~240 us.  The fold
// below does half of those multiply-adds, so its own floor is half of each.
//
// Design: one radix-2 fold per product, then a register-blocked float32
// GEMM, the whole chain of a row group in one CTA.  (Unlike the power
// spectrum's, M's output symmetry b <-> n/2 - b pairs an even column with
// an odd one at n = 1022, which the fold above already uses: one fold is
// all it has.)
// * The fold.  M is even or odd about a = n/4 by the parity of the output
//   index: M[n/2 - a][b] = (-1)^b M[a][b].  So with S[a] = x[a] + x[n/2 - a]
//   and D[a] = x[a] - x[n/2 - a] for a < n/2 - a (S[a] = x[a], D[a] = 0 at
//   the self-paired a = n/4 when n/4 is whole), an even output column is
//   sum_{a <= n/4} S[a] M[a][b] and an odd one sum D[a] M[a][b]: half the
//   depth of each product, exact in real arithmetic.  The folded basis is
//   one constant (ops/analysis.py `wide_cepstrum_basis`): per folded depth
//   row a, the even columns' M[a][2j] then the odd ones' M[a][2j + 1], each
//   padded to NE = 64 x the warps of a group (256 at K = 512, 320 at
//   K = 513), the depth padded to QD (a multiple of 16; 256 at K = 512),
//   zero past K, past n/4 and in the odd row of the self pair.
// * A CTA owns 32 rows and every column, in two groups of 4 warps (5 at
//   K = 513) that take the two halves of every depth chunk.  Thread (row
//   group rg, column group cg) holds 8 rows x (8 even + 8 odd columns) =
//   128 accumulators: eight 16-byte shared loads (broadcast within a warp)
//   per 128 FMAs.  After each product the groups exchange halves through
//   shared memory, so that each finishes 16 rows whole (each sum is the
//   two groups' 128-term halves added once).  The row group's
//   intermediates never leave the CTA: Y [K][32] holds P, then each
//   product's output, in shared memory (64 KB at K = 512), and a fold pass
//   turns it into S (in place) and D [QD][32] before each product.  Y is
//   stored k-major with an XOR swizzle of the row index by (k ^ k / 8)
//   mod 8, so that the product's row reads, the epilogues' 16-byte stores
//   and P's transposing load are all free of bank conflicts.
// * Loads overlap the FMAs.  The basis (512 KB at K = 512, shared by the
//   three products and every CTA, so it stays in L2) streams through a ring
//   of 3 stages of 16 depth rows (32 KB each) by `cp.async.bulk` on
//   mbarriers; the ring runs on across the three products, so the next
//   product's first chunks land during an epilogue and a fold.  P's rows
//   arrive 16 loads in flight per thread.
// * Between the products: the lifter (each group reads its 16 rows' values
//   from device memory, all loads in flight at once), the row maxima (a
//   shared-memory reduction over the warps), the floor and the log, each
//   one pass over Y.
// One launch for the whole chain, as the cluster design: R = 10,240 rows
// make 320 CTAs, one per SM at a time (shared memory), so three rounds.
// Numerics: float32 FMA, no TF32, no fast math; each accumulator sums 128
// folded terms (the cluster design's depth warps sum 256 each, then add 2).

#include <cfloat>
#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int BM = 32;        // rows per CTA (the swizzle spans 32 rows)
constexpr int DK = 16;        // folded depth rows per chunk
constexpr int STAGES = 3;     // basis chunks in flight
constexpr int CPW = 64;       // even (and odd) columns per warp of a group

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

// the swizzled row offset of row r in depth (or column) row k of Y and D
__device__ __forceinline__ int swz(int k, int r) {
  return r ^ (((k ^ (k >> 3)) & 7) << 2);
}

__device__ __forceinline__ int yidx(int k, int r) {
  return k * BM + swz(k, r);
}

// acc[i][2 j] += s_i e[j], acc[i][2 j + 1] += d_i o[j]: 8 rows, 4 even
// and 4 odd columns (one block of a thread's two)
__device__ __forceinline__ void fma_block(float (&acc)[8][16], int b,
                                          const float (&s)[8],
                                          const float (&d)[8], float4 e,
                                          float4 o) {
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    acc[i][8 * b + 0] = fmaf(s[i], e.x, acc[i][8 * b + 0]);
    acc[i][8 * b + 2] = fmaf(s[i], e.y, acc[i][8 * b + 2]);
    acc[i][8 * b + 4] = fmaf(s[i], e.z, acc[i][8 * b + 4]);
    acc[i][8 * b + 6] = fmaf(s[i], e.w, acc[i][8 * b + 6]);
    acc[i][8 * b + 1] = fmaf(d[i], o.x, acc[i][8 * b + 1]);
    acc[i][8 * b + 3] = fmaf(d[i], o.y, acc[i][8 * b + 3]);
    acc[i][8 * b + 5] = fmaf(d[i], o.z, acc[i][8 * b + 5]);
    acc[i][8 * b + 7] = fmaf(d[i], o.w, acc[i][8 * b + 7]);
  }
}

// NWG warps per depth group, two groups (the halves of every chunk).
// Thread (group g, row group rg, column group cg): rows 4 rg + (0..3) and
// 16 + 4 rg + (0..3); output columns k = 8 NCG b + 8 cg + kk, b = 0, 1,
// kk = 0 .. 7 (even kk from S, odd from D), held as acc[i][8 b + kk].
template <int NWG>
struct Chain {
  static constexpr int GROUP = 32 * NWG;       // threads per depth group
  static constexpr int THREADS = 2 * GROUP;
  static constexpr int NW = 2 * NWG;           // warps
  static constexpr int NCG = 8 * NWG;          // column groups
  static constexpr int NE = 8 * NCG;           // even (odd) columns
  static constexpr int CHUNK = DK * 2 * NE;    // floats of one basis chunk

  float* Bs;            // [STAGES][DK][2 NE]
  float* Y;             // [K][BM], swizzled
  float* Dq;            // [QD][BM], swizzled
  uint64_t* full;       // [STAGES]
  const float* F;       // the folded basis [QD][2 NE]
  int K, half, QD, NQ;
  int g;                // chunks consumed so far (the ring's position)

  // One thread: the basis chunk that ring position `pos` takes.
  __device__ void issue(int pos) const {
    bulk_load(Bs + (pos % STAGES) * CHUNK,
              F + static_cast<size_t>(pos % NQ) * CHUNK, CHUNK * 4,
              &full[pos % STAGES]);
  }

  // Y -> S (in place) and D, for every folded depth row
  __device__ void fold() const {
    const int r = threadIdx.x % 32;
    for (int q = threadIdx.x / 32; q < QD; q += NW) {
      const int p = half - q;
      if (q < p) {
        const float a = Y[yidx(q, r)], b = Y[yidx(p, r)];
        Y[yidx(q, r)] = a + b;
        Dq[yidx(q, r)] = a - b;
      } else {
        Dq[yidx(q, r)] = 0.f;   // the self pair, and depth past n/4
      }
    }
  }

  // This group's half of the product.  Ends with every thread past it (a
  // barrier).
  __device__ void product(float (&acc)[8][16], int grp, int rg, int cg) {
#pragma unroll
    for (int i = 0; i < 8; ++i)
#pragma unroll
      for (int j = 0; j < 16; ++j) acc[i][j] = 0.f;
    for (int c = 0; c < NQ; ++c, ++g) {
      mbar_wait(&full[g % STAGES], (g / STAGES) & 1);
      const float* Bc = Bs + (g % STAGES) * CHUNK + 4 * cg;
#pragma unroll
      for (int dd = 0; dd < DK / 2; ++dd) {
        const int d = (DK / 2) * grp + dd, q = c * DK + d;
        const int o0 = swz(q, 4 * rg), o1 = o0 ^ 16;
        const float* Sq = Y + q * BM;
        const float* Dd = Dq + q * BM;
        const float4 s0 = *reinterpret_cast<const float4*>(Sq + o0);
        const float4 s1 = *reinterpret_cast<const float4*>(Sq + o1);
        const float4 d0 = *reinterpret_cast<const float4*>(Dd + o0);
        const float4 d1 = *reinterpret_cast<const float4*>(Dd + o1);
        const float* B = Bc + d * 2 * NE;
        const float4 e0 = *reinterpret_cast<const float4*>(B);
        const float4 e1 = *reinterpret_cast<const float4*>(B + 4 * NCG);
        const float4 f0 = *reinterpret_cast<const float4*>(B + NE);
        const float4 f1 = *reinterpret_cast<const float4*>(B + NE + 4 * NCG);
        const float s[8] = {s0.x, s0.y, s0.z, s0.w, s1.x, s1.y, s1.z, s1.w};
        const float dv[8] = {d0.x, d0.y, d0.z, d0.w, d1.x, d1.y, d1.z, d1.w};
        fma_block(acc, 0, s, dv, e0, f0);
        fma_block(acc, 1, s, dv, e1, f1);
      }
      __syncthreads();   // this stage is read no more
      if (threadIdx.x == 0 && g + STAGES < 3 * NQ) issue(g + STAGES);
    }
  }

  // Y's 16-byte slot of rows 16 h + 4 rg .. + 3 at column k
  __device__ float4* slot(int k, int h, int rg) const {
    return reinterpret_cast<float4*>(Y + k * BM + swz(k, 16 * h + 4 * rg));
  }

  // Y[k][rows 16 H + 4 rg .. + 3] = acc's rows 4 H .. 4 H + 3 (k < K)
  template <int H>
  __device__ void park_half(const float (&acc)[8][16], int rg,
                            int cg) const {
#pragma unroll
    for (int b = 0; b < 2; ++b)
#pragma unroll
      for (int kk = 0; kk < 8; ++kk) {
        const int k = 8 * NCG * b + 8 * cg + kk;
        if (k < K)
          *slot(k, H, rg) = make_float4(
              acc[4 * H][8 * b + kk], acc[4 * H + 1][8 * b + kk],
              acc[4 * H + 2][8 * b + kk], acc[4 * H + 3][8 * b + kk]);
      }
  }

  // acc's rows 4 H .. 4 H + 3 += what Y holds for them (k < K)
  template <int H>
  __device__ void add_half(float (&acc)[8][16], int rg, int cg) const {
#pragma unroll
    for (int b = 0; b < 2; ++b)
#pragma unroll
      for (int kk = 0; kk < 8; ++kk) {
        const int k = 8 * NCG * b + 8 * cg + kk;
        if (k < K) {
          const float4 v = *slot(k, H, rg);
          acc[4 * H][8 * b + kk] += v.x;
          acc[4 * H + 1][8 * b + kk] += v.y;
          acc[4 * H + 2][8 * b + kk] += v.z;
          acc[4 * H + 3][8 * b + kk] += v.w;
        }
      }
  }

  // The two groups' halves of the product, summed: each group parks the
  // rows the other finishes, then adds the other's share of its own rows
  // (the first group finishes rows 4 rg + (0..3), the second 16 + those).
  __device__ void exchange(float (&acc)[8][16], int grp, int rg,
                           int cg) const {
    if (grp == 0)
      park_half<1>(acc, rg, cg);
    else
      park_half<0>(acc, rg, cg);
    __syncthreads();
    if (grp == 0)
      add_half<0>(acc, rg, cg);
    else
      add_half<1>(acc, rg, cg);
  }
};

// acc's rows 4 H .. 4 H + 3 *= scale * lift at (row 16 H + 4 rg + i,
// column 8 NCG b + 8 cg + kk), the lifter's loads all in flight at once;
// with `out`, the products are written there (rows < R, columns < K)
template <int H, int NCG>
__device__ __forceinline__ void lifted(float (&acc)[8][16],
                                       const float* __restrict__ lift,
                                       float* __restrict__ out, float scale,
                                       int R, int K, int row0, int rg, int cg,
                                       bool vec) {
  float lf[4][16];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int r = row0 + 16 * H + 4 * rg + i;
    const size_t base = static_cast<size_t>(r < R ? r : 0) * K;
#pragma unroll
    for (int b = 0; b < 2; ++b) {
      const int k0 = 8 * NCG * b + 8 * cg;
      // every address valid (clamped), the unused values dropped after
      if (vec) {
        const float4* src = reinterpret_cast<const float4*>(
            lift + base + (k0 < K ? k0 : 0));
        const float4 x = __ldg(src), y = __ldg(src + 1);
        lf[i][8 * b] = x.x;
        lf[i][8 * b + 1] = x.y;
        lf[i][8 * b + 2] = x.z;
        lf[i][8 * b + 3] = x.w;
        lf[i][8 * b + 4] = y.x;
        lf[i][8 * b + 5] = y.y;
        lf[i][8 * b + 6] = y.z;
        lf[i][8 * b + 7] = y.w;
      } else {
#pragma unroll
        for (int kk = 0; kk < 8; ++kk)
          lf[i][8 * b + kk] =
              __ldg(lift + base + (k0 + kk < K ? k0 + kk : 0));
      }
    }
  }
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int r = row0 + 16 * H + 4 * rg + i;
    float* a = acc[4 * H + i];
#pragma unroll
    for (int b = 0; b < 2; ++b) {
      const int k0 = 8 * NCG * b + 8 * cg;
#pragma unroll
      for (int kk = 0; kk < 8; ++kk) {
        const bool in = r < R && k0 + kk < K;
        a[8 * b + kk] *= scale * (in ? lf[i][8 * b + kk] : 0.f);
      }
      if (out == nullptr || r >= R || k0 >= K) continue;
      float* o = out + static_cast<size_t>(r) * K + k0;
      if (vec) {
        reinterpret_cast<float4*>(o)[0] =
            make_float4(a[8 * b], a[8 * b + 1], a[8 * b + 2], a[8 * b + 3]);
        reinterpret_cast<float4*>(o)[1] = make_float4(
            a[8 * b + 4], a[8 * b + 5], a[8 * b + 6], a[8 * b + 7]);
      } else {
#pragma unroll
        for (int kk = 0; kk < 8; ++kk)
          if (k0 + kk < K) o[kk] = a[8 * b + kk];
      }
    }
  }
}

}  // namespace

namespace wide {

// Grid: row groups of 32.  QD: the basis' folded depth.
template <int NWG>
__global__ void __launch_bounds__(64 * NWG, 1)
envelope_cepstrum_kernel(const float* __restrict__ P,
                         const float* __restrict__ lift,
                         const float* __restrict__ F,
                         float* __restrict__ out, int R, int K, int QD,
                         float gain, float power_floor) {
  using C = Chain<NWG>;
  extern __shared__ __align__(128) unsigned char smem[];
  C ch;
  ch.Bs = reinterpret_cast<float*>(smem);
  ch.Y = ch.Bs + STAGES * C::CHUNK;
  ch.Dq = ch.Y + K * BM;
  float* red = ch.Dq + QD * BM;                   // [NW][BM]
  float* rfloor = red + C::NW * BM;               // [BM]
  ch.full = reinterpret_cast<uint64_t*>(rfloor + BM);
  ch.F = F;
  ch.K = K;
  ch.half = K - 1;
  ch.QD = QD;
  ch.NQ = QD / DK;
  ch.g = 0;
  const int tid = threadIdx.x, lane = tid % 32, w = tid / 32;
  const int grp = tid / C::GROUP;
  const int rg = lane / 8, cg = 8 * ((tid % C::GROUP) / 32) + lane % 8;
  const int row0 = blockIdx.x * BM;
  const float inv_n = 1.f / static_cast<float>(2 * (K - 1));
  const bool vec = (K & 7) == 0 &&
                   (reinterpret_cast<uintptr_t>(lift) & 15) == 0 &&
                   (reinterpret_cast<uintptr_t>(out) & 15) == 0;

  if (tid == 0) {
    for (int s = 0; s < STAGES; ++s) mbar_init(&ch.full[s], 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
    for (int s = 0; s < STAGES; ++s) ch.issue(s);
  }
  // P's rows -> Y, transposed: a warp reads 4 rows x 8 columns; 16 loads
  // in flight per thread
  {
    const int total = BM * ((K + 7) / 8 * 8);
    for (int base = tid; base < total; base += 16 * C::THREADS) {
      float v[16];
      int at[16];
#pragma unroll
      for (int u = 0; u < 16; ++u) {
        const int e = base + u * C::THREADS;
        const int kl = e % 8, rl = (e / 8) % 4, rest = e / 32;
        const int r = (rest % 8) * 4 + rl, k = (rest / 8) * 8 + kl;
        const int gr = row0 + r;
        const bool ok = e < total && k < K && gr < R;
        v[u] = __ldg(P + (ok ? static_cast<size_t>(gr) * K + k : 0));
        if (!ok) v[u] = 0.f;
        at[u] = e < total && k < K ? yidx(k, r) : -1;
      }
#pragma unroll
      for (int u = 0; u < 16; ++u)
        if (at[u] >= 0) ch.Y[at[u]] = v[u];
    }
  }
  __syncthreads();
  ch.fold();
  __syncthreads();

  float acc[8][16];
  // 1. cepstrum of the linear power, times the lifter -> Y
  ch.product(acc, grp, rg, cg);
  ch.exchange(acc, grp, rg, cg);
  if (grp == 0) {
    lifted<0, C::NCG>(acc, lift, nullptr, inv_n, R, K, row0, rg, cg, vec);
    ch.template park_half<0>(acc, rg, cg);
  } else {
    lifted<1, C::NCG>(acc, lift, nullptr, inv_n, R, K, row0, rg, cg, vec);
    ch.template park_half<1>(acc, rg, cg);
  }
  __syncthreads();
  ch.fold();
  __syncthreads();

  // 2. back to the (smoothed) power spectrum -> Y, then the row maxima
  ch.product(acc, grp, rg, cg);
  ch.exchange(acc, grp, rg, cg);
  if (grp == 0)
    ch.template park_half<0>(acc, rg, cg);
  else
    ch.template park_half<1>(acc, rg, cg);
  __syncthreads();
  {
    const int r = lane;
    float mx = -FLT_MAX;
#pragma unroll 4
    for (int k = w; k < K; k += C::NW) mx = fmaxf(mx, ch.Y[yidx(k, r)]);
    red[w * BM + r] = mx;
    __syncthreads();
    if (tid < BM) {
      float m = red[tid];
      for (int p = 1; p < C::NW; ++p) m = fmaxf(m, red[p * BM + tid]);
      rfloor[tid] = fmaxf(m * gain, power_floor);
    }
    __syncthreads();
    // 3. the relative floor and the log
    const float fl = rfloor[r];
#pragma unroll 4
    for (int k = w; k < K; k += C::NW) {
      float& v = ch.Y[yidx(k, r)];
      v = logf(fmaxf(v, fl));
    }
  }
  __syncthreads();
  ch.fold();
  __syncthreads();

  // 4. cepstrum of the log envelope, times the lifter -> out
  ch.product(acc, grp, rg, cg);
  ch.exchange(acc, grp, rg, cg);
  if (grp == 0)
    lifted<0, C::NCG>(acc, lift, out, inv_n, R, K, row0, rg, cg, vec);
  else
    lifted<1, C::NCG>(acc, lift, out, inv_n, R, K, row0, rg, cg, vec);
}

template <int NWG>
int launch(const float* P, const float* lift, const float* F, float* out,
           int R, int K, int QD, float gain, float power_floor,
           cudaStream_t stream) {
  using C = Chain<NWG>;
  const size_t smem =
      static_cast<size_t>(STAGES * C::CHUNK + K * BM + QD * BM + C::NW * BM +
                          BM) * 4 + STAGES * 8;
  auto kernel = envelope_cepstrum_kernel<NWG>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  kernel<<<(R + BM - 1) / BM, C::THREADS, smem, stream>>>(
      P, lift, F, out, R, K, QD, gain, power_floor);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace wide

// P, lift, out [R, K]; F the folded basis of ops/analysis.py
// `wide_cepstrum_basis(n, NE)` (n = 2 (K - 1)), [QD][2 NE].  Rows per CTA,
// columns per parity (NE = 32 x warps: 256 at K = 512, 288 at K = 513) and
// folded depth rows per chunk come from the wrapper's plan (ops/analysis.py
// `cepstrum_plan`); any other layout is refused.
extern "C" int envelope_cepstrum_wide_forward(const void* P, const void* lift,
                                              const void* F, void* out, int R,
                                              int K, int rows, int columns,
                                              int chunk, float gain,
                                              float power_floor,
                                              void* stream) {
  if (rows != BM || chunk != DK)
    return static_cast<int>(cudaErrorInvalidValue);
  if (R == 0) return 0;
  if (K < 2 * DK || 2 * columns < K || 2 * columns >= K + 2 * CPW)
    return static_cast<int>(cudaErrorInvalidValue);
  const int QD = ((K - 1) / 2 + 1 + DK - 1) / DK * DK;
  const auto* p = static_cast<const float*>(P);
  const auto* l = static_cast<const float*>(lift);
  const auto* f = static_cast<const float*>(F);
  auto* o = static_cast<float*>(out);
  auto s = static_cast<cudaStream_t>(stream);
  if (columns == 4 * CPW)
    return wide::launch<4>(p, l, f, o, R, K, QD, gain, power_floor, s);
  if (columns == 5 * CPW)
    return wide::launch<5>(p, l, f, o, R, K, QD, gain, power_floor, s);
  return static_cast<int>(cudaErrorInvalidValue);
}

extern "C" const char* envelope_cepstrum_wide_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
