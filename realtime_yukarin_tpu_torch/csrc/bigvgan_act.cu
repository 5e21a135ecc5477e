// The BigVGAN generator's pass before an activation, fused, for Hopper
// (sm_90a): the bias, the residual add or the resblocks' sum and mean, then
// the anti-aliased SnakeBeta activation.
//
// Replaces: none — added for the bigvgan mode, which the JAX package lacks
// (models/vocoder_bigvgan.py; its plain version is
// ops/bigvgan_act.py:bigvgan_act_plain).
//
// The generator keeps its activations channels-last, [rows, T, C], and runs
// every convolution through cuDNN without a bias.  Where an activation
// follows a convolution this kernel forms, per row t and channel c,
//   v = ([acc +] ([r +] (y [+ b]))) / n
// (y the convolution's output, b its bias, r the residual, acc the stage's
// resblock sum, n the resblocks' count or 1) and writes
//   Act(v) = Down2(SnakeBeta(Up2(v)))
// and, where it is the new residual, v
// with Up2 a 2x polyphase upsample by the 12-tap filter f (replicate
// padding of 5 rows, transposed conv at stride 2 scaled by 2, 15 samples
// cropped each side), SnakeBeta(u) = u + sin(alpha u)^2 inv_beta (alpha,
// inv_beta per channel), and Down2 the same filter at stride 2 over the
// snake's 2T samples (replicate padding 5 and 6).  Output row o reads the
// snake's samples 2o - 5 ... 2o + 6, which read v's rows o - 5 ... o + 5:
// a stencil, not an elementwise pass.  Rows are those of the operands'
// first `extent` rows, whose edges are replicated; `length` rows are kept
// from row `start` (the generator's dependency cone,
// VocoderBigVGANConfig.cone).  The passes with no activation are
// hifigan_tail.cu's at slope 1.
// Arithmetic in float32 on bfloat16 (or float32) operands and float32
// bias, alpha and inv_beta: v is not rounded before the activation, and
// each stored value is rounded once.  The sine is the SFU's __sinf (the
// plain version's torch.sin differs by float32 rounding; the arguments are
// activations times alpha, a few radians, where __sinf's absolute error is
// about 1e-6).
//
// Design (bigvgan_act_kernel): a CTA owns TILE = 32 output rows of one row
// (a lane) and a tile of up to 64 channels, two channels a thread (one
// 4-byte bfloat16 pair or 8-byte float pair along C, so a warp reads 128
// contiguous bytes of a row at 64 channels).  Phase 1 forms v over the
// tile's rows and 6 either side, each row clamped to the operand (the
// upsample's replicate padding), into shared memory as float32, writing
// v's kept rows where it is a result.  Phase 2 forms the snake's samples
// the tile reads two at a time: for a = o0 - 3 ... o0 + TILE + 2 (clamped
// to the operand: the downsample's replicate padding) the upsampled
// samples 2a and 2a + 1 both read v's rows a - 3 ... a + 3, six odd taps
// and six even ones; a thread walks consecutive a, so the seven rows
// slide in registers (one shared load a step).  Phase 3 sums 12 taps per
// output row, four consecutive rows a thread (18 shared loads for 48
// taps).  The filter is in registers; no index is clamped after phase 1.
// Grid (row tiles, channel tiles, rows), 256 threads; shared memory 44 +
// 76 rows of 32 float pairs, 30.7 KB.
//
// Bound on an H100 (bytes / 3.35 TB/s against 56 FLOP an element / 67
// TFLOP/s float32, the sines on the SFU not counted): an element of a
// pass reads 1-3 operands and writes 1-2 results, 2 bytes each in
// bfloat16, 4-8 bytes against 56 FLOP: 0.6-1.2 ps by bytes, 0.84 ps by
// operations, so the passes sit at the balance point.  At 128 lanes of
// 157 frames the 109 activations of a step write 1.86 G elements
// (benchmark/formulas_bigvgan.py): 3.04 ms at the bound.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <stdint.h>

namespace {

constexpr int TAPS = 12;
constexpr int TILE = 32;                 // output rows a CTA
constexpr int CH = 64;                   // channels a CTA, at most
constexpr int PAIRS = CH / 2;            // threads along C
constexpr int THREADS = 256;
constexpr int V_ROWS = TILE + 12;       // v's rows o0 - 6 ... o0 + TILE + 5
constexpr int A_ROWS = TILE + 6;        // a = o0 - 3 ... o0 + TILE + 2
constexpr int S_ROWS = 2 * A_ROWS;      // snake samples 2o0 - 6 ... on
constexpr int GROUP = 4;                // output rows a thread in phase 3

// two channels of T as float32, and back with one rounding each
template <typename T>
struct Pair;

template <>
struct Pair<__nv_bfloat16> {
  static __device__ __forceinline__ float2 load(const __nv_bfloat16* p) {
    return __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(p));
  }
  static __device__ __forceinline__ void store(__nv_bfloat16* p, float2 v) {
    *reinterpret_cast<__nv_bfloat162*>(p) = __floats2bfloat162_rn(v.x, v.y);
  }
};

template <>
struct Pair<float> {
  static __device__ __forceinline__ float2 load(const float* p) {
    return *reinterpret_cast<const float2*>(p);
  }
  static __device__ __forceinline__ void store(float* p, float2 v) {
    *reinterpret_cast<float2*>(p) = v;
  }
};

struct Params {
  const void* y;
  const void* r;
  const void* acc;
  const float* bias;
  const float* alpha;
  const float* inv_beta;
  const float* filter;
  void* out_v;
  void* out_a;
  int extent;       // the operand's rows (replicated past its edges)
  long long y_row;  // elements between two rows (lanes) of y, r and acc
  int start;        // first kept row
  int length;       // kept rows
  int C;
  float divisor;
};

// v at operand position `o` (an offset into y, r and acc) of the channel
// pair at `c`, in float32, summed in the plain version's order
template <typename T>
__device__ __forceinline__ float2 value(const Params& p, size_t o, int c) {
  using V = Pair<T>;
  float2 v = V::load(static_cast<const T*>(p.y) + o);
  if (p.bias != nullptr) {
    v.x = v.x + p.bias[c];
    v.y = v.y + p.bias[c + 1];
  }
  if (p.r != nullptr) {
    const float2 x = V::load(static_cast<const T*>(p.r) + o);
    v.x = x.x + v.x;
    v.y = x.y + v.y;
  }
  if (p.acc != nullptr) {
    const float2 a = V::load(static_cast<const T*>(p.acc) + o);
    v.x = a.x + v.x;
    v.y = a.y + v.y;
  }
  if (p.divisor != 1.0f) {
    v.x = v.x / p.divisor;
    v.y = v.y / p.divisor;
  }
  return v;
}

template <typename T>
__global__ void __launch_bounds__(THREADS)
    bigvgan_act_kernel(const Params p) {
  __shared__ float2 sv[V_ROWS][PAIRS];
  __shared__ float2 ss[S_ROWS][PAIRS];
  const int lane = blockIdx.z;
  const int c0 = blockIdx.y * CH;
  const int width = min(CH, p.C - c0);         // channels of this tile
  const int pairs = width / 2;
  const int rows_par = THREADS / pairs;        // rows handled at once
  const int tx = threadIdx.x % pairs;
  const int ty = threadIdx.x / pairs;
  const bool active = ty < rows_par;
  const int c = c0 + 2 * tx;
  const int o0 = p.start + blockIdx.x * TILE;  // the tile's first row
  const int base = o0 - 6;                     // operand row of sv[0]
  const int last = p.extent - 1;
  const size_t lane_off = static_cast<size_t>(lane) * p.y_row;
  const size_t out_lane = static_cast<size_t>(lane) * p.length * p.C;
  const int kept_end = p.start + p.length;
  float f[TAPS];
#pragma unroll
  for (int j = 0; j < TAPS; ++j) f[j] = __ldg(p.filter + j);

  // phase 1: v over rows base ... base + V_ROWS - 1, each clamped to the
  // operand; v's kept rows written where v is a result
  if (active) {
    for (int i = ty; i < V_ROWS; i += rows_par) {
      const int row = base + i;
      const int rc = min(max(row, 0), last);
      const float2 v =
          value<T>(p, lane_off + static_cast<size_t>(rc) * p.C + c, c);
      sv[i][tx] = v;
      if (p.out_v != nullptr && row >= o0 && row < o0 + TILE &&
          row < kept_end)
        Pair<T>::store(static_cast<T*>(p.out_v) + out_lane +
                           static_cast<size_t>(row - p.start) * p.C + c,
                       v);
    }
  }
  __syncthreads();

  // phase 2: snake samples 2a and 2a + 1 for a = o0 - 3 + k, a run of
  // consecutive k a thread.  a is clamped to the operand: before it both
  // samples are s[0], past it both s[2T - 1].  Sample 2a reads v's rows
  // a - 3 ... a + 2 with the odd taps, 2a + 1 rows a - 2 ... a + 3 with the
  // even ones: x[j] below is row a - 3 + j.
  if (active) {
    const float al_x = p.alpha[c], al_y = p.alpha[c + 1];
    const float ib_x = p.inv_beta[c], ib_y = p.inv_beta[c + 1];
    const int run = (A_ROWS + rows_par - 1) / rows_par;
    const int k_end = min((ty + 1) * run, A_ROWS);
    float2 x[7];
    int have = -100;                            // the row x[0] holds
    for (int k = ty * run; k < k_end; ++k) {
      const int a = o0 - 3 + k;
      const int ac = min(max(a, 0), last);
      const int r0 = ac - 3 - base;             // sv row of x[0]
      if (r0 == have + 1) {
#pragma unroll
        for (int j = 0; j < 6; ++j) x[j] = x[j + 1];
        x[6] = sv[r0 + 6][tx];
      } else if (r0 != have) {
#pragma unroll
        for (int j = 0; j < 7; ++j) x[j] = sv[r0 + j][tx];
      }
      have = r0;
      float ex = 0.0f, ey = 0.0f, ox = 0.0f, oy = 0.0f;
#pragma unroll
      for (int q = 0; q < 6; ++q) {
        ex = fmaf(x[5 - q].x, f[2 * q + 1], ex);
        ey = fmaf(x[5 - q].y, f[2 * q + 1], ey);
        ox = fmaf(x[6 - q].x, f[2 * q], ox);
        oy = fmaf(x[6 - q].y, f[2 * q], oy);
      }
      ex = 2.0f * ex;
      ey = 2.0f * ey;
      ox = 2.0f * ox;
      oy = 2.0f * oy;
      float t = __sinf(al_x * ex);
      ex = ex + t * t * ib_x;
      t = __sinf(al_y * ey);
      ey = ey + t * t * ib_y;
      t = __sinf(al_x * ox);
      ox = ox + t * t * ib_x;
      t = __sinf(al_y * oy);
      oy = oy + t * t * ib_y;
      const float2 se = make_float2(ex, ey), so = make_float2(ox, oy);
      ss[2 * k][tx] = a > last ? so : se;
      ss[2 * k + 1][tx] = a < 0 ? se : so;
    }
  }
  __syncthreads();

  // phase 3: output row o = o0 + i sums the snake's samples 2o - 5 ...
  // 2o + 6, shared rows 2i + 1 ... 2i + 12; GROUP consecutive rows a
  // thread read 2 GROUP + 10 of them
  if (active) {
    for (int g = ty; g < TILE / GROUP; g += rows_par) {
      const int i0 = GROUP * g;
      if (o0 + i0 >= kept_end) break;
      float2 s[2 * GROUP + 10];
#pragma unroll
      for (int j = 0; j < 2 * GROUP + 10; ++j) s[j] = ss[2 * i0 + 1 + j][tx];
#pragma unroll
      for (int r = 0; r < GROUP; ++r) {
        const int o = o0 + i0 + r;
        if (o < kept_end) {
          float ax = 0.0f, ay = 0.0f;
#pragma unroll
          for (int j = 0; j < TAPS; ++j) {
            ax = fmaf(s[2 * r + j].x, f[j], ax);
            ay = fmaf(s[2 * r + j].y, f[j], ay);
          }
          Pair<T>::store(static_cast<T*>(p.out_a) + out_lane +
                             static_cast<size_t>(o - p.start) * p.C + c,
                         make_float2(ax, ay));
        }
      }
    }
  }
}

template <typename T>
cudaError_t launch(const Params& p, int rows, cudaStream_t stream) {
  const dim3 grid((p.length + TILE - 1) / TILE, (p.C + CH - 1) / CH, rows);
  bigvgan_act_kernel<T><<<grid, THREADS, 0, stream>>>(p);
  return cudaGetLastError();
}

}  // namespace

// y, r, acc [rows, y_row / C, C], the operand their first `extent` rows,
// `length` rows kept from row `start`; out_v, out_a [rows, length, C];
// bias, alpha, inv_beta [C] and filter [12] float32.  bf16: 1 for bfloat16
// activations, 0 for float32.  r, acc and bias may be null, and out_v
// where v is not kept.
extern "C" int bigvgan_act_forward(const void* y, const void* r,
                                   const void* acc, const void* bias,
                                   const void* alpha, const void* inv_beta,
                                   const void* filter, void* out_v,
                                   void* out_a, int rows, int extent,
                                   long long y_row, int start, int length,
                                   int C, int bf16, float divisor,
                                   void* stream) {
  if (rows < 0 || extent <= 0 || start < 0 || length <= 0 || C <= 0 ||
      C % 2 != 0 || start + length > extent ||
      y_row < static_cast<long long>(extent) * C ||
      out_a == nullptr || alpha == nullptr || inv_beta == nullptr ||
      filter == nullptr)
    return static_cast<int>(cudaErrorInvalidValue);
  if (rows == 0) return 0;
  if (static_cast<long long>(rows) * y_row > 0x7fffffffLL ||
      rows > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  Params p{y,
           r,
           acc,
           static_cast<const float*>(bias),
           static_cast<const float*>(alpha),
           static_cast<const float*>(inv_beta),
           static_cast<const float*>(filter),
           out_v,
           out_a,
           extent,
           y_row,
           start,
           length,
           C,
           divisor};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const cudaError_t err = bf16 ? launch<__nv_bfloat16>(p, rows, s)
                               : launch<float>(p, rows, s);
  return static_cast<int>(err);
}

extern "C" const char* bigvgan_act_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
