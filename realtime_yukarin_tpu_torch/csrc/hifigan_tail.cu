// The HiFi-GAN generator's tail between two convolutions, fused, for Hopper
// (sm_90a).
//
// Replaces: none — added for the hifigan mode, which the JAX package lacks
// (models/vocoder_hifigan.py; its plain version is
// ops/hifigan_tail.py:hifigan_tail_plain).
//
// The generator keeps its activations channels-last, [rows, T, C], and runs
// every convolution through cuDNN without a bias.  What lies between two
// convolutions is one pass of this kernel over [rows * T, C], in one of
// five modes (y the convolution's output, b its bias, r the residual, acc
// the stage's resblock sum, lrelu(v) = v > 0 ? v : slope * v):
//   ACT   out0 = lrelu(y + b)                        conv_pre, each c1 conv
//   UP    out0 = y + b, out1 = lrelu(y + b)          each transposed conv
//   RES   x = r + (y + b); out0 = x, out1 = lrelu(x) a c2 conv before a
//                                                    resblock's last dilation
//   SUM   out0 = [acc +] (r + (y + b))               the last dilation of a
//                                                    stage's first resblocks;
//                                                    out0 may be acc itself
//   MEAN  out0 = lrelu(([acc +] (r + (y + b))) / n)  the stage's last
//                                                    resblock (slope 0.1
//                                                    before an upsample, 0.01
//                                                    before conv_post)
// Every mode may keep a window of its operands' rows: `length` samples a
// row from row `start` of y, r and acc, which share one row stride; the
// outputs hold the window alone.  The generator keeps the rows of each
// stage that the kept output samples depend on
// (VocoderHiFiGANConfig.cone): conv_pre's ACT and each UP drop the rows
// the stage does not run over (and an odd-stride transposed conv's
// trailing sample), a stage's MEAN those the next conv does not read.
// Arithmetic in float32 on bfloat16 (or float32) operands and a float32
// bias, one rounding per stored value; no FMA can form (no product feeds a
// sum), so the plain version's float32 ops give the same bits.
//
// Design: a thread owns one group of 16 bytes of channels (8 bfloat16 or 4
// float32), loads its bias group into registers once, and walks positions
// (row, t) grid-stride; every global access is one 16-byte vector along C
// (the wrapper refuses C % 8 != 0 and unaligned tensors).  A block is
// 256 / G positions of G = C / 8 groups (C = 512 ... 32 in the generator),
// and the grid fills every SM once.
//
// Bound on an H100 (bytes / 3.35 TB/s; E = rows * T * C elements, 2 bytes
// each in bfloat16): ACT 2E, UP 3E, RES 4E, SUM 3E (4E with acc), MEAN 3E
// (4E with acc) elements moved, plus 4C bytes of bias.  At 256 lanes of 63
// frames a stage runs over 268 / 583 / 1,384 / 2,526 samples a row (stages
// 1-4, C = 256 / 128 / 64 / 32; the whole window is 315 / 1,260 / 3,780 /
// 7,560), E = 17.6 M / 19.1 M / 22.7 M / 20.7 M, so a stage's 19 tails
// (one UP, 9 ACT, 6 RES, 2 SUM, 1 MEAN) move about 56 E elements: 0.59 /
// 0.64 / 0.76 / 0.69 ms a tick, 2.7 ms in all.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <stdint.h>

namespace {

constexpr int MODE_ACT = 0;
constexpr int MODE_UP = 1;
constexpr int MODE_RES = 2;
constexpr int MODE_SUM = 3;
constexpr int MODE_MEAN = 4;
constexpr int BLOCK = 256;           // threads a block aims for
constexpr int MAX_THREADS = 1024;    // a block of one position: G <= 1024
constexpr int THREADS_PER_SM = 2048;

// 16 bytes of T as float32, and back with one rounding each
template <typename T>
struct Vec;

template <>
struct Vec<__nv_bfloat16> {
  static constexpr int N = 8;
  static __device__ __forceinline__ void load(const __nv_bfloat16* p,
                                              float (&v)[N]) {
    const uint4 u = *reinterpret_cast<const uint4*>(p);
    const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&u);
#pragma unroll
    for (int i = 0; i < N / 2; ++i) {
      const float2 f = __bfloat1622float2(h[i]);
      v[2 * i] = f.x;
      v[2 * i + 1] = f.y;
    }
  }
  static __device__ __forceinline__ void store(__nv_bfloat16* p,
                                               const float (&v)[N]) {
    uint4 u;
    __nv_bfloat162* h = reinterpret_cast<__nv_bfloat162*>(&u);
#pragma unroll
    for (int i = 0; i < N / 2; ++i)
      h[i] = __floats2bfloat162_rn(v[2 * i], v[2 * i + 1]);
    *reinterpret_cast<uint4*>(p) = u;
  }
};

template <>
struct Vec<float> {
  static constexpr int N = 4;
  static __device__ __forceinline__ void load(const float* p,
                                              float (&v)[N]) {
    const float4 f = *reinterpret_cast<const float4*>(p);
    v[0] = f.x;
    v[1] = f.y;
    v[2] = f.z;
    v[3] = f.w;
  }
  static __device__ __forceinline__ void store(float* p, const float (&v)[N]) {
    *reinterpret_cast<float4*>(p) = make_float4(v[0], v[1], v[2], v[3]);
  }
};

__device__ __forceinline__ float lrelu(float v, float slope) {
  return v > 0.0f ? v : v * slope;
}

// acc and out0 may be one tensor (SUM adds into the stage's sum in place,
// uncropped): neither is __restrict__; each element is read before it is
// written, by the one thread that owns it.
template <typename T, int MODE, bool ACC>
__global__ void __launch_bounds__(MAX_THREADS)
    hifigan_tail_kernel(const T* __restrict__ y, const T* __restrict__ r,
                        const T* acc, const float* __restrict__ bias,
                        T* out0, T* __restrict__ out1, int positions,
                        int length, int C, int y_row, float slope,
                        float divisor) {
  using V = Vec<T>;
  constexpr int N = V::N;
  const int G = C / N;
  const int per_block = blockDim.x / G;
  const int g = threadIdx.x % G;
  const int slot = threadIdx.x / G;
  float b[N];
#pragma unroll
  for (int j = 0; j < N; ++j) b[j] = bias[g * N + j];
  const bool cropped = y_row != length * C;
  for (int p = blockIdx.x * per_block + slot; p < positions;
       p += gridDim.x * per_block) {
    const size_t o = static_cast<size_t>(p) * C + g * N;
    size_t yo = o;
    if (cropped) {
      const int row = p / length;
      yo = static_cast<size_t>(row) * y_row
           + static_cast<size_t>(p - row * length) * C + g * N;
    }
    float v[N];
    V::load(y + yo, v);
#pragma unroll
    for (int j = 0; j < N; ++j) v[j] = v[j] + b[j];
    if (MODE == MODE_ACT) {
#pragma unroll
      for (int j = 0; j < N; ++j) v[j] = lrelu(v[j], slope);
      V::store(out0 + o, v);
      continue;
    }
    if (MODE == MODE_UP) {
      V::store(out0 + o, v);
#pragma unroll
      for (int j = 0; j < N; ++j) v[j] = lrelu(v[j], slope);
      V::store(out1 + o, v);
      continue;
    }
    float x[N];
    V::load(r + yo, x);
#pragma unroll
    for (int j = 0; j < N; ++j) v[j] = x[j] + v[j];
    if (MODE == MODE_RES) {
      V::store(out0 + o, v);
#pragma unroll
      for (int j = 0; j < N; ++j) v[j] = lrelu(v[j], slope);
      V::store(out1 + o, v);
      continue;
    }
    if (ACC) {
      float a[N];
      V::load(acc + yo, a);
#pragma unroll
      for (int j = 0; j < N; ++j) v[j] = a[j] + v[j];
    }
    if (MODE == MODE_MEAN) {
#pragma unroll
      for (int j = 0; j < N; ++j) v[j] = lrelu(v[j] / divisor, slope);
    }
    V::store(out0 + o, v);
  }
}

template <typename T, int MODE, bool ACC>
cudaError_t launch(const void* y, const void* r, const void* acc,
                   const void* bias, void* out0, void* out1, int positions,
                   int length, int C, int y_row, float slope, float divisor,
                   cudaStream_t stream) {
  const int G = C / Vec<T>::N;
  const int per_block = G >= BLOCK ? 1 : BLOCK / G;
  const int threads = per_block * G;
  int device = 0, sms = 0;
  cudaError_t err = cudaGetDevice(&device);
  if (err != cudaSuccess) return err;
  err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  if (err != cudaSuccess) return err;
  const int needed = (positions + per_block - 1) / per_block;
  const int fill = sms * (THREADS_PER_SM / threads);
  const int grid = needed < fill ? needed : fill;
  hifigan_tail_kernel<T, MODE, ACC><<<grid, threads, 0, stream>>>(
      static_cast<const T*>(y), static_cast<const T*>(r),
      static_cast<const T*>(acc), static_cast<const float*>(bias),
      static_cast<T*>(out0), static_cast<T*>(out1), positions, length, C,
      y_row, slope, divisor);
  return cudaGetLastError();
}

template <typename T>
cudaError_t dispatch(int mode, bool has_acc, const void* y, const void* r,
                     const void* acc, const void* bias, void* out0,
                     void* out1, int positions, int length, int C, int y_row,
                     float slope, float divisor, cudaStream_t s) {
  switch (mode) {
    case MODE_ACT:
      return launch<T, MODE_ACT, false>(y, r, acc, bias, out0, out1,
                                        positions, length, C, y_row, slope,
                                        divisor, s);
    case MODE_UP:
      return launch<T, MODE_UP, false>(y, r, acc, bias, out0, out1,
                                       positions, length, C, y_row, slope,
                                       divisor, s);
    case MODE_RES:
      return launch<T, MODE_RES, false>(y, r, acc, bias, out0, out1,
                                        positions, length, C, y_row, slope,
                                        divisor, s);
    case MODE_SUM:
      return has_acc
                 ? launch<T, MODE_SUM, true>(y, r, acc, bias, out0, out1,
                                             positions, length, C, y_row,
                                             slope, divisor, s)
                 : launch<T, MODE_SUM, false>(y, r, acc, bias, out0, out1,
                                              positions, length, C, y_row,
                                              slope, divisor, s);
    case MODE_MEAN:
      return has_acc
                 ? launch<T, MODE_MEAN, true>(y, r, acc, bias, out0, out1,
                                              positions, length, C, y_row,
                                              slope, divisor, s)
                 : launch<T, MODE_MEAN, false>(y, r, acc, bias, out0, out1,
                                               positions, length, C, y_row,
                                               slope, divisor, s);
    default:
      return cudaErrorInvalidValue;
  }
}

}  // namespace

// y, r, acc [rows, y_row / C, C] (`length` samples a row kept from row
// `start`), out0, out1 [rows, length, C]; bias [C] float32.  bf16: 1 for
// bfloat16 activations, 0 for float32.  acc may be null (SUM and MEAN
// without a running sum), r and out1 null where the mode reads or writes
// none; acc may be out0 only uncropped.
extern "C" int hifigan_tail_forward(const void* y, const void* r,
                                    const void* acc, const void* bias,
                                    void* out0, void* out1, int rows,
                                    int length, int C, int y_row, int start,
                                    int mode, int bf16, float slope,
                                    float divisor, void* stream) {
  const int N = bf16 ? 8 : 4;
  if (rows < 0 || length < 0 || start < 0 || C <= 0 || C % 8 != 0
      || static_cast<long long>(y_row)
             < static_cast<long long>(start + length) * C
      || C / N > MAX_THREADS
      || (acc == out0 && y_row != length * C))
    return static_cast<int>(cudaErrorInvalidValue);
  const long long positions = static_cast<long long>(rows) * length;
  if (positions == 0) return 0;
  if (positions * C > 0x7fffffffLL)
    return static_cast<int>(cudaErrorInvalidValue);
  // the window's first row: every operand read at the same offset
  const size_t skip = static_cast<size_t>(start) * C * (bf16 ? 2 : 4);
  const auto at = [skip](const void* p) {
    return p == nullptr ? p : static_cast<const char*>(p) + skip;
  };
  y = at(y);
  r = at(r);
  acc = at(acc);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const bool has_acc = acc != nullptr;
  const cudaError_t err =
      bf16 ? dispatch<__nv_bfloat16>(mode, has_acc, y, r, acc, bias, out0,
                                     out1, static_cast<int>(positions),
                                     length, C, y_row, slope, divisor, s)
           : dispatch<float>(mode, has_acc, y, r, acc, bias, out0, out1,
                             static_cast<int>(positions), length, C, y_row,
                             slope, divisor, s);
  return static_cast<int>(err);
}

extern "C" const char* hifigan_tail_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
