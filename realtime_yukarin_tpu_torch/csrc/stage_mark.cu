// Stage markers: empty kernels whose names say which stage of a step
// begins, so a device trace can split a captured step by stage.
//
// Replaces: no TPU kernel; the markers serve the port's device traces.
//
// A host range cannot label the kernels of a CUDA graph replay: the replay
// is one host call, and the profiler lists its kernels one by one.  A
// marker is a kernel node inside the graph instead: stage_begin_<stage> is
// launched, on the step's stream, before the stage's first operation and
// stage_end after the step's last, so every device operation between two
// markers belongs to the first one's stage (one stream runs in order).
// The kernels are `extern "C"`, so their trace names are exactly these.
//
// Bound on an H100: none; each launch is one block of one thread that
// does nothing, and a graph node of an empty kernel costs the device
// about a microsecond.
//
// The stage numbers are the positions in utils/profiling.py's STAGES.

#include <cuda_runtime.h>

extern "C" {
__global__ void stage_begin_carry_in() {}
__global__ void stage_begin_resample_in() {}
__global__ void stage_begin_analysis() {}
__global__ void stage_begin_stage1() {}
__global__ void stage_begin_sr() {}
__global__ void stage_begin_render() {}
__global__ void stage_begin_resample_out() {}
__global__ void stage_begin_carry_out() {}
__global__ void stage_begin_forward() {}
__global__ void stage_begin_backward() {}
__global__ void stage_begin_optimizer() {}
__global__ void stage_begin_vocoder() {}
__global__ void stage_begin_vocoder_s1() {}
__global__ void stage_begin_vocoder_s2() {}
__global__ void stage_begin_vocoder_s3() {}
__global__ void stage_begin_vocoder_s4() {}
__global__ void stage_begin_vocoder_s5() {}
__global__ void stage_begin_vocoder_s6() {}
__global__ void stage_end() {}
}  // extern "C"

extern "C" int stage_mark_forward(int stage, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (stage) {
    case 0: stage_begin_carry_in<<<1, 1, 0, s>>>(); break;
    case 1: stage_begin_resample_in<<<1, 1, 0, s>>>(); break;
    case 2: stage_begin_analysis<<<1, 1, 0, s>>>(); break;
    case 3: stage_begin_stage1<<<1, 1, 0, s>>>(); break;
    case 4: stage_begin_sr<<<1, 1, 0, s>>>(); break;
    case 5: stage_begin_render<<<1, 1, 0, s>>>(); break;
    case 6: stage_begin_resample_out<<<1, 1, 0, s>>>(); break;
    case 7: stage_begin_carry_out<<<1, 1, 0, s>>>(); break;
    case 8: stage_begin_forward<<<1, 1, 0, s>>>(); break;
    case 9: stage_begin_backward<<<1, 1, 0, s>>>(); break;
    case 10: stage_begin_optimizer<<<1, 1, 0, s>>>(); break;
    case 11: stage_begin_vocoder<<<1, 1, 0, s>>>(); break;
    case 12: stage_begin_vocoder_s1<<<1, 1, 0, s>>>(); break;
    case 13: stage_begin_vocoder_s2<<<1, 1, 0, s>>>(); break;
    case 14: stage_begin_vocoder_s3<<<1, 1, 0, s>>>(); break;
    case 15: stage_begin_vocoder_s4<<<1, 1, 0, s>>>(); break;
    case 16: stage_begin_vocoder_s5<<<1, 1, 0, s>>>(); break;
    case 17: stage_begin_vocoder_s6<<<1, 1, 0, s>>>(); break;
    case 18: stage_end<<<1, 1, 0, s>>>(); break;
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* stage_mark_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
