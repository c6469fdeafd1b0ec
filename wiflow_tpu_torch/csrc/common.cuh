// Shared helpers of the port's CUDA kernels (sm_90a).
//
// Every kernel takes float32 or bfloat16 tensors and accumulates in
// float32.  Each source file exports plain C entry points that launch on
// the stream they are given, allocate nothing, and return
// cudaGetLastError() so the Python wrapper can raise on a refused launch.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace wf {

enum DType : int { kF32 = 0, kBF16 = 1 };

__device__ __forceinline__ float to_f(float v) { return v; }
__device__ __forceinline__ float to_f(__nv_bfloat16 v) {
  return __bfloat162float(v);
}

template <typename T> __device__ __forceinline__ T from_f(float v);
template <> __device__ __forceinline__ float from_f<float>(float v) {
  return v;
}
template <> __device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(
    float v) {
  return __float2bfloat16_rn(v);
}

// n / d and n % d for 0 <= n < 2^21, d >= 1, from one float multiply
// instead of an integer division (tens of instructions): (n + 0.5) / d lies
// at least 0.5 / d away from an integer, and the float product's error is
// below n / d * 2^-22, smaller than that for every such n.
struct FastDiv {
  int d;
  float inv;
  __host__ __device__ explicit FastDiv(int divisor = 1)
      : d(divisor), inv(1.0f / divisor) {}
  __device__ __forceinline__ int div(int n) const {
    return __float2int_rz(__fmul_rn(__int2float_rn(n) + 0.5f, inv));
  }
  __device__ __forceinline__ int mod(int n) const { return n - div(n) * d; }
};

// torch.nn.functional.silu: x * sigmoid(x), with the fast exp and divide
// (a few ulp of fp32, far below the bf16 rounding of every stored result)
__device__ __forceinline__ float silu(float v) {
  return __fdividef(v, 1.0f + __expf(-v));
}

// Threads of a block in the kernels that launch a fixed 256.
constexpr int kThreads = 256;

// Longest sequence the attention kernels take: a thread keeps a row of up
// to this many logits, or walks this many keys, in registers.
constexpr int kMaxLen = 32;

}  // namespace wf

#define WF_EXPORT_ERROR_STRING                                \
  extern "C" const char* wf_error_string(int code) {          \
    return cudaGetErrorString(static_cast<cudaError_t>(code)); \
  }
