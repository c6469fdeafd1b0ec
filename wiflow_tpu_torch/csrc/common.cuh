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

// ---------------------------------------------------------------------------
// Block-level product on CUDA cores: acc += A[rows, K] x W[K, n0:n0+64].
//
// 256 threads as 16 x 16: thread (ty, tx) owns rows ty, ty+16, ..., (up to
// kMaxRows of them, i.e. at most 80 rows) and the 4 columns n0 + 4*tx ...
// A lives in shared memory (row stride lda, element type T); W is read
// from device memory row-major [K, N] and staged through a 32 x 64 float
// tile `ws` (8 KB of shared memory).  Rows >= m and columns >= N
// contribute zeros.  Starts and ends with __syncthreads() around `ws`.
// ---------------------------------------------------------------------------
constexpr int kThreads = 256;
constexpr int kTileN = 64;
constexpr int kTileK = 32;
constexpr int kColsPerThread = 4;
constexpr int kMaxRows = 5;
constexpr int kTileFloats = kTileK * kTileN;

template <typename T>
__device__ __forceinline__ void gemm_acc(float (&acc)[kMaxRows][kColsPerThread],
                                         const T* a, int lda, int m,
                                         const T* __restrict__ w, int k_dim,
                                         int n_dim, int n0, float* ws) {
  const int tid = threadIdx.x;
  const int tx = tid % 16, ty = tid / 16;
  for (int k0 = 0; k0 < k_dim; k0 += kTileK) {
    __syncthreads();
    for (int e = tid; e < kTileFloats; e += kThreads) {
      const int kk = e / kTileN, nn = e % kTileN;
      const int k = k0 + kk, n = n0 + nn;
      ws[e] = (k < k_dim && n < n_dim) ? to_f(w[(size_t)k * n_dim + n]) : 0.f;
    }
    __syncthreads();
    const int kmax = min(kTileK, k_dim - k0);
    for (int kk = 0; kk < kmax; ++kk) {
      const float4 w4 =
          *reinterpret_cast<const float4*>(&ws[kk * kTileN + tx * 4]);
#pragma unroll
      for (int r = 0; r < kMaxRows; ++r) {
        const int row = ty + 16 * r;
        const float av = row < m ? to_f(a[row * lda + k0 + kk]) : 0.f;
        acc[r][0] += av * w4.x;
        acc[r][1] += av * w4.y;
        acc[r][2] += av * w4.z;
        acc[r][3] += av * w4.w;
      }
    }
  }
  __syncthreads();
}

__device__ __forceinline__ void zero(float (&acc)[kMaxRows][kColsPerThread]) {
#pragma unroll
  for (int r = 0; r < kMaxRows; ++r)
#pragma unroll
    for (int c = 0; c < kColsPerThread; ++c) acc[r][c] = 0.f;
}

}  // namespace wf

#define WF_EXPORT_ERROR_STRING                                \
  extern "C" const char* wf_error_string(int code) {          \
    return cudaGetErrorString(static_cast<cudaError_t>(code)); \
  }
