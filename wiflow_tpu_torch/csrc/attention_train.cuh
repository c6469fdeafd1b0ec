// Helpers shared by the train-mode attention kernels (axial_core.cu,
// logits_sums.cu).
//
// Both work on sequences of L <= 32 positions with channels in the
// standard group-major order, 8 channels per group (channel = g * 8 + cc).
// A block stages a few whole sequences in shared memory as fp32, and each
// reduction over all sequences goes through per-block fp32 partials and a
// second launch that sums them in float64 in a fixed order: the result is
// the same from run to run (no atomics).
#pragma once

#include "common.cuh"

namespace wf {

constexpr int kGC = 8;        // channels per group
constexpr int kMaxLen = 32;   // longest sequence a thread keeps in registers

// Copy `nvalid` sequences starting at s0 from src ([N, L, *], position
// stride ld) into dst ([npos, c] fp32); rows of missing sequences are
// zeroed.
template <typename T>
__device__ __forceinline__ void stage_rows(float* dst, const T* src, int ld,
                                           int s0, int nvalid, int len, int c,
                                           int npos) {
  for (int e = threadIdx.x; e < npos * c; e += kThreads) {
    const int p = e / c, ch = e % c;
    dst[e] = p / len < nvalid ? to_f(src[(size_t)(s0 * len + p) * ld + ch])
                              : 0.f;
  }
}

__device__ __forceinline__ float dot8(const float* a, const float* b) {
  float s = 0.f;
#pragma unroll
  for (int cc = 0; cc < kGC; ++cc) s += a[cc] * b[cc];
  return s;
}

template <typename T>
__device__ __forceinline__ void store8(T* dst, const float* v) {
#pragma unroll
  for (int cc = 0; cc < kGC; ++cc) dst[cc] = from_f<T>(v[cc]);
}

// This block's column sums of red[rows, cols] (shared memory), row by row
// in order, into partial[blockIdx.x, cols].  Call after a barrier.
__device__ __forceinline__ void block_column_sums(const float* red, int rows,
                                                  int cols, float* partial) {
  if (threadIdx.x < cols) {
    float acc = 0.f;
    for (int r = 0; r < rows; ++r) acc += red[r * cols + threadIdx.x];
    partial[(size_t)blockIdx.x * cols + threadIdx.x] = acc;
  }
}

// Second pass: out[col] = sum over rows of partial[rows, cols], one block,
// in float64.  Each thread sums a fixed stride of rows and a fixed tree
// combines the threads.
__global__ void __launch_bounds__(kThreads) reduce_columns(
    const float* __restrict__ partial, int rows, int cols, float* out) {
  __shared__ double acc[kThreads];
  for (int col = 0; col < cols; ++col) {
    double s = 0.0;
    for (int r = threadIdx.x; r < rows; r += kThreads)
      s += (double)partial[(size_t)r * cols + col];
    acc[threadIdx.x] = s;
    __syncthreads();
    for (int half = kThreads / 2; half > 0; half /= 2) {
      if (threadIdx.x < half) acc[threadIdx.x] += acc[threadIdx.x + half];
      __syncthreads();
    }
    if (threadIdx.x == 0) out[col] = (float)acc[0];
    __syncthreads();
  }
}

}  // namespace wf
