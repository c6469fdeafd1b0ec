// Helpers shared by the train-mode attention kernels (axial_core.cu,
// logits_sums.cu).
//
// Both work on sequences of L <= 32 positions with channels in the
// standard group-major order, 8 channels per group (channel = g * 8 + cc),
// and reduce over all sequences without atomics, in a fixed order, so a
// launch repeats bit for bit: axial_core's dscale through per-block fp32
// partials and reduce_columns, a second launch that sums them in float64;
// logits_sums through its own float64 sum of per-block partials
// (logits_sums.cu).
#pragma once

#include "common.cuh"

namespace wf {

constexpr int kGC = 8;        // channels per group

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
