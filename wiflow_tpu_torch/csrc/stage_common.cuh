// Helpers shared by the stage-fused train kernels (stage_fused.cu,
// join_fused.cu).
//
// Both work on channel-last activations [positions, C] in float32 or
// bfloat16.  The BatchNorm that precedes a stage is applied inside it as
// u = (x - m) * a + b with the per-channel vectors m, a, b given in fp32
// and rounded to the compute type T here, each step of the expression
// rounded to T as a tensor op in T would round it; the sigmoid of SiLU is
// taken in fp32.  A dropout keep-mask is one byte per element
// (mask_div = 1) or one byte per (sample, channel) shared by the
// mask_div positions of a sample.
//
// Every reduction over all positions (per-channel sums, weight gradients)
// goes through per-block fp32 partials, summed in a fixed order, which a
// second launch (stage_fused.cu) or the launch's last block to finish
// (join_fused.cu) adds in float64 in a fixed order: the result is the
// same from run to run (no float atomics).
#pragma once

#include "common.cuh"

// Kernel launch.  `kernel` is a variable that holds the kernel's address
// (a template-id with commas cannot be a macro argument).
#ifndef WF_LAUNCH
#define WF_LAUNCH(kernel, grid, block, smem, stream, ...) \
  kernel<<<grid, block, smem, stream>>>(__VA_ARGS__)
#endif

namespace wf {

template <typename T>
__device__ __forceinline__ float round_to(float v) {
  return to_f(from_f<T>(v));
}

__device__ __forceinline__ float sigmoid(float v) {
  return 1.0f / (1.0f + __expf(-v));
}

// d silu(u) / du from u and sigmoid(u)
__device__ __forceinline__ float dsilu(float u, float sig) {
  return sig * (1.0f + u * (1.0f - sig));
}

// u = (x - m) * a + b, every step rounded to T; m, a, b already rounded
template <typename T>
__device__ __forceinline__ float bn_apply(float x, float m, float a, float b) {
  return round_to<T>(round_to<T>(round_to<T>(x - m) * a) + b);
}

// silu(u) rounded to T, the sigmoid in fp32
template <typename T>
__device__ __forceinline__ float silu_to(float u) {
  return round_to<T>(u * sigmoid(u));
}

struct Mask {
  const uint8_t* bits;   // null: no dropout
  int div;               // positions that share one mask row
  float keep;
  __device__ __forceinline__ bool on(size_t pos, int channels, int c) const {
    return bits[(pos / div) * channels + c] != 0;
  }
};

constexpr int kReduceCols = 32;
constexpr int kReduceLanes = kThreads / kReduceCols;

// out[col] = sum over rows of partial[row * ld + col], in float64: a block
// takes 32 columns, each of its 8 lanes a fixed stride of rows, and lane 0
// adds the lanes in order.
__global__ void __launch_bounds__(kThreads) reduce_rows(
    const float* __restrict__ partial, int rows, int ld, int cols,
    float* __restrict__ out) {
  __shared__ double acc[kReduceLanes][kReduceCols];
  const int lane = threadIdx.x / kReduceCols, cc = threadIdx.x % kReduceCols;
  const int col = blockIdx.x * kReduceCols + cc;
  double s = 0.0;
  if (col < cols)
    for (int r = lane; r < rows; r += kReduceLanes)
      s += (double)partial[(size_t)r * ld + col];
  acc[lane][cc] = s;
  __syncthreads();
  if (lane == 0 && col < cols) {
    double t = 0.0;
    for (int l = 0; l < kReduceLanes; ++l) t += acc[l][cc];
    out[col] = (float)t;
  }
}

// The chain rule of u = (x - m) * a + b from A = sum(gu * x) and
// B = sum(gu), per channel: g_m = -a B, g_a = A - m B, g_b = B, with m and
// a rounded to the compute type as the kernels read them.  partial is
// [rows, ld] with A at column off + c and B at off + C + c, for the
// branches blockIdx.y = 0, 1 (off = 2 C blockIdx.y); out is [branches, 3, C].
struct AffineGradArgs {
  const float* partial;
  int rows, ld, channels, bf16;
  const float* m[2];
  const float* a[2];
  float* out;
};

__global__ void __launch_bounds__(kThreads) reduce_affine_grads(
    AffineGradArgs g) {
  __shared__ double acc[2][kReduceLanes][kReduceCols];
  const int lane = threadIdx.x / kReduceCols, cc = threadIdx.x % kReduceCols;
  const int c = blockIdx.x * kReduceCols + cc;
  const int branch = blockIdx.y, off = 2 * g.channels * branch;
  double sa = 0.0, sb = 0.0;
  if (c < g.channels)
    for (int r = lane; r < g.rows; r += kReduceLanes) {
      const float* row = g.partial + (size_t)r * g.ld + off;
      sa += (double)row[c];
      sb += (double)row[g.channels + c];
    }
  acc[0][lane][cc] = sa;
  acc[1][lane][cc] = sb;
  __syncthreads();
  if (lane == 0 && c < g.channels) {
    double ta = 0.0, tb = 0.0;
    for (int l = 0; l < kReduceLanes; ++l) {
      ta += acc[0][l][cc];
      tb += acc[1][l][cc];
    }
    float m = g.m[branch][c], a = g.a[branch][c];
    if (g.bf16) {
      m = round_to<__nv_bfloat16>(m);
      a = round_to<__nv_bfloat16>(a);
    }
    float* out = g.out + (size_t)branch * 3 * g.channels;
    out[c] = (float)(-(double)a * tb);
    out[g.channels + c] = (float)(ta - (double)m * tb);
    out[2 * g.channels + c] = (float)tb;
  }
}

}  // namespace wf
