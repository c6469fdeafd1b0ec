// Shared stages of the eval axial-attention kernels (axial_attention.cu,
// axial_attention_v1.cu, axial_attention_dual.cu).
//
// All three keep a block's q, k, v in shared memory as fp32 rows
// [position, 3C + 4] (q at column 0, k at C, v at 2C; the 4 floats of
// padding spread the rows over the banks) and give one thread one
// (sequence, query, group): its row of L <= 32 logits, the softmax and the
// weighted sum stay in registers.  They differ in where q, k, v come from
// (projected in the block, or read from device memory) and in where the
// result goes (device memory, or a shared-memory intermediate).
#pragma once

#include <cfloat>

#include "common.cuh"

namespace wf {

constexpr int kGroupChannels = 8;
constexpr int kMaxLen = 32;

// qkv[row, 0:3C] = xs[row, 0:C] @ wq + bq for row < npos (<= 80), fp32.
// xs [npos, c] lives in shared memory, wq [C, 3C] and bq [3C] in device
// memory; ws is the 32 x 64 weight tile of wf::gemm_acc.  Starts and ends
// with __syncthreads().
template <typename T>
__device__ __forceinline__ void project_qkv(const T* xs, int npos, int c,
                                            const T* __restrict__ wq,
                                            const float* __restrict__ bq,
                                            float* qkv, int ldq, float* ws) {
  const int c3 = 3 * c;
  const int tx = threadIdx.x % 16, ty = threadIdx.x / 16;
  for (int n0 = 0; n0 < c3; n0 += kTileN) {
    float acc[kMaxRows][kColsPerThread];
    zero(acc);
    gemm_acc(acc, xs, c, npos, wq, c, c3, n0, ws);
#pragma unroll
    for (int r = 0; r < kMaxRows; ++r) {
      const int row = ty + 16 * r;
      if (row >= npos) continue;
#pragma unroll
      for (int k = 0; k < kColsPerThread; ++k) {
        const int col = n0 + tx * 4 + k;
        if (col < c3) qkv[row * ldq + col] = acc[r][k] + bq[col];
      }
    }
  }
  __syncthreads();
}

// Query i, group g of the sequence whose qkv rows start at `base`:
//   logit[j] = (q_i . k_j) * s_g + b_g, p = softmax_j(logit),
//   dst[g*8 + cc] = (sum_j p[j] v_j[cc]) * so + bo, rounded to T.
// `dst` is the output position's channel 0, in device or shared memory.
template <typename T>
__device__ __forceinline__ void attend_store(const float* base, int ldq, int c,
                                             int len, int i, int g, int groups,
                                             const float* __restrict__ sim,
                                             const float* __restrict__ oaff,
                                             T* dst) {
  float q[kGroupChannels];
#pragma unroll
  for (int cc = 0; cc < kGroupChannels; ++cc)
    q[cc] = base[i * ldq + g * kGroupChannels + cc];
  const float ss = sim[g], sb = sim[groups + g];
  float lg[kMaxLen];
  float m = -FLT_MAX;
#pragma unroll
  for (int j = 0; j < kMaxLen; ++j) {
    if (j < len) {
      const float* k = base + j * ldq + c + g * kGroupChannels;
      float dot = 0.f;
#pragma unroll
      for (int cc = 0; cc < kGroupChannels; ++cc) dot += q[cc] * k[cc];
      lg[j] = dot * ss + sb;
      m = fmaxf(m, lg[j]);
    }
  }
  float den = 0.f;
  float o[kGroupChannels];
#pragma unroll
  for (int cc = 0; cc < kGroupChannels; ++cc) o[cc] = 0.f;
#pragma unroll
  for (int j = 0; j < kMaxLen; ++j) {
    if (j < len) {
      const float p = expf(lg[j] - m);
      den += p;
      const float* v = base + j * ldq + 2 * c + g * kGroupChannels;
#pragma unroll
      for (int cc = 0; cc < kGroupChannels; ++cc) o[cc] += p * v[cc];
    }
  }
  const float r = 1.0f / den;
#pragma unroll
  for (int cc = 0; cc < kGroupChannels; ++cc) {
    const int ch = g * kGroupChannels + cc;
    dst[ch] = from_f<T>(o[cc] * r * oaff[ch] + oaff[c + ch]);
  }
}

}  // namespace wf
