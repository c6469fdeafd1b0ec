// Eval axial attention along one axis of [B, H, W, C], for sm_90a.
//
// Replaces wiflow_tpu/ops/pallas/axial_attention.py:axial_attention_eval_v2
// (kernel body _kernel_v2 / _attend), called once per axis by the
// dual-attention wrapper.  Per sequence of L positions (L = 20 along W,
// 15 along H), with bn_qkv folded into the projection:
//   qkv = x @ Wq + bq                                  [L, 3C], fp32
//   per group g (gc = 8 channels):
//     logit[i, j] = (q_i . k_j) * s_g + b_g            bn_similarity
//     p[i, :]     = softmax_j(logit[i, :])
//     o[i]        = sum_j p[i, j] v_j
//   out = o * so_c + bo_c                              bn_output
// Channels come out in the standard (group-major) order; the TPU kernel's
// scrambled (cc, g) order was a tiling choice and is not carried over.
//
// What bounds it on the H100: ~17 MFLOP per window for both axes, three
// quarters of it the QKV projection, against ~154 KB of device traffic
// per window in bf16.  On CUDA cores the projection's FMAs bound this
// first version; the byte bound is ~0.19 ms at batch 4096.
//
// Design: a block takes a few whole sequences (at most 80 positions).  The
// sequence stride is an argument, so the height axis reads columns of the
// [B, H, W, C] tensor in place, with no transpose in device memory.  The
// block stages its positions in shared memory, runs the projection there
// (weights streamed through 32 x 64 tiles), keeps q, k, v in fp32 in shared
// memory, and one thread per (sequence, query, group) does the logits,
// softmax and weighted sum in registers.  Logits never leave the chip.
#include <cfloat>

#include "common.cuh"

namespace {

using wf::kThreads;
constexpr int kGroupChannels = 8;
constexpr int kMaxLen = 32;

template <typename T>
struct AttnArgs {
  const T* x;            // [B, H, W, C]
  T* out;                // same shape and addressing
  int nseq, len, c, groups;
  int n_inner;           // sequences per outer index
  long long inner_stride, outer_stride, seq_stride;   // in elements
  int seqs_per_block;
  const T* wq;           // [C, 3C]
  const float* bq;       // [3C]
  const float* sim;      // [2, G]: scale, bias
  const float* oaff;     // [2, C]: scale, bias
};

template <typename T>
__device__ __forceinline__ long long seq_base(const AttnArgs<T>& a, int s) {
  return (long long)(s / a.n_inner) * a.outer_stride +
         (long long)(s % a.n_inner) * a.inner_stride;
}

template <typename T>
__global__ void __launch_bounds__(kThreads) axial_attention_kernel(
    AttnArgs<T> a) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int c = a.c, c3 = 3 * c, ldq = c3 + 4;
  const int npos = a.seqs_per_block * a.len;
  float* ws = reinterpret_cast<float*>(smem);              // weight tile
  float* qkv = ws + wf::kTileFloats;                       // [npos, ldq]
  T* xs = reinterpret_cast<T*>(qkv + npos * ldq);          // [npos, c]
  const int s0 = blockIdx.x * a.seqs_per_block;
  const int nvalid = min(a.seqs_per_block, a.nseq - s0);

  for (int e = threadIdx.x; e < npos * c; e += kThreads) {
    const int p = e / c, ch = e % c;
    const int s = p / a.len, l = p % a.len;
    xs[e] = s < nvalid ? a.x[seq_base(a, s0 + s) + l * a.seq_stride + ch]
                       : wf::from_f<T>(0.f);
  }
  __syncthreads();

  // QKV projection, fp32 result kept in shared memory
  const int tx = threadIdx.x % 16, ty = threadIdx.x / 16;
  for (int n0 = 0; n0 < c3; n0 += wf::kTileN) {
    float acc[wf::kMaxRows][wf::kColsPerThread];
    wf::zero(acc);
    wf::gemm_acc(acc, xs, c, npos, a.wq, c, c3, n0, ws);
#pragma unroll
    for (int r = 0; r < wf::kMaxRows; ++r) {
      const int row = ty + 16 * r;
      if (row >= npos) continue;
#pragma unroll
      for (int k = 0; k < wf::kColsPerThread; ++k) {
        const int col = n0 + tx * 4 + k;
        if (col < c3) qkv[row * ldq + col] = acc[r][k] + a.bq[col];
      }
    }
  }
  __syncthreads();

  const int len = a.len, groups = a.groups;
  for (int e = threadIdx.x; e < nvalid * len * groups; e += kThreads) {
    const int g = e % groups, rest = e / groups;
    const int i = rest % len, s = rest / len;
    const float* base = qkv + (s * len) * ldq;
    float q[kGroupChannels];
#pragma unroll
    for (int cc = 0; cc < kGroupChannels; ++cc)
      q[cc] = base[i * ldq + g * kGroupChannels + cc];
    const float ss = a.sim[g], sb = a.sim[groups + g];
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
    T* dst = a.out + seq_base(a, s0 + s) + i * a.seq_stride;
#pragma unroll
    for (int cc = 0; cc < kGroupChannels; ++cc) {
      const int ch = g * kGroupChannels + cc;
      dst[ch] = wf::from_f<T>(o[cc] * r * a.oaff[ch] + a.oaff[c + ch]);
    }
  }
}

template <typename T>
int run(const void* x, void* out, int nseq, int len, int c, int groups,
        int n_inner, long long inner_stride, long long outer_stride,
        long long seq_stride, int seqs_per_block, const void* wq,
        const void* bq, const void* sim, const void* oaff, size_t smem_bytes,
        void* stream) {
  if (c != groups * kGroupChannels || len > kMaxLen ||
      seqs_per_block * len > 16 * wf::kMaxRows)
    return (int)cudaErrorInvalidValue;
  AttnArgs<T> a{static_cast<const T*>(x), static_cast<T*>(out), nseq, len, c,
                groups, n_inner, inner_stride, outer_stride, seq_stride,
                seqs_per_block, static_cast<const T*>(wq),
                static_cast<const float*>(bq), static_cast<const float*>(sim),
                static_cast<const float*>(oaff)};
  cudaError_t err = cudaFuncSetAttribute(
      axial_attention_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem_bytes);
  if (err != cudaSuccess) return (int)err;
  const int blocks = (nseq + seqs_per_block - 1) / seqs_per_block;
  axial_attention_kernel<T><<<blocks, kThreads, smem_bytes,
                              static_cast<cudaStream_t>(stream)>>>(a);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" int axial_attention_forward(
    int dtype, const void* x, void* out, int nseq, int len, int c, int groups,
    int n_inner, long long inner_stride, long long outer_stride,
    long long seq_stride, int seqs_per_block, const void* wq, const void* bq,
    const void* sim, const void* oaff, size_t smem_bytes, void* stream) {
  if (dtype == wf::kF32)
    return run<float>(x, out, nseq, len, c, groups, n_inner, inner_stride,
                      outer_stride, seq_stride, seqs_per_block, wq, bq, sim,
                      oaff, smem_bytes, stream);
  if (dtype == wf::kBF16)
    return run<__nv_bfloat16>(x, out, nseq, len, c, groups, n_inner,
                              inner_stride, outer_stride, seq_stride,
                              seqs_per_block, wq, bq, sim, oaff, smem_bytes,
                              stream);
  return (int)cudaErrorInvalidValue;
}

WF_EXPORT_ERROR_STRING
