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
// The projection and the per-thread attention are shared with the v1 and
// the dual kernel (axial_attention_eval.cuh).
#include "axial_attention_eval.cuh"

namespace {

using wf::kThreads;

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
  const int c = a.c, ldq = 3 * c + 4;
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
  wf::project_qkv(xs, npos, c, a.wq, a.bq, qkv, ldq, ws);

  const int len = a.len, groups = a.groups;
  for (int e = threadIdx.x; e < nvalid * len * groups; e += kThreads) {
    const int g = e % groups, rest = e / groups;
    const int i = rest % len, s = rest / len;
    wf::attend_store(qkv + (s * len) * ldq, ldq, c, len, i, g, groups, a.sim,
                     a.oaff,
                     a.out + seq_base(a, s0 + s) + i * a.seq_stride);
  }
}

template <typename T>
int run(const void* x, void* out, int nseq, int len, int c, int groups,
        int n_inner, long long inner_stride, long long outer_stride,
        long long seq_stride, int seqs_per_block, const void* wq,
        const void* bq, const void* sim, const void* oaff, size_t smem_bytes,
        void* stream) {
  if (c != groups * wf::kGroupChannels || len > wf::kMaxLen ||
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
