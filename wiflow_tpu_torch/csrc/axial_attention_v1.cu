// Eval axial attention along one axis on a precomputed qkv, for sm_90a.
//
// Replaces wiflow_tpu/ops/pallas/axial_attention.py:axial_attention_eval
// (the v1 kernel, body _kernel).  The QKV projection with bn_qkv folded in
// runs outside the kernel, as in the JAX package, and its result is rounded
// to the storage type before the kernel reads it.  Per sequence of L
// positions and per group g of 8 channels:
//   logit[i, j] = (q_i . k_j) * s_g + b_g            bn_similarity
//   p[i, :]     = softmax_j(logit[i, :])
//   o[i]        = sum_j p[i, j] v_j
//   out         = o * so_c + bo_c                    bn_output
// Channels are in the standard (group-major) order, as in the TPU kernel.
//
// What bounds it on the H100: bytes.  A position reads 3C and writes C
// values for ~4 L C FLOPs (L <= 20), far below the ~295 FLOPs per byte
// where the tensor cores would be the limit.
//
// Design: qkv is [B, H, W, 3C] and out [B, H, W, C]; a sequence is
// addressed by strides counted in positions, so the height axis reads the
// columns of the projection in place and writes the columns of the output
// in place: no transpose in device memory.  A block copies a few whole
// sequences (at most 80 positions) of qkv into shared memory as fp32 with
// 16-byte loads and runs the per-thread attention it shares with the v2
// kernel (axial_attention_eval.cuh), the projection stage taken out.
#include "axial_attention_eval.cuh"

namespace {

using wf::kThreads;

template <typename T>
struct V1Args {
  const T* qkv;          // [B, H, W, 3C]
  T* out;                // [B, H, W, C]
  int nseq, len, c, groups;
  int n_inner;           // sequences per outer index
  long long inner_stride, outer_stride, seq_stride;   // in positions
  int seqs_per_block;
  const float* sim;      // [2, G]: scale, bias
  const float* oaff;     // [2, C]: scale, bias
};

template <typename T>
__device__ __forceinline__ long long seq_pos(const V1Args<T>& a, int s) {
  return (long long)(s / a.n_inner) * a.outer_stride +
         (long long)(s % a.n_inner) * a.inner_stride;
}

template <typename T>
__global__ void __launch_bounds__(kThreads) axial_attention_v1_kernel(
    V1Args<T> a) {
  extern __shared__ __align__(16) unsigned char smem[];
  constexpr int kVec = 16 / sizeof(T);                     // values per load
  const int c = a.c, c3 = 3 * c, ldq = c3 + 4, len = a.len;
  float* qkv = reinterpret_cast<float*>(smem);             // [npos, ldq]
  const int s0 = blockIdx.x * a.seqs_per_block;
  const int nvalid = min(a.seqs_per_block, a.nseq - s0);

  const int vecs = c3 / kVec;
  for (int e = threadIdx.x; e < nvalid * len * vecs; e += kThreads) {
    const int p = e / vecs, col = (e % vecs) * kVec;
    const int s = p / len, l = p % len;
    const T* src = a.qkv + (seq_pos(a, s0 + s) + l * a.seq_stride) * c3 + col;
    const uint4 raw = *reinterpret_cast<const uint4*>(src);
    const T* vals = reinterpret_cast<const T*>(&raw);
#pragma unroll
    for (int k = 0; k < kVec; ++k) qkv[p * ldq + col + k] = wf::to_f(vals[k]);
  }
  __syncthreads();

  const int groups = a.groups;
  for (int e = threadIdx.x; e < nvalid * len * groups; e += kThreads) {
    const int g = e % groups, rest = e / groups;
    const int i = rest % len, s = rest / len;
    wf::attend_store(qkv + (s * len) * ldq, ldq, c, len, i, g, groups, a.sim,
                     a.oaff,
                     a.out + (seq_pos(a, s0 + s) + i * a.seq_stride) * c);
  }
}

template <typename T>
int run(const void* qkv, void* out, int nseq, int len, int c, int groups,
        int n_inner, long long inner_stride, long long outer_stride,
        long long seq_stride, int seqs_per_block, const void* sim,
        const void* oaff, size_t smem_bytes, void* stream) {
  if (c != groups * wf::kGroupChannels || len > wf::kMaxLen ||
      seqs_per_block < 1 ||
      smem_bytes < (size_t)seqs_per_block * len * (3 * c + 4) * sizeof(float))
    return (int)cudaErrorInvalidValue;
  V1Args<T> a{static_cast<const T*>(qkv), static_cast<T*>(out), nseq, len, c,
              groups, n_inner, inner_stride, outer_stride, seq_stride,
              seqs_per_block, static_cast<const float*>(sim),
              static_cast<const float*>(oaff)};
  cudaError_t err = cudaFuncSetAttribute(
      axial_attention_v1_kernel<T>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem_bytes);
  if (err != cudaSuccess) return (int)err;
  const int blocks = (nseq + seqs_per_block - 1) / seqs_per_block;
  axial_attention_v1_kernel<T><<<blocks, kThreads, smem_bytes,
                                 static_cast<cudaStream_t>(stream)>>>(a);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" int axial_attention_v1_forward(
    int dtype, const void* qkv, void* out, int nseq, int len, int c,
    int groups, int n_inner, long long inner_stride, long long outer_stride,
    long long seq_stride, int seqs_per_block, const void* sim,
    const void* oaff, size_t smem_bytes, void* stream) {
  if (dtype == wf::kF32)
    return run<float>(qkv, out, nseq, len, c, groups, n_inner, inner_stride,
                      outer_stride, seq_stride, seqs_per_block, sim, oaff,
                      smem_bytes, stream);
  if (dtype == wf::kBF16)
    return run<__nv_bfloat16>(qkv, out, nseq, len, c, groups, n_inner,
                              inner_stride, outer_stride, seq_stride,
                              seqs_per_block, sim, oaff, smem_bytes, stream);
  return (int)cudaErrorInvalidValue;
}

WF_EXPORT_ERROR_STRING
