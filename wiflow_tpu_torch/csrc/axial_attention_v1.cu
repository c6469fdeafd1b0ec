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
// 16-byte loads and runs the attention core it shares with the v2 kernel
// (axial_attention_eval.cuh: a thread takes 2 queries of one group and
// reads each key and value once for them), the projection stage taken out.
#include "axial_attention_eval.cuh"

namespace {

// A tile of at most 80 positions has at most 320 (sequence, query pair,
// group) items of the core, one a thread.
constexpr int kThreads = wf::kMaxAttnThreads;

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
__global__ void __launch_bounds__(kThreads, 2) axial_attention_v1_kernel(
    V1Args<T> a) {
  extern __shared__ __align__(16) unsigned char smem[];
  constexpr int kVec = 16 / sizeof(T);                     // values per load
  const int c = a.c, c3 = 3 * c, ldq = wf::qkv_ld(c), len = a.len;
  const wf::QkvLayout lay(c);
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
    // kVec channels of one group of q, k or v: one or two 4-float halves
    const int sec = col / c, r = col - sec * c;
    float* dst = qkv + p * ldq;
#pragma unroll
    for (int k = 0; k < kVec; k += 4)
      *reinterpret_cast<float4*>(dst + lay.at(sec, r / 8, r % 8 + k)) =
          make_float4(wf::to_f(vals[k]), wf::to_f(vals[k + 1]),
                      wf::to_f(vals[k + 2]), wf::to_f(vals[k + 3]));
  }
  __syncthreads();

  wf::attend_tile<T>(
      qkv, c, len, nvalid, a.sim, a.oaff, [&](int s, int i, int g) {
        return a.out + (seq_pos(a, s0 + s) + i * a.seq_stride) * c +
               g * wf::kGroupChannels;
      });
}

template <typename T>
int run(const void* qkv, void* out, int nseq, int len, int c, int groups,
        int n_inner, long long inner_stride, long long outer_stride,
        long long seq_stride, int seqs_per_block, const void* sim,
        const void* oaff, size_t smem_bytes, void* stream) {
  if (c != groups * wf::kGroupChannels || len > wf::kMaxLen ||
      seqs_per_block < 1 ||
      smem_bytes < (size_t)seqs_per_block * len * wf::qkv_ld(c) * sizeof(float))
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
