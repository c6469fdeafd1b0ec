// Sums of the attention logits and of their squares, forward and backward,
// for sm_90a.
//
// Replaces wiflow_tpu/ops/pallas/axial_attention_train.py:logits_sums, its
// forward (_moments_fwd_kernel) and its backward (_moments_bwd_kernel).
// With lg[n, g, i, j] = q_{n,i} . k_{n,j} over the 8 channels of group g:
//   sums[0, g] = sum_{n,i,j} lg,   sums[1, g] = sum_{n,i,j} lg^2,
// the batch statistics of the BatchNorm on the logits, with no logits in
// device memory.  Given dsums [2, G]:
//   dlg = dsums[0, g] + 2 lg dsums[1, g]
//   dq_i = sum_j dlg[i, j] k_j,   dk_j = sum_i dlg[i, j] q_i.
// q and k are [N, L, *] with a position stride `ld`; dq and dk are
// contiguous [N, L, C].
//
// What bounds it on the H100: bytes.  At batch 256 the forward reads q and
// k of the width axis (~20 MB in bf16) for ~0.4 GFLOP: ~0.006 ms.
//
// Design: as axial_core.cu, a block stages a few whole sequences of q and
// k in shared memory as fp32 and one thread takes one (sequence, query,
// group) row of logits in registers.  The forward sums each row, then the
// block's rows in a fixed order into partial[block, 2G], then a second
// launch (wf::reduce_columns) sums the blocks in float64: deterministic, no
// atomics.  The backward needs no reduction across blocks: per query row
// (dq), then per key column (dk), each recomputing its logits.
#include "attention_train.cuh"

namespace {

using wf::kGC;
using wf::kMaxLen;
using wf::kThreads;

template <typename T>
struct SumsArgs {
  const T* q;
  const T* k;            // [N, L, *], position stride ld
  int ld;
  const float* dsums;    // [2, G] (backward)
  T* dq;
  T* dk;                 // [N, L, C] (backward)
  float* partial;        // [blocks, 2G] (forward)
  int nseq, len, c, groups, seqs_per_block;
};

template <typename T>
__global__ void __launch_bounds__(kThreads) sums_forward_kernel(
    SumsArgs<T> a) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int c = a.c, len = a.len, groups = a.groups;
  const int npos = a.seqs_per_block * len;
  float* qs = reinterpret_cast<float*>(smem);
  float* ks = qs + npos * c;
  float* red = ks + npos * c;              // [npos, 2G]: row sums
  const int s0 = blockIdx.x * a.seqs_per_block;
  const int nvalid = min(a.seqs_per_block, a.nseq - s0);
  wf::stage_rows(qs, a.q, a.ld, s0, nvalid, len, c, npos);
  wf::stage_rows(ks, a.k, a.ld, s0, nvalid, len, c, npos);
  __syncthreads();

  for (int e = threadIdx.x; e < nvalid * len * groups; e += kThreads) {
    const int g = e % groups, p = e / groups;       // p = s * len + i
    const int s = p / len;
    const float* qi = qs + p * c + g * kGC;
    const float* kb = ks + s * len * c + g * kGC;
    float s1 = 0.f, s2 = 0.f;
    for (int j = 0; j < len; ++j) {
      const float lg = wf::dot8(qi, kb + j * c);
      s1 += lg;
      s2 += lg * lg;
    }
    red[p * 2 * groups + g] = s1;
    red[p * 2 * groups + groups + g] = s2;
  }
  __syncthreads();
  wf::block_column_sums(red, nvalid * len, 2 * groups, a.partial);
}

template <typename T>
__global__ void __launch_bounds__(kThreads) sums_backward_kernel(
    SumsArgs<T> a) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int c = a.c, len = a.len, groups = a.groups;
  const int npos = a.seqs_per_block * len;
  float* qs = reinterpret_cast<float*>(smem);
  float* ks = qs + npos * c;
  const int s0 = blockIdx.x * a.seqs_per_block;
  const int nvalid = min(a.seqs_per_block, a.nseq - s0);
  wf::stage_rows(qs, a.q, a.ld, s0, nvalid, len, c, npos);
  wf::stage_rows(ks, a.k, a.ld, s0, nvalid, len, c, npos);
  __syncthreads();

  // one item per (sequence, position, group): dq of the position as a
  // query row, then dk of the same position as a key column
  for (int e = threadIdx.x; e < nvalid * len * groups; e += kThreads) {
    const int g = e % groups, p = e / groups;       // p = s * len + i
    const int s = p / len;
    const float d1 = a.dsums[g], d2 = 2.f * a.dsums[groups + g];
    const float* qp = qs + p * c + g * kGC;
    const float* kp = ks + p * c + g * kGC;
    const float* qb = qs + s * len * c + g * kGC;
    const float* kb = ks + s * len * c + g * kGC;
    float dqp[kGC], dkp[kGC];
#pragma unroll
    for (int cc = 0; cc < kGC; ++cc) dqp[cc] = dkp[cc] = 0.f;
    for (int j = 0; j < len; ++j) {
      const float* kj = kb + j * c;
      const float* qj = qb + j * c;
      const float dl_row = d1 + d2 * wf::dot8(qp, kj);   // dlg[p, j]
      const float dl_col = d1 + d2 * wf::dot8(qj, kp);   // dlg[j, p]
#pragma unroll
      for (int cc = 0; cc < kGC; ++cc) {
        dqp[cc] += dl_row * kj[cc];
        dkp[cc] += dl_col * qj[cc];
      }
    }
    const size_t o = (size_t)(s0 * len + p) * c + g * kGC;
    wf::store8(a.dq + o, dqp);
    wf::store8(a.dk + o, dkp);
  }
}

template <typename T>
int run(bool backward, const void* q, const void* k, int ld,
        const void* dsums, void* dq, void* dk, void* partial, void* sums,
        int nseq, int len, int c, int groups, int seqs_per_block,
        void* stream) {
  if (c != groups * kGC || len > kMaxLen || len < 1 ||
      2 * groups > kThreads || seqs_per_block < 1 || nseq < 1)
    return (int)cudaErrorInvalidValue;
  const SumsArgs<T> a{static_cast<const T*>(q), static_cast<const T*>(k), ld,
                      static_cast<const float*>(dsums), static_cast<T*>(dq),
                      static_cast<T*>(dk), static_cast<float*>(partial), nseq,
                      len, c, groups, seqs_per_block};
  const int npos = seqs_per_block * len;
  const int blocks = (nseq + seqs_per_block - 1) / seqs_per_block;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (backward) {
    const size_t smem = (size_t)2 * npos * c * sizeof(float);
    cudaError_t err = cudaFuncSetAttribute(
        sums_backward_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (err != cudaSuccess) return (int)err;
    sums_backward_kernel<T><<<blocks, kThreads, smem, st>>>(a);
    return (int)cudaGetLastError();
  }
  const size_t smem = (size_t)(2 * npos * c + 2 * npos * groups) *
                      sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(
      sums_forward_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return (int)err;
  sums_forward_kernel<T><<<blocks, kThreads, smem, st>>>(a);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  wf::reduce_columns<<<1, kThreads, 0, st>>>(
      static_cast<const float*>(partial), blocks, 2 * groups,
      static_cast<float*>(sums));
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" int logits_sums_forward(int dtype, const void* q, const void* k,
                                   int ld, int nseq, int len, int c,
                                   int groups, int seqs_per_block,
                                   void* partial, void* sums, void* stream) {
  if (dtype == wf::kF32)
    return run<float>(false, q, k, ld, nullptr, nullptr, nullptr, partial,
                      sums, nseq, len, c, groups, seqs_per_block, stream);
  if (dtype == wf::kBF16)
    return run<__nv_bfloat16>(false, q, k, ld, nullptr, nullptr, nullptr,
                              partial, sums, nseq, len, c, groups,
                              seqs_per_block, stream);
  return (int)cudaErrorInvalidValue;
}

extern "C" int logits_sums_backward(int dtype, const void* q, const void* k,
                                    int ld, const void* dsums, void* dq,
                                    void* dk, int nseq, int len, int c,
                                    int groups, int seqs_per_block,
                                    void* stream) {
  if (dtype == wf::kF32)
    return run<float>(true, q, k, ld, dsums, dq, dk, nullptr, nullptr, nseq,
                      len, c, groups, seqs_per_block, stream);
  if (dtype == wf::kBF16)
    return run<__nv_bfloat16>(true, q, k, ld, dsums, dq, dk, nullptr, nullptr,
                              nseq, len, c, groups, seqs_per_block, stream);
  return (int)cudaErrorInvalidValue;
}

WF_EXPORT_ERROR_STRING
