// Train-mode axial attention core, forward and backward, for sm_90a.
//
// Replaces wiflow_tpu/ops/pallas/axial_attention_train.py:axial_core, its
// forward (_core_fwd_kernel) and its backward (_core_bwd_kernel).  Per
// sequence n of L positions (L = 20 on the width axis, 15 on the height
// axis) and per group g of 8 channels, with s_g the logits-BN scale:
//   lg[i, j] = q_i . k_j              raw logits
//   p[i, :]  = softmax_j(s_g lg[i, :])
//   out_i    = sum_j p[i, j] v_j
// and, given dout,
//   dsim[i, j] = dout_i . v_j,  t_i = sum_j p[i, j] dsim[i, j]
//   dz[i, j]   = p[i, j] (dsim[i, j] - t_i),  dlg = s_g dz
//   dq_i = sum_j dlg[i, j] k_j,  dk_j = sum_i dlg[i, j] q_i,
//   dv_j = sum_i p[i, j] dout_i,  dscale_g = sum_{n,i,j} dz lg.
// q, k and v are [N, L, *] with a position stride `ld` (so the thirds of
// a [N, L, 3C] projection are read in place); out, dout, dq, dk and dv are
// contiguous [N, L, C].  Channels are in the standard order; the TPU
// kernel's scrambled order and its padding of N to 128 lanes were tiling
// choices and are not carried over.
//
// What bounds it on the H100: bytes.  At batch 256 the width axis moves
// ~39 MB in bf16 (q, k, v read, out written) for ~0.4 GFLOP; the bound is
// ~0.012 ms forward.
//
// Design: a block stages a few whole sequences (at most 80 positions) of
// q, k, v (and dout) in shared memory as fp32.  One thread per (sequence,
// position, group) keeps its row of logits in registers; nothing of size
// L x L reaches device memory, and the backward recomputes the logits and
// the softmax instead of saving them.  The backward runs in two phases
// separated by a barrier: per query row (dq, and the row's softmax max,
// 1/denominator and t kept in shared memory), then per key column (dk, dv,
// recomputing p from those row statistics).  dscale goes through per-block
// partials and wf::reduce_columns (attention_train.cuh).
#include <cfloat>

#include "attention_train.cuh"

namespace {

using wf::kGC;
using wf::kMaxLen;
using wf::kThreads;

template <typename T>
struct CoreArgs {
  const T* q;
  const T* k;
  const T* v;            // [N, L, *], position stride ld
  int ld;
  const T* dout;         // [N, L, C] (backward)
  T* out;                // [N, L, C] (forward)
  T* dq;
  T* dk;
  T* dv;                 // [N, L, C] (backward)
  const float* scale;    // [G]
  float* partial;        // [blocks, G] (backward)
  int nseq, len, c, groups, seqs_per_block;
};

template <typename T>
__global__ void __launch_bounds__(kThreads) core_forward_kernel(
    CoreArgs<T> a) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int c = a.c, len = a.len, groups = a.groups;
  const int npos = a.seqs_per_block * len;
  float* qs = reinterpret_cast<float*>(smem);
  float* ks = qs + npos * c;
  float* vs = ks + npos * c;
  const int s0 = blockIdx.x * a.seqs_per_block;
  const int nvalid = min(a.seqs_per_block, a.nseq - s0);
  wf::stage_rows(qs, a.q, a.ld, s0, nvalid, len, c, npos);
  wf::stage_rows(ks, a.k, a.ld, s0, nvalid, len, c, npos);
  wf::stage_rows(vs, a.v, a.ld, s0, nvalid, len, c, npos);
  __syncthreads();

  for (int e = threadIdx.x; e < nvalid * len * groups; e += kThreads) {
    const int g = e % groups, p = e / groups;       // p = s * len + i
    const int s = p / len;
    const float sc = a.scale[g];
    const float* qi = qs + p * c + g * kGC;
    const float* kb = ks + s * len * c + g * kGC;
    const float* vb = vs + s * len * c + g * kGC;
    float z[kMaxLen];
    float m = -FLT_MAX;
#pragma unroll
    for (int j = 0; j < kMaxLen; ++j) {
      if (j < len) {
        z[j] = wf::dot8(qi, kb + j * c) * sc;
        m = fmaxf(m, z[j]);
      }
    }
    float den = 0.f;
    float o[kGC];
#pragma unroll
    for (int cc = 0; cc < kGC; ++cc) o[cc] = 0.f;
#pragma unroll
    for (int j = 0; j < kMaxLen; ++j) {
      if (j < len) {
        const float pj = expf(z[j] - m);
        den += pj;
#pragma unroll
        for (int cc = 0; cc < kGC; ++cc) o[cc] += pj * vb[j * c + cc];
      }
    }
    const float r = 1.0f / den;
#pragma unroll
    for (int cc = 0; cc < kGC; ++cc) o[cc] *= r;
    wf::store8(a.out + (size_t)(s0 * len + p) * c + g * kGC, o);
  }
}

template <typename T>
__global__ void __launch_bounds__(kThreads) core_backward_kernel(
    CoreArgs<T> a) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int c = a.c, len = a.len, groups = a.groups;
  const int npos = a.seqs_per_block * len;
  float* qs = reinterpret_cast<float*>(smem);
  float* ks = qs + npos * c;
  float* vs = ks + npos * c;
  float* ds = vs + npos * c;               // dout
  float* stats = ds + npos * c;            // [npos, G, 3]: max, 1/den, t
  float* red = stats + npos * groups * 3;  // [npos, G]: dscale terms
  const int s0 = blockIdx.x * a.seqs_per_block;
  const int nvalid = min(a.seqs_per_block, a.nseq - s0);
  wf::stage_rows(qs, a.q, a.ld, s0, nvalid, len, c, npos);
  wf::stage_rows(ks, a.k, a.ld, s0, nvalid, len, c, npos);
  wf::stage_rows(vs, a.v, a.ld, s0, nvalid, len, c, npos);
  wf::stage_rows(ds, a.dout, c, s0, nvalid, len, c, npos);
  __syncthreads();

  const int items = nvalid * len * groups;
  // phase 1: one query row per item -> dq_i, the row's statistics and its
  // dscale term
  for (int e = threadIdx.x; e < items; e += kThreads) {
    const int g = e % groups, p = e / groups;       // p = s * len + i
    const int s = p / len;
    const float sc = a.scale[g];
    const float* qi = qs + p * c + g * kGC;
    const float* di = ds + p * c + g * kGC;
    const float* kb = ks + s * len * c + g * kGC;
    const float* vb = vs + s * len * c + g * kGC;
    float lg[kMaxLen], dsim[kMaxLen];
    float m = -FLT_MAX;
#pragma unroll
    for (int j = 0; j < kMaxLen; ++j) {
      if (j < len) {
        lg[j] = wf::dot8(qi, kb + j * c);
        dsim[j] = wf::dot8(di, vb + j * c);
        m = fmaxf(m, lg[j] * sc);
      }
    }
    float den = 0.f;
#pragma unroll
    for (int j = 0; j < kMaxLen; ++j)
      if (j < len) den += expf(lg[j] * sc - m);
    const float r = 1.0f / den;
    float t = 0.f;
#pragma unroll
    for (int j = 0; j < kMaxLen; ++j)
      if (j < len) t += expf(lg[j] * sc - m) * r * dsim[j];
    float dsc = 0.f;
    float dqi[kGC];
#pragma unroll
    for (int cc = 0; cc < kGC; ++cc) dqi[cc] = 0.f;
#pragma unroll
    for (int j = 0; j < kMaxLen; ++j) {
      if (j < len) {
        const float pj = expf(lg[j] * sc - m) * r;
        const float dz = pj * (dsim[j] - t);
        dsc += dz * lg[j];
        const float dl = dz * sc;
#pragma unroll
        for (int cc = 0; cc < kGC; ++cc) dqi[cc] += dl * kb[j * c + cc];
      }
    }
    wf::store8(a.dq + (size_t)(s0 * len + p) * c + g * kGC, dqi);
    float* st = stats + (p * groups + g) * 3;
    st[0] = m;
    st[1] = r;
    st[2] = t;
    red[p * groups + g] = dsc;
  }
  __syncthreads();
  wf::block_column_sums(red, nvalid * len, groups, a.partial);

  // phase 2: one key column per item -> dk_j, dv_j
  for (int e = threadIdx.x; e < items; e += kThreads) {
    const int g = e % groups, p = e / groups;       // p = s * len + j
    const int s = p / len;
    const float sc = a.scale[g];
    const float* kj = ks + p * c + g * kGC;
    const float* vj = vs + p * c + g * kGC;
    float dkj[kGC], dvj[kGC];
#pragma unroll
    for (int cc = 0; cc < kGC; ++cc) dkj[cc] = dvj[cc] = 0.f;
    for (int i = 0; i < len; ++i) {
      const int pi = s * len + i;
      const float* qi = qs + pi * c + g * kGC;
      const float* di = ds + pi * c + g * kGC;
      const float* st = stats + (pi * groups + g) * 3;
      const float pij = expf(wf::dot8(qi, kj) * sc - st[0]) * st[1];
      const float dl = pij * (wf::dot8(di, vj) - st[2]) * sc;
#pragma unroll
      for (int cc = 0; cc < kGC; ++cc) {
        dkj[cc] += dl * qi[cc];
        dvj[cc] += pij * di[cc];
      }
    }
    const size_t o = (size_t)(s0 * len + p) * c + g * kGC;
    wf::store8(a.dk + o, dkj);
    wf::store8(a.dv + o, dvj);
  }
}

template <typename T>
int launch(bool backward, const CoreArgs<T>& a, float* dscale, void* stream) {
  if (a.c != a.groups * kGC || a.len > kMaxLen || a.len < 1 ||
      a.groups > kThreads || a.seqs_per_block < 1 || a.nseq < 1)
    return (int)cudaErrorInvalidValue;
  const int npos = a.seqs_per_block * a.len;
  const int blocks = (a.nseq + a.seqs_per_block - 1) / a.seqs_per_block;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (!backward) {
    const size_t smem = (size_t)3 * npos * a.c * sizeof(float);
    cudaError_t err = cudaFuncSetAttribute(
        core_forward_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (err != cudaSuccess) return (int)err;
    core_forward_kernel<T><<<blocks, kThreads, smem, st>>>(a);
    return (int)cudaGetLastError();
  }
  const size_t smem =
      (size_t)(4 * npos * a.c + 4 * npos * a.groups) * sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(
      core_backward_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return (int)err;
  core_backward_kernel<T><<<blocks, kThreads, smem, st>>>(a);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  wf::reduce_columns<<<1, kThreads, 0, st>>>(a.partial, blocks, a.groups,
                                             dscale);
  return (int)cudaGetLastError();
}

template <typename T>
int run(bool backward, const void* q, const void* k, const void* v, int ld,
        const void* dout, void* out, void* dq, void* dk, void* dv,
        const void* scale, void* partial, void* dscale, int nseq, int len,
        int c, int groups, int seqs_per_block, void* stream) {
  const CoreArgs<T> a{static_cast<const T*>(q),    static_cast<const T*>(k),
                      static_cast<const T*>(v),    ld,
                      static_cast<const T*>(dout), static_cast<T*>(out),
                      static_cast<T*>(dq),         static_cast<T*>(dk),
                      static_cast<T*>(dv),         static_cast<const float*>(scale),
                      static_cast<float*>(partial), nseq, len, c, groups,
                      seqs_per_block};
  return launch(backward, a, static_cast<float*>(dscale), stream);
}

}  // namespace

extern "C" int axial_core_forward(int dtype, const void* q, const void* k,
                                  const void* v, int ld, void* out, int nseq,
                                  int len, int c, int groups,
                                  int seqs_per_block, const void* scale,
                                  void* stream) {
  if (dtype == wf::kF32)
    return run<float>(false, q, k, v, ld, nullptr, out, nullptr, nullptr,
                      nullptr, scale, nullptr, nullptr, nseq, len, c, groups,
                      seqs_per_block, stream);
  if (dtype == wf::kBF16)
    return run<__nv_bfloat16>(false, q, k, v, ld, nullptr, out, nullptr,
                              nullptr, nullptr, scale, nullptr, nullptr, nseq,
                              len, c, groups, seqs_per_block, stream);
  return (int)cudaErrorInvalidValue;
}

extern "C" int axial_core_backward(int dtype, const void* q, const void* k,
                                   const void* v, int ld, const void* dout,
                                   void* dq, void* dk, void* dv, int nseq,
                                   int len, int c, int groups,
                                   int seqs_per_block, const void* scale,
                                   void* partial, void* dscale, void* stream) {
  if (dtype == wf::kF32)
    return run<float>(true, q, k, v, ld, dout, nullptr, dq, dk, dv, scale,
                      partial, dscale, nseq, len, c, groups, seqs_per_block,
                      stream);
  if (dtype == wf::kBF16)
    return run<__nv_bfloat16>(true, q, k, v, ld, dout, nullptr, dq, dk, dv,
                              scale, partial, dscale, nseq, len, c, groups,
                              seqs_per_block, stream);
  return (int)cudaErrorInvalidValue;
}

WF_EXPORT_ERROR_STRING
