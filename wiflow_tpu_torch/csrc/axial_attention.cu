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
// What bounds it on the H100, both axes at batch 4096 in bf16 (C = 64):
// 0.63 GB of device traffic (x read, the output written, per axis) is
// 0.19 ms at 3.35 TB/s; the projection, 60 GFLOP, is 0.06 ms of bf16
// tensor-core time; the core, 11 GFLOP of fp32 FMAs on CUDA cores (the
// TPU kernel keeps it on the VPU) and 0.34 G exponentials, is ~0.3 ms at
// the 67 TFLOP/s fp32 rate and the SFUs' rate.  So the core's
// instructions, not bytes, set the floor.
//
// Design (the launch plan is ops/kernels/axial_attention.py::
// attention_plan; the C side refuses a plan that does not add up):
//   Tiles.  A tile is a few whole sequences (<= 80 positions: 4 rows of
//     20, 5 columns of 15).  The sequence stride is an argument, so the
//     height axis reads and writes the columns of [B, H, W, C] in place,
//     no transpose in device memory.  The grid is persistent: blocks sized
//     to the SMs walk the tiles, and each prefetches its next tile's input
//     rows with cp.async while its core runs.
//   Projection on the tensor cores (bf16).  The packed weights ([C, 3C] in
//     mma.sync B-fragment order, 24 KB at C = 64) are staged once per
//     block and stay resident; A fragments come by ldmatrix from the
//     staged rows (row stride C + 8: conflict-free), fp32 accumulation,
//     the bias in the epilogue, q, k, v written as fp32 to shared memory.
//   Core on CUDA cores, fp32: a thread takes 2 queries of one (sequence,
//     group) and reads each k_j, v_j once for them as 16-byte loads, in
//     one pass over the keys with a running max (a shared load per 4-8
//     FMAs).
//   fp32, the check type, runs the same tiles on CUDA-core FMAs and reads
//     [C, 3C] from device memory: no TF32.
// The stages are shared with the one-launch dual kernel and the v1 kernel
// (axial_attention_eval.cuh).  No atomics: a launch repeats bit for bit.
#include "axial_attention_eval.cuh"

namespace {

template <typename T>
struct AttnArgs {
  const T* x;            // [B, H, W, C]
  T* out;                // same shape and addressing
  int nseq, len, c, groups;
  int n_inner;           // sequences per outer index
  long long inner_stride, outer_stride, seq_stride;   // in elements
  int seqs;              // whole sequences a tile
  int ldx;               // elements of a staged input row
  const void* wpack;     // bf16: B fragments; fp32: [C, 3C]
  const float* bq;       // [3C]
  const float* sim;      // [2, G]: scale, bias
  const float* oaff;     // [2, C]: scale, bias
};

__host__ __device__ constexpr int align16(int v) { return (v + 15) / 16 * 16; }

struct Layout {
  int w, zero, xs, qkv, total;
};

// Shared memory of a block: the resident bf16 weights, a zero row for the
// padding rows of the last m-tile, the tile's staged input rows and its
// fp32 q, k, v.
__host__ __device__ inline Layout layout(int c, int npos, int ldx, int esize) {
  Layout l;
  l.w = 0;
  l.zero = esize == 2 ? align16(3 * c * c * 2) : 0;
  l.xs = l.zero + align16(ldx * esize);
  l.qkv = l.xs + align16(npos * ldx * esize);
  l.total = l.qkv + npos * wf::qkv_ld(c) * 4;
  return l;
}

template <typename T>
__device__ __forceinline__ long long seq_base(const AttnArgs<T>& a, int s) {
  return (long long)(s / a.n_inner) * a.outer_stride +
         (long long)(s % a.n_inner) * a.inner_stride;
}

// The input rows of a tile's valid sequences, 16 bytes at a time.
template <typename T>
__device__ __forceinline__ void stage_tile(const AttnArgs<T>& a, T* xs,
                                           int tile) {
  constexpr int kVec = 16 / sizeof(T);
  const int chunks = a.c / kVec;
  const int s0 = tile * a.seqs, nvalid = min(a.seqs, a.nseq - s0);
  const wf::FastDiv by_chunks(chunks), by_len(a.len);
  for (int e = threadIdx.x; e < nvalid * a.len * chunks; e += blockDim.x) {
    const int p = by_chunks.div(e), ch = e - p * chunks;
    const int s = by_len.div(p), l = p - s * a.len;
    wf::cp_async16(xs + p * a.ldx + ch * kVec,
                   a.x + seq_base(a, s0 + s) + l * a.seq_stride + ch * kVec);
  }
}

template <typename T>
__global__ void __launch_bounds__(wf::kMaxAttnThreads, 2)
    axial_attention_kernel(const AttnArgs<T> a) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int c = a.c, len = a.len;
  const Layout l = layout(c, a.seqs * len, a.ldx, (int)sizeof(T));
  const T* zero = reinterpret_cast<const T*>(smem + l.zero);
  T* xs = reinterpret_cast<T*>(smem + l.xs);
  float* qkv = reinterpret_cast<float*>(smem + l.qkv);
  const int tid = threadIdx.x;

  if constexpr (sizeof(T) == 2) {   // the weights, once for the block's life
    for (int e = tid; e < 3 * c * c * 2 / 16; e += blockDim.x)
      wf::cp_async16(smem + l.w + 16 * e,
                     static_cast<const unsigned char*>(a.wpack) + 16 * e);
  }
  for (int e = tid; e < (l.xs - l.zero) / 16; e += blockDim.x)
    reinterpret_cast<uint4*>(smem + l.zero)[e] = make_uint4(0, 0, 0, 0);
  const int ntiles = (a.nseq + a.seqs - 1) / a.seqs;
  if (blockIdx.x < ntiles) stage_tile(a, xs, blockIdx.x);
  wf::cp_async_commit();

  for (int tile = blockIdx.x; tile < ntiles; tile += gridDim.x) {
    const int s0 = tile * a.seqs, nvalid = min(a.seqs, a.nseq - s0);
    const int npos = nvalid * len;
    wf::cp_async_wait<0>();
    __syncthreads();   // rows (and weights) landed; the last core is done
    const auto row = [&](int p, int e) {
      return (p < npos ? xs + p * a.ldx : zero) + e;
    };
    if constexpr (sizeof(T) == 2)
      wf::project_tile(row, npos, c,
                       reinterpret_cast<const __nv_bfloat16*>(smem + l.w),
                       a.bq, qkv);
    else
      wf::project_tile(row, npos, c, static_cast<const float*>(a.wpack),
                       a.bq, qkv);
    __syncthreads();   // q, k, v written; the staged rows are free
    if (tile + (int)gridDim.x < ntiles) stage_tile(a, xs, tile + gridDim.x);
    wf::cp_async_commit();
    wf::attend_tile<T>(qkv, c, len, nvalid, a.sim, a.oaff,
                       [&](int s, int i, int g) {
                         return a.out + seq_base(a, s0 + s) +
                                i * a.seq_stride + g * wf::kGroupChannels;
                       });
  }
  wf::cp_async_wait<0>();
}

template <typename T>
int run(const void* x, void* out, int nseq, int len, int c, int groups,
        int n_inner, long long inner_stride, long long outer_stride,
        long long seq_stride, int seqs, int threads, int grid, int ldx,
        const void* wpack, const void* bq, const void* sim,
        const void* oaff, size_t smem_bytes, void* stream) {
  const int esize = (int)sizeof(T);
  if (c != groups * wf::kGroupChannels || c % 16 || len < 1 ||
      len > wf::kMaxLen || seqs < 1 || nseq < 1 || threads % 32 ||
      threads < 32 || threads > wf::kMaxAttnThreads || grid < 1 ||
      ldx < c || ldx * esize % 16 ||
      smem_bytes < (size_t)layout(c, seqs * len, ldx, esize).total ||
      smem_bytes > 232448)
    return (int)cudaErrorInvalidValue;
  AttnArgs<T> a{static_cast<const T*>(x), static_cast<T*>(out), nseq, len, c,
                groups, n_inner, inner_stride, outer_stride, seq_stride,
                seqs, ldx, wpack, static_cast<const float*>(bq),
                static_cast<const float*>(sim),
                static_cast<const float*>(oaff)};
  cudaError_t err = cudaFuncSetAttribute(
      axial_attention_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem_bytes);
  if (err != cudaSuccess) return (int)err;
  axial_attention_kernel<T><<<grid, threads, smem_bytes,
                              static_cast<cudaStream_t>(stream)>>>(a);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" int axial_attention_forward(
    int dtype, const void* x, void* out, int nseq, int len, int c, int groups,
    int n_inner, long long inner_stride, long long outer_stride,
    long long seq_stride, int seqs, int threads, int grid, int ldx,
    const void* wpack, const void* bq, const void* sim,
    const void* oaff, size_t smem_bytes, void* stream) {
  if (dtype == wf::kF32)
    return run<float>(x, out, nseq, len, c, groups, n_inner, inner_stride,
                      outer_stride, seq_stride, seqs, threads, grid, ldx,
                      wpack, bq, sim, oaff, smem_bytes, stream);
  if (dtype == wf::kBF16)
    return run<__nv_bfloat16>(x, out, nseq, len, c, groups, n_inner,
                              inner_stride, outer_stride, seq_stride, seqs,
                              threads, grid, ldx, wpack, bq, sim, oaff,
                              smem_bytes, stream);
  return (int)cudaErrorInvalidValue;
}

WF_EXPORT_ERROR_STRING
