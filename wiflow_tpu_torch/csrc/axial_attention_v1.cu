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
// values, 512 B an axis in bf16 at C = 64 (0.19 ms a [4096, 15, 20] axis
// at 3.35 TB/s), for ~4 L C FLOPs (L <= 20), far below the ~295 FLOPs per
// byte where the tensor cores would be the limit.  The fp32 core on CUDA
// cores (axial_attention_eval.cuh) takes about as long as those bytes, so
// the kernel can approach its bound only if the loads run while the core
// does.
//
// Design (the launch plan is ops/kernels/axial_attention.py::v1_plan; the
// C side refuses a plan that does not add up):
//   Tiles.  qkv is [B, H, W, 3C] and out [B, H, W, C]; a sequence is
//     addressed by strides counted in positions, so the height axis reads
//     the columns of the projection in place and writes the columns of the
//     output in place: no transpose in device memory.  A tile is a few
//     whole sequences, at most 80 positions.
//   A persistent grid with a ring.  The blocks that fit the SMs at once
//     walk the tiles (blockIdx.x, + gridDim.x, ...).  Shared memory holds
//     one fp32 q, k, v tile in the core's layout (QkvLayout) and a ring of
//     one tile of raw rows in the storage type, with its mbarrier.  While
//     the core runs on tile n, the bulk copies (the Tensor Memory
//     Accelerator's 1-D form) of the block's next tile's rows are in
//     flight into the ring: one copy a row (a sequence, where its rows are
//     contiguous), issued by one warp, so the loads cost the threads a few
//     instructions a row, not a chunk.  (A second raw tile, where one fits
//     beside two blocks an SM, measured no faster on the H100.)  The move
//     of tile n + 1 into the fp32 layout (bf16 -> fp32 is exact) is then a
//     pass from shared memory to shared memory, with no device-memory
//     latency behind it, in which each thread keeps one 16-byte column of
//     the rows for the launch.  Two blocks an SM; by ablation the move and
//     the copies still add to the core's time rather than hide behind it:
//     they compete with it for the SM, not for latency.
//   The core is the one the v2 and the one-launch kernels run
//     (wf::attend_tile: a thread takes 2 queries of one group and reads
//     each key and value once for them); a thread's items do not depend on
//     the grid or the block size, so the outputs are those of the earlier
//     one-tile-a-block design, bit for bit.  No atomics: a launch repeats
//     bit for bit.
#include "axial_attention_eval.cuh"

namespace {

template <typename T>
struct V1Args {
  const T* qkv;          // [B, H, W, 3C]
  T* out;                // [B, H, W, C]
  int nseq, len, c, groups;
  int n_inner;           // sequences per outer index
  long long inner_stride, outer_stride, seq_stride;   // in positions
  int seqs;              // whole sequences a tile
  const float* sim;      // [2, G]: scale, bias
  const float* oaff;     // [2, C]: scale, bias
};

struct Layout {
  int raw, bar, total;   // bytes
};

// Shared memory of a block: the fp32 q, k, v tile (at 0), the raw tile,
// [npos][3C] in the storage type, and its mbarrier.
__host__ __device__ inline Layout layout(int c, int npos, int esize) {
  Layout l;
  l.raw = npos * wf::qkv_ld(c) * 4;
  l.bar = l.raw + npos * 3 * c * esize;
  l.total = l.bar + 8;
  return l;
}

template <typename T>
__device__ __forceinline__ long long seq_pos(const V1Args<T>& a, int s) {
  return (long long)(s / a.n_inner) * a.outer_stride +
         (long long)(s % a.n_inner) * a.inner_stride;
}

// Warp 0: the raw rows of a tile's valid sequences into the raw tile, one
// bulk copy a row, or a sequence where its rows are contiguous; lane 0
// first arrives on the barrier for all of their bytes.
template <typename T>
__device__ __forceinline__ void stage_tile(const V1Args<T>& a, T* raw,
                                           uint64_t* bar, int tile) {
  const int lane = threadIdx.x & 31, c3 = 3 * a.c;
  const int s0 = tile * a.seqs, nvalid = min(a.seqs, a.nseq - s0);
  const int run = a.seq_stride == 1 ? a.len : 1;    // rows a copy
  const int bytes = run * c3 * (int)sizeof(T);
  const int copies = nvalid * a.len / run;
  if (lane == 0) wf::mbar_expect_tx(bar, copies * bytes);
  __syncwarp();
  for (int u = lane; u < copies; u += 32) {
    const int p = u * run, s = p / a.len, l = p - s * a.len;
    wf::bulk_copy_tx(raw + p * c3,
                     a.qkv + (seq_pos(a, s0 + s) + l * a.seq_stride) * c3,
                     bytes, bar);
  }
}

// The landed raw tile into the fp32 layout.  Thread (row r0, column c0) moves
// 16-byte chunk c0 (and c0 + per_row, ...) of rows r0, r0 + rows, ...: a
// chunk holds kVec channels of one group of q, k or v, which land on one
// or two runs of 4 contiguous floats (QkvLayout::at).
template <typename T>
__device__ __forceinline__ void settle_tile(const T* raw, float* qkv, int c,
                                            int npos, int per_row, int rows,
                                            int r0, int c0) {
  constexpr int kVec = 16 / sizeof(T);
  const int c3 = 3 * c, chunks = c3 / kVec, ldq = wf::qkv_ld(c);
  const wf::QkvLayout lay(c);
  if (r0 >= rows) return;
  for (int ch = c0; ch < chunks; ch += per_row) {
    const int col = ch * kVec;
    const int sec = (col >= c) + (col >= 2 * c), r = col - sec * c;
    int dst[kVec / 4];
#pragma unroll
    for (int k = 0; k < kVec; k += 4)
      dst[k / 4] = lay.at(sec, r / 8, r % 8 + k);
    for (int p = r0; p < npos; p += rows) {
      const uint4 u = *reinterpret_cast<const uint4*>(raw + p * c3 + col);
      const T* vals = reinterpret_cast<const T*>(&u);
      float* row = qkv + p * ldq;
#pragma unroll
      for (int k = 0; k < kVec; k += 4)
        *reinterpret_cast<float4*>(row + dst[k / 4]) =
            make_float4(wf::to_f(vals[k]), wf::to_f(vals[k + 1]),
                        wf::to_f(vals[k + 2]), wf::to_f(vals[k + 3]));
    }
  }
}

template <typename T>
__global__ void __launch_bounds__(wf::kMaxAttnThreads, 2)
    axial_attention_v1_kernel(const V1Args<T> a) {
  extern __shared__ __align__(16) unsigned char smem[];
  constexpr int kVec = 16 / sizeof(T);
  const int c = a.c, len = a.len;
  const Layout l = layout(c, a.seqs * len, (int)sizeof(T));
  float* qkv = reinterpret_cast<float*>(smem);
  T* raw = reinterpret_cast<T*>(smem + l.raw);
  uint64_t* bar = reinterpret_cast<uint64_t*>(smem + l.bar);
  const int ntiles = (a.nseq + a.seqs - 1) / a.seqs;
  const int warp = threadIdx.x >> 5;
  // the move's columns: a thread keeps one for the launch
  const int chunks = 3 * c / kVec, per_row = min(chunks, (int)blockDim.x);
  const int rows = blockDim.x / per_row;
  const int r0 = threadIdx.x / per_row, c0 = threadIdx.x - r0 * per_row;

  if (threadIdx.x == 0) {
    wf::mbar_init(bar, 1);
    wf::mbar_init_fence();
  }
  __syncthreads();
  if (warp == 0 && blockIdx.x < ntiles) stage_tile(a, raw, bar, blockIdx.x);
  int parity = 0;   // of the barrier's phase that brings the next tile
  for (int tile = blockIdx.x; tile < ntiles; tile += gridDim.x) {
    const int s0 = tile * a.seqs, nvalid = min(a.seqs, a.nseq - s0);
    wf::mbar_wait(bar, parity);
    parity ^= 1;
    __syncthreads();   // the last core is done with the fp32 tile
    settle_tile(raw, qkv, c, nvalid * len, per_row, rows, r0, c0);
    __syncthreads();   // q, k, v in fp32; the raw tile is free
    const int next = tile + (int)gridDim.x;
    if (warp == 0 && next < ntiles) stage_tile(a, raw, bar, next);
    wf::attend_tile<T>(
        qkv, c, len, nvalid, a.sim, a.oaff, [&](int s, int i, int g) {
          return a.out + (seq_pos(a, s0 + s) + i * a.seq_stride) * c +
                 g * wf::kGroupChannels;
        });
  }
}

template <typename T>
int run(const void* qkv, void* out, int nseq, int len, int c, int groups,
        int n_inner, long long inner_stride, long long outer_stride,
        long long seq_stride, int seqs, int threads, int grid,
        const void* sim, const void* oaff, size_t smem_bytes, void* stream) {
  if (c != groups * wf::kGroupChannels || len < 1 || len > wf::kMaxLen ||
      seqs < 1 || nseq < 1 || threads % 32 || threads < 32 ||
      threads > wf::kMaxAttnThreads || grid < 1 ||
      smem_bytes < (size_t)layout(c, seqs * len, (int)sizeof(T)).total ||
      smem_bytes > 232448)
    return (int)cudaErrorInvalidValue;
  V1Args<T> a{static_cast<const T*>(qkv), static_cast<T*>(out), nseq, len, c,
              groups, n_inner, inner_stride, outer_stride, seq_stride,
              seqs, static_cast<const float*>(sim),
              static_cast<const float*>(oaff)};
  cudaError_t err = cudaFuncSetAttribute(
      axial_attention_v1_kernel<T>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem_bytes);
  if (err != cudaSuccess) return (int)err;
  axial_attention_v1_kernel<T><<<grid, threads, smem_bytes,
                                 static_cast<cudaStream_t>(stream)>>>(a);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" int axial_attention_v1_forward(
    int dtype, const void* qkv, void* out, int nseq, int len, int c,
    int groups, int n_inner, long long inner_stride, long long outer_stride,
    long long seq_stride, int seqs, int threads, int grid, const void* sim,
    const void* oaff, size_t smem_bytes, void* stream) {
  if (dtype == wf::kF32)
    return run<float>(qkv, out, nseq, len, c, groups, n_inner, inner_stride,
                      outer_stride, seq_stride, seqs, threads, grid, sim,
                      oaff, smem_bytes, stream);
  if (dtype == wf::kBF16)
    return run<__nv_bfloat16>(qkv, out, nseq, len, c, groups, n_inner,
                              inner_stride, outer_stride, seq_stride, seqs,
                              threads, grid, sim, oaff, smem_bytes, stream);
  return (int)cudaErrorInvalidValue;
}

WF_EXPORT_ERROR_STRING
