// The whole eval conv stack of WiFlow per (sample, time) row, for sm_90a.
//
// Replaces wiflow_tpu/ops/pallas/conv_stack.py:fused_conv_stack_eval
// (kernel body _make_kernel).  A row is one time step's 240 TCN features;
// it goes through ConvBlock1 (1 -> 8 channels, stride 1) and four stride-2
// blocks (8/16/32/64 channels, width 240 -> 120 -> 60 -> 30 -> 15).  Each
// block, with BatchNorm folded into the weights:
//   h1  = silu(conv1x3(x, stride) + b1)       reads x[s*w + d - 1], pad 1
//   h2  = silu(conv1x3(h1) + b2)
//   out = silu(conv1x3(h2) + b3 + x[s*w] @ D + e)
// h1, h2 and out are rounded to the storage type, as the Pallas kernel does.
//
// What bounds it on the H100: ~2.1 MFLOP per row (172 GFLOP at batch 4096)
// against 2.4 KB of device traffic per row in bf16, so it is compute-bound;
// with 1-64 channels per conv the CUDA-core fp32 rate (67 TFLOP/s, ~2.5 ms
// at batch 4096) is the realistic bound of this first version.
//
// Design: the TPU kernel's space-to-depth banded layout exists for the
// (8, 128) tiles and pads the FLOPs 8x; here the plain math runs per row.
// A block holds a few rows in shared memory, three [C, W] buffers each
// (channel-major), and writes only the final [64, 15] per row to device
// memory.  The weights of the conv in progress (at most 3*64*64 + 32*64
// floats) are staged in shared memory; each thread computes 8 output
// channels at one (row, w), so every activation it reads feeds 8 FMAs and
// the weight reads are warp-wide broadcasts.
#include "common.cuh"

namespace {

using wf::kThreads;
constexpr int kMaxBlocks = 8;
constexpr int kOutPerThread = 8;

template <typename T>
struct BlockW {
  const T* w1;          // [3, ci, co]
  const T* w2;          // [3, co, co]
  const T* w3;          // [3, co, co]
  const T* wd;          // [ci, co]
  const float* b1;      // [co] each
  const float* b2;
  const float* b3;
  const float* bd;
  int ci, co, stride, win, wout;
};

template <typename T>
struct StackArgs {
  const T* x;           // [rows, w0]
  T* out;               // [rows, co_last, wout_last]
  int rows;
  int block_rows;       // rows per thread block
  int buf;              // shared-memory elements per activation buffer per row
  int nblk;
  BlockW<T> blk[kMaxBlocks];
};

template <typename T>
__device__ void stage_weights(float* wsm, const T* __restrict__ w, int n) {
  for (int e = threadIdx.x; e < n; e += kThreads) wsm[e] = wf::to_f(w[e]);
}

// acc[o] += sum_ci sum_d src[ci, s*w + d - 1] * wsm[d, ci, co0 + o]
template <typename T>
__device__ __forceinline__ void conv1x3_acc(float (&acc)[kOutPerThread],
                                            const T* src, int ci_n, int win,
                                            int stride, int w, const float* wsm,
                                            int co_n, int co0) {
  for (int ci = 0; ci < ci_n; ++ci) {
#pragma unroll
    for (int d = 0; d < 3; ++d) {
      const int p = stride * w + d - 1;
      if (p < 0 || p >= win) continue;
      const float xv = wf::to_f(src[ci * win + p]);
      const float4* wr =
          reinterpret_cast<const float4*>(wsm + (d * ci_n + ci) * co_n + co0);
      const float4 wa = wr[0], wb = wr[1];
      acc[0] += xv * wa.x; acc[1] += xv * wa.y;
      acc[2] += xv * wa.z; acc[3] += xv * wa.w;
      acc[4] += xv * wb.x; acc[5] += xv * wb.y;
      acc[6] += xv * wb.z; acc[7] += xv * wb.w;
    }
  }
}

// dst[row] = silu(conv1x3(src[row]) + b) for every row of the block.
template <typename T>
__device__ void conv_stage(const T* src, T* dst, int buf, int nrows, int ci_n,
                           int win, int stride, int co_n, int wout,
                           const T* __restrict__ w,
                           const float* __restrict__ b, float* wsm) {
  __syncthreads();
  stage_weights(wsm, w, 3 * ci_n * co_n);
  __syncthreads();
  const int ncg = co_n / kOutPerThread;
  for (int u = threadIdx.x; u < nrows * ncg * wout; u += kThreads) {
    const int w_pos = u % wout, r = u / wout;
    const int co0 = (r % ncg) * kOutPerThread, row = r / ncg;
    float acc[kOutPerThread];
#pragma unroll
    for (int o = 0; o < kOutPerThread; ++o) acc[o] = b[co0 + o];
    conv1x3_acc(acc, src + row * buf, ci_n, win, stride, w_pos, wsm, co_n, co0);
    T* d = dst + row * buf;
#pragma unroll
    for (int o = 0; o < kOutPerThread; ++o)
      d[(co0 + o) * wout + w_pos] = wf::from_f<T>(wf::silu(acc[o]));
  }
}

template <typename T>
__global__ void __launch_bounds__(kThreads) conv_stack_kernel(StackArgs<T> a) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int nrows = a.block_rows, buf = a.buf;
  T* p0 = reinterpret_cast<T*>(smem);
  T* p1 = p0 + nrows * buf;
  T* p2 = p1 + nrows * buf;
  float* wsm = reinterpret_cast<float*>(p2 + nrows * buf);
  const int row0 = blockIdx.x * nrows;
  const int valid = min(nrows, a.rows - row0);

  const int w0 = a.blk[0].win;
  for (int e = threadIdx.x; e < nrows * w0; e += kThreads) {
    const int r = e / w0, c = e % w0;
    p0[r * buf + c] =
        r < valid ? a.x[(size_t)(row0 + r) * w0 + c] : wf::from_f<T>(0.f);
  }

  T* xb = p0;   // block input
  T* h1 = p1;
  T* h2 = p2;
  for (int k = 0; k < a.nblk; ++k) {
    const BlockW<T>& bw = a.blk[k];
    const bool last = k == a.nblk - 1;
    conv_stage(xb, h1, buf, nrows, bw.ci, bw.win, bw.stride, bw.co, bw.wout,
               bw.w1, bw.b1, wsm);
    conv_stage(h1, h2, buf, nrows, bw.co, bw.wout, 1, bw.co, bw.wout, bw.w2,
               bw.b2, wsm);
    // conv3 + strided 1x1 shortcut + residual, written over h1
    __syncthreads();
    const int n3 = 3 * bw.co * bw.co;
    stage_weights(wsm, bw.w3, n3);
    stage_weights(wsm + n3, bw.wd, bw.ci * bw.co);
    __syncthreads();
    const int ncg = bw.co / kOutPerThread;
    for (int u = threadIdx.x; u < nrows * ncg * bw.wout; u += kThreads) {
      const int w_pos = u % bw.wout, r = u / bw.wout;
      const int co0 = (r % ncg) * kOutPerThread, row = r / ncg;
      float acc[kOutPerThread];
#pragma unroll
      for (int o = 0; o < kOutPerThread; ++o)
        acc[o] = bw.b3[co0 + o] + bw.bd[co0 + o];
      conv1x3_acc(acc, h2 + row * buf, bw.co, bw.wout, 1, w_pos, wsm, bw.co,
                  co0);
      const T* xr = xb + row * buf;
      const int p = bw.stride * w_pos;
      for (int ci = 0; ci < bw.ci; ++ci) {
        const float xv = wf::to_f(xr[ci * bw.win + p]);
        const float4* wr =
            reinterpret_cast<const float4*>(wsm + n3 + ci * bw.co + co0);
        const float4 wa = wr[0], wb = wr[1];
        acc[0] += xv * wa.x; acc[1] += xv * wa.y;
        acc[2] += xv * wa.z; acc[3] += xv * wa.w;
        acc[4] += xv * wb.x; acc[5] += xv * wb.y;
        acc[6] += xv * wb.z; acc[7] += xv * wb.w;
      }
      if (last) {
        if (row < valid) {
          T* o_row = a.out + (size_t)(row0 + row) * bw.co * bw.wout;
#pragma unroll
          for (int o = 0; o < kOutPerThread; ++o)
            o_row[(co0 + o) * bw.wout + w_pos] = wf::from_f<T>(wf::silu(acc[o]));
        }
      } else {
        T* d = h1 + row * buf;
#pragma unroll
        for (int o = 0; o < kOutPerThread; ++o)
          d[(co0 + o) * bw.wout + w_pos] = wf::from_f<T>(wf::silu(acc[o]));
      }
    }
    T* t = xb;   // the block output (in h1) is the next block's input
    xb = h1;
    h1 = t;
  }
}

template <typename T>
int run(const void* x, void* out, int rows, int block_rows, int buf, int nblk,
        const int* dims, const void* const* ptrs, size_t smem_bytes,
        void* stream) {
  if (nblk < 1 || nblk > kMaxBlocks) return (int)cudaErrorInvalidValue;
  StackArgs<T> a{};
  a.x = static_cast<const T*>(x);
  a.out = static_cast<T*>(out);
  a.rows = rows;
  a.block_rows = block_rows;
  a.buf = buf;
  a.nblk = nblk;
  for (int k = 0; k < nblk; ++k) {
    BlockW<T>& b = a.blk[k];
    const int* d = dims + 5 * k;
    b.ci = d[0]; b.co = d[1]; b.stride = d[2]; b.win = d[3]; b.wout = d[4];
    const void* const* p = ptrs + 8 * k;
    b.w1 = static_cast<const T*>(p[0]);
    b.b1 = static_cast<const float*>(p[1]);
    b.w2 = static_cast<const T*>(p[2]);
    b.b2 = static_cast<const float*>(p[3]);
    b.w3 = static_cast<const T*>(p[4]);
    b.b3 = static_cast<const float*>(p[5]);
    b.wd = static_cast<const T*>(p[6]);
    b.bd = static_cast<const float*>(p[7]);
    if (b.co % kOutPerThread != 0) return (int)cudaErrorInvalidValue;
  }
  cudaError_t err = cudaFuncSetAttribute(
      conv_stack_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem_bytes);
  if (err != cudaSuccess) return (int)err;
  const int blocks = (rows + block_rows - 1) / block_rows;
  conv_stack_kernel<T><<<blocks, kThreads, smem_bytes,
                         static_cast<cudaStream_t>(stream)>>>(a);
  return (int)cudaGetLastError();
}

}  // namespace

// dims: per block (ci, co, stride, win, wout); ptrs: per block
// (w1, b1, w2, b2, w3, b3, wd, bd).  Both are host arrays.
extern "C" int conv_stack_forward(int dtype, const void* x, void* out,
                                  int rows, int block_rows, int buf, int nblk,
                                  const int* dims, const void* const* ptrs,
                                  size_t smem_bytes, void* stream) {
  if (dtype == wf::kF32)
    return run<float>(x, out, rows, block_rows, buf, nblk, dims, ptrs,
                      smem_bytes, stream);
  if (dtype == wf::kBF16)
    return run<__nv_bfloat16>(x, out, rows, block_rows, buf, nblk, dims, ptrs,
                              smem_bytes, stream);
  return (int)cudaErrorInvalidValue;
}

WF_EXPORT_ERROR_STRING
