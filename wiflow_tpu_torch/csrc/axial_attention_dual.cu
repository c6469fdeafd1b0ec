// Eval dual axial attention, both axes in one launch, for sm_90a.
//
// Replaces wiflow_tpu/ops/pallas/axial_attention.py:
// dual_axial_attention_eval_fused (kernel body _kernel_dual over _attend).
// On x [B, H, W, C]: attention along W with the first axis's weights into
// an intermediate a1 [H, W, C], rounded to the storage type, then
// attention along H read from a1, each as in axial_attention.cu (QKV
// projection with bn_qkv folded, bn_similarity on the logits, softmax,
// weighted sum, bn_output).  a1 never reaches device memory.  Channels
// are in the standard (group-major) order.
//
// What bounds it on the H100: bytes.  x is read once and the output
// written once (2 C values per position) for two projections of 6 C^2
// FLOPs each per position: ~0.09 ms of traffic against ~0.06 ms of bf16
// tensor-core time at batch 4096.  On CUDA cores the projections' FMAs
// bound this first version, as they do the v2 kernel.
//
// Design: one block owns one whole sample, and a1 for it sits in shared
// memory in the storage type (15 x 20 x 64: 38,400 bytes in bf16, 76,800
// in fp32) next to the staging the v2 kernel uses: the 32 x 64 weight
// tile, fp32 q, k, v for at most 80 positions, and those positions' input
// rows.  Pass 1 walks the sample's H rows, a few whole rows (of W
// positions) at a time: stage, project, attend into a1.  A barrier, then
// pass 2 walks the W columns, a few whole columns (of H positions) at a
// time: the column's rows of a1 (stride W * C) are copied to the staging
// rows, projected with the second axis's weights, and the result goes to
// device memory.  That is about 168 KB in fp32, so one block per SM.  The
// projection and the per-thread attention are shared with the v2 and v1
// kernels (axial_attention_eval.cuh).
#include "axial_attention_eval.cuh"

namespace {

using wf::kThreads;

template <typename T>
struct AxisW {
  const T* wq;           // [C, 3C]
  const float* bq;       // [3C]
  const float* sim;      // [2, G]: scale, bias
  const float* oaff;     // [2, C]: scale, bias
};

template <typename T>
struct DualArgs {
  const T* x;            // [B, H, W, C]
  T* out;                // [B, H, W, C]
  int batch, h, w, c, groups;
  int rows_per_pass;     // whole rows of W positions staged at once (pass 1)
  int cols_per_pass;     // whole columns of H positions (pass 2)
  int max_pos;           // staged positions: the larger of the two passes'
  AxisW<T> width, height;
};

template <typename T>
__global__ void __launch_bounds__(kThreads) axial_attention_dual_kernel(
    DualArgs<T> a) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int c = a.c, ldq = 3 * c + 4, h = a.h, w = a.w, groups = a.groups;
  float* ws = reinterpret_cast<float*>(smem);              // weight tile
  float* qkv = ws + wf::kTileFloats;                       // [max_pos, ldq]
  T* xs = reinterpret_cast<T*>(qkv + a.max_pos * ldq);     // [max_pos, c]
  T* a1 = xs + a.max_pos * c;                              // [h * w, c]

  for (int b = blockIdx.x; b < a.batch; b += gridDim.x) {
    const T* x = a.x + (size_t)b * h * w * c;
    T* out = a.out + (size_t)b * h * w * c;

    // pass 1: attention along W, rows h0 .. h0 + nrows - 1, into a1
    for (int h0 = 0; h0 < h; h0 += a.rows_per_pass) {
      const int nrows = min(a.rows_per_pass, h - h0);
      const int npos = nrows * w;
      __syncthreads();            // the last pass's readers of xs and qkv
      for (int e = threadIdx.x; e < npos * c; e += kThreads)
        xs[e] = x[(size_t)h0 * w * c + e];                 // rows are contiguous
      __syncthreads();
      wf::project_qkv(xs, npos, c, a.width.wq, a.width.bq, qkv, ldq, ws);
      for (int e = threadIdx.x; e < npos * groups; e += kThreads) {
        const int g = e % groups, rest = e / groups;
        const int i = rest % w, s = rest / w;
        wf::attend_store(qkv + (s * w) * ldq, ldq, c, w, i, g, groups,
                         a.width.sim, a.width.oaff,
                         a1 + ((h0 + s) * w + i) * c);
      }
    }

    // pass 2: attention along H, columns w0 .. w0 + ncols - 1, from a1
    for (int w0 = 0; w0 < w; w0 += a.cols_per_pass) {
      const int ncols = min(a.cols_per_pass, w - w0);
      const int npos = ncols * h;
      __syncthreads();            // a1 complete; xs and qkv free again
      for (int e = threadIdx.x; e < npos * c; e += kThreads) {
        const int p = e / c, ch = e % c;
        const int s = p / h, l = p % h;
        xs[e] = a1[(l * w + w0 + s) * c + ch];
      }
      __syncthreads();
      wf::project_qkv(xs, npos, c, a.height.wq, a.height.bq, qkv, ldq, ws);
      for (int e = threadIdx.x; e < npos * groups; e += kThreads) {
        const int g = e % groups, rest = e / groups;
        const int i = rest % h, s = rest / h;
        wf::attend_store(qkv + (s * h) * ldq, ldq, c, h, i, g, groups,
                         a.height.sim, a.height.oaff,
                         out + ((size_t)i * w + w0 + s) * c);
      }
    }
  }
}

template <typename T>
int run(const void* x, void* out, int batch, int h, int w, int c, int groups,
        int rows_per_pass, int cols_per_pass, const void* const* weights,
        size_t smem_bytes, void* stream) {
  const int max_pos = rows_per_pass * w > cols_per_pass * h
                          ? rows_per_pass * w
                          : cols_per_pass * h;
  const size_t need = wf::kTileFloats * sizeof(float) +
                      (size_t)max_pos * (3 * c + 4) * sizeof(float) +
                      ((size_t)max_pos + (size_t)h * w) * c * sizeof(T);
  if (c != groups * wf::kGroupChannels || h > wf::kMaxLen ||
      w > wf::kMaxLen || rows_per_pass < 1 || cols_per_pass < 1 ||
      max_pos > 16 * wf::kMaxRows || smem_bytes < need)
    return (int)cudaErrorInvalidValue;
  DualArgs<T> a{static_cast<const T*>(x), static_cast<T*>(out), batch, h, w,
                c, groups, rows_per_pass, cols_per_pass, max_pos, {}, {}};
  AxisW<T>* axes[2] = {&a.width, &a.height};
  for (int k = 0; k < 2; ++k) {
    const void* const* p = weights + 4 * k;
    axes[k]->wq = static_cast<const T*>(p[0]);
    axes[k]->bq = static_cast<const float*>(p[1]);
    axes[k]->sim = static_cast<const float*>(p[2]);
    axes[k]->oaff = static_cast<const float*>(p[3]);
  }
  cudaError_t err = cudaFuncSetAttribute(
      axial_attention_dual_kernel<T>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem_bytes);
  if (err != cudaSuccess) return (int)err;
  axial_attention_dual_kernel<T><<<batch, kThreads, smem_bytes,
                                   static_cast<cudaStream_t>(stream)>>>(a);
  return (int)cudaGetLastError();
}

}  // namespace

// weights: per axis (width, then height) the pointers wq, bq, sim, oaff;
// a host array.
extern "C" int axial_attention_dual_forward(
    int dtype, const void* x, void* out, int batch, int h, int w, int c,
    int groups, int rows_per_pass, int cols_per_pass,
    const void* const* weights, size_t smem_bytes, void* stream) {
  if (dtype == wf::kF32)
    return run<float>(x, out, batch, h, w, c, groups, rows_per_pass,
                      cols_per_pass, weights, smem_bytes, stream);
  if (dtype == wf::kBF16)
    return run<__nv_bfloat16>(x, out, batch, h, w, c, groups, rows_per_pass,
                              cols_per_pass, weights, smem_bytes, stream);
  return (int)cudaErrorInvalidValue;
}

WF_EXPORT_ERROR_STRING
