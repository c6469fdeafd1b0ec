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
// What bounds it on the H100, at batch 4096 in bf16 (C = 64): x read once
// and the output written once, 0.31 GB, is 0.09 ms at 3.35 TB/s; the two
// projections, 60 GFLOP, 0.06 ms of bf16 tensor-core time; the fp32 core,
// as in the v2 kernel, ~0.3 ms of CUDA-core and SFU time.  The core's
// instructions set the floor, as they do for the v2 kernel, which this
// kernel saves the intermediate's 0.31 GB of traffic.
//
// Design (the launch plan is ops/kernels/axial_attention.py::
// attention_plan; the C side refuses a plan that does not add up): a
// block owns one sample at a time and walks the samples grid apart.
//   a1 sits in shared memory in the storage type, unpadded in bf16 (38,400
//     bytes) with its 16-byte chunks swizzled, so that ldmatrix reads its
//     rows and its columns without bank conflicts.
//   Pass 1 walks the sample's H rows, a few whole rows (of W positions) a
//     tile: the rows are staged with cp.async into their place in a1,
//     projected with the width axis's weights and attended into a1 over
//     themselves.
//   Pass 2 walks the W columns, a few whole columns (of H positions) a
//     tile, and projects them straight from a1 (each lane of an ldmatrix
//     gives its own row's address, so there is no copy); the result goes
//     to device memory.
//   One axis's packed weights (24 KB at C = 64) are resident at a time:
//     the height axis's are fetched while pass 1's last core runs, the
//     next sample's width weights and first rows while pass 2's last core
//     runs.  Tiles of at most 64 positions (3 rows, 4 columns) keep a
//     block under 113 KB in bf16, so two blocks share an SM.
// The projection and the core are the v2 kernel's
// (axial_attention_eval.cuh): the two kernels agree bit for bit.  fp32
// runs the same tiles on CUDA-core FMAs and reads the weights from device
// memory.
#include "axial_attention_eval.cuh"

namespace {

// A block's most threads (so 128 registers a thread at two blocks an SM):
// the tiles of both models' shapes have at most 256 core items of 2
// queries; a tile with more takes them in turns.
constexpr int kMaxThreads = 256;

struct AxisW {
  const void* wpack;     // bf16: B fragments; fp32: [C, 3C]
  const float* bq;       // [3C]
  const float* sim;      // [2, G]: scale, bias
  const float* oaff;     // [2, C]: scale, bias
};

template <typename T>
struct DualArgs {
  const T* x;            // [B, H, W, C]
  T* out;                // [B, H, W, C]
  int batch, h, w, c, groups;
  int rows;              // whole rows of W positions a tile (pass 1)
  int cols;              // whole columns of H positions a tile (pass 2)
  int lda;               // elements between positions of a1
  int rstride;           // elements between rows of a1
  AxisW width, height;
};

__host__ __device__ constexpr int align16(int v) { return (v + 15) / 16 * 16; }

struct Layout {
  int w, zero, a1, qkv, total;
};

// Shared memory of a block: one axis's bf16 weights, a zero row for the
// padding rows of the last m-tile, a1 (which also takes pass 1's input
// rows, staged where their outputs go), and a tile's fp32 q, k, v.
__host__ __device__ inline Layout layout(int h, int w, int c, int rows,
                                         int cols, int rstride, int esize) {
  const int npos = rows * w > cols * h ? rows * w : cols * h;
  Layout l;
  l.w = 0;
  l.zero = esize == 2 ? align16(3 * c * c * 2) : 0;
  l.a1 = l.zero + align16(c * esize);
  l.qkv = l.a1 + align16(h * rstride * esize);
  l.total = l.qkv + npos * wf::qkv_ld(c) * 4;
  return l;
}

// The intermediate a1 [H, W, C] in shared memory.  bf16: positions C
// elements apart, their 8-element chunks swizzled (chunk ^ ((l + col) &
// mask)), so that 8 consecutive positions of a row or of a column, the 8
// rows of an ldmatrix in either pass, fall in 8 different bank groups.
// fp32 (read by CUDA cores, not ldmatrix): positions lda floats apart, rows
// of W positions rstride apart.
template <typename T>
struct A1 {
  T* p;
  int w, c, lda, rstride, mask;
  __device__ __forceinline__ T* at(int l, int col, int e) const {
    if constexpr (sizeof(T) == 2)
      return p + (l * w + col) * c + (((e >> 3) ^ ((l + col) & mask)) << 3) +
             (e & 7);
    else
      return p + l * rstride + col * lda + e;
  }
};

template <typename T>
__device__ __forceinline__ void stage_weights(const AxisW& ax, int c,
                                              unsigned char* dst) {
  if constexpr (sizeof(T) == 2) {
    for (int e = threadIdx.x; e < 3 * c * c * 2 / 16; e += blockDim.x)
      wf::cp_async16(dst + 16 * e,
                     static_cast<const unsigned char*>(ax.wpack) + 16 * e);
  }
}

// Rows h0 .. h0 + nrows - 1 of sample x (contiguous in device memory) into
// the same rows of a1: pass 1's core overwrites them only after they have
// been projected, and reaches the next tile's rows only after them.
template <typename T>
__device__ __forceinline__ void stage_rows(const DualArgs<T>& a, const T* x,
                                           const A1<T>& a1, int h0) {
  constexpr int kVec = 16 / sizeof(T);
  const int chunks = a.c / kVec;
  const int nrows = min(a.rows, a.h - h0);
  const wf::FastDiv by_chunks(chunks), by_w(a.w);
  const T* src = x + (size_t)h0 * a.w * a.c;
  for (int e = threadIdx.x; e < nrows * a.w * chunks; e += blockDim.x) {
    const int p = by_chunks.div(e), ch = e - p * chunks;
    const int r = by_w.div(p), i = p - r * a.w;
    wf::cp_async16(a1.at(h0 + r, i, ch * kVec), src + p * a.c + ch * kVec);
  }
}

template <typename T, typename RowFn>
__device__ __forceinline__ void project(const RowFn& row, int npos, int c,
                                        const AxisW& ax,
                                        const unsigned char* ws, float* qkv) {
  if constexpr (sizeof(T) == 2)
    wf::project_tile(row, npos, c,
                     reinterpret_cast<const __nv_bfloat16*>(ws), ax.bq, qkv);
  else
    wf::project_tile(row, npos, c, static_cast<const float*>(ax.wpack),
                     ax.bq, qkv);
}

template <typename T>
__global__ void __launch_bounds__(kMaxThreads, 2)
    axial_attention_dual_kernel(const DualArgs<T> a) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int c = a.c, h = a.h, w = a.w;
  const Layout l = layout(h, w, c, a.rows, a.cols, a.rstride,
                          (int)sizeof(T));
  unsigned char* ws = smem + l.w;
  const T* zero = reinterpret_cast<const T*>(smem + l.zero);
  const int chunks = c / 8, low = chunks & -chunks;
  const A1<T> a1{reinterpret_cast<T*>(smem + l.a1), w, c, a.lda, a.rstride,
                 (low < 8 ? low : 8) - 1};
  float* qkv = reinterpret_cast<float*>(smem + l.qkv);
  const size_t sample = (size_t)h * w * c;
  const wf::FastDiv by_h(h), by_w(w);

  for (int e = threadIdx.x; e < (l.a1 - l.zero) / 16; e += blockDim.x)
    reinterpret_cast<uint4*>(smem + l.zero)[e] = make_uint4(0, 0, 0, 0);
  if (blockIdx.x < a.batch) {
    stage_weights<T>(a.width, c, ws);
    stage_rows(a, a.x + blockIdx.x * sample, a1, 0);
  }
  wf::cp_async_commit();

  for (int b = blockIdx.x; b < a.batch; b += gridDim.x) {
    const T* x = a.x + b * sample;
    T* out = a.out + b * sample;

    // pass 1: attention along W, rows h0 .. h0 + nrows - 1, into a1
    for (int h0 = 0; h0 < h; h0 += a.rows) {
      const int nrows = min(a.rows, h - h0), npos = nrows * w;
      wf::cp_async_wait<0>();
      __syncthreads();   // rows and weights landed; the last core is done
      project<T>(
          [&](int p, int e) -> const T* {
            if (p >= npos) return zero + e;
            const int r = by_w.div(p);
            return a1.at(h0 + r, p - r * w, e);
          },
          npos, c, a.width, ws, qkv);
      __syncthreads();   // q, k, v written; staged rows and weights free
      if (h0 + a.rows < h)
        stage_rows(a, x, a1, h0 + a.rows);
      else
        stage_weights<T>(a.height, c, ws);
      wf::cp_async_commit();
      wf::attend_tile<T>(qkv, c, w, nrows, a.width.sim, a.width.oaff,
                         [&](int s, int i, int g) {
                           return a1.at(h0 + s, i, g * wf::kGroupChannels);
                         });
    }

    // pass 2: attention along H, columns w0 .. w0 + ncols - 1, from a1
    for (int w0 = 0; w0 < w; w0 += a.cols) {
      const int ncols = min(a.cols, w - w0), npos = ncols * h;
      wf::cp_async_wait<0>();
      __syncthreads();   // a1 complete, the height weights landed
      project<T>(
          [&](int p, int e) -> const T* {
            if (p >= npos) return zero + e;
            const int s = by_h.div(p);
            return a1.at(p - s * h, w0 + s, e);
          },
          npos, c, a.height, ws, qkv);
      __syncthreads();   // q, k, v written
      if (w0 + a.cols >= w && b + (int)gridDim.x < a.batch) {
        stage_weights<T>(a.width, c, ws);
        stage_rows(a, x + gridDim.x * sample, a1, 0);
      }
      wf::cp_async_commit();
      wf::attend_tile<T>(qkv, c, h, ncols, a.height.sim, a.height.oaff,
                         [&](int s, int i, int g) {
                           return out + ((size_t)i * w + w0 + s) * c +
                                  g * wf::kGroupChannels;
                         });
    }
  }
  wf::cp_async_wait<0>();
}

template <typename T>
int run(const void* x, void* out, int batch, int h, int w, int c, int groups,
        int rows, int cols, int threads, int grid, int lda,
        int rstride, const void* const* weights, size_t smem_bytes,
        void* stream) {
  const int esize = (int)sizeof(T);
  if (c != groups * wf::kGroupChannels || c % 16 || h < 1 || w < 1 ||
      h > wf::kMaxLen || w > wf::kMaxLen || rows < 1 || cols < 1 ||
      batch < 1 || threads % 32 || threads < 32 || threads > kMaxThreads ||
      grid < 1 ||
      (esize == 2 ? lda != c || rstride != w * c
                  : lda < c || lda % 4 || rstride < w * lda || rstride % 4) ||
      smem_bytes <
          (size_t)layout(h, w, c, rows, cols, rstride, esize).total ||
      smem_bytes > 232448)
    return (int)cudaErrorInvalidValue;
  DualArgs<T> a{static_cast<const T*>(x), static_cast<T*>(out), batch, h, w,
                c, groups, rows, cols, lda, rstride, {}, {}};
  AxisW* axes[2] = {&a.width, &a.height};
  for (int k = 0; k < 2; ++k) {
    const void* const* p = weights + 4 * k;
    axes[k]->wpack = p[0];
    axes[k]->bq = static_cast<const float*>(p[1]);
    axes[k]->sim = static_cast<const float*>(p[2]);
    axes[k]->oaff = static_cast<const float*>(p[3]);
  }
  cudaError_t err = cudaFuncSetAttribute(
      axial_attention_dual_kernel<T>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem_bytes);
  if (err != cudaSuccess) return (int)err;
  axial_attention_dual_kernel<T><<<grid, threads, smem_bytes,
                                   static_cast<cudaStream_t>(stream)>>>(a);
  return (int)cudaGetLastError();
}

}  // namespace

// weights: per axis (width, then height) the pointers wpack, bq, sim,
// oaff; a host array.
extern "C" int axial_attention_dual_forward(
    int dtype, const void* x, void* out, int batch, int h, int w, int c,
    int groups, int rows, int cols, int threads, int grid,
    int lda, int rstride, const void* const* weights, size_t smem_bytes,
    void* stream) {
  if (dtype == wf::kF32)
    return run<float>(x, out, batch, h, w, c, groups, rows, cols, threads,
                      grid, lda, rstride, weights, smem_bytes, stream);
  if (dtype == wf::kBF16)
    return run<__nv_bfloat16>(x, out, batch, h, w, c, groups, rows, cols,
                              threads, grid, lda, rstride, weights,
                              smem_bytes, stream);
  return (int)cudaErrorInvalidValue;
}

WF_EXPORT_ERROR_STRING
