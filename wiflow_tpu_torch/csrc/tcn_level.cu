// One eval TCN level with BatchNorm folded in, for sm_90a.
//
// Replaces wiflow_tpu/ops/pallas/tcn_level.py:fused_tcn_eval (kernel body
// _make_level_kernel).  Per level:
//   h1 = silu(causal grouped conv(x)  + b1)      3 taps, dilation d, G groups
//   h2 = silu(h1 @ P1 + c1)                      pointwise
//   h3 = silu(causal grouped conv(h2) + b2)
//   y  = silu(h3 @ P2 + c2)
//   out = silu(y + (x @ D + e  if C_in != C_out else x))
// h1..h3 are rounded to the storage type, as the Pallas kernel does.
//
// What bounds it on the H100: the two pointwise products are ~89% of the
// FLOPs (85 MFLOP per window over the four levels); at batch 4096 the work
// is ~0.35 ms at the bf16 tensor-core peak against ~0.17 ms of
// device-memory traffic, so it is bound by operations.
//
// Design: one block holds whole samples (all T time steps), so the causal
// dilated taps x[t - j*d] never leave the block.  The block keeps two
// [rows, C] activation buffers in shared memory (4 samples in bf16, 2 in
// fp32) and ping-pongs h1..h3 between them; the input is read from device
// memory once at the start and once more for the residual, the output
// written once.  The pointwise products run on the tensor cores in bf16
// (mma.sync m16n8k16, fp32 accumulation; each warp owns 8 of a 64-column
// slice for all rows) with the weights streamed through 128-deep
// shared-memory tiles, the next tile fetched into registers while the
// current one is multiplied; in fp32 they run on CUDA cores.  The grouped
// convs stay grouped (27/22/17/12 channels per group, no block-diagonal
// padding): in bf16 each warp runs whole groups on the tensor cores, in
// fp32 a thread computes one channel at one time step for all samples of
// the block, so each weight it loads feeds every sample.  One launch per
// level.
#include "common.cuh"
#include "mma.cuh"

namespace {

using wf::kThreads;
using wf::ldmatrix_x2;
using wf::ldmatrix_x4;
using wf::mma_bf16;
using wf::pack2;
using bf16 = __nv_bfloat16;
constexpr int kMaxSamples = 4;
constexpr int kMmaTileK = 128;
constexpr int kMmaLdw = kMmaTileK + 8;   // padded row of the transposed tile

template <typename T>
struct TcnArgs {
  const T* x;           // [rows, cin]
  T* out;               // [rows, cout]
  int rows;             // batch * steps
  int steps;            // T, time steps per sample
  int samples;          // samples per block (<= kMaxSamples)
  int buf_rows;         // samples * steps rounded up to 16 (<= 80)
  int lda;              // shared-memory row stride (>= max(cin, cout), /16)
  int cin, cout, groups, dil;
  const T* g1w;         // [3, G, cin/G, cin/G] (tap, group, in, out)
  const float* g1b;     // [cin]
  const T* p1w;         // [cin, cout]
  const float* p1b;     // [cout]
  const T* g2w;         // [3, G, cout/G, cout/G]
  const float* g2b;     // [cout]
  const T* p2w;         // [cout, cout]
  const float* p2b;     // [cout]
  const T* dw;          // [cin, cout] or nullptr when cin == cout
  const float* db;      // [cout] or nullptr
};

// acc[5][4] += A[buf_rows, K] (shared) x W[K, n0:n0+64] (device memory).
// Product<T>::coord maps an accumulator slot to its (row, column - n0).
template <typename T>
struct Product;

template <>
struct Product<float> {   // CUDA cores: wf::gemm_acc
  static constexpr int kTileBytes = wf::kTileFloats * 4;
  __device__ static void coord(int r, int c, int& row, int& col) {
    row = threadIdx.x / 16 + 16 * r;
    col = (threadIdx.x % 16) * 4 + c;
  }
  __device__ static void acc(float (&acc)[wf::kMaxRows][4], const float* a,
                             int lda, int m, const float* __restrict__ w,
                             int k_dim, int n_dim, int n0,
                             unsigned char* tile) {
    wf::gemm_acc(acc, a, lda, m, w, k_dim, n_dim, n0,
                 reinterpret_cast<float*>(tile));
  }
};

template <>
struct Product<bf16> {    // tensor cores: mma.sync m16n8k16, fp32 accumulate
  static constexpr int kTileBytes = wf::kTileN * kMmaLdw * 2;
  __device__ static void coord(int r, int c, int& row, int& col) {
    const int lane = threadIdx.x & 31;
    row = 16 * r + (lane >> 2) + 8 * (c >> 1);
    col = 8 * (threadIdx.x >> 5) + 2 * (lane & 3) + (c & 1);
  }
  static constexpr int kPairsPerThread = kMmaTileK / 2 * wf::kTileN / kThreads;
  // W[k0 + 2 kp + {0, 1}, n0 + nn] as bf16 pairs, zero outside [K, N)
  __device__ static void fetch_tile(__nv_bfloat162 (&next)[kPairsPerThread],
                                    const bf16* __restrict__ w, int k_dim,
                                    int n_dim, int k0, int n0) {
#pragma unroll
    for (int q = 0; q < kPairsPerThread; ++q) {
      const int e = threadIdx.x + q * kThreads;
      const int k = k0 + 2 * (e / wf::kTileN), n = n0 + e % wf::kTileN;
      bf16 lo = __float2bfloat16_rn(0.f), hi = lo;
      if (n < n_dim) {
        if (k < k_dim) lo = w[(size_t)k * n_dim + n];
        if (k + 1 < k_dim) hi = w[(size_t)(k + 1) * n_dim + n];
      }
      next[q].x = lo;
      next[q].y = hi;
    }
  }
  // m must be a multiple of 16; A must hold finite values in columns
  // [K, round_up(K, 16)), which W's zero-filled rows multiply.
  __device__ static void acc(float (&acc)[wf::kMaxRows][4], const bf16* a,
                             int lda, int m, const bf16* __restrict__ w,
                             int k_dim, int n_dim, int n0,
                             unsigned char* tile) {
    bf16* wt = reinterpret_cast<bf16*>(tile);   // [64 n][kMmaLdw k]
    const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
    const int mtiles = m / 16;
    // the next weight tile is fetched into registers while the tensor
    // cores work on the current one
    __nv_bfloat162 next[kPairsPerThread];
    fetch_tile(next, w, k_dim, n_dim, 0, n0);
    for (int k0 = 0; k0 < k_dim; k0 += kMmaTileK) {
      __syncthreads();
#pragma unroll
      for (int q = 0; q < kPairsPerThread; ++q) {
        const int e = tid + q * kThreads;
        *reinterpret_cast<__nv_bfloat162*>(
            &wt[(e % wf::kTileN) * kMmaLdw + 2 * (e / wf::kTileN)]) = next[q];
      }
      __syncthreads();
      if (k0 + kMmaTileK < k_dim)
        fetch_tile(next, w, k_dim, n_dim, k0 + kMmaTileK, n0);
#pragma unroll
      for (int ks = 0; ks < kMmaTileK; ks += 16) {
        if (k0 + ks >= k_dim) break;
        // B (k16 x n8) from the [n][k] tile: lanes 0-7 give rows n at k,
        // lanes 8-15 the same rows at k + 8
        uint32_t bfrag[2];
        ldmatrix_x2(bfrag, wt + (warp * 8 + (lane & 7)) * kMmaLdw + ks +
                               8 * ((lane >> 3) & 1));
#pragma unroll
        for (int mt = 0; mt < wf::kMaxRows; ++mt) {
          if (mt >= mtiles) break;
          // A (m16 x k16): lanes 0-15 give rows 0-15 at k, 16-31 at k + 8
          uint32_t afrag[4];
          ldmatrix_x4(afrag, a + (mt * 16 + (lane & 15)) * lda + k0 + ks +
                                 8 * (lane >> 4));
          mma_bf16(acc[mt], afrag, bfrag);
        }
      }
    }
    __syncthreads();
  }
};

// fp32: dst[s, t, c] = silu(b[c] + sum_j sum_i src[s, t - (2-j)*d, g*cg + i]
//                                         * w[j, g, i, o]),  c = g*cg + o,
// taps inside the sample only (zero before t = 0).
template <typename T>
__device__ void grouped_causal(const T* src, T* dst, int lda, int samples,
                               int steps, int ch, int groups, int dil,
                               const T* __restrict__ w,
                               const float* __restrict__ b) {
  const int cg = ch / groups;
  const int sstride = steps * lda;
  for (int e = threadIdx.x; e < steps * ch; e += kThreads) {
    const int t = e / ch, c = e % ch;
    const int g = c / cg, o = c % cg;
    float acc[kMaxSamples];
#pragma unroll
    for (int s = 0; s < kMaxSamples; ++s) acc[s] = b[c];
#pragma unroll
    for (int j = 0; j < 3; ++j) {
      const int shift = (2 - j) * dil;
      if (t < shift) continue;
      const T* sp = src + (t - shift) * lda + g * cg;
      const T* wj = w + ((size_t)(j * groups + g) * cg) * cg + o;
#pragma unroll 4
      for (int i = 0; i < cg; ++i) {
        const float wv = wf::to_f(wj[i * cg]);
#pragma unroll
        for (int s = 0; s < kMaxSamples; ++s)
          if (s < samples) acc[s] += wf::to_f(sp[s * sstride + i]) * wv;
      }
    }
#pragma unroll
    for (int s = 0; s < kMaxSamples; ++s)
      if (s < samples)
        dst[(s * steps + t) * lda + c] = wf::from_f<T>(wf::silu(acc[s]));
  }
}

// The same grouped conv in bf16 on the tensor cores: per group, the sum
// over taps of [rows, cg] x [cg, cg] products (cg <= 32, padded with zeros
// to 16-deep, 8-wide tiles).  A warp takes whole groups; the shifted rows
// of a tap are read in place, zero where t < shift.
constexpr int kMaxGroupTilesN = 4;
constexpr int kMaxGroupSteps = 2;   // 16-deep steps: cg <= 32
__device__ void grouped_causal(const bf16* src, bf16* dst, int lda,
                               int samples, int steps, int ch, int groups,
                               int dil, const bf16* __restrict__ w,
                               const float* __restrict__ b) {
  const int cg = ch / groups;
  const int m_rows = samples * steps;
  const int mtiles = (m_rows + 15) / 16;
  const int ntiles = (cg + 7) / 8;
  const int ksteps = (cg + 15) / 16;
  const int lane = threadIdx.x & 31, gid = lane >> 2, tig = lane & 3;
  const bf16 zero = __float2bfloat16_rn(0.f);
  // time step of each row this thread feeds (rows mt*16 + gid + 8h), or -1
  int t_of[wf::kMaxRows][2];
#pragma unroll
  for (int mt = 0; mt < wf::kMaxRows; ++mt)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int r = mt * 16 + gid + 8 * h;
      t_of[mt][h] = r < m_rows ? r % steps : -1;
    }
  for (int g = threadIdx.x >> 5; g < groups; g += kThreads / 32) {
    // all of this group's weight fragments, loaded up front
    uint32_t bw[3][kMaxGroupSteps][kMaxGroupTilesN][2];
#pragma unroll
    for (int j = 0; j < 3; ++j)
#pragma unroll
      for (int ks = 0; ks < kMaxGroupSteps; ++ks)
#pragma unroll
        for (int nt = 0; nt < kMaxGroupTilesN; ++nt)
#pragma unroll
          for (int q = 0; q < 2; ++q) {   // b0, b1: k half q
            const int k = ks * 16 + tig * 2 + 8 * q, n = nt * 8 + gid;
            const bf16* wg = w + (size_t)(j * groups + g) * cg * cg;
            bf16 lo = zero, hi = zero;
            if (n < cg) {
              if (k < cg) lo = wg[k * cg + n];
              if (k + 1 < cg) hi = wg[(k + 1) * cg + n];
            }
            bw[j][ks][nt][q] = pack2(lo, hi);
          }
    float acc[wf::kMaxRows][kMaxGroupTilesN][4] = {};
#pragma unroll
    for (int j = 0; j < 3; ++j) {
      const int shift = (2 - j) * dil;
#pragma unroll
      for (int ks = 0; ks < kMaxGroupSteps; ++ks) {
        if (ks >= ksteps) break;
#pragma unroll
        for (int mt = 0; mt < wf::kMaxRows; ++mt) {
          if (mt >= mtiles) break;
          uint32_t af[4];
#pragma unroll
          for (int q = 0; q < 4; ++q) {   // a0..a3: row half q&1, k half q>>1
            const int r = mt * 16 + gid + 8 * (q & 1);
            const int k = ks * 16 + tig * 2 + 8 * (q >> 1);
            bf16 lo = zero, hi = zero;
            if (t_of[mt][q & 1] >= shift) {
              const bf16* p = src + (r - shift) * lda + g * cg + k;
              if (k < cg) lo = p[0];
              if (k + 1 < cg) hi = p[1];
            }
            af[q] = pack2(lo, hi);
          }
#pragma unroll
          for (int nt = 0; nt < kMaxGroupTilesN; ++nt)
            if (nt < ntiles) mma_bf16(acc[mt][nt], af, bw[j][ks][nt]);
        }
      }
    }
#pragma unroll
    for (int mt = 0; mt < wf::kMaxRows; ++mt)
#pragma unroll
      for (int nt = 0; nt < kMaxGroupTilesN; ++nt)
#pragma unroll
        for (int q = 0; q < 4; ++q) {     // c0..c3: row half q>>1, col q&1
          const int r = mt * 16 + gid + 8 * (q >> 1);
          const int col = nt * 8 + tig * 2 + (q & 1);
          if (t_of[mt][q >> 1] >= 0 && nt < ntiles && col < cg)
            dst[r * lda + g * cg + col] = __float2bfloat16_rn(
                wf::silu(acc[mt][nt][q] + b[g * cg + col]));
        }
  }
}

// dst = silu(src @ w + b), both in shared memory.
template <typename T>
__device__ void pointwise(const T* src, T* dst, int lda, int m_pad, int k_dim,
                          int n_dim, const T* __restrict__ w,
                          const float* __restrict__ b, unsigned char* tile) {
  for (int n0 = 0; n0 < n_dim; n0 += wf::kTileN) {
    float acc[wf::kMaxRows][4];
    wf::zero(acc);
    Product<T>::acc(acc, src, lda, m_pad, w, k_dim, n_dim, n0, tile);
#pragma unroll
    for (int r = 0; r < wf::kMaxRows; ++r)
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        int row, col;
        Product<T>::coord(r, c, row, col);
        col += n0;
        if (row < m_pad && col < n_dim)
          dst[row * lda + col] = wf::from_f<T>(wf::silu(acc[r][c] + b[col]));
      }
  }
}

template <typename T>
__device__ void load_rows(const TcnArgs<T>& a, T* dst, int row0, int valid) {
  const int m_rows = a.samples * a.steps;
  for (int m = threadIdx.x / 32; m < m_rows; m += kThreads / 32)
    for (int c = threadIdx.x % 32; c < a.cin; c += 32)
      dst[m * a.lda + c] = m < valid ? a.x[(size_t)(row0 + m) * a.cin + c]
                                     : wf::from_f<T>(0.f);
}

template <typename T>
__global__ void __launch_bounds__(kThreads) tcn_level_kernel(TcnArgs<T> a) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int m_rows = a.samples * a.steps, m_pad = a.buf_rows;
  T* buf_a = reinterpret_cast<T*>(smem);
  T* buf_b = buf_a + m_pad * a.lda;
  unsigned char* tile = reinterpret_cast<unsigned char*>(buf_b + m_pad * a.lda);
  const int row0 = blockIdx.x * m_rows;
  const int valid = min(m_rows, a.rows - row0);

  // padding rows and columns must hold finite values for the products
  uint4* words = reinterpret_cast<uint4*>(smem);
  for (int e = threadIdx.x; e < 2 * m_pad * a.lda * (int)sizeof(T) / 16;
       e += kThreads)
    words[e] = make_uint4(0, 0, 0, 0);
  __syncthreads();
  load_rows(a, buf_b, row0, valid);
  __syncthreads();
  grouped_causal(buf_b, buf_a, a.lda, a.samples, a.steps, a.cin, a.groups,
                 a.dil, a.g1w, a.g1b);
  __syncthreads();
  pointwise(buf_a, buf_b, a.lda, m_pad, a.cin, a.cout, a.p1w, a.p1b, tile);
  __syncthreads();
  grouped_causal(buf_b, buf_a, a.lda, a.samples, a.steps, a.cout, a.groups,
                 a.dil, a.g2w, a.g2b);
  __syncthreads();
  load_rows(a, buf_b, row0, valid);   // x again, for the residual
  __syncthreads();

  const bool has_ds = a.dw != nullptr;
  for (int n0 = 0; n0 < a.cout; n0 += wf::kTileN) {
    float acc[wf::kMaxRows][4];
    float res[wf::kMaxRows][4];
    wf::zero(acc);
    wf::zero(res);
    Product<T>::acc(acc, buf_a, a.lda, m_pad, a.p2w, a.cout, a.cout, n0, tile);
    if (has_ds)
      Product<T>::acc(res, buf_b, a.lda, m_pad, a.dw, a.cin, a.cout, n0, tile);
#pragma unroll
    for (int r = 0; r < wf::kMaxRows; ++r)
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        int row, col;
        Product<T>::coord(r, c, row, col);
        col += n0;
        if (row >= valid || col >= a.cout) continue;
        const float y = wf::silu(acc[r][c] + a.p2b[col]);
        const float rv = has_ds ? res[r][c] + a.db[col]
                                : wf::to_f(buf_b[row * a.lda + col]);
        a.out[(size_t)(row0 + row) * a.cout + col] =
            wf::from_f<T>(wf::silu(y + rv));
      }
  }
}

template <typename T>
int run(const void* x, void* out, int rows, int steps, int samples,
        int buf_rows, int lda, int cin, int cout, int groups, int dil,
        const void* g1w, const void* g1b, const void* p1w, const void* p1b,
        const void* g2w, const void* g2b, const void* p2w, const void* p2b,
        const void* dw, const void* db, void* stream) {
  if (samples < 1 || samples > kMaxSamples || buf_rows % 16 != 0 ||
      buf_rows < samples * steps || buf_rows > 16 * wf::kMaxRows ||
      lda % 16 != 8 || lda < ((cin > cout ? cin : cout) + 15) / 16 * 16 ||
      cin % groups != 0 || cout % groups != 0 ||
      (sizeof(T) == 2 && (cin / groups > 32 || cout / groups > 32)))
    return (int)cudaErrorInvalidValue;
  TcnArgs<T> a{static_cast<const T*>(x), static_cast<T*>(out), rows, steps,
               samples, buf_rows, lda, cin, cout, groups, dil,
               static_cast<const T*>(g1w), static_cast<const float*>(g1b),
               static_cast<const T*>(p1w), static_cast<const float*>(p1b),
               static_cast<const T*>(g2w), static_cast<const float*>(g2b),
               static_cast<const T*>(p2w), static_cast<const float*>(p2b),
               static_cast<const T*>(dw), static_cast<const float*>(db)};
  const size_t smem =
      2 * (size_t)buf_rows * lda * sizeof(T) + Product<T>::kTileBytes;
  cudaError_t err = cudaFuncSetAttribute(
      tcn_level_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return (int)err;
  const int m_rows = samples * steps;
  const int blocks = (rows + m_rows - 1) / m_rows;
  tcn_level_kernel<T><<<blocks, kThreads, smem,
                        static_cast<cudaStream_t>(stream)>>>(a);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" int tcn_level_forward(
    int dtype, const void* x, void* out, int rows, int steps, int samples,
    int buf_rows, int lda, int cin, int cout, int groups, int dil,
    const void* g1w, const void* g1b, const void* p1w, const void* p1b,
    const void* g2w, const void* g2b, const void* p2w, const void* p2b,
    const void* dw, const void* db, void* stream) {
  if (dtype == wf::kF32)
    return run<float>(x, out, rows, steps, samples, buf_rows, lda, cin, cout,
                      groups, dil, g1w, g1b, p1w, p1b, g2w, g2b, p2w, p2b, dw,
                      db, stream);
  if (dtype == wf::kBF16)
    return run<bf16>(x, out, rows, steps, samples, buf_rows, lda, cin, cout,
                     groups, dil, g1w, g1b, p1w, p1b, g2w, g2b, p2w, p2b, dw,
                     db, stream);
  return (int)cudaErrorInvalidValue;
}

WF_EXPORT_ERROR_STRING
