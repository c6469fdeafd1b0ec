// Sums of the attention logits and of their squares, forward and backward,
// for sm_90a.
//
// Replaces wiflow_tpu/ops/pallas/axial_attention_train.py:logits_sums, its
// forward (_moments_fwd_kernel) and its backward (_moments_bwd_kernel).
// With lg[n, g, i, j] = q_{n,i} . k_{n,j} over the 8 channels of group g:
//   sums[0, g] = sum_{n,i,j} lg,   sums[1, g] = sum_{n,i,j} lg^2,
// the batch statistics of the BatchNorm on the logits.  Given dsums [2, G],
// d1 = dsums[0, g], d2 = dsums[1, g]:
//   dq_i = sum_j (d1 + 2 d2 lg[i, j]) k_j,
//   dk_j = sum_i (d1 + 2 d2 lg[i, j]) q_i.
// q and k are [N, L, *] with a position stride `ld` (the thirds of a
// [N, L, 3C] projection, read in place); dq and dk are contiguous [N, L, C].
//
// The Gram form.  Per (sequence n, group g), with Qs = sum_i q_i,
// Ks = sum_j k_j, Gq = sum_i q_i q_i^T and Gk = sum_j k_j k_j^T (8 x 8):
//   sums[0, g] = sum_n Qs . Ks,   sums[1, g] = sum_n <Gq, Gk>_F,
//   dq_i = d1 Ks + 2 d2 Gk q_i,   dk_j = d1 Qs + 2 d2 Gq k_j,
// the VJP of the TPU kernels in closed form.  The work is linear in L and
// no kernel loops over (query, key) pairs: a Gram is 36 products a
// position (its upper triangle), 44 accumulators with the sum.
//
// What bounds it on the H100: bytes.  At batch 256 both axes read ~39 MB
// of q and k in bf16 (0.012 ms at 3.35 TB/s) for a few hundred MFLOP; no
// tensor cores (an mma cannot take fp32 inputs without TF32, and the
// products are 8 x 8).
//
// Design (the launch plan is ops/kernels/axial_attention_train.py::
// sums_plan; the C side refuses a plan that does not add up; the choices
// below were timed on an H100 by logits_sums_sweep.py and chip_smoke.py):
//   Lanes.  A (sequence, group) takes 2 x P lanes: one for q and one for k,
//     each over P ranges of positions.  Lane bits, low to high: q or k, the
//     position range, the group (padded to a power of two, the pad lanes
//     idle), the sequence of the tile.  A lane reads its group's 8
//     channels of a position with one 16-byte load in bf16 (two in fp32),
//     64 bytes of loads issued ahead of their use, and accumulates its
//     sums and Gram in fp32 registers.  Nothing is staged in shared memory.
//     The ranges are summed with a butterfly of shuffles, and q's lane and
//     k's lane trade theirs with one more.  P is the fewest of 1, 2 and 4
//     at which the tiles give at least half the SMs a block: 1 at both
//     models' train shapes at batch 256, where more ranges only add
//     shuffles; 2 on the flagship's width axis at batch 64; 4 on a few
//     sequences.
//   Tiles.  A block of 256 threads takes a tile of whole sequences; a
//     persistent grid of blocks sized to the SMs walks the tiles: 3 blocks
//     an SM forward (80 registers), 2 backward (128), whose second walk
//     holds the moments, the loads and the outputs at once (at 80
//     registers it spilled and took three times as long).
//   Forward.  Both lanes of a pair form Qs . Ks and <Gq, Gk> (the same
//     bits); a lane adds its tiles' values in turn, then a shuffle tree
//     sums a warp's sequences, the block sums its warps in order into
//     partial[block, 2G], and the last block to finish (an int32 counter
//     that it resets to zero) sums the blocks in float64 in a fixed order
//     into sums [2, G]: no float atomics, so a launch repeats bit for bit.
//     A second one-block launch for the float64 sum instead took the same
//     device time within 2% (2% less busy time; replayed from a CUDA
//     graph, where the device sets the pace, 2% either way), and a launch.
//   Backward.  Walk 1 forms the moments as the forward does; q's lane
//     takes k's (and k's lane q's), scales them by d1 and 2 d2, and walk 2
//     reads its positions again, from L1 or L2 (faster than a copy that
//     walk 1 makes in shared memory with cp.async), and stores dq_i (dk_i)
//     with 16-byte stores.  Saving the forward's moments instead would
//     write and read 88 floats per (sequence, group), more bytes than q and
//     k in bf16.
#include "attention_train.cuh"
#include "axial_attention_eval.cuh"

namespace {

using wf::kGC;
using wf::kMaxLen;
using wf::store_group;

constexpr int kThreads = wf::kThreads;          // a block's threads
// blocks an SM at the kernels' launch bounds (_SUMS_BLOCKS_PER_SM): the
// backward's walk 2 holds more registers
constexpr int kForwardBlocksPerSm = 3;
constexpr int kBackwardBlocksPerSm = 2;
constexpr int kTri = kGC * (kGC + 1) / 2;       // a Gram's upper triangle
constexpr int kMoments = kGC + kTri;            // the sum, then the Gram
constexpr int kLoadBytes = 64;                  // a lane's loads in flight

template <typename T>
struct SumsArgs {
  const T* q;
  const T* k;            // [N, L, *], position stride ld
  int ld;
  const float* dsums;    // [2, G] (backward)
  T* dq;
  T* dk;                 // [N, L, C] (backward)
  float* partial;        // [grid, 2G] (forward)
  int* counter;          // blocks done (forward); the last resets it
  float* sums;           // [2, G] (forward)
  int nseq, len, c, groups;
  int parts_log2, gslots_log2, seqs;   // a tile: seqs x 2^gslots_log2 items
};

// A group's 8 channels of one position as loaded: 16 bytes in bf16, 32 in
// fp32.
template <typename T>
struct Raw {
  uint4 v[sizeof(T) / 2];
};

template <typename T>
__device__ __forceinline__ Raw<T> load_raw(const T* p) {
  Raw<T> r;
#pragma unroll
  for (int w = 0; w < (int)(sizeof(T) / 2); ++w)
    r.v[w] = reinterpret_cast<const uint4*>(p)[w];
  return r;
}

template <typename T>
__device__ __forceinline__ Raw<T> zero_raw() {
  Raw<T> r;
#pragma unroll
  for (int w = 0; w < (int)(sizeof(T) / 2); ++w)
    r.v[w] = make_uint4(0, 0, 0, 0);
  return r;
}

__device__ __forceinline__ void unpack(const Raw<float>& r, float (&x)[kGC]) {
  const uint32_t u[kGC] = {r.v[0].x, r.v[0].y, r.v[0].z, r.v[0].w,
                           r.v[1].x, r.v[1].y, r.v[1].z, r.v[1].w};
#pragma unroll
  for (int cc = 0; cc < kGC; ++cc) x[cc] = __uint_as_float(u[cc]);
}

// bf16 -> fp32 is a shift: the lower address holds the low half.
__device__ __forceinline__ void unpack(const Raw<__nv_bfloat16>& r,
                                       float (&x)[kGC]) {
  const uint32_t u[4] = {r.v[0].x, r.v[0].y, r.v[0].z, r.v[0].w};
#pragma unroll
  for (int h = 0; h < 4; ++h) {
    x[2 * h] = __uint_as_float(u[h] << 16);
    x[2 * h + 1] = __uint_as_float(u[h] & 0xffff0000u);
  }
}

// A lane's sum and Gram of its positions: m[cc], then the upper triangle
// of x x^T row by row.
struct Moments {
  float m[kMoments];

  __device__ __forceinline__ void add(const float (&x)[kGC]) {
#pragma unroll
    for (int cc = 0; cc < kGC; ++cc) m[cc] += x[cc];
    int t = kGC;
#pragma unroll
    for (int cc = 0; cc < kGC; ++cc)
#pragma unroll
      for (int dd = cc; dd < kGC; ++dd) m[t++] += x[cc] * x[dd];
  }
};

// What a thread of a block takes: q (qk = 0) or k, its range of positions,
// its group slot and sequence slot in the tile.
struct Lane {
  int qk, g, slot, i0, n;

  __device__ Lane(int parts_log2, int gslots_log2, int len) {
    const int e = threadIdx.x;
    qk = e & 1;
    const int part = (e >> 1) & ((1 << parts_log2) - 1);
    const int item = e >> (1 + parts_log2);
    g = item & ((1 << gslots_log2) - 1);
    slot = item >> gslots_log2;
    const int span = (len + (1 << parts_log2) - 1) >> parts_log2;
    i0 = min(len, part * span);
    n = min(len, i0 + span) - i0;
  }
};

// Positions [0, n) of src (stride ld) through f(i, x), Bytes of loads
// issued before their first use.
template <int Bytes, typename T, typename F>
__device__ __forceinline__ void walk(const T* src, int ld, int n, F f) {
  constexpr int kU = Bytes / (kGC * (int)sizeof(T));
  static_assert(kU >= 1, "a position's loads at least");
  for (int i0 = 0; i0 < n; i0 += kU) {
    Raw<T> r[kU];
#pragma unroll
    for (int u = 0; u < kU; ++u)
      r[u] = i0 + u < n ? load_raw(src + (size_t)(i0 + u) * ld)
                        : zero_raw<T>();
#pragma unroll
    for (int u = 0; u < kU; ++u) {
      if (i0 + u < n) {
        float x[kGC];
        unpack(r[u], x);
        f(i0 + u, x);
      }
    }
  }
}

// The moments of a (sequence, group) pair's positions: each lane of the
// pair's position ranges ends with their sum (a butterfly: the same bits
// on every lane).
template <typename T>
__device__ __forceinline__ void moments(Moments& mo, const T* src, int ld,
                                        int n, int parts_log2) {
#pragma unroll
  for (int v = 0; v < kMoments; ++v) mo.m[v] = 0.f;
  walk<kLoadBytes>(src, ld, n,
                   [&](int, const float (&x)[kGC]) { mo.add(x); });
  for (int mask = 2; mask < (2 << parts_log2); mask <<= 1) {
#pragma unroll
    for (int v = 0; v < kMoments; ++v)
      mo.m[v] += __shfl_xor_sync(0xffffffffu, mo.m[v], mask);
  }
}

template <typename T>
__device__ __forceinline__ const T* lane_rows(const SumsArgs<T>& a,
                                              const Lane& ln, int s) {
  return (ln.qk ? a.k : a.q) + (size_t)s * a.len * a.ld + ln.g * kGC +
         (size_t)ln.i0 * a.ld;
}

// out[col] = sum over rows of partial[rows, cols] in float64, in a fixed
// order: the nsub lanes of a column (a power of two, at most 32, one warp)
// each sum rows sub, sub + nsub, ... in turn, kBatch loads issued at once,
// then a shuffle tree sums the lanes.  All of a block's threads call it.
__device__ __forceinline__ void sum_partials(const float* partial, int rows,
                                             int cols, float* out) {
  constexpr int kBatch = 16;
  int nsub = 1;
  while (nsub < 32 && 2 * nsub * cols <= kThreads) nsub *= 2;
  const int col = threadIdx.x / nsub, sub = threadIdx.x % nsub;
  double s = 0.0;
  if (col < cols) {
    for (int r0 = sub; r0 < rows; r0 += kBatch * nsub) {
      float v[kBatch];
#pragma unroll
      for (int u = 0; u < kBatch; ++u) {
        const int r = r0 + u * nsub;
        v[u] = r < rows ? __ldcg(partial + (size_t)r * cols + col) : 0.f;
      }
#pragma unroll
      for (int u = 0; u < kBatch; ++u) s += (double)v[u];
    }
  }
  for (int mask = 1; mask < nsub; mask <<= 1)
    s += __shfl_xor_sync(0xffffffffu, s, mask);
  if (col < cols && sub == 0) out[col] = (float)s;
}

template <typename T>
__global__ void __launch_bounds__(kThreads, kForwardBlocksPerSm)
    sums_forward_kernel(SumsArgs<T> a) {
  __shared__ float red[kThreads];       // [sequence slot, group slot, 2]
  __shared__ bool last;
  const Lane ln(a.parts_log2, a.gslots_log2, a.len);
  const int lanes = 2 << a.parts_log2;           // lanes a (sequence, group)
  const int tiles = (a.nseq + a.seqs - 1) / a.seqs;
  const bool live = ln.g < a.groups;
  float s1 = 0.f, s2 = 0.f;
  for (int tile = blockIdx.x; tile < tiles; tile += gridDim.x) {
    const int s = tile * a.seqs + ln.slot;
    const bool valid = live && s < a.nseq;
    Moments mo;
    moments(mo, lane_rows(a, ln, valid ? s : 0), a.ld, valid ? ln.n : 0,
            a.parts_log2);
    // Qs . Ks and <Gq, Gk>, from q's lane and k's lane alike
    float t1 = 0.f, t2 = 0.f;
#pragma unroll
    for (int cc = 0; cc < kGC; ++cc)
      t1 += mo.m[cc] * __shfl_xor_sync(0xffffffffu, mo.m[cc], 1);
    int t = kGC;
#pragma unroll
    for (int cc = 0; cc < kGC; ++cc) {
#pragma unroll
      for (int dd = cc; dd < kGC; ++dd, ++t) {
        const float p = mo.m[t] * __shfl_xor_sync(0xffffffffu, mo.m[t], 1);
        t2 += dd == cc ? p : 2.f * p;
      }
    }
    s1 += t1;
    s2 += t2;
  }
  // a warp's sequences, then the block's warps in order
  const int lane = threadIdx.x & 31;
  const int items = lanes << a.gslots_log2;      // lanes a sequence
  for (int mask = items; mask < 32; mask <<= 1) {
    s1 += __shfl_xor_sync(0xffffffffu, s1, mask);
    s2 += __shfl_xor_sync(0xffffffffu, s2, mask);
  }
  if ((lane & (lanes - 1)) == 0 && lane < items) {
    const int e = ((ln.slot << a.gslots_log2) + ln.g) * 2;
    red[e] = s1;
    red[e + 1] = s2;
  }
  __syncthreads();
  const int cols = 2 * a.groups;
  if (threadIdx.x < cols) {
    const int g = threadIdx.x % a.groups, w = threadIdx.x / a.groups;
    const int step = max(1, 32 / items);         // sequences a warp
    float acc = 0.f;
    for (int slot = 0; slot < a.seqs; slot += step)
      acc += red[((slot << a.gslots_log2) + g) * 2 + w];
    a.partial[(size_t)blockIdx.x * cols + threadIdx.x] = acc;
  }
  // the last block to finish sums the partials
  __threadfence();
  __syncthreads();
  if (threadIdx.x == 0) last = atomicAdd(a.counter, 1) == (int)gridDim.x - 1;
  __syncthreads();
  if (!last) return;
  __threadfence();
  sum_partials(a.partial, gridDim.x, cols, a.sums);
  if (threadIdx.x == 0) *a.counter = 0;
}

template <typename T>
__global__ void __launch_bounds__(kThreads, kBackwardBlocksPerSm)
    sums_backward_kernel(SumsArgs<T> a) {
  const Lane ln(a.parts_log2, a.gslots_log2, a.len);
  const int tiles = (a.nseq + a.seqs - 1) / a.seqs;
  const bool live = ln.g < a.groups;
  const float d1 = live ? a.dsums[ln.g] : 0.f;
  const float d2 = live ? 2.f * a.dsums[a.groups + ln.g] : 0.f;
  T* out = ln.qk ? a.dk : a.dq;
  for (int tile = blockIdx.x; tile < tiles; tile += gridDim.x) {
    const int s = tile * a.seqs + ln.slot;
    const bool valid = live && s < a.nseq;
    const T* src = lane_rows(a, ln, valid ? s : 0);
    const int n = valid ? ln.n : 0;
    int ld = a.ld;
    Moments mo;
    moments(mo, src, ld, n, a.parts_log2);
    // q's lane takes k's moments and k's lane q's: base = d1 Ks, M = 2 d2 Gk
#pragma unroll
    for (int v = 0; v < kMoments; ++v)
      mo.m[v] = __shfl_xor_sync(0xffffffffu, mo.m[v], 1) *
                (v < kGC ? d1 : d2);
    T* dst = out + ((size_t)(valid ? s : 0) * a.len + ln.i0) * a.c +
             ln.g * kGC;
    const int c = a.c;
    walk<kLoadBytes>(src, ld, n, [&mo, dst, c](int i, const float (&x)[kGC]) {
      float y[kGC];
#pragma unroll
      for (int cc = 0; cc < kGC; ++cc) y[cc] = mo.m[cc];
      int t = kGC;
#pragma unroll
      for (int cc = 0; cc < kGC; ++cc) {
#pragma unroll
        for (int dd = cc; dd < kGC; ++dd, ++t) {
          y[cc] += mo.m[t] * x[dd];
          if (dd != cc) y[dd] += mo.m[t] * x[cc];
        }
      }
      store_group(dst + (size_t)i * c, y);
    });
  }
}

template <typename T>
int run(bool backward, const void* q, const void* k, int ld,
        const void* dsums, void* dq, void* dk, void* partial, void* counter,
        void* sums, int nseq, int len, int c, int groups, int parts, int seqs,
        int threads, int grid, void* stream) {
  // the plan must add up: 2 x parts lanes a (sequence, group), the groups
  // padded to a power of two, whole sequences a tile of `threads` lanes
  int parts_log2 = 0, gslots_log2 = 0;
  while ((1 << parts_log2) < parts) ++parts_log2;
  while ((1 << gslots_log2) < groups) ++gslots_log2;
  if (c != groups * kGC || len < 1 || len > kMaxLen || nseq < 1 ||
      2 * groups > kThreads || (1 << parts_log2) != parts || parts > 4 ||
      seqs < 1 || threads != kThreads ||
      (seqs * 2 * parts << gslots_log2) != threads || grid < 1 ||
      grid > (nseq + seqs - 1) / seqs || ld < c || ld % (16 / sizeof(T)))
    return (int)cudaErrorInvalidValue;
  const SumsArgs<T> a{static_cast<const T*>(q), static_cast<const T*>(k), ld,
                      static_cast<const float*>(dsums), static_cast<T*>(dq),
                      static_cast<T*>(dk), static_cast<float*>(partial),
                      static_cast<int*>(counter), static_cast<float*>(sums),
                      nseq, len, c, groups, parts_log2, gslots_log2, seqs};
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (backward) {
    sums_backward_kernel<T><<<grid, threads, 0, st>>>(a);
    return (int)cudaGetLastError();
  }
  sums_forward_kernel<T><<<grid, threads, 0, st>>>(a);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" int logits_sums_forward(int dtype, const void* q, const void* k,
                                   int ld, int nseq, int len, int c,
                                   int groups, int parts, int seqs,
                                   int threads, int grid, void* partial,
                                   void* counter, void* sums, void* stream) {
  if (dtype == wf::kF32)
    return run<float>(false, q, k, ld, nullptr, nullptr, nullptr, partial,
                      counter, sums, nseq, len, c, groups, parts, seqs,
                      threads, grid, stream);
  if (dtype == wf::kBF16)
    return run<__nv_bfloat16>(false, q, k, ld, nullptr, nullptr, nullptr,
                              partial, counter, sums, nseq, len, c, groups,
                              parts, seqs, threads, grid, stream);
  return (int)cudaErrorInvalidValue;
}

extern "C" int logits_sums_backward(int dtype, const void* q, const void* k,
                                    int ld, const void* dsums, void* dq,
                                    void* dk, int nseq, int len, int c,
                                    int groups, int parts, int seqs,
                                    int threads, int grid, void* stream) {
  if (dtype == wf::kF32)
    return run<float>(true, q, k, ld, dsums, dq, dk, nullptr, nullptr,
                      nullptr, nseq, len, c, groups, parts, seqs, threads,
                      grid, stream);
  if (dtype == wf::kBF16)
    return run<__nv_bfloat16>(true, q, k, ld, dsums, dq, dk, nullptr,
                              nullptr, nullptr, nseq, len, c, groups, parts,
                              seqs, threads, grid, stream);
  return (int)cudaErrorInvalidValue;
}

WF_EXPORT_ERROR_STRING
