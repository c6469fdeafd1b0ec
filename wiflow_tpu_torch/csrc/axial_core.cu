// Train-mode axial attention core, forward and backward, for sm_90a.
//
// Replaces wiflow_tpu/ops/pallas/axial_attention_train.py:axial_core, its
// forward (_core_fwd_kernel) and its backward (_core_bwd_kernel).  Per
// sequence n of L positions (L = 20 on the width axis, 15 on the height
// axis; 10 and 17 in the MM-Fi model) and per group g of 8 channels, with
// s_g the logits-BN scale:
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
// What bounds it on the H100: bytes on paper (both axes at batch 256 in
// bf16: 0.024 ms forward, 0.041 ms backward at 3.35 TB/s), the fp32
// instructions in practice: ~20 a (query, key, group) forward and ~90
// backward.  The products are 20 x 20 x 8 per (sequence, group), too
// shallow for mma.sync's 16 x 8 x 16 tiles to pay, so the arithmetic stays
// fp32 on the CUDA cores, where it has to be lean.
//
// Design (the launch plan is ops/kernels/axial_attention_train.py::
// train_attention_plan; the C side refuses a plan that does not add up):
//   Tiles.  A tile is a few whole sequences (at most 80 positions); a
//     persistent grid of blocks sized to the SMs walks the tiles.  A block
//     stages a tile's rows from device memory with 16-byte loads into
//     shared memory as fp32, in the eval core's layout (wf::QkvLayout: a
//     warp's 8 groups read 128 contiguous bytes of a row with one 16-byte
//     load a lane, one wavefront).  The backward copies its next tile with
//     cp.async while it computes on the tile before (on the card that
//     saved 9%, and cost the lighter forward 10%: it loads in place).
//   Forward: the eval kernels' core, wf::attend_tile without the affines.
//     A thread takes 2 queries of one (sequence, group) and reads each k_j
//     and v_j once for both; one pass with a running max, exponentials in
//     log2 units on the SFU.
//   Backward: a fourth section of each staged row holds dout.  Pass 1,
//     rows: a thread takes 2 queries, as the core, and makes two passes
//     over the keys, reading each k_j and v_j once a pass for both: the
//     softmax's max and denominator and t_i with a running max, then dq_i
//     and the rows' dscale term; the rows' log-sum-exp (log2 units) and t_i
//     go to shared memory.  Pass 2, columns: a thread takes 2 keys, reads
//     each q_i, dout_i and row's statistics once for both, recomputes p and
//     dz, and sums dk_j and dv_j.  Nothing of size L x L is stored.
//   Stores: 16 bytes a group; consecutive threads take the groups of one
//     position, so a warp stores whole 128-byte rows.
//   dscale: a block sums its rows' terms in a fixed order (a warp's lanes
//     over rows in turn, a fixed shuffle tree, the tiles in turn) into
//     partial[block, G], and a second launch (wf::reduce_columns) sums the
//     blocks in float64: no atomics, so a launch repeats bit for bit.
#include "attention_train.cuh"
#include "axial_attention_eval.cuh"

namespace {

using wf::ex2;
using wf::FastDiv;
using wf::group_dot;
using wf::load_group;
using wf::QkvLayout;
using wf::store_group;

constexpr int kGC = wf::kGroupChannels;
constexpr int kQ = wf::kQueries;   // queries (pass 2: keys) a thread
constexpr int kMaxThreads = wf::kMaxAttnThreads;
constexpr float kLog2e = 1.4426950408889634f;

__host__ __device__ constexpr int align16(int v) { return (v + 15) / 16 * 16; }

// A staged position of the backward: q, k, v and dout, four sections in
// QkvLayout's order.
__host__ __device__ constexpr int bwd_ld(int c) { return 4 * c + 32; }

// Byte offsets in a backward block's shared memory: the staged fp32 rows
// at 0, the next tile's rows as they come from device memory ([npos, 4, C]
// in T), the row statistics (float2 [npos, G]: log-sum-exp in log2 units,
// t), pass 1's dscale terms ([seqs, ceil(L / 2), G]) and the block's
// running dscale sums [G].  A forward block holds the staged rows alone.
struct BwdLayout {
  int raw, stats, terms, sums, total;
  __host__ __device__ BwdLayout(int c, int groups, int len, int seqs,
                                int esize) {
    const int npos = seqs * len;
    raw = npos * bwd_ld(c) * 4;
    stats = raw + npos * 4 * c * esize;
    terms = stats + align16(npos * groups * 8);
    sums = terms + align16(seqs * ((len + kQ - 1) / kQ) * groups * 4);
    total = sums + align16(groups * 4);
  }
};

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
  float* partial;        // [grid, G] (backward)
  int nseq, len, c, groups, seqs;   // seqs: whole sequences a tile
};

// A tile's rows in 16-byte chunks e = (position p, section, channel col):
// sections q, k, v, and dout when S = 4; consecutive threads on consecutive
// chunks of a row.  load() stages a tile into the fp32 rows (QkvLayout, ldr
// floats a position) with 16-byte loads, a thread's 4 in flight at once.
// fetch() copies a tile's chunks into raw, in order, with cp.async, so the
// copy runs while the block computes on the tile before, and unpack()
// converts them into the rows.
template <int S, typename T>
struct Stager {
  static constexpr int kVec = 16 / sizeof(T);   // values a chunk: 4 or 8
  int cps, per_pos;
  FastDiv by_pos, by_sec;
  QkvLayout lay;
  __device__ explicit Stager(int c)
      : cps(c / kVec), per_pos(S * (c / kVec)), by_pos(S * (c / kVec)),
        by_sec(c / kVec), lay(c) {}

  struct Chunk {
    int p, sec, col;
  };
  __device__ __forceinline__ Chunk chunk(int e) const {
    const int p = by_pos.div(e), r = e - p * per_pos;
    const int sec = by_sec.div(r);
    return {p, sec, (r - sec * cps) * kVec};
  }
  // the chunk in device memory, for a tile from position p0 on
  __device__ __forceinline__ const T* source(const CoreArgs<T>& a, size_t p0,
                                             Chunk ch) const {
    const T* src =
        ch.sec == 0 ? a.q : ch.sec == 1 ? a.k : ch.sec == 2 ? a.v : a.dout;
    return src + (p0 + ch.p) * (ch.sec == 3 ? a.c : a.ld) + ch.col;
  }
  // its first float in the staged rows
  __device__ __forceinline__ int staged(int ldr, Chunk ch) const {
    return ch.p * ldr + lay.at(ch.sec, ch.col / kGC, ch.col % kGC);
  }

  __device__ __forceinline__ void put(float* rows, int dst, uint4 u) const {
    const T* vals = reinterpret_cast<const T*>(&u);
#pragma unroll
    for (int k = 0; k < kVec; k += 4)   // bf16: channels 4-7 a half on
      *reinterpret_cast<float4*>(rows + dst + (k ? lay.half : 0)) =
          make_float4(wf::to_f(vals[k]), wf::to_f(vals[k + 1]),
                      wf::to_f(vals[k + 2]), wf::to_f(vals[k + 3]));
  }

  __device__ __forceinline__ void load(const CoreArgs<T>& a, float* rows,
                                       int ldr, int s0, int nvalid) const {
    constexpr int kBatch = 4;
    const int total = nvalid * a.len * per_pos;
    const size_t p0 = (size_t)s0 * a.len;
    for (int e0 = threadIdx.x; e0 < total; e0 += kBatch * blockDim.x) {
      uint4 raw[kBatch];
      int dst[kBatch];
#pragma unroll
      for (int b = 0; b < kBatch; ++b) {
        const int e = e0 + b * blockDim.x;
        if (e < total) {
          const Chunk ch = chunk(e);
          raw[b] = *reinterpret_cast<const uint4*>(source(a, p0, ch));
          dst[b] = staged(ldr, ch);
        }
      }
#pragma unroll
      for (int b = 0; b < kBatch; ++b)
        if (e0 + b * blockDim.x < total) put(rows, dst[b], raw[b]);
    }
  }

  __device__ __forceinline__ void fetch(const CoreArgs<T>& a, T* raw,
                                        int tile) const {
    const int s0 = tile * a.seqs, nvalid = min(a.seqs, a.nseq - s0);
    const int total = nvalid * a.len * per_pos;
    for (int e = threadIdx.x; e < total; e += blockDim.x)
      wf::cp_async16(raw + e * kVec, source(a, (size_t)s0 * a.len, chunk(e)));
    wf::cp_async_commit();
  }

  __device__ __forceinline__ void unpack(const T* raw, float* rows, int ldr,
                                         int npos) const {
    for (int e = threadIdx.x; e < npos * per_pos; e += blockDim.x)
      put(rows, staged(ldr, chunk(e)),
          *reinterpret_cast<const uint4*>(raw + e * kVec));
  }
};

template <typename T>
__global__ void __launch_bounds__(kMaxThreads, 2) axial_core_forward_kernel(
    const CoreArgs<T> a) {
  extern __shared__ __align__(16) unsigned char smem[];
  float* rows = reinterpret_cast<float*>(smem);
  const Stager<3, T> stager(a.c);
  const int ntiles = (a.nseq + a.seqs - 1) / a.seqs;
  for (int tile = blockIdx.x; tile < ntiles; tile += gridDim.x) {
    const int s0 = tile * a.seqs, nvalid = min(a.seqs, a.nseq - s0);
    __syncthreads();   // the last tile's core is done with the rows
    stager.load(a, rows, wf::qkv_ld(a.c), s0, nvalid);
    __syncthreads();
    wf::attend_tile<T, false>(
        rows, a.c, a.len, nvalid, a.scale, nullptr, [&](int s, int i, int g) {
          return a.out + ((size_t)(s0 + s) * a.len + i) * a.c + g * kGC;
        });
  }
}

// Pass 1 on (sequence s of the tile, queries 2 qb and 2 qb + 1, group g):
// their dq and row statistics; returns their dscale term.
template <typename T>
__device__ __forceinline__ float row_pass(const CoreArgs<T>& a,
                                          const float* rows, float2* stats,
                                          int s0, int s, int qb, int g) {
  constexpr int kChunk = 4;
  const int len = a.len, ldr = bwd_ld(a.c);
  const QkvLayout lay(a.c);
  const int i0 = qb * kQ, nq = min(kQ, len - i0);
  const float* base = rows + s * len * ldr + lay.at(0, g, 0);
  const float* kb = base + lay.sec;
  const float* vb = base + 2 * lay.sec;
  const float* db = base + 3 * lay.sec;
  const float sc = __ldg(a.scale + g), s2 = sc * kLog2e;
  float q[kQ][8], d[kQ][8];
#pragma unroll
  for (int u = 0; u < kQ; ++u) {
    if (u < nq) {
      load_group(q[u], base + (i0 + u) * ldr, lay.half);
      load_group(d[u], db + (i0 + u) * ldr, lay.half);
    } else {
#pragma unroll
      for (int cc = 0; cc < 8; ++cc) q[u][cc] = d[u][cc] = 0.f;
    }
  }
  // In log2 units, l_j = s2 lg_j: the max m, den = sum_j 2^(l_j - m) and
  // w = sum_j 2^(l_j - m) dsim_j, in chunks of 4 keys with a running max.
  float m[kQ], den[kQ], w[kQ];
#pragma unroll
  for (int u = 0; u < kQ; ++u) m[u] = -INFINITY, den[u] = w[u] = 0.f;
  for (int j0 = 0; j0 < len; j0 += kChunk) {
    float l[kQ][kChunk], ds[kQ][kChunk];
#pragma unroll
    for (int jj = 0; jj < kChunk; ++jj) {
      if (j0 + jj < len) {
        float k[8], v[8];
        load_group(k, kb + (j0 + jj) * ldr, lay.half);
        load_group(v, vb + (j0 + jj) * ldr, lay.half);
#pragma unroll
        for (int u = 0; u < kQ; ++u) {
          l[u][jj] = group_dot(0.f, q[u], k) * s2;
          ds[u][jj] = group_dot(0.f, d[u], v);
        }
      } else {
#pragma unroll
        for (int u = 0; u < kQ; ++u) l[u][jj] = -INFINITY, ds[u][jj] = 0.f;
      }
    }
#pragma unroll
    for (int u = 0; u < kQ; ++u) {
      float mn = m[u];
#pragma unroll
      for (int jj = 0; jj < kChunk; ++jj) mn = fmaxf(mn, l[u][jj]);
      const float alpha = ex2(m[u] - mn);
      m[u] = mn;
      den[u] *= alpha;
      w[u] *= alpha;
#pragma unroll
      for (int jj = 0; jj < kChunk; ++jj) {
        const float p = ex2(l[u][jj] - mn);
        den[u] += p;
        w[u] += p * ds[u][jj];
      }
    }
  }
  // p_j = 2^(l_j - lse), t = w / den; then dq and sum_j dz_j lg_j.
  float lse[kQ], t[kQ], dq[kQ][8];
#pragma unroll
  for (int u = 0; u < kQ; ++u) {
    t[u] = w[u] / den[u];
    lse[u] = m[u] + __log2f(den[u]);
#pragma unroll
    for (int cc = 0; cc < 8; ++cc) dq[u][cc] = 0.f;
  }
  float dsc = 0.f;
#pragma unroll 2
  for (int j = 0; j < len; ++j) {
    float k[8], v[8];
    load_group(k, kb + j * ldr, lay.half);
    load_group(v, vb + j * ldr, lay.half);
#pragma unroll
    for (int u = 0; u < kQ; ++u) {
      const float lg = group_dot(0.f, q[u], k);
      const float p = ex2(lg * s2 - lse[u]);
      const float dz = p * (group_dot(0.f, d[u], v) - t[u]);
      dsc += dz * lg;
      const float dl = dz * sc;
#pragma unroll
      for (int cc = 0; cc < 8; ++cc) dq[u][cc] += dl * k[cc];
    }
  }
  const int p0 = s * len + i0;   // the first query's position in the tile
#pragma unroll
  for (int u = 0; u < kQ; ++u) {
    if (u < nq) {
      store_group(a.dq + ((size_t)s0 * len + p0 + u) * a.c + g * kGC, dq[u]);
      stats[(p0 + u) * a.groups + g] = make_float2(lse[u], t[u]);
    }
  }
  return dsc;
}

// Pass 2 on (sequence s of the tile, keys 2 kp and 2 kp + 1, group g):
// their dk and dv.
template <typename T>
__device__ __forceinline__ void column_pass(const CoreArgs<T>& a,
                                            const float* rows,
                                            const float2* stats, int s0,
                                            int s, int kp, int g) {
  const int len = a.len, ldr = bwd_ld(a.c);
  const QkvLayout lay(a.c);
  const int j0 = kp * kQ, nk = min(kQ, len - j0);
  const float* base = rows + s * len * ldr + lay.at(0, g, 0);
  const float* db = base + 3 * lay.sec;
  const float2* st = stats + s * len * a.groups + g;
  const float sc = __ldg(a.scale + g), s2 = sc * kLog2e;
  float k[kQ][8], v[kQ][8], dk[kQ][8], dv[kQ][8];
#pragma unroll
  for (int u = 0; u < kQ; ++u) {
    if (u < nk) {
      load_group(k[u], base + lay.sec + (j0 + u) * ldr, lay.half);
      load_group(v[u], base + 2 * lay.sec + (j0 + u) * ldr, lay.half);
    } else {
#pragma unroll
      for (int cc = 0; cc < 8; ++cc) k[u][cc] = v[u][cc] = 0.f;
    }
#pragma unroll
    for (int cc = 0; cc < 8; ++cc) dk[u][cc] = dv[u][cc] = 0.f;
  }
#pragma unroll 2
  for (int i = 0; i < len; ++i) {
    float q[8], d[8];
    load_group(q, base + i * ldr, lay.half);
    load_group(d, db + i * ldr, lay.half);
    const float2 r = st[i * a.groups];   // log-sum-exp, t of row i
#pragma unroll
    for (int u = 0; u < kQ; ++u) {
      const float lg = group_dot(0.f, q, k[u]);
      const float p = ex2(lg * s2 - r.x);
      const float dl = p * (group_dot(0.f, d, v[u]) - r.y) * sc;
#pragma unroll
      for (int cc = 0; cc < 8; ++cc) {
        dk[u][cc] += dl * q[cc];
        dv[u][cc] += p * d[cc];
      }
    }
  }
#pragma unroll
  for (int u = 0; u < kQ; ++u) {
    if (u < nk) {
      const size_t o = ((size_t)s0 * len + s * len + j0 + u) * a.c + g * kGC;
      store_group(a.dk + o, dk[u]);
      store_group(a.dv + o, dv[u]);
    }
  }
}

// sums[g] += the tile's dscale terms of group g, terms[r * groups + g] for
// r < nrows: warp w takes groups w, w + warps, ...; its lanes take rows
// lane, lane + 32, ... in order, then a fixed shuffle tree.
__device__ __forceinline__ void sum_terms(const float* terms, int nrows,
                                          int groups, float* sums) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  for (int g = warp; g < groups; g += blockDim.x >> 5) {
    float acc = 0.f;
    for (int r = lane; r < nrows; r += 32) acc += terms[r * groups + g];
#pragma unroll
    for (int off = 16; off > 0; off >>= 1)
      acc += __shfl_xor_sync(0xffffffffu, acc, off);
    if (lane == 0) sums[g] += acc;
  }
}

template <typename T>
__global__ void __launch_bounds__(kMaxThreads, 2) axial_core_backward_kernel(
    const CoreArgs<T> a) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int len = a.len, groups = a.groups, nqb = (len + kQ - 1) / kQ;
  const BwdLayout l(a.c, groups, len, a.seqs, sizeof(T));
  float* rows = reinterpret_cast<float*>(smem);
  T* raw = reinterpret_cast<T*>(smem + l.raw);
  float2* stats = reinterpret_cast<float2*>(smem + l.stats);
  float* terms = reinterpret_cast<float*>(smem + l.terms);
  float* sums = reinterpret_cast<float*>(smem + l.sums);
  for (int g = threadIdx.x; g < groups; g += blockDim.x) sums[g] = 0.f;
  const Stager<4, T> stager(a.c);
  const FastDiv by_groups(groups), by_pairs(nqb);
  const int ntiles = (a.nseq + a.seqs - 1) / a.seqs;
  if (blockIdx.x < ntiles) stager.fetch(a, raw, blockIdx.x);
  for (int tile = blockIdx.x; tile < ntiles; tile += gridDim.x) {
    const int s0 = tile * a.seqs, nvalid = min(a.seqs, a.nseq - s0);
    const int items = nvalid * nqb * groups;   // (sequence, pair, group)
    wf::cp_async_wait<0>();
    __syncthreads();   // the tile landed; the last tile's pass 2 is done
    stager.unpack(raw, rows, bwd_ld(a.c), nvalid * len);
    __syncthreads();   // staged; raw is free for the next tile
    if (tile + gridDim.x < ntiles) stager.fetch(a, raw, tile + gridDim.x);
    for (int e = threadIdx.x; e < items; e += blockDim.x) {
      const int rest = by_groups.div(e), g = e - rest * groups;
      const int s = by_pairs.div(rest), qb = rest - s * nqb;
      terms[e] = row_pass(a, rows, stats, s0, s, qb, g);
    }
    __syncthreads();
    sum_terms(terms, nvalid * nqb, groups, sums);
    for (int e = threadIdx.x; e < items; e += blockDim.x) {
      const int rest = by_groups.div(e), g = e - rest * groups;
      const int s = by_pairs.div(rest), kp = rest - s * nqb;
      column_pass(a, rows, stats, s0, s, kp, g);
    }
  }
  __syncthreads();
  for (int g = threadIdx.x; g < groups; g += blockDim.x)
    a.partial[(size_t)blockIdx.x * groups + g] = sums[g];
}

bool aligned16(const void* p) {
  return reinterpret_cast<uintptr_t>(p) % 16 == 0;
}

template <typename T>
int launch(bool backward, const CoreArgs<T>& a, int threads, int grid,
           size_t smem, float* dscale, void* stream) {
  const size_t need =
      backward ? (size_t)BwdLayout(a.c, a.groups, a.len, a.seqs, sizeof(T))
                     .total
               : (size_t)a.seqs * a.len * wf::qkv_ld(a.c) * sizeof(float);
  const bool aligned =
      aligned16(a.q) && aligned16(a.k) && aligned16(a.v) &&
      a.ld * sizeof(T) % 16 == 0 &&
      (backward ? aligned16(a.dout) && aligned16(a.dq) && aligned16(a.dk) &&
                      aligned16(a.dv)
                : aligned16(a.out));
  if (a.c != a.groups * kGC || a.len < 1 || a.len > wf::kMaxLen ||
      a.ld < a.c || a.seqs < 1 || a.nseq < 1 || threads < 32 ||
      threads > kMaxThreads || threads % 32 || grid < 1 || smem < need ||
      !aligned)
    return (int)cudaErrorInvalidValue;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (!backward) {
    cudaError_t err = cudaFuncSetAttribute(
        axial_core_forward_kernel<T>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return (int)err;
    axial_core_forward_kernel<T><<<grid, threads, smem, st>>>(a);
    return (int)cudaGetLastError();
  }
  cudaError_t err = cudaFuncSetAttribute(
      axial_core_backward_kernel<T>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  axial_core_backward_kernel<T><<<grid, threads, smem, st>>>(a);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  wf::reduce_columns<<<1, wf::kThreads, 0, st>>>(a.partial, grid, a.groups,
                                                 dscale);
  return (int)cudaGetLastError();
}

template <typename T>
int run(bool backward, const void* q, const void* k, const void* v, int ld,
        const void* dout, void* out, void* dq, void* dk, void* dv,
        const void* scale, void* partial, void* dscale, int nseq, int len,
        int c, int groups, int seqs, int threads, int grid, size_t smem,
        void* stream) {
  const CoreArgs<T> a{static_cast<const T*>(q),    static_cast<const T*>(k),
                      static_cast<const T*>(v),    ld,
                      static_cast<const T*>(dout), static_cast<T*>(out),
                      static_cast<T*>(dq),         static_cast<T*>(dk),
                      static_cast<T*>(dv),         static_cast<const float*>(scale),
                      static_cast<float*>(partial), nseq, len, c, groups,
                      seqs};
  return launch(backward, a, threads, grid, smem, static_cast<float*>(dscale),
                stream);
}

}  // namespace

extern "C" int axial_core_forward(int dtype, const void* q, const void* k,
                                  const void* v, int ld, void* out, int nseq,
                                  int len, int c, int groups, int seqs,
                                  int threads, int grid, const void* scale,
                                  size_t smem, void* stream) {
  if (dtype == wf::kF32)
    return run<float>(false, q, k, v, ld, nullptr, out, nullptr, nullptr,
                      nullptr, scale, nullptr, nullptr, nseq, len, c, groups,
                      seqs, threads, grid, smem, stream);
  if (dtype == wf::kBF16)
    return run<__nv_bfloat16>(false, q, k, v, ld, nullptr, out, nullptr,
                              nullptr, nullptr, scale, nullptr, nullptr, nseq,
                              len, c, groups, seqs, threads, grid, smem,
                              stream);
  return (int)cudaErrorInvalidValue;
}

extern "C" int axial_core_backward(int dtype, const void* q, const void* k,
                                   const void* v, int ld, const void* dout,
                                   void* dq, void* dk, void* dv, int nseq,
                                   int len, int c, int groups, int seqs,
                                   int threads, int grid, const void* scale,
                                   void* partial, void* dscale, size_t smem,
                                   void* stream) {
  if (dtype == wf::kF32)
    return run<float>(true, q, k, v, ld, dout, nullptr, dq, dk, dv, scale,
                      partial, dscale, nseq, len, c, groups, seqs, threads,
                      grid, smem, stream);
  if (dtype == wf::kBF16)
    return run<__nv_bfloat16>(true, q, k, v, ld, dout, nullptr, dq, dk, dv,
                              scale, partial, dscale, nseq, len, c, groups,
                              seqs, threads, grid, smem, stream);
  return (int)cudaErrorInvalidValue;
}

WF_EXPORT_ERROR_STRING
