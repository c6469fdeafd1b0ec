// Shared stages of the eval axial-attention kernels (axial_attention.cu,
// axial_attention_dual.cu, axial_attention_v1.cu): the QKV projection of a
// tile of positions, and the attention core on the projected tile, which
// the train core's forward (axial_core.cu) runs too, without the affines.
//
// A tile is a few whole sequences of L <= 32 positions.  Its q, k, v live
// in shared memory in fp32, as the TPU kernel keeps them, one row of
// qkv_ld(C) floats a position (QkvLayout).  The kernels differ in where a
// tile's input rows come from (staged from device memory, or the
// one-launch kernel's intermediate in shared memory), in where the result
// goes, and in how the tile is sized (ops/kernels/axial_attention.py::
// attention_plan).
//
// Both stages are device functions of one definition, so the v2 and the
// one-launch kernel compute every output with the same instructions in
// the same order: they agree bit for bit.
#pragma once

#include <cmath>

#include "common.cuh"
#include "mma.cuh"

namespace wf {

constexpr int kGroupChannels = 8;

// A position's q, k, v row: three sections (q, k, v) of C + 8 floats; a
// section holds channels 0-3 of every group (group g at 4 g), 4 floats of
// padding, then channels 4-7 of every group.  So a warp's 8 groups read
// 128 contiguous bytes of k or v with one 16-byte load a lane (one
// shared-memory wavefront a row), and with qkv_ld(C) = 3C + 24 (8 or 24
// words mod 32) the projection's float2 stores meet no bank conflict.
__host__ __device__ constexpr int qkv_ld(int c) { return 3 * c + 24; }

struct QkvLayout {
  int sec, half;   // floats between sections, and between a section's halves
  __device__ explicit QkvLayout(int c) : sec(c + 8), half(c / 2 + 4) {}
  // the float of channel cc (0-7) of group g in section s (0 q, 1 k, 2 v)
  __device__ __forceinline__ int at(int s, int g, int cc) const {
    return s * sec + (cc >> 2) * half + 4 * g + (cc & 3);
  }
};

// Queries a thread of the core, and a block's most threads for it such
// that two blocks fit an SM's registers (102 a thread): a tile of at most
// 80 positions has at most 320 (sequence, query pair, group) items at G =
// 8; a tile with more items takes them in turns.
constexpr int kQueries = 2;
constexpr int kMaxAttnThreads = 320;

// qkv[p] = A[p, 0:C] @ W + bq for the tile's positions p < npos.
// row(p, e) gives the shared-memory address of element e of input row p
// (e a multiple of 8 in bf16, whose layouts may swizzle 8-element chunks;
// fp32 rows are contiguous), the zero row for p >= npos.  The warps take
// units of one m-tile (16 positions) x NT n-tiles (8 columns: one group of
// q, k or v each) in turn: NT = 12 where 4 divides the G groups (a tile's
// 2 units an m-tile then fill 10 warps in one round), else 6 (C is a
// multiple of 16, so G is even).
//   bf16: mma.sync m16n8k16 with fp32 accumulation; the A fragments by
//     ldmatrix straight from the rows, the B fragments from the weights
//     resident in shared memory in fragment order, [C/16][3C/8][lane]
//     (8 bytes a lane).
//   fp32: the same units on CUDA-core FMAs, thread (gid, tig) owning rows
//     gid and gid + 8 and columns 2 tig, 2 tig + 1 of each n-tile, like an
//     mma's accumulator; W [C, 3C] is read from device memory (L1).
// The bias is added in the fp32 epilogue.
template <int NT>
struct Unit {
  int mt, nt0;   // m-tile, first n-tile

  __device__ Unit(int unit, int groups) {
    const int per_mt = 3 * groups / NT;
    mt = unit / per_mt;
    nt0 = (unit - mt * per_mt) * NT;
  }

  __device__ __forceinline__ void store(const float (&acc)[NT][4], int npos,
                                        int c, const float* __restrict__ bq,
                                        float* qkv) const {
    const int lane = threadIdx.x & 31, gid = lane >> 2, tig = lane & 3;
    const int groups = c / kGroupChannels, ldq = qkv_ld(c);
    const QkvLayout lay(c);
    int sec = nt0 / groups, g = nt0 - sec * groups;
#pragma unroll
    for (int nt = 0; nt < NT; ++nt) {
      const int col = (nt0 + nt) * 8 + 2 * tig;
      const float b0 = __ldg(bq + col), b1 = __ldg(bq + col + 1);
      float* dst = qkv + lay.at(sec, g, 2 * tig);
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int p = mt * 16 + gid + 8 * h;
        if (p < npos)
          *reinterpret_cast<float2*>(dst + p * ldq) =
              make_float2(acc[nt][2 * h] + b0, acc[nt][2 * h + 1] + b1);
      }
      if (++g == groups) g = 0, ++sec;
    }
  }
};

template <int NT, typename RowFn>
__device__ __forceinline__ void project_units(const RowFn& row, int npos,
                                              int c,
                                              const __nv_bfloat16* wfrag,
                                              const float* __restrict__ bq,
                                              float* qkv) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int nwarps = blockDim.x >> 5, groups = c / kGroupChannels;
  const int ntiles = 3 * groups, ksteps = c / 16;
  const int units = (npos + 15) / 16 * (ntiles / NT);
  for (int unit = warp; unit < units; unit += nwarps) {
    const Unit<NT> u(unit, groups);
    float acc[NT][4];
#pragma unroll
    for (int nt = 0; nt < NT; ++nt)
#pragma unroll
      for (int q = 0; q < 4; ++q) acc[nt][q] = 0.f;
    // lanes 0-15 give chunk 2 ks of rows 0-15, lanes 16-31 chunk 2 ks + 1
    const int m = u.mt * 16 + (lane & 15);
    const uint2* bp = reinterpret_cast<const uint2*>(wfrag) + u.nt0 * 32 +
                      lane;
#pragma unroll 4
    for (int ks = 0; ks < ksteps; ++ks) {
      uint32_t af[4];
      ldmatrix_x4(af, row(m, 16 * ks + 8 * (lane >> 4)));
#pragma unroll
      for (int nt = 0; nt < NT; ++nt) {
        const uint2 b2 = bp[(ks * ntiles + nt) * 32];
        const uint32_t bf[2] = {b2.x, b2.y};
        mma_bf16(acc[nt], af, bf);
      }
    }
    u.store(acc, npos, c, bq, qkv);
  }
}

template <int NT, typename RowFn>
__device__ __forceinline__ void project_units(const RowFn& row, int npos,
                                              int c,
                                              const float* __restrict__ wq,
                                              const float* __restrict__ bq,
                                              float* qkv) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int gid = lane >> 2, tig = lane & 3, nwarps = blockDim.x >> 5;
  const int groups = c / kGroupChannels, c3 = 3 * c;
  const int units = (npos + 15) / 16 * (3 * groups / NT);
  for (int unit = warp; unit < units; unit += nwarps) {
    const Unit<NT> u(unit, groups);
    float acc[NT][4];
#pragma unroll
    for (int nt = 0; nt < NT; ++nt)
#pragma unroll
      for (int q = 0; q < 4; ++q) acc[nt][q] = 0.f;
    const float* a0 = row(u.mt * 16 + gid, 0);
    const float* a1 = row(u.mt * 16 + gid + 8, 0);
    const float* wk = wq + u.nt0 * 8 + 2 * tig;
    for (int k0 = 0; k0 < c; k0 += 4) {
      const float4 x0 = *reinterpret_cast<const float4*>(a0 + k0);
      const float4 x1 = *reinterpret_cast<const float4*>(a1 + k0);
      const float xa[4] = {x0.x, x0.y, x0.z, x0.w};
      const float xb[4] = {x1.x, x1.y, x1.z, x1.w};
#pragma unroll
      for (int e = 0; e < 4; ++e) {
#pragma unroll
        for (int nt = 0; nt < NT; ++nt) {
          const float2 w2 = __ldg(reinterpret_cast<const float2*>(
              wk + (size_t)(k0 + e) * c3 + nt * 8));
          acc[nt][0] += xa[e] * w2.x;
          acc[nt][1] += xa[e] * w2.y;
          acc[nt][2] += xb[e] * w2.x;
          acc[nt][3] += xb[e] * w2.y;
        }
      }
    }
    u.store(acc, npos, c, bq, qkv);
  }
}

template <typename W, typename RowFn>
__device__ __forceinline__ void project_tile(const RowFn& row, int npos,
                                             int c, const W* w,
                                             const float* __restrict__ bq,
                                             float* qkv) {
  if (c / kGroupChannels % 4 == 0)
    project_units<12>(row, npos, c, w, bq, qkv);
  else
    project_units<6>(row, npos, c, w, bq, qkv);
}

__device__ __forceinline__ void store_group(float* p, const float (&v)[8]) {
  float4* q = reinterpret_cast<float4*>(p);
  q[0] = make_float4(v[0], v[1], v[2], v[3]);
  q[1] = make_float4(v[4], v[5], v[6], v[7]);
}
__device__ __forceinline__ void store_group(__nv_bfloat16* p,
                                            const float (&v)[8]) {
  uint4 u;
  u.x = pack2(__float2bfloat16_rn(v[0]), __float2bfloat16_rn(v[1]));
  u.y = pack2(__float2bfloat16_rn(v[2]), __float2bfloat16_rn(v[3]));
  u.z = pack2(__float2bfloat16_rn(v[4]), __float2bfloat16_rn(v[5]));
  u.w = pack2(__float2bfloat16_rn(v[6]), __float2bfloat16_rn(v[7]));
  *reinterpret_cast<uint4*>(p) = u;
}

// A group's 8 channels: 4 at p, 4 at p + half.
__device__ __forceinline__ void load_group(float (&v)[8], const float* p,
                                           int half) {
  const float4 a = *reinterpret_cast<const float4*>(p);
  const float4 b = *reinterpret_cast<const float4*>(p + half);
  v[0] = a.x; v[1] = a.y; v[2] = a.z; v[3] = a.w;
  v[4] = b.x; v[5] = b.y; v[6] = b.z; v[7] = b.w;
}

// b + q . k, summed from b in channel order
__device__ __forceinline__ float group_dot(float b, const float (&q)[8],
                                           const float (&k)[8]) {
#pragma unroll
  for (int cc = 0; cc < kGroupChannels; ++cc) b += q[cc] * k[cc];
  return b;
}

// 2^x on the SFU (ex2.approx.ftz: 2 ulp; 2^-inf = 0).
__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

// The attention core on a projected tile of nseq whole sequences of len
// positions (sequence s's rows start at qkv + s * len * qkv_ld(C)).  A
// thread takes Q = kQueries consecutive queries of one (sequence, group),
// so every k_j and v_j it reads (8 fp32 channels: two 16-byte loads each)
// serves Q logits and Q weighted sums.  Per query i and group g, in log2
// units (s2 = s_g log2 e, b2 = b_g log2 e), with q scaled once:
//   l_j = b2 + (s2 q_i) . k_j
//   o = sum_j 2^(l_j - m) v_j / sum_j 2^(l_j - m), m = max_j l_j
//   dst(s, i, g)[cc] = o[cc] * so + bo, rounded to T.
// One pass over the keys in chunks of 4 with a running max: a chunk's
// logits stay in registers, and the sums are rescaled by 2^(m_old - m_new)
// once a chunk, so each k_j and v_j is read once.  Consecutive threads
// take the groups of one position, so a warp's device stores are whole
// 128-byte rows.
// Affine = false is the train core (axial_core.cu): sim is the [G] scale
// alone, b2 = 0, and the output is o, with no affine.
template <typename T, bool Affine = true, typename DstFn>
__device__ __forceinline__ void attend_tile(const float* qkv, int c, int len,
                                            int nseq,
                                            const float* __restrict__ sim,
                                            const float* __restrict__ oaff,
                                            const DstFn& dst) {
  constexpr int Q = kQueries;
  constexpr float kLog2e = 1.4426950408889634f;
  constexpr int kChunk = 4;
  const int groups = c / kGroupChannels, ldq = qkv_ld(c);
  const QkvLayout lay(c);
  const int nqb = (len + Q - 1) / Q;
  const int items = nseq * nqb * groups;
  for (int e = threadIdx.x; e < items; e += blockDim.x) {
    const int g = e % groups, rest = e / groups;
    const int qb = rest % nqb, s = rest / nqb;
    const int i0 = qb * Q, nq = min(Q, len - i0);
    const float* base = qkv + s * len * ldq + lay.at(0, g, 0);
    const float* kb = base + lay.sec;
    const float* vb = base + 2 * lay.sec;
    const float s2 = __ldg(sim + g) * kLog2e;
    const float b2 = Affine ? __ldg(sim + groups + g) * kLog2e : 0.f;
    float q[Q][8];
#pragma unroll
    for (int u = 0; u < Q; ++u) {
      if (u < nq) {
        load_group(q[u], base + (i0 + u) * ldq, lay.half);
      } else {
#pragma unroll
        for (int cc = 0; cc < 8; ++cc) q[u][cc] = 0.f;
      }
#pragma unroll
      for (int cc = 0; cc < 8; ++cc) q[u][cc] *= s2;
    }
    float m[Q], den[Q], o[Q][8];
#pragma unroll
    for (int u = 0; u < Q; ++u) {
      m[u] = -INFINITY;
      den[u] = 0.f;
#pragma unroll
      for (int cc = 0; cc < 8; ++cc) o[u][cc] = 0.f;
    }
    for (int j0 = 0; j0 < len; j0 += kChunk) {
      float lg[Q][kChunk];
#pragma unroll
      for (int jj = 0; jj < kChunk; ++jj) {
        if (j0 + jj < len) {
          float k[8];
          load_group(k, kb + (j0 + jj) * ldq, lay.half);
#pragma unroll
          for (int u = 0; u < Q; ++u) lg[u][jj] = group_dot(b2, q[u], k);
        } else {
#pragma unroll
          for (int u = 0; u < Q; ++u) lg[u][jj] = -INFINITY;
        }
      }
#pragma unroll
      for (int u = 0; u < Q; ++u) {
        float mn = m[u];
#pragma unroll
        for (int jj = 0; jj < kChunk; ++jj) mn = fmaxf(mn, lg[u][jj]);
        const float alpha = ex2(m[u] - mn);
        m[u] = mn;
        den[u] *= alpha;
#pragma unroll
        for (int cc = 0; cc < 8; ++cc) o[u][cc] *= alpha;
      }
#pragma unroll
      for (int jj = 0; jj < kChunk; ++jj) {
        if (j0 + jj < len) {
          float v[8];
          load_group(v, vb + (j0 + jj) * ldq, lay.half);
#pragma unroll
          for (int u = 0; u < Q; ++u) {
            const float p = ex2(lg[u][jj] - m[u]);
            den[u] += p;
#pragma unroll
            for (int cc = 0; cc < 8; ++cc) o[u][cc] += p * v[cc];
          }
        }
      }
    }
    const int ch0 = g * kGroupChannels;
    float so[8], bo[8];
#pragma unroll
    for (int cc = 0; cc < 8; ++cc) {
      so[cc] = Affine ? __ldg(oaff + ch0 + cc) : 1.f;
      bo[cc] = Affine ? __ldg(oaff + c + ch0 + cc) : 0.f;
    }
#pragma unroll
    for (int u = 0; u < Q; ++u) {
      const float r = 1.0f / den[u];
      float out[8];
#pragma unroll
      for (int cc = 0; cc < 8; ++cc)
        out[cc] = Affine ? o[u][cc] * r * so[cc] + bo[cc] : o[u][cc] * r;
      if (u < nq) store_group(dst(s, i0 + u, g), out);
    }
  }
}

}  // namespace wf
