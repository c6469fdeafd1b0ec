// WPformer's channel attention core, eval, bf16, for sm_90a.
//
// Replaces no TPU kernel: the JAX package computes this core with XLA
// einsums (wiflow_tpu/models/baselines/wpformer.py, ChannelAttention).  It
// was added because the core is the one mechanism of a served
// configuration that had no kernel of the port.  Per window, with H heads
// of Q, K, V [N, C] read in place from the packed projection
// qkv [B, N, 3 H C] (columns q_0 .. q_{H-1}, k_0 .., v_0 ..):
//   S_h = Q_h^T K_h / sqrt(C)                      [C, C], fp32
//   Z_h = (S_h - mean(S_h)) * rsqrt(var(S_h) + eps) InstanceNorm over all
//                                                   C x C entries (biased)
//   P_h = softmax_rows(Z_h), rounded to bf16        as the model rounds it
//   out = (1 / H) sum_h V_h P_h^T                  [N, C], fp32 sums, bf16
//
// What bounds it on the H100, at N = 2160, C = 256, H = 3: a window reads
// 9.95 MB of Q, K, V and writes 1.1 MB, 3.3 us at 3.35 TB/s; its 1.70
// GFLOP are 1.7 us of bf16 tensor-core time.  So bytes set the floor, and
// the design reads Q, K and V once from device memory and keeps the
// [C, C] scores on chip.
//
// Design (the launch plan is ops/kernels/channel_attention.py::
// channel_attention_plan; the C side refuses a plan that does not add up):
//   A cluster of C / 64 CTAs a window.  CTA r owns rows r*64 .. r*64+63
//     of every S_h: it streams Q_h's 64 columns and all of K_h through a
//     3-stage cp.async ring (32 tokens a stage, rows padded by 16 bytes:
//     ldmatrix without bank conflicts) and accumulates its [64, C] block
//     of S_h in registers with mma.sync (8 warps of 16 x C/2).
//   The InstanceNorm's statistics cross the cluster.  Each CTA reduces its
//     block to a sum and the sum of squares about the block's own mean
//     (from the registers, so no cancellation), leaves the two in shared
//     memory, and after a cluster barrier reads every rank's pair through
//     distributed shared memory and merges them in rank order (Chan's
//     formula): every CTA gets the same mean and variance, no atomics, no
//     scratch in device memory.  The row softmax then runs on the
//     registers (row max and sum across the 4 lanes of a row and the 2
//     warps of its halves) and P_h's 64 rows go to shared memory as bf16.
//   The context.  With every head's P rows resident (H x 64 x (C + 8)
//     bf16), the CTA walks the tokens in tiles of 64, streams V_h [64, C]
//     of each head through a 2-stage ring and accumulates its 64 output
//     columns over all heads (K = H x C) in fp32 registers; the epilogue
//     divides by H, rounds to bf16 and stores [64 tokens, 64 columns].
//   Every CTA of a cluster reads all of K_h and V_h; the cluster's four
//     run side by side, so the repeats come from L2, not device memory.
//   Tokens past N are zero-filled by cp.async and never stored.  A launch
//     repeats bit for bit.
#include <cooperative_groups.h>

#include "common.cuh"
#include "mma.cuh"

namespace cg = cooperative_groups;

namespace {

constexpr int kRows = 64;        // rows of S (channels) a CTA owns
constexpr int kTokA = 32;        // tokens a stage of the scores' ring
constexpr int kStagesA = 3;
constexpr int kTokB = 64;        // tokens a tile of the context
constexpr int kStagesB = 2;
constexpr int kQRow = kRows + 8; // padded row of a staged Q block
constexpr int kWarps = wf::kThreads / 32;

struct Layout {
  size_t p, stage, red, stats, total;
};

// Byte offsets of the dynamic shared memory; the plan computes the same.
__host__ __device__ inline Layout layout(int c, int heads) {
  const size_t row = (size_t)(c + 8) * 2;            // a padded bf16 row
  Layout l;
  l.p = 0;
  const size_t p_bytes = (size_t)heads * kRows * row;
  const size_t stage_a = (size_t)kTokA * kQRow * 2 + (size_t)kTokA * row;
  const size_t stage_b = (size_t)kTokB * row;
  const size_t stage = kStagesA * stage_a > kStagesB * stage_b
                           ? kStagesA * stage_a : kStagesB * stage_b;
  l.stage = p_bytes;
  l.red = l.stage + stage;
  // row max and row sum of both column halves, and a float per warp
  l.stats = l.red + (size_t)(2 * 2 * kRows + kWarps) * 4;
  l.total = l.stats + (((size_t)heads * 2 * 4 + 15) / 16) * 16;
  return l;
}

struct Args {
  const __nv_bfloat16* qkv;   // [B, N, 3 H C]
  __nv_bfloat16* out;         // [B, N, C]
  int batch, n, heads;
  float sqrt_c, eps;
};

// One stage of the scores' ring: tokens t0 .. t0 + 31 of Q_h's columns
// c0 .. c0 + 63 and of all of K_h.
template <int C>
__device__ __forceinline__ void load_a(const Args& a,
                                       const __nv_bfloat16* win, int h,
                                       int c0, int t0, __nv_bfloat16* qs,
                                       __nv_bfloat16* ks) {
  const long long ld = 3LL * a.heads * C;
  const int tid = threadIdx.x;
  {
    const int row = tid >> 3, seg = tid & 7;
    const int t = t0 + row;
    const bool ok = t < a.n;
    const __nv_bfloat16* src =
        win + (ok ? (long long)t * ld : 0) + (long long)h * C + c0 + seg * 8;
    wf::cp_async16(qs + row * kQRow + seg * 8, src, ok);
  }
  constexpr int kSegs = C / 8;
  for (int i = tid; i < kTokA * kSegs; i += wf::kThreads) {
    const int row = i / kSegs, seg = i % kSegs;
    const int t = t0 + row;
    const bool ok = t < a.n;
    const __nv_bfloat16* src = win + (ok ? (long long)t * ld : 0) +
                               (long long)(a.heads + h) * C + seg * 8;
    wf::cp_async16(ks + row * (C + 8) + seg * 8, src, ok);
  }
}

// One stage of the context's ring: tokens t0 .. t0 + 63 of all of V_h.
template <int C>
__device__ __forceinline__ void load_b(const Args& a,
                                       const __nv_bfloat16* win, int h,
                                       int t0, __nv_bfloat16* vs) {
  const long long ld = 3LL * a.heads * C;
  constexpr int kSegs = C / 8;
  for (int i = threadIdx.x; i < kTokB * kSegs; i += wf::kThreads) {
    const int row = i / kSegs, seg = i % kSegs;
    const int t = t0 + row;
    const bool ok = t < a.n;
    const __nv_bfloat16* src = win + (ok ? (long long)t * ld : 0) +
                               (long long)(2 * a.heads + h) * C + seg * 8;
    wf::cp_async16(vs + row * (C + 8) + seg * 8, src, ok);
  }
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

// The sum of v over the CTA, the same value in every thread (warp sums
// added in warp order).  Leaves red free for the next call.
__device__ __forceinline__ float block_sum(float v, float* red) {
  v = warp_sum(v);
  if ((threadIdx.x & 31) == 0) red[threadIdx.x >> 5] = v;
  __syncthreads();
  float s = 0.f;
#pragma unroll
  for (int w = 0; w < kWarps; ++w) s += red[w];
  __syncthreads();
  return s;
}

template <int C>
__global__ void __launch_bounds__(wf::kThreads, 1)
    channel_attention_kernel(Args a) {
  constexpr int kNT = C / 16;          // n8 tiles of a warp's C / 2 columns
  constexpr int kCluster = C / kRows;
  extern __shared__ __align__(16) unsigned char smem[];
  const Layout lay = layout(C, a.heads);
  __nv_bfloat16* ps = reinterpret_cast<__nv_bfloat16*>(smem + lay.p);
  unsigned char* stage = smem + lay.stage;
  float* rmax = reinterpret_cast<float*>(smem + lay.red);   // [2][64]
  float* rsum = rmax + 2 * kRows;                           // [2][64]
  float* red = rsum + 2 * kRows;                            // [kWarps]
  float* stats = reinterpret_cast<float*>(smem + lay.stats);  // [H][2]

  cg::cluster_group cluster = cg::this_cluster();
  const int rank = (int)cluster.block_rank();
  const int c0 = rank * kRows;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int gid = lane >> 2, tig = lane & 3;
  const int wr = warp & 3, wc = warp >> 2;   // 16-row group, column half
  const int heads = a.heads;
  const long long ld = 3LL * heads * C;
  const size_t stage_a =
      (size_t)kTokA * kQRow * 2 + (size_t)kTokA * (C + 8) * 2;
  const int nchunk_a = (a.n + kTokA - 1) / kTokA;
  const int ntile_b = (a.n + kTokB - 1) / kTokB;
  const float cnt = (float)kRows * C;        // entries of a CTA's block

  for (int b = blockIdx.y; b < a.batch; b += gridDim.y) {
    const __nv_bfloat16* win = a.qkv + (long long)b * a.n * ld;

    // ---- scores, InstanceNorm, softmax: P_h's rows c0 .. c0 + 63 -------
    for (int h = 0; h < heads; ++h) {
      float acc[kNT][4];
#pragma unroll
      for (int t = 0; t < kNT; ++t)
        acc[t][0] = acc[t][1] = acc[t][2] = acc[t][3] = 0.f;
      auto qs_of = [&](int s) {
        return reinterpret_cast<__nv_bfloat16*>(stage + s * stage_a);
      };
      auto ks_of = [&](int s) {
        return reinterpret_cast<__nv_bfloat16*>(stage + s * stage_a +
                                                kTokA * kQRow * 2);
      };
#pragma unroll
      for (int s = 0; s < kStagesA - 1; ++s) {
        if (s < nchunk_a)
          load_a<C>(a, win, h, c0, s * kTokA, qs_of(s), ks_of(s));
        wf::cp_async_commit();
      }
      for (int it = 0; it < nchunk_a; ++it) {
        wf::cp_async_wait<kStagesA - 2>();
        __syncthreads();
        const int nx = it + kStagesA - 1;
        if (nx < nchunk_a)
          load_a<C>(a, win, h, c0, nx * kTokA, qs_of(nx % kStagesA),
                    ks_of(nx % kStagesA));
        wf::cp_async_commit();
        const __nv_bfloat16* qs = qs_of(it % kStagesA);
        const __nv_bfloat16* ks = ks_of(it % kStagesA);
#pragma unroll
        for (int k0 = 0; k0 < kTokA; k0 += 16) {
          uint32_t af[4];
          wf::ldmatrix_x4_trans(
              af, qs + (k0 + (lane & 7) + ((lane >> 4) << 3)) * kQRow +
                      wr * 16 + ((lane >> 3) & 1) * 8);
#pragma unroll
          for (int j = 0; j < kNT / 2; ++j) {
            uint32_t bf[4];
            const int i = lane >> 3;
            wf::ldmatrix_x4_trans(
                bf, ks + (k0 + (lane & 7) + ((i & 1) << 3)) * (C + 8) +
                        wc * (C / 2) + j * 16 + ((i >> 1) << 3));
            const uint32_t b0[2] = {bf[0], bf[1]}, b1[2] = {bf[2], bf[3]};
            wf::mma_bf16(acc[2 * j], af, b0);
            wf::mma_bf16(acc[2 * j + 1], af, b1);
          }
        }
      }
      wf::cp_async_wait<0>();

      // the block's sum, then its squares about the block's mean
      float s = 0.f;
#pragma unroll
      for (int t = 0; t < kNT; ++t)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          acc[t][e] = acc[t][e] / a.sqrt_c;
          s += acc[t][e];
        }
      const float bsum = block_sum(s, red);
      const float bmean = bsum / cnt;
      float q = 0.f;
#pragma unroll
      for (int t = 0; t < kNT; ++t)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const float d = acc[t][e] - bmean;
          q += d * d;
        }
      const float bm2 = block_sum(q, red);
      if (threadIdx.x == 0) {
        stats[2 * h] = bsum;
        stats[2 * h + 1] = bm2;
      }
      cluster.sync();
      float total = 0.f;
      float part_sum[kCluster], part_m2[kCluster];
#pragma unroll
      for (int j = 0; j < kCluster; ++j) {
        const float* st = cluster.map_shared_rank(stats, j);
        part_sum[j] = st[2 * h];
        part_m2[j] = st[2 * h + 1];
        total += part_sum[j];
      }
      const float mean = total / (cnt * kCluster);
      float m2 = 0.f;
#pragma unroll
      for (int j = 0; j < kCluster; ++j) {
        const float d = part_sum[j] / cnt - mean;
        m2 += part_m2[j] + cnt * d * d;
      }
      const float rstd = rsqrtf(m2 / (cnt * kCluster) + a.eps);

      // row softmax: rows wr*16 + gid (entries 0, 1) and + 8 (2, 3)
#pragma unroll
      for (int t = 0; t < kNT; ++t)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[t][e] = (acc[t][e] - mean) * rstd;
      float mx0 = acc[0][0], mx1 = acc[0][2];
#pragma unroll
      for (int t = 0; t < kNT; ++t) {
        mx0 = fmaxf(mx0, fmaxf(acc[t][0], acc[t][1]));
        mx1 = fmaxf(mx1, fmaxf(acc[t][2], acc[t][3]));
      }
#pragma unroll
      for (int o = 1; o <= 2; o <<= 1) {
        mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, o));
        mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, o));
      }
      const int row0 = wr * 16 + gid, row1 = row0 + 8;
      if (tig == 0) {
        rmax[wc * kRows + row0] = mx0;
        rmax[wc * kRows + row1] = mx1;
      }
      __syncthreads();
      mx0 = fmaxf(rmax[row0], rmax[kRows + row0]);
      mx1 = fmaxf(rmax[row1], rmax[kRows + row1]);
      float sm0 = 0.f, sm1 = 0.f;
#pragma unroll
      for (int t = 0; t < kNT; ++t) {
        acc[t][0] = expf(acc[t][0] - mx0);
        acc[t][1] = expf(acc[t][1] - mx0);
        acc[t][2] = expf(acc[t][2] - mx1);
        acc[t][3] = expf(acc[t][3] - mx1);
        sm0 += acc[t][0] + acc[t][1];
        sm1 += acc[t][2] + acc[t][3];
      }
#pragma unroll
      for (int o = 1; o <= 2; o <<= 1) {
        sm0 += __shfl_xor_sync(0xffffffffu, sm0, o);
        sm1 += __shfl_xor_sync(0xffffffffu, sm1, o);
      }
      if (tig == 0) {
        rsum[wc * kRows + row0] = sm0;
        rsum[wc * kRows + row1] = sm1;
      }
      __syncthreads();
      sm0 = rsum[row0] + rsum[kRows + row0];
      sm1 = rsum[row1] + rsum[kRows + row1];
      __nv_bfloat16* prow = ps + (size_t)h * kRows * (C + 8);
#pragma unroll
      for (int t = 0; t < kNT; ++t) {
        const int col = wc * (C / 2) + t * 8 + 2 * tig;
        *reinterpret_cast<uint32_t*>(prow + row0 * (C + 8) + col) =
            wf::pack2(__float2bfloat16_rn(acc[t][0] / sm0),
                      __float2bfloat16_rn(acc[t][1] / sm0));
        *reinterpret_cast<uint32_t*>(prow + row1 * (C + 8) + col) =
            wf::pack2(__float2bfloat16_rn(acc[t][2] / sm1),
                      __float2bfloat16_rn(acc[t][3] / sm1));
      }
      __syncthreads();   // rmax, rsum and the ring are free for the next head
    }
    // every rank has read every other's statistics; P is in shared memory
    cluster.sync();

    // ---- context: out[:, c0 .. c0 + 63] = (1/H) sum_h V_h P_h^T ----------
    auto vs_of = [&](int s) {
      return reinterpret_cast<__nv_bfloat16*>(stage +
                                              (size_t)s * kTokB * (C + 8) * 2);
    };
    const int pairs = ntile_b * heads;
    float acc2[4][4];
#pragma unroll
    for (int t = 0; t < 4; ++t)
      acc2[t][0] = acc2[t][1] = acc2[t][2] = acc2[t][3] = 0.f;
    load_b<C>(a, win, 0, 0, vs_of(0));
    wf::cp_async_commit();
    for (int p = 0; p < pairs; ++p) {
      const int tile = p / heads, h = p % heads;
      if (p + 1 < pairs)
        load_b<C>(a, win, (p + 1) % heads, ((p + 1) / heads) * kTokB,
                  vs_of((p + 1) % kStagesB));
      wf::cp_async_commit();
      wf::cp_async_wait<1>();
      __syncthreads();
      const __nv_bfloat16* vs = vs_of(p % kStagesB);
      const __nv_bfloat16* prow = ps + (size_t)h * kRows * (C + 8);
#pragma unroll 4
      for (int k0 = 0; k0 < C; k0 += 16) {
        uint32_t af[4];
        wf::ldmatrix_x4(af, vs + (wr * 16 + (lane & 15)) * (C + 8) + k0 +
                                ((lane >> 4) << 3));
#pragma unroll
        for (int jj = 0; jj < 2; ++jj) {
          uint32_t bf[4];
          const int i = lane >> 3;
          wf::ldmatrix_x4(bf, prow + (wc * 32 + jj * 16 + (lane & 7) +
                                      ((i >> 1) << 3)) * (C + 8) +
                                  k0 + ((i & 1) << 3));
          const uint32_t b0[2] = {bf[0], bf[1]}, b1[2] = {bf[2], bf[3]};
          wf::mma_bf16(acc2[2 * jj], af, b0);
          wf::mma_bf16(acc2[2 * jj + 1], af, b1);
        }
      }
      if (h == heads - 1) {
        const float hf = (float)heads;
        const int tok0 = tile * kTokB + wr * 16 + gid, tok1 = tok0 + 8;
        __nv_bfloat16* o = a.out + (long long)b * a.n * C + c0 + wc * 32 +
                           2 * tig;
#pragma unroll
        for (int t = 0; t < 4; ++t) {
          if (tok0 < a.n)
            *reinterpret_cast<uint32_t*>(o + (long long)tok0 * C + t * 8) =
                wf::pack2(__float2bfloat16_rn(acc2[t][0] / hf),
                          __float2bfloat16_rn(acc2[t][1] / hf));
          if (tok1 < a.n)
            *reinterpret_cast<uint32_t*>(o + (long long)tok1 * C + t * 8) =
                wf::pack2(__float2bfloat16_rn(acc2[t][2] / hf),
                          __float2bfloat16_rn(acc2[t][3] / hf));
          acc2[t][0] = acc2[t][1] = acc2[t][2] = acc2[t][3] = 0.f;
        }
      }
      __syncthreads();   // this stage is free for the load two pairs on
    }
    wf::cp_async_wait<0>();
  }
}

template <int C>
int run(const Args& a, int grid_y, size_t smem_bytes, void* stream) {
  const Layout lay = layout(C, a.heads);
  if (a.batch < 1 || a.n < 1 || a.heads < 1 || grid_y < 1 ||
      grid_y > 65535 || grid_y > a.batch || smem_bytes != lay.total ||
      smem_bytes > 232448)
    return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaFuncSetAttribute(
      channel_attention_kernel<C>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem_bytes);
  if (err != cudaSuccess) return (int)err;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(C / kRows, grid_y, 1);
  cfg.blockDim = dim3(wf::kThreads, 1, 1);
  cfg.dynamicSmemBytes = smem_bytes;
  cfg.stream = static_cast<cudaStream_t>(stream);
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = C / kRows;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  err = cudaLaunchKernelEx(&cfg, channel_attention_kernel<C>, a);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" int channel_attention_forward(const void* qkv, void* out,
                                         int batch, int n, int c, int heads,
                                         float sqrt_c, float eps, int grid_y,
                                         size_t smem_bytes, void* stream) {
  Args a{static_cast<const __nv_bfloat16*>(qkv),
         static_cast<__nv_bfloat16*>(out), batch, n, heads, sqrt_c, eps};
  if (c == 64) return run<64>(a, grid_y, smem_bytes, stream);
  if (c == 128) return run<128>(a, grid_y, smem_bytes, stream);
  if (c == 256) return run<256>(a, grid_y, smem_bytes, stream);
  return (int)cudaErrorInvalidValue;
}

WF_EXPORT_ERROR_STRING
