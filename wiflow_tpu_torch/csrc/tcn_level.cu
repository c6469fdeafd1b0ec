// One eval TCN level with BatchNorm folded in, for sm_90a.
//
// Replaces wiflow_tpu/ops/pallas/tcn_level.py:fused_tcn_eval (kernel body
// _make_level_kernel).  Per level:
//   h1 = silu(causal grouped conv(x)  + b1)      3 taps, dilation d, G groups
//   h2 = silu(h1 @ P1 + c1)                      pointwise
//   h3 = silu(causal grouped conv(h2) + b2)
//   y  = silu(h3 @ P2 + c2)
//   out = silu(y + (x @ D + e  if C_in != C_out else x))
// h1..h3 are rounded to the storage type, as the Pallas kernel does; y is
// not.
//
// What bounds it on the H100: the two pointwise products and the shortcut
// are ~89% of the FLOPs (85 MFLOP per window over the four levels); at
// batch 4096 the work is ~0.35 ms at the bf16 tensor-core peak against
// ~0.17 ms of device-memory traffic, so by the roofline it is bound by
// operations.  With the products on wgmma, what bounds it now (bf16,
// per-phase clock64 stamps, batch 4096, the four levels): the grouped convs
// (~36% of the time: mma.sync on windows of 8-channel chunks, 12 warps for
// 20 groups), the products (~33%, of it ~28% waiting for the ring: every
// block streams the weights from L2 once per tile of rows, 5.3 GB a
// forward, and level 0's 4 slots do not hide a copy's latency), the
// epilogues (~18%) and the loads of x (~10%).
//
// The launch plan (rows a tile, layouts, ring, weight offsets, grid) is
// ops/kernels/tcn_level.py::tcn_plan; the C side refuses a plan that does
// not add up.  One launch a level, one persistent block an SM, walking
// tiles of whole samples, so the causal dilated taps never leave the block.
// No atomics: a launch repeats bit for bit.
//
// bf16 (the served type): the pointwise products on wgmma.
//   Roles.  16 warps: three consumer warpgroups (warps 0-11) and a
//     producer warpgroup (warps 12-15), whose first thread owns the weight
//     stream: it bulk-copies (the TMA's 1-D form) each 16-deep k-step of
//     P1, P2 and D, all N columns, into a ring of 2-8 slots (as many as the
//     shared memory left holds) and refills a slot as soon as the 12
//     consumer warps have released it; nothing that computes waits to issue
//     a copy.  Registers go to a block in units of 4 warps, so 13 warps
//     would cost as much as 16: the block has 128 registers a thread, and
//     setmaxnreg takes the producers to 32 and gives the consumers 160.
//   Tiles.  64 rows, one wgmma M (3 samples of T = 20, 6 of T = 10).
//     C_out, padded to 24 NT columns, is split across the three warpgroups:
//     warpgroup w computes columns [8 NT w, 8 NT (w + 1)) of all 64 rows as
//     one m64n(8 NT)k16 wgmma a k-step (NT = 24 at 540 columns), A (the
//     activations) and B (the k-step's slot) both read from shared memory,
//     the fp32 accumulators (4 NT a thread) in registers.  NT is a template
//     parameter of the kernel, a multiple of 4 (6 instantiations): a width
//     chosen at run time inside one kernel made ptxas spill.
//   Layouts.  Activations live in two buffers, channel-last, K-major with
//     the 128-byte swizzle: 64 channels x 64 rows an 8 KB atom, chunk c of
//     row r at chunk c ^ (r % 8), so the wgmma reads them directly, and the
//     epilogues' pairs, the loads of x and the grouped convs' ldmatrix
//     rows meet no bank conflict.  The buffers take turns: x -> h1 -> h2
//     -> h3, x again for the shortcut.  The weights' k-steps are packed by
//     the packer in wgmma's no-swizzle B order (8 columns x 8 k-values a
//     128-byte core matrix; LBO 128 bytes along K, SBO 256 along N).
//   Epilogues in registers.  Bias (staged once a block in shared memory),
//     SiLU and the bf16 rounding run on the accumulators; h2 goes to its
//     buffer as whole 4-byte pairs at addresses each thread works out from
//     its row and column.  y + e stays in the registers and the shortcut
//     x @ D accumulates on top; out = silu(.) leaves from the registers in
//     pairs (or x is added from shared memory for the identity residual).
//   Grouped convs on mma.sync (12 warps, a group of 64 rows each): each
//     group reads the 8-channel chunks of the dense layout that its
//     channels touch (up to ceil((cg + 7) / 8) a tap), the packed weights
//     zero on the neighbours' channels, at rows shifted by (2 - j) d or the
//     zero row where t < shift.  Their weights (up to 123 KB a conv) are
//     read as packed B fragments from device memory, one k-step at a time
//     for all 4 m-tiles of the group.  Out of line (one copy for all
//     instantiations), as are the loads of x.
//   Not carried over: the ring is filled from L2 by every block on its
//     own; a cluster that multicasts one copy to several SMs would cut the
//     5.3 GB of L2 reads a forward and let level 0's ring run ahead, and is
//     a separate change.
// fp32, the check type, runs on CUDA cores (16 warps, 32 rows a tile, its
//   weights read from device memory) in two layouts: dense (channel c at
//   column c) for the products, group-padded (group g's channels from
//   column g * cgp, cgp the group width rounded up to 8) for the grouped
//   convs; unchanged, it repeats the earlier kernel's bits.
// The TPU kernel's block-diagonal packing of the grouped taps is not
// carried over.
#include <type_traits>

#include "common.cuh"
#include "mma.cuh"
#include "wgmma.cuh"

namespace {

using bf16 = __nv_bfloat16;
constexpr int kSmemLimit = 232448;

struct LevelArgs {
  const void* x;       // [batch * steps, cin]
  void* out;           // [batch * steps, cout]
  const void* w;       // packed: G1, G2, P1, P2, D
  const float* g1b;    // [cin]
  const float* p1b;    // [cout]
  const float* g2b;    // [cout]
  const float* p2b;    // [cout]
  const float* db;     // [cout] or null: identity residual
  int batch, steps, cin, cout, groups, dil;
  int samples;                        // samples a tile
  int ks_g1, ks_g2, ks_p1, ks_p2, ks_d;
  int off_g1, off_g2, off_p1, off_p2, off_d;   // elements of w
  int smem;
  // fp32
  int cgp_in, cgp_out;                // padded group widths
  int ldg_in, ldd_in, ldg_out, ldd_out;
  int buf0, buf1;                     // elements a row of each buffer
  int ntiles;                         // n-tiles of the pointwise products
  // bf16
  int nch_in, nch_out;                // chunks of a group's window
  int kbuf;                           // channels a row of each buffer
  int nt;                             // n-tiles of a warpgroup's wgmma
  int stages;                         // slots of the weight ring
  int vec_x;                          // elements a load of x: 4, 2 or 1
};

__host__ __device__ constexpr int align16(int v) { return (v + 15) / 16 * 16; }
__host__ __device__ constexpr int align4(int v) { return (v + 3) / 4 * 4; }
__host__ __device__ constexpr int align64(int v) { return (v + 63) / 64 * 64; }
__host__ __device__ constexpr int ceil_div(int a, int b) {
  return (a + b - 1) / b;
}

// ===========================================================================
// fp32: CUDA cores
// ===========================================================================
constexpr int kThreads = 512;
constexpr int kWarps = kThreads / 32;
constexpr int kWarpRows = 2;          // warps along M
constexpr int kWarpCols = kWarps / kWarpRows;
constexpr int kMaxNTW = 9;            // n-tiles of a warp in a product
constexpr int kMaxNTG = 4;            // n-tiles of a group (32 channels)
constexpr int kZeroBytes = 32;        // one 8-channel chunk of zeros
constexpr int kRows = 32;             // rows of a tile

struct Layout {
  int buf0, buf1, zero, tab, total;
};

__host__ __device__ inline Layout layout(const LevelArgs& a) {
  Layout l;
  l.buf0 = 0;
  l.buf1 = l.buf0 + align16(kRows * a.buf0 * 4);
  l.zero = l.buf1 + align16(kRows * a.buf1 * 4);
  l.tab = l.zero + kZeroBytes;
  l.total = l.tab + align16(2 * (a.cin + a.cout));
  return l;
}

// pointwise products: acc[i] += A[rows of the warp, K] x W[K, n-tile wn +
// 8 i]; thread slot q of an accumulator is row gid + 8 (q / 2), column 2
// tig + q % 2.  The weights [K_pad, ntiles * 8] from device memory.
using Acc = float[1][kMaxNTW][4];

__device__ __forceinline__ void pw_product(Acc& acc, const float* a, int lda,
                                           int ksteps, int ntiles,
                                           const void* wsrc) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int wm = warp / kWarpCols, wn = warp % kWarpCols;
  const int gid = lane >> 2, tig = lane & 3;
  const int n8 = ntiles * 8;
  const float* a0 = a + (wm * 16 + gid) * lda;
  const float* a1 = a0 + 8 * lda;
  const float* w = static_cast<const float*>(wsrc) + 8 * wn + 2 * tig;
  for (int k = 0; k < ksteps * 16; ++k) {
    const float x0 = a0[k], x1 = a1[k];
    const float* wk = w + (size_t)k * n8;
#pragma unroll
    for (int i = 0; i < kMaxNTW; ++i) {
      if (wn + kWarpCols * i >= ntiles) break;
      const float2 wv =
          __ldg(reinterpret_cast<const float2*>(wk + 8 * kWarpCols * i));
      acc[0][i][0] += x0 * wv.x;
      acc[0][i][1] += x0 * wv.y;
      acc[0][i][2] += x1 * wv.x;
      acc[0][i][3] += x1 * wv.y;
    }
  }
}

__device__ __forceinline__ void zero_acc(Acc& acc) {
#pragma unroll
  for (int i = 0; i < kMaxNTW; ++i)
#pragma unroll
    for (int q = 0; q < 4; ++q) acc[0][i][q] = 0.f;
}

// Calls f(row, col, acc slot) for every slot of the warp's tile inside
// [0, rows) x [0, n).
template <typename F>
__device__ __forceinline__ void for_each_slot(Acc& acc, int ntiles, int n,
                                              F&& f) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int wm = warp / kWarpCols, wn = warp % kWarpCols;
  const int gid = lane >> 2, tig = lane & 3;
#pragma unroll
  for (int i = 0; i < kMaxNTW; ++i) {
    const int j = wn + kWarpCols * i;
    if (j >= ntiles) break;
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      const int row = wm * 16 + gid + 8 * (q >> 1);
      const int col = j * 8 + 2 * tig + (q & 1);
      if (col < n) f(row, col, acc[0][i][q]);
    }
  }
}

// grouped causal convs: dst (dense) = silu(b + sum_j x[t - (2-j) d] @ W_j)
// per group, src group-padded
struct Grouped {
  int ch, groups, cgp, lds, ldd, ksteps, dil;
  wf::FastDiv by_steps;   // row -> time step
};

// The shared-memory row of chunk q (tap j = q / cc8, 8 channels c8 = q %
// cc8 of group g) for tile row m at time t, or the zero row.
__device__ __forceinline__ const float* group_row(const float* src,
                                                  const float* zero,
                                                  const Grouped& c, int g,
                                                  int q, int m, int t) {
  const int cc8 = c.cgp / 8;
  const int j = q / cc8;
  if (j >= 3) return zero;
  const int shift = (2 - j) * c.dil;
  if (t < shift) return zero;
  return src + (m - shift) * c.lds + g * c.cgp + 8 * (q - j * cc8);
}

// the group's weights [K_pad, ntg * 8] from device memory
__device__ __forceinline__ void group_product(float (&acc)[kMaxNTG][4],
                                              const float* src,
                                              const float* zero,
                                              const Grouped& c, int g, int m0,
                                              int ntg, const void* wsrc) {
  const int lane = threadIdx.x & 31, gid = lane >> 2, tig = lane & 3;
  const int n8 = ntg * 8;
  const float* wg = static_cast<const float*>(wsrc) +
                    (size_t)g * c.ksteps * 16 * n8 + 2 * tig;
  int m[2], t[2];
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    m[h] = m0 + gid + 8 * h;
    t[h] = c.by_steps.mod(m[h]);
  }
  for (int q = 0; q < 2 * c.ksteps; ++q) {
    const float* r0 = group_row(src, zero, c, g, q, m[0], t[0]);
    const float* r1 = group_row(src, zero, c, g, q, m[1], t[1]);
#pragma unroll
    for (int e = 0; e < 8; ++e) {
      const float x0 = r0[e], x1 = r1[e];
      const float* wk = wg + (size_t)(q * 8 + e) * n8;
#pragma unroll
      for (int nt = 0; nt < kMaxNTG; ++nt) {
        if (nt >= ntg) break;
        const float2 wv = __ldg(reinterpret_cast<const float2*>(wk + nt * 8));
        acc[nt][0] += x0 * wv.x;
        acc[nt][1] += x0 * wv.y;
        acc[nt][2] += x1 * wv.x;
        acc[nt][3] += x1 * wv.y;
      }
    }
  }
}

// A warp takes a group and one of the two row halves of the tile.
__device__ void grouped_conv(const float* src, float* dst, const float* zero,
                             const Grouped& c, const void* wsrc,
                             const float* __restrict__ bias) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int gid = lane >> 2, tig = lane & 3;
  const int cg = c.ch / c.groups, ntg = (cg + 7) / 8;
  for (int u = warp; u < c.groups * kWarpRows; u += kWarps) {
    const int g = u / kWarpRows, m0 = (u - g * kWarpRows) * 16;
    float acc[kMaxNTG][4];
#pragma unroll
    for (int nt = 0; nt < kMaxNTG; ++nt)
#pragma unroll
      for (int q = 0; q < 4; ++q) acc[nt][q] = 0.f;
    group_product(acc, src, zero, c, g, m0, ntg, wsrc);
#pragma unroll
    for (int nt = 0; nt < kMaxNTG; ++nt) {
      if (nt >= ntg) break;
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        const int o = nt * 8 + 2 * tig + (q & 1);
        if (o >= cg) continue;
        const int row = m0 + gid + 8 * (q >> 1);
        const int col = g * cg + o;
        dst[row * c.ldd + col] = wf::silu(acc[nt][q] + bias[col]);
      }
    }
  }
}

__device__ __forceinline__ void level_fma(const LevelArgs& a) {
  extern __shared__ __align__(16) unsigned char smem[];
  const Layout l = layout(a);
  float* buf0 = reinterpret_cast<float*>(smem + l.buf0);
  float* buf1 = reinterpret_cast<float*>(smem + l.buf1);
  const float* zero = reinterpret_cast<const float*>(smem + l.zero);
  // the group-padded column of each channel, in and out
  short* gpos_in = reinterpret_cast<short*>(smem + l.tab);
  short* gpos_out = gpos_in + a.cin;
  const float* x = static_cast<const float*>(a.x);
  float* out = static_cast<float*>(a.out);
  const float* w = static_cast<const float*>(a.w);
  const int tid = threadIdx.x;
  const int cg_in = a.cin / a.groups, cg_out = a.cout / a.groups;
  const int tile_rows = a.samples * a.steps;
  const int ntm = (a.batch + a.samples - 1) / a.samples;

  // every row of both buffers starts finite (zero): padding columns and
  // rows are multiplied by zero weights or never stored
  for (int e = tid; e < l.total / 16; e += kThreads)
    reinterpret_cast<uint4*>(smem)[e] = make_uint4(0, 0, 0, 0);
  __syncthreads();
  for (int c = tid; c < a.cin; c += kThreads)
    gpos_in[c] = (short)(c / cg_in * a.cgp_in + c % cg_in);
  for (int c = tid; c < a.cout; c += kThreads)
    gpos_out[c] = (short)(c / cg_out * a.cgp_out + c % cg_out);

  const Grouped gc1{a.cin, a.groups, a.cgp_in, a.ldg_in, a.ldd_in, a.ks_g1,
                    a.dil, wf::FastDiv(a.steps)};
  const Grouped gc2{a.cout, a.groups, a.cgp_out, a.ldg_out, a.ldd_out,
                    a.ks_g2, a.dil, wf::FastDiv(a.steps)};
  const int warp = tid >> 5, lane = tid & 31;
  const wf::FastDiv by_cout(a.cout);
  for (int tile = blockIdx.x; tile < ntm; tile += gridDim.x) {
    const size_t row0 = (size_t)tile * tile_rows;
    const int valid =
        min(tile_rows, (int)((size_t)a.batch * a.steps - row0));
    __syncthreads();   // buf0 is free: the last tile's residual is read
    // x, group-padded, into buf0: a warp a row, lanes along the channels
    for (int m = warp; m < valid; m += kWarps) {
      const float* xr = x + (row0 + m) * a.cin;
      for (int c = lane; c < a.cin; c += 32)
        buf0[m * a.ldg_in + gpos_in[c]] = xr[c];
    }
    __syncthreads();
    grouped_conv(buf0, buf1, zero, gc1, w + a.off_g1, a.g1b);   // h1
    __syncthreads();
    Acc acc;
    zero_acc(acc);
    pw_product(acc, buf1, a.ldd_in, a.ks_p1, a.ntiles, w + a.off_p1);
    for_each_slot(acc, a.ntiles, a.cout, [&](int row, int col, float v) {
      buf0[row * a.ldg_out + gpos_out[col]] =   // h2, group-padded
          wf::silu(v + a.p1b[col]);
    });
    __syncthreads();
    grouped_conv(buf0, buf1, zero, gc2, w + a.off_g2, a.g2b);   // h3
    __syncthreads();
    // x again, dense, for the residual
    for (int m = warp; m < valid; m += kWarps) {
      const float* xr = x + (row0 + m) * a.cin;
      for (int c = lane; c < a.cin; c += 32) buf0[m * a.ldd_in + c] = xr[c];
    }
    __syncthreads();
    zero_acc(acc);
    pw_product(acc, buf1, a.ldd_out, a.ks_p2, a.ntiles, w + a.off_p2);
    if (a.db != nullptr) {
      // y + e, then the shortcut accumulates on top
      for_each_slot(acc, a.ntiles, a.cout, [&](int, int col, float& v) {
        v = wf::silu(v + a.p2b[col]) + a.db[col];
      });
      pw_product(acc, buf0, a.ldd_in, a.ks_d, a.ntiles, w + a.off_d);
    } else {
      for_each_slot(acc, a.ntiles, a.cout, [&](int row, int col, float& v) {
        v = wf::silu(v + a.p2b[col]) + buf0[row * a.ldd_in + col];
      });
    }
    // out = silu(acc), staged through buf1 (every warp is done with h3)
    // so that the tile's rows, contiguous in device memory, leave in
    // coalesced stores
    __syncthreads();
    for_each_slot(acc, a.ntiles, a.cout, [&](int row, int col, float v) {
      buf1[row * a.ldd_out + col] = wf::silu(v);
    });
    __syncthreads();
    float* dst = out + row0 * a.cout;
    for (int e = tid; e < valid * a.cout; e += kThreads) {
      const int r = by_cout.div(e);
      dst[e] = buf1[r * a.ldd_out + e - r * a.cout];
    }
  }
}

// ===========================================================================
// bf16: wgmma, a producer warp, three consumer warpgroups
// ===========================================================================
constexpr int kWGs = 3;                       // consumer warpgroups
constexpr int kConsumers = 128 * kWGs;        // their threads
constexpr int kConsumerWarps = kConsumers / 32;
constexpr int kThreadsW = kConsumers + 128;   // and the producer warpgroup
constexpr int kRowsW = 64;                    // a tile: one wgmma M
constexpr int kMaxNT = 24;                    // n-tiles of a warpgroup
constexpr int kNTStep = 4;                    // instantiated: 4, 8, .., 24
constexpr int kMaxKSG = 8;                    // k-steps of a group's window
constexpr int kMaxStages = 8;
constexpr int kAtomBytes = kRowsW * 128;      // 64 channels of 64 rows
constexpr int kConsumerRegs = 160, kProducerRegs = 32;
constexpr int kAlign = 1024;                  // the swizzle atoms' alignment

struct LayoutW {
  int buf_a, buf_b, ring, bias, zero, bars, total;
};

// Offsets from the block's shared memory rounded up to 1024 bytes; total
// counts that rounding's slack.
__host__ __device__ inline LayoutW layout_w(const LevelArgs& a) {
  const int npad = 3 * 8 * a.nt;
  LayoutW l;
  l.buf_a = 0;
  l.buf_b = l.buf_a + a.kbuf * 128;
  l.ring = l.buf_b + a.kbuf * 128;
  l.bias = l.ring + a.stages * npad * 32;
  l.zero = l.bias + align16(4 * (align4(a.cin) + align4(a.cout) +
                                 (a.db != nullptr ? 3 : 2) * npad));
  l.bars = l.zero + 16;
  l.total = l.bars + 16 * a.stages + kAlign;
  return l;
}

// element offset of (row, col) in a swizzled activation buffer; rb, the
// swizzle's row bits, is row % 8
__device__ __forceinline__ int swz(int row, int col, int rb) {
  return (col >> 6) * (kRowsW * 64) + row * 64 +
         ((((col >> 3) & 7) ^ rb) << 3) + (col & 7);
}

__device__ __forceinline__ int swz(int row, int col) {
  return swz(row, col, row & 7);
}

__device__ __forceinline__ void bar_consumers() {
  asm volatile("bar.sync 1, %0;" ::"n"(kConsumers) : "memory");
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}

// columns col, col + 1 of a row of a swizzled buffer (rb = row % 8); only
// col if !both
__device__ __forceinline__ void store_pair(bf16* buf, int row, int rb,
                                           int col, float v0, float v1,
                                           bool both) {
  bf16* p = buf + swz(row, col, rb);
  if (both)
    *reinterpret_cast<uint32_t*>(p) = pack_bf16(v0, v1);
  else
    *p = __float2bfloat16_rn(v0);
}

// The consumers' side of the weight ring.
struct RingC {
  uint32_t base;              // shared address of slot 0
  int bytes, stages;
  uint64_t* full;             // [stages]: the slot's copy has landed
  uint64_t* empty;            // [stages]: the 12 consumer warps are done
  int slot, phase;

  __device__ uint32_t acquire() {
    wf::mbar_wait(full + slot, phase);
    return base + slot * bytes;
  }
  __device__ void release(int s) {
    __syncwarp();
    if ((threadIdx.x & 31) == 0) wf::mbar_arrive(empty + s);
  }
  __device__ void advance() {
    if (++slot == stages) {
      slot = 0;
      phase ^= 1;
    }
  }
};

// acc (this warpgroup's 64 x 8 NT columns) += A[64, 16 ks] x B, A a
// swizzled buffer at shared address a_addr, B the ring's next ks k-steps.
template <int NT>
__device__ __forceinline__ void product(float (&acc)[4 * NT],
                                        uint32_t a_addr, int ksteps,
                                        RingC& ring, int wg) {
  wf::fence_acc(acc);
  wf::wgmma_fence();
  int prev = -1;
  for (int s = 0; s < ksteps; ++s) {
    const uint32_t slot = ring.acquire();
    const uint64_t da = wf::gmma_desc(
        a_addr + (s >> 2) * kAtomBytes + (s & 3) * 32, 16, 1024, 1);
    const uint64_t db = wf::gmma_desc(slot + wg * NT * 256, 128, 256, 0);
    wf::wgmma_bf16<NT>(acc, da, db);
    wf::wgmma_commit();
    if (prev >= 0) {
      wf::wgmma_wait<1>();
      ring.release(prev);
    }
    prev = ring.slot;
    ring.advance();
  }
  wf::wgmma_wait<0>();
  wf::fence_acc(acc);
  if (prev >= 0) ring.release(prev);
}

// A grouped conv over the dense swizzled layout: group g reads the nch
// 8-channel chunks from chunk (g cg) / 8 on, for each of the 3 taps.
struct Window {
  int cg, groups, nch, nchunks, ksteps, dil;
  wf::FastDiv by_steps;   // row -> time step
};

// K chunk q of group g (tap j, window chunk k) for the lane's rows: the
// element offset of its chunk in a swizzled buffer less the rows' own
// part, and the causal shift; or none (the zero row for every row).  The
// swizzle's row bits, (row - shift) % 8, are the same for the rows of
// every m-tile of a lane.
struct Tap {
  int base, shift;
  bool none;
};

__device__ __forceinline__ Tap window_tap(const Window& c, int g, int q,
                                          int lane) {
  Tap tp{0, 0, true};
  int j = 0, k = q;
  while (k >= c.nch) {
    k -= c.nch;
    if (++j == 3) return tp;
  }
  const int chunk = ((g * c.cg) >> 3) + k;
  if (chunk >= c.nchunks) return tp;
  tp.shift = (2 - j) * c.dil;
  tp.base = (chunk >> 3) * (kRowsW * 64) +
            (((chunk & 7) ^ ((lane - tp.shift) & 7)) << 3);
  tp.none = false;
  return tp;
}

// A warp takes a group, all 64 rows of the tile: dst = silu(b + the
// group's taps), its weights [ks][ntg][lane] B fragments from device
// memory, a k-step's at a time (loading more of them at once spilled
// registers and measured slower on the H100), each feeding all 4 m-tiles.
__device__ __noinline__ void grouped_conv_w(const bf16* src, bf16* dst,
                                            const bf16* zero, const Window c,
                                            const uint2* w,
                                            const float* bias) {
  constexpr int MT = kRowsW / 16;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int gid = lane >> 2, tig = lane & 3;
  const int ntg = (c.cg + 7) >> 3;
  for (int g = warp; g < c.groups; g += kConsumerWarps) {
    const uint2* wg = w + (size_t)g * c.ksteps * ntg * 32 + lane;
    float acc[MT][kMaxNTG][4];
#pragma unroll
    for (int mt = 0; mt < MT; ++mt)
#pragma unroll
      for (int nt = 0; nt < kMaxNTG; ++nt)
#pragma unroll
        for (int q = 0; q < 4; ++q) acc[mt][nt][q] = 0.f;
    int m[MT], t[MT];
#pragma unroll
    for (int mt = 0; mt < MT; ++mt) {
      m[mt] = mt * 16 + (lane & 15);
      t[mt] = c.by_steps.mod(m[mt]);
    }
#pragma unroll
    for (int ks = 0; ks < kMaxKSG; ++ks) {
      if (ks >= c.ksteps) break;
      uint2 bw[kMaxNTG];
#pragma unroll
      for (int nt = 0; nt < kMaxNTG; ++nt)
        if (nt < ntg) bw[nt] = __ldg(wg + (ks * ntg + nt) * 32);
      const Tap tp = window_tap(c, g, 2 * ks + (lane >> 4), lane);
      uint32_t af[MT][4];
#pragma unroll
      for (int mt = 0; mt < MT; ++mt)
        wf::ldmatrix_x4(af[mt], tp.none || t[mt] < tp.shift
                                    ? zero
                                    : src + tp.base + (m[mt] - tp.shift) * 64);
#pragma unroll
      for (int nt = 0; nt < kMaxNTG; ++nt) {
        if (nt >= ntg) break;
        const uint32_t bfr[2] = {bw[nt].x, bw[nt].y};
#pragma unroll
        for (int mt = 0; mt < MT; ++mt) wf::mma_bf16(acc[mt][nt], af[mt], bfr);
      }
    }
    // columns o, o + 1 of the group: a 4-byte pair where both are the
    // group's and the pair is aligned (the group starts on an even
    // channel); the row's part of the address, (mt 16 + gid + 8 h) * 64,
    // keeps the swizzle's row bits at gid
    const bool even = ((g * c.cg) & 1) == 0;
#pragma unroll
    for (int nt = 0; nt < kMaxNTG; ++nt) {
      if (nt >= ntg) break;
      const int o = nt * 8 + 2 * tig;
      if (o >= c.cg) continue;
      const int col = g * c.cg + o;
      const bool two = o + 1 < c.cg;
      const float b0 = bias[col], b1 = two ? bias[col + 1] : 0.f;
      const int at = (col >> 6) * (kRowsW * 64) +
                     ((((col >> 3) & 7) ^ gid) << 3) + (col & 7);
      const int at1 = ((col + 1) >> 6) * (kRowsW * 64) +
                      ((((col + 1) >> 3) & 7) ^ gid) * 8 + ((col + 1) & 7);
#pragma unroll
      for (int mt = 0; mt < MT; ++mt)
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int row = (mt * 16 + gid + 8 * h) * 64;
          const float v0 = wf::silu(acc[mt][nt][2 * h] + b0);
          const float v1 = wf::silu(acc[mt][nt][2 * h + 1] + b1);
          if (even && two) {
            *reinterpret_cast<uint32_t*>(dst + row + at) = pack_bf16(v0, v1);
          } else {
            dst[row + at] = __float2bfloat16_rn(v0);
            if (two) dst[row + at1] = __float2bfloat16_rn(v1);
          }
        }
    }
  }
}

// The tile's rows of x (n elements, contiguous in device memory) into a
// swizzled buffer, V elements a load, 8 loads in flight a thread.
template <int V>
__device__ __forceinline__ void load_rows(const bf16* src, int n,
                                          const wf::FastDiv& by_c, bf16* buf) {
  using Vec = typename std::conditional<
      V == 4, uint2,
      typename std::conditional<V == 2, unsigned int,
                                unsigned short>::type>::type;
  constexpr int U = 8;
  const Vec* s = reinterpret_cast<const Vec*>(src);
  const int nv = n / V;
  for (int p0 = threadIdx.x; p0 < nv; p0 += kConsumers * U) {
    Vec v[U];
#pragma unroll
    for (int u = 0; u < U; ++u) {
      const int p = p0 + u * kConsumers;
      if (p < nv) v[u] = __ldg(s + p);
    }
#pragma unroll
    for (int u = 0; u < U; ++u) {
      const int p = p0 + u * kConsumers;
      if (p < nv) {
        const int e = p * V, r = by_c.div(e);
        *reinterpret_cast<Vec*>(buf + swz(r, e - r * by_c.d)) = v[u];
      }
    }
  }
}

__device__ __noinline__ void load_x(int vec, const bf16* src, int n,
                                    const wf::FastDiv by_c, bf16* buf) {
  if (vec == 4)
    load_rows<4>(src, n, by_c, buf);
  else if (vec == 2)
    load_rows<2>(src, n, by_c, buf);
  else
    load_rows<1>(src, n, by_c, buf);
}

// Producer: the block's stream of k-steps (P1, P2, D of every tile) into
// the ring, each slot refilled once the consumer warps release it.
__device__ void produce(const LevelArgs& a, const unsigned char* src,
                        unsigned char* ring, uint64_t* full, uint64_t* empty,
                        int total) {
  const int bytes = 3 * 8 * a.nt * 32;
  const int per_tile = a.ks_p1 + a.ks_p2 + a.ks_d;
  int slot = 0, phase = 0, k = 0;
  for (int i = 0; i < total; ++i) {
    if (i >= a.stages) wf::mbar_wait(empty + slot, phase ^ 1);
    wf::bulk_copy_g2s(ring + slot * bytes, src + (size_t)k * bytes, bytes,
                      full + slot);
    if (++k == per_tile) k = 0;
    if (++slot == a.stages) {
      slot = 0;
      phase ^= 1;
    }
  }
  // leave once the consumers are done with every slot still filled
  for (int i = max(total - a.stages, 0); i < total; ++i)
    wf::mbar_wait(empty + i % a.stages, (i / a.stages) & 1);
}

// The consumer warpgroups' walk over the block's tiles, NT n-tiles a
// warpgroup.
template <int NT>
__device__ __forceinline__ void consume(const LevelArgs& a,
                                        unsigned char* smem,
                                        const LayoutW& l) {
  bf16* buf_a = reinterpret_cast<bf16*>(smem + l.buf_a);
  bf16* buf_b = reinterpret_cast<bf16*>(smem + l.buf_b);
  const int npad = 3 * 8 * NT;
  const float* g1b = reinterpret_cast<const float*>(smem + l.bias);
  const float* p1b = g1b + align4(a.cin);
  const float* g2b = p1b + npad;
  const float* p2b = g2b + align4(a.cout);
  const float* db = p2b + npad;
  const bf16* zero = reinterpret_cast<const bf16*>(smem + l.zero);
  uint64_t* full = reinterpret_cast<uint64_t*>(smem + l.bars);
  uint64_t* empty = full + a.stages;
  const int tid = threadIdx.x;
  const int tile_rows = a.samples * a.steps;
  const int ntm = (a.batch + a.samples - 1) / a.samples;
  const bf16* w = static_cast<const bf16*>(a.w);
  const bf16* x = static_cast<const bf16*>(a.x);
  bf16* out = static_cast<bf16*>(a.out);
  RingC ring{wf::smem_addr(smem + l.ring), npad * 32, a.stages, full, empty,
             0, 0};
  const Window w1{a.cin / a.groups, a.groups, a.nch_in, ceil_div(a.cin, 8),
                  a.ks_g1, a.dil, wf::FastDiv(a.steps)};
  const Window w2{a.cout / a.groups, a.groups, a.nch_out,
                  ceil_div(a.cout, 8), a.ks_g2, a.dil, wf::FastDiv(a.steps)};
  const uint2* wg1 = reinterpret_cast<const uint2*>(w + a.off_g1);
  const uint2* wg2 = reinterpret_cast<const uint2*>(w + a.off_g2);
  const wf::FastDiv by_cin(a.cin);
  const uint32_t addr_a = wf::smem_addr(buf_a), addr_b = wf::smem_addr(buf_b);
  // this thread's accumulator slots: rows r0, r0 + 8 (both gid modulo 8);
  // columns c0 + 8 j, c0 + 8 j + 1
  const int wg = tid >> 7, lane = tid & 31, gid = lane >> 2;
  const int r0_ = ((tid >> 5) & 3) * 16 + (lane >> 2);
  const int c0_ = wg * NT * 8 + 2 * (lane & 3);
  const bool pairs = (a.cout & 1) == 0;
  float acc[4 * NT];

  for (int tile = blockIdx.x; tile < ntm; tile += gridDim.x) {
    const size_t row0 = (size_t)tile * tile_rows;
    const int valid =
        min(tile_rows, (int)((size_t)a.batch * a.steps - row0));
    const bf16* xt = x + row0 * a.cin;
    // the epilogues' columns and rows, opaque to the compiler a tile, so
    // that it does not keep their addresses live across the tile
    int c0 = c0_, r0 = r0_;
    asm volatile("" : "+r"(c0), "+r"(r0));
    bar_consumers();   // buf_a is free: every warpgroup's last product is done
    load_x(a.vec_x, xt, valid * a.cin, by_cin, buf_a);
    bar_consumers();
    grouped_conv_w(buf_a, buf_b, zero, w1, wg1, g1b);   // h1
    wf::fence_proxy_async();
    bar_consumers();
#pragma unroll
    for (int i = 0; i < 4 * NT; ++i) acc[i] = 0.f;
    product<NT>(acc, addr_b, a.ks_p1, ring, wg);
    // h2 = silu(h1 @ P1 + c1) into buf_a (x was read by the grouped conv)
#pragma unroll
    for (int j = 0; j < NT; ++j) {
      const int col = c0 + 8 * j;
      if (col >= a.cout) break;
      const float2 b = *reinterpret_cast<const float2*>(p1b + col);
      const bool both = pairs || col + 1 < a.cout;
      store_pair(buf_a, r0, gid, col, wf::silu(acc[4 * j] + b.x),
                 wf::silu(acc[4 * j + 1] + b.y), both);
      store_pair(buf_a, r0 + 8, gid, col, wf::silu(acc[4 * j + 2] + b.x),
                 wf::silu(acc[4 * j + 3] + b.y), both);
    }
    bar_consumers();   // h2 whole, and every warpgroup done with h1
    grouped_conv_w(buf_a, buf_b, zero, w2, wg2, g2b);   // h3
    bar_consumers();   // every warp done with h2
    load_x(a.vec_x, xt, valid * a.cin, by_cin, buf_a);   // x again
    wf::fence_proxy_async();
    bar_consumers();
#pragma unroll
    for (int i = 0; i < 4 * NT; ++i) acc[i] = 0.f;
    product<NT>(acc, addr_b, a.ks_p2, ring, wg);
    if (a.db != nullptr) {
      // y + e, then the shortcut accumulates on top
#pragma unroll
      for (int j = 0; j < NT; ++j) {
        const float2 b = *reinterpret_cast<const float2*>(p2b + c0 + 8 * j);
        const float2 e = *reinterpret_cast<const float2*>(db + c0 + 8 * j);
        acc[4 * j] = wf::silu(acc[4 * j] + b.x) + e.x;
        acc[4 * j + 1] = wf::silu(acc[4 * j + 1] + b.y) + e.y;
        acc[4 * j + 2] = wf::silu(acc[4 * j + 2] + b.x) + e.x;
        acc[4 * j + 3] = wf::silu(acc[4 * j + 3] + b.y) + e.y;
      }
      product<NT>(acc, addr_a, a.ks_d, ring, wg);
    } else {
      // y + x, x from buf_a
#pragma unroll
      for (int j = 0; j < NT; ++j) {
        const int col = c0 + 8 * j;
        if (col >= a.cout) break;
        const float2 b = *reinterpret_cast<const float2*>(p2b + col);
        const bool both = pairs || col + 1 < a.cout;
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const bf16* xp = buf_a + swz(r0 + 8 * h, col, gid);
          const float x0 = __bfloat162float(xp[0]);
          const float x1 = both ? __bfloat162float(xp[1]) : 0.f;
          acc[4 * j + 2 * h] = wf::silu(acc[4 * j + 2 * h] + b.x) + x0;
          acc[4 * j + 2 * h + 1] = wf::silu(acc[4 * j + 2 * h + 1] + b.y) + x1;
        }
      }
    }
    // out = silu(acc), from the registers in pairs
    bf16* ot = out + row0 * a.cout;
#pragma unroll
    for (int j = 0; j < NT; ++j) {
      const int col = c0 + 8 * j;
      if (col >= a.cout) break;
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int r = r0 + 8 * h;
        if (r >= valid) continue;
        bf16* p = ot + (size_t)r * a.cout + col;
        const float v0 = wf::silu(acc[4 * j + 2 * h]);
        const float v1 = wf::silu(acc[4 * j + 2 * h + 1]);
        if (pairs) {
          *reinterpret_cast<uint32_t*>(p) = pack_bf16(v0, v1);
        } else {
          p[0] = __float2bfloat16_rn(v0);
          if (col + 1 < a.cout) p[1] = __float2bfloat16_rn(v1);
        }
      }
    }
  }
}

template <int NT>
__device__ __forceinline__ void level_wgmma(const LevelArgs& a) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  unsigned char* smem =
      smem_raw + ((kAlign - (wf::smem_addr(smem_raw) & (kAlign - 1))) &
                  (kAlign - 1));
  const LayoutW l = layout_w(a);
  float* g1b = reinterpret_cast<float*>(smem + l.bias);
  const int npad = 3 * 8 * a.nt;
  float* p1b = g1b + align4(a.cin);
  float* g2b = p1b + npad;
  float* p2b = g2b + align4(a.cout);
  float* db = p2b + npad;
  uint64_t* full = reinterpret_cast<uint64_t*>(smem + l.bars);
  uint64_t* empty = full + a.stages;
  const int tid = threadIdx.x;

  // every row of both buffers starts finite (zero): padding columns and
  // rows are multiplied by zero weights or never stored
  for (int e = tid; e < l.ring / 16; e += kThreadsW)
    reinterpret_cast<uint4*>(smem)[e] = make_uint4(0, 0, 0, 0);
  if (tid == 0) *reinterpret_cast<uint4*>(smem + l.zero) = make_uint4(0, 0, 0, 0);
  // the biases, zero past each vector's end
  for (int c = tid; c < align4(a.cin); c += kThreadsW)
    g1b[c] = c < a.cin ? a.g1b[c] : 0.f;
  for (int c = tid; c < align4(a.cout); c += kThreadsW)
    g2b[c] = c < a.cout ? a.g2b[c] : 0.f;
  for (int c = tid; c < npad; c += kThreadsW) {
    p1b[c] = c < a.cout ? a.p1b[c] : 0.f;
    p2b[c] = c < a.cout ? a.p2b[c] : 0.f;
    if (a.db != nullptr) db[c] = c < a.cout ? a.db[c] : 0.f;
  }
  if (tid == 0) {
    for (int s = 0; s < a.stages; ++s) {
      wf::mbar_init(full + s, 1);
      wf::mbar_init(empty + s, kConsumerWarps);
    }
    wf::mbar_init_fence();
  }
  __syncthreads();

  const int ntm = (a.batch + a.samples - 1) / a.samples;
  const int my_tiles =
      (int)blockIdx.x < ntm ? (ntm - 1 - blockIdx.x) / gridDim.x + 1 : 0;
  const bf16* w = static_cast<const bf16*>(a.w);

  if (tid >= kConsumers) {   // the producer warpgroup
    asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;" ::"n"(kProducerRegs));
    if (tid == kConsumers)
      produce(a, reinterpret_cast<const unsigned char*>(w + a.off_p1),
              smem + l.ring, full, empty,
              my_tiles * (a.ks_p1 + a.ks_p2 + a.ks_d));
    return;
  }
  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;" ::"n"(kConsumerRegs));
  consume<NT>(a, smem, l);
}

// ---------------------------------------------------------------------------
// the level: one kernel, its body by the storage type, the bf16 one by the
// width of its warpgroups' wgmma (NT, a multiple of 4); fp32 takes NT = 0
// ---------------------------------------------------------------------------
template <typename T, int NT>
__global__ void __launch_bounds__(sizeof(T) == 2 ? kThreadsW : kThreads, 1)
    tcn_level_kernel(const LevelArgs a) {
  if constexpr (sizeof(T) == 2)
    level_wgmma<NT>(a);
  else
    level_fma(a);
}

// The plan must add up: layouts wide enough and aligned, enough k-steps
// for every reduction, the weight stream contiguous and 16-byte aligned.
bool plan_ok_fma(const LevelArgs& a) {
  if (a.groups < 1 || a.cin % a.groups || a.cout % a.groups || a.steps < 1 ||
      a.samples < 1 || a.samples * a.steps > kRows || a.batch < 1 ||
      a.dil < 1)
    return false;
  const int cg_in = a.cin / a.groups, cg_out = a.cout / a.groups;
  if (a.cgp_in % 8 || a.cgp_in < cg_in || a.cgp_in > 8 * kMaxNTG ||
      a.cgp_out % 8 || a.cgp_out < cg_out || a.cgp_out > 8 * kMaxNTG)
    return false;
  const int kin = align16(a.cin), kout = align16(a.cout);
  if (a.ldg_in < a.groups * a.cgp_in || a.ldg_out < a.groups * a.cgp_out ||
      a.ldd_in < kin || a.ldd_out < kout || a.ldg_in % 8 || a.ldg_out % 8 ||
      a.ldd_in % 8 || a.ldd_out % 8 ||
      a.buf0 < a.ldg_in || a.buf0 < a.ldg_out || a.buf0 < a.ldd_in ||
      a.buf1 < a.ldd_in || a.buf1 < a.ldd_out || a.buf0 % 8 || a.buf1 % 8)
    return false;
  if (a.ntiles != ceil_div(a.cout, 8) ||
      a.ntiles > kWarpCols * kMaxNTW || a.ks_p1 != kin / 16 ||
      a.ks_p2 != kout / 16 || a.ks_d != (a.db != nullptr ? kin / 16 : 0) ||
      a.ks_g1 != ceil_div(3 * a.cgp_in, 16) ||
      a.ks_g2 != ceil_div(3 * a.cgp_out, 16))
    return false;
  const int g1 = a.groups * a.ks_g1 * 16 * ceil_div(cg_in, 8) * 8;
  const int g2 = a.groups * a.ks_g2 * 16 * ceil_div(cg_out, 8) * 8;
  const int step = a.ntiles * 8 * 16;
  if (a.off_g1 != 0 || a.off_g2 != g1 || a.off_p1 != g1 + g2 ||
      a.off_p2 != a.off_p1 + a.ks_p1 * step ||
      a.off_d != a.off_p2 + a.ks_p2 * step || a.off_p1 % 8)
    return false;
  return layout(a).total == a.smem && a.smem <= kSmemLimit;
}

// The 8-channel chunks that the widest window of a group of cg channels
// touches, over G groups of the dense layout.
int window_chunks(int cg, int groups) {
  int most = 0;
  for (int g = 0; g < groups; ++g) {
    const int n = (g * cg + cg - 1) / 8 - g * cg / 8 + 1;
    most = n > most ? n : most;
  }
  return most;
}

bool plan_ok_wgmma(const LevelArgs& a) {
  if (a.groups < 1 || a.cin % a.groups || a.cout % a.groups || a.steps < 1 ||
      a.samples < 1 || a.samples * a.steps > kRowsW || a.batch < 1 ||
      a.dil < 1 || a.cin < 1 || a.cout < 1)
    return false;
  const int cg_in = a.cin / a.groups, cg_out = a.cout / a.groups;
  if (cg_in > 8 * kMaxNTG || cg_out > 8 * kMaxNTG ||
      ceil_div(3 * a.nch_in, 2) > kMaxKSG || ceil_div(3 * a.nch_out, 2) > kMaxKSG ||
      a.nch_in != window_chunks(cg_in, a.groups) ||
      a.nch_out != window_chunks(cg_out, a.groups) ||
      a.ks_g1 != ceil_div(3 * a.nch_in, 2) ||
      a.ks_g2 != ceil_div(3 * a.nch_out, 2))
    return false;
  if (a.kbuf != align64(max(a.cin, a.cout)) || a.nt < 1 || a.nt > kMaxNT ||
      a.nt != kNTStep * ceil_div(ceil_div(a.cout, 8), kNTStep * kWGs) ||
      a.stages < 2 ||
      a.stages > kMaxStages || a.ks_p1 != ceil_div(a.cin, 16) ||
      a.ks_p2 != ceil_div(a.cout, 16) ||
      a.ks_d != (a.db != nullptr ? a.ks_p1 : 0))
    return false;
  if (a.vec_x != 1 && a.vec_x != 2 && a.vec_x != 4) return false;
  if (a.cin % a.vec_x ||
      reinterpret_cast<uintptr_t>(a.x) % (2 * a.vec_x))
    return false;
  const int npad = 3 * 8 * a.nt;
  const int g1 = a.groups * a.ks_g1 * 16 * ceil_div(cg_in, 8) * 8;
  const int g2 = a.groups * a.ks_g2 * 16 * ceil_div(cg_out, 8) * 8;
  const int step = 16 * npad;
  if (a.off_g1 != 0 || a.off_g2 != g1 || a.off_p1 != g1 + g2 ||
      a.off_p2 != a.off_p1 + a.ks_p1 * step ||
      a.off_d != a.off_p2 + a.ks_p2 * step || a.off_p1 % 8)
    return false;
  return layout_w(a).total == a.smem && a.smem <= kSmemLimit;
}

using Kernel = void (*)(const LevelArgs);

template <typename T, int NT>
int launch(const LevelArgs& a, int grid, void* stream) {
  const Kernel kernel = tcn_level_kernel<T, NT>;
  constexpr bool wgmma = sizeof(T) == 2;
  if (wgmma) {
    // setmaxnreg moves registers within the block's allocation, which is
    // the compiled count for every thread: refuse a build whose count
    // could not grant them (the consumers would wait forever)
    static int regs = -1;
    if (regs < 0) {
      cudaFuncAttributes attr;
      const cudaError_t err = cudaFuncGetAttributes(&attr, kernel);
      if (err != cudaSuccess) return (int)err;
      regs = attr.numRegs;
    }
    if (kConsumers * kConsumerRegs + 128 * kProducerRegs > kThreadsW * regs)
      return (int)cudaErrorInvalidConfiguration;
  }
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, a.smem);
  if (err != cudaSuccess) return (int)err;
  kernel<<<grid, wgmma ? kThreadsW : kThreads, a.smem,
           static_cast<cudaStream_t>(stream)>>>(a);
  return (int)cudaGetLastError();
}

template <typename T>
int run(const LevelArgs& a, int grid, void* stream) {
  if (grid < 1) return (int)cudaErrorInvalidValue;
  if constexpr (sizeof(T) == 4) {
    return plan_ok_fma(a) ? launch<T, 0>(a, grid, stream)
                          : (int)cudaErrorInvalidValue;
  } else {
    if (!plan_ok_wgmma(a)) return (int)cudaErrorInvalidValue;
    switch (a.nt) {
      case 4: return launch<T, 4>(a, grid, stream);
      case 8: return launch<T, 8>(a, grid, stream);
      case 12: return launch<T, 12>(a, grid, stream);
      case 16: return launch<T, 16>(a, grid, stream);
      case 20: return launch<T, 20>(a, grid, stream);
      case 24: return launch<T, 24>(a, grid, stream);
      default: return (int)cudaErrorInvalidValue;
    }
  }
}

}  // namespace

// dims (host array): float32, 28 ints: batch, steps, cin, cout, groups,
// dil, samples, cgp_in, cgp_out, ldg_in, ldd_in, ldg_out, ldd_out, buf0,
// buf1, ntiles, ks_g1, ks_g2, ks_p1, ks_p2, ks_d, grid, smem, off_g1,
// off_g2, off_p1, off_p2, off_d.  bfloat16, 24 ints: batch, steps, cin,
// cout, groups, dil, samples, nch_in, nch_out, kbuf, nt, stages, ks_g1,
// ks_g2, ks_p1, ks_p2, ks_d, grid, smem, off_g1, off_g2, off_p1, off_p2,
// off_d.  db null: the identity residual.
extern "C" int tcn_level_forward(int dtype, const void* x, void* out,
                                 const void* w, const float* g1b,
                                 const float* p1b, const float* g2b,
                                 const float* p2b, const float* db,
                                 const int* dims, void* stream) {
  LevelArgs a{};
  a.x = x; a.out = out; a.w = w;
  a.g1b = g1b; a.p1b = p1b; a.g2b = g2b; a.p2b = p2b; a.db = db;
  a.batch = dims[0]; a.steps = dims[1]; a.cin = dims[2]; a.cout = dims[3];
  a.groups = dims[4]; a.dil = dims[5]; a.samples = dims[6];
  if (dtype == wf::kF32) {
    a.cgp_in = dims[7]; a.cgp_out = dims[8];
    a.ldg_in = dims[9]; a.ldd_in = dims[10];
    a.ldg_out = dims[11]; a.ldd_out = dims[12];
    a.buf0 = dims[13]; a.buf1 = dims[14]; a.ntiles = dims[15];
    a.ks_g1 = dims[16]; a.ks_g2 = dims[17]; a.ks_p1 = dims[18];
    a.ks_p2 = dims[19]; a.ks_d = dims[20];
    const int grid = dims[21];
    a.smem = dims[22];
    a.off_g1 = dims[23]; a.off_g2 = dims[24]; a.off_p1 = dims[25];
    a.off_p2 = dims[26]; a.off_d = dims[27];
    return run<float>(a, grid, stream);
  }
  if (dtype == wf::kBF16) {
    a.nch_in = dims[7]; a.nch_out = dims[8]; a.kbuf = dims[9];
    a.nt = dims[10]; a.stages = dims[11];
    a.ks_g1 = dims[12]; a.ks_g2 = dims[13]; a.ks_p1 = dims[14];
    a.ks_p2 = dims[15]; a.ks_d = dims[16];
    const int grid = dims[17];
    a.smem = dims[18];
    a.off_g1 = dims[19]; a.off_g2 = dims[20]; a.off_p1 = dims[21];
    a.off_p2 = dims[22]; a.off_d = dims[23];
    // the widest loads of x that its rows and its address allow
    const uintptr_t at = reinterpret_cast<uintptr_t>(x);
    a.vec_x = a.cin % 4 == 0 && at % 8 == 0   ? 4
              : a.cin % 2 == 0 && at % 4 == 0 ? 2
                                              : 1;
    return run<bf16>(a, grid, stream);
  }
  return (int)cudaErrorInvalidValue;
}

WF_EXPORT_ERROR_STRING
