// The whole eval conv stack of WiFlow per (sample, time) row, for sm_90a.
//
// Replaces wiflow_tpu/ops/pallas/conv_stack.py:fused_conv_stack_eval
// (kernel body _make_kernel).  A row is one time step's features (240 in
// the flagship, 272 in MM-Fi); it goes through ConvBlock1 (1 -> 8
// channels, stride 1) and four stride-2 blocks (8/8/16/32 -> 8/16/32/64
// channels, width 240 -> 120 -> 60 -> 30 -> 15).  Each block, with
// BatchNorm folded in:
//   h1  = silu(conv1x3(x, stride) + b1)       reads x[s*w + d - 1], pad 1
//   h2  = silu(conv1x3(h1) + b2)
//   out = silu(conv1x3(h2) + b3 + x[s*w] @ D + e)
// h1, h2 and out are rounded to the storage type, as the Pallas kernel does.
//
// What bounds it on the H100: ~2.1 MFLOP per row (172 GFLOP at batch 4096)
// against 2.4 KB of device traffic per row in bf16, so by the card's
// roofline it is bound by operations (0.17 ms at the bf16 tensor-core
// peak).  Below that lie the SFU and shared memory: 17,280 SiLUs a row,
// two MUFU operations each (wf::silu: __expf, __fdividef), 0.65-0.8 ms a
// batch of 4096 at 16 results a clock on 132 SMs; and the products' A
// operands, re-read from shared memory for every k-step, ~180 KB a row at
// N = 8-64, ~0.5 ms at 128 bytes a clock.  So the design keeps the
// products off the CUDA cores and the SiLUs off the critical path of any
// one warp: several warpgroups, each on its own rows.
//
// The launch plan is ops/kernels/conv_stack.py::conv_stack_plan; the C
// side refuses a plan that does not add up.  One block an SM walks many
// row tiles.  No atomics: a launch repeats bit for bit.
//
// bf16 (the served type): every (1,3) conv with C_in >= 8 on wgmma.
//   Roles.  2-5 warpgroups (the plan's choice: the most at which tiles of
//     3 rows fit), each walking its own row tiles through all 15 convs with
//     its own named barrier (bar.sync id, 128) after each conv, so one
//     warpgroup's SiLUs overlap another's products.  A conv runs in groups
//     of m-tiles (2 at N = 8, else 1): the group's products issued as one
//     commit, each slot's place worked out while they run, then the
//     group's epilogue.  The tile's input rows (480-544 bytes a row) are
//     copied by cp.async a tile ahead, once block 0 has read them.
//   Layout.  A warpgroup's region holds its input rows and its buffers:
//     each block's input at one end, its h2 beside it, its h1 and output at
//     the other end (h1 is dead when conv3 writes the output), the ends
//     swapping block by block, so the region holds the largest working set
//     of any conv.  Activations are position-major planes of 16-byte atoms
//     (8 channels), a plane a channel chunk; every row is padded with a
//     zero position at both ends (W + 2 positions, the pads written zero by
//     the epilogue that makes them), and a stride-2 block's input is
//     written by the block before as an even and an odd plane of rows of
//     W_out + 2 positions.  So each tap of each conv is a shifted view:
//     output position m reads position m + d - 1 (stride 1) or entry m - 1,
//     m - 1, m of the even, odd, even plane (stride 2; the shortcut the odd
//     plane's m - 1).
//   Products.  M = the positions of the tile's rows, flattened, 64 an
//     m-tile; N = C_out (one m64n(8 NT)k16 a k-step, NT = 1-8, a template
//     parameter); each k-step pairs two views (two chunks of one tap, or
//     taps 0 and 1 of the last of an odd number of chunks, or a view beside
//     zero weights).  A is read by descriptor, no swizzle: core matrices of
//     8 positions x 16 bytes (SBO 128), the k-step's second view LBO bytes
//     after the first (16: the next position); the plan's table gives each
//     k-step's offset and LBO, staged as descriptors, and an m-tile adds 64
//     positions.  No lane computes an address.  conv3 and the strided 1x1
//     shortcut are one GEMM, one epilogue.  B: the BN-folded weights,
//     packed by the packer in wgmma's B order (fragments.py::to_wgmma_b,
//     89 KB for the five blocks), staged once a block.  The bias is the
//     accumulators' initial value.  The whole shared memory is zeroed
//     first, so every byte a view reads is finite: a view past its plane
//     reads the next buffer or the slack after the regions and feeds only
//     outputs that are dropped, or zero weights.
//   Epilogues in registers: SiLU (wf::silu's formula, its exponential
//     flushed to zero: silu_ftz) of every slot first, then bf16 pairs
//     stored as 4 bytes into the next conv's planes; the last block's
//     output is staged as [row][C][W] and leaves in 16-byte copies.
//   Tried and slower on the H100: two sets of accumulators a warpgroup, the
//     next item's products issued before this one's epilogue (the
//     epilogue then adds the bias and may not write the accumulators, and
//     the code doubles: 2.16-2.34 ms at batch 4096 against 1.98-2.08).
//   ConvBlock1's first conv (C_in = 1) is elementwise on CUDA cores: a
//     thread makes the 8 outputs of one position, one 16-byte store; its
//     1-channel shortcut is added in conv3's epilogue.
//
// fp32, the check type: the tile of 32 rows goes through each conv in
//   turn, 24 warps, a block barrier after each conv, on CUDA-core FMAs.
//   Activations are channel-last, [row][position][channel], one position a
//   padded row of ld elements; the row of 16-byte zeros stands in for every
//   tap outside [0, W).  Each conv with C_in >= 8 is an implicit GEMM in
//   the mma.sync m16n8k16 accumulator layout: M = the positions of all rows
//   of the tile, flattened; N = C_out; K = 8-channel chunks, tap-major,
//   then the shortcut's; a warp's unit is 1-4 m-tiles of 16 positions x 1-4
//   n-tiles of 8 channels, the shape picked by the plan.  Its [K, N]
//   weights are read from device memory (L1).  Index arithmetic uses
//   wf::FastDiv, not integer division.
// The TPU kernel's space-to-depth banded layout exists for the (8, 128)
// tiles and is not carried over.
#include "common.cuh"
#include "mma.cuh"
#include "wgmma.cuh"

namespace {

using bf16 = __nv_bfloat16;
constexpr int kThreads = 768;
constexpr int kWarps = kThreads / 32;
constexpr int kMaxBlocks = 8;
constexpr int kZeroBytes = 512;   // the row of zeros: >= the widest row
constexpr int kSmemLimit = 232448;

struct ConvSpec {
  int ksteps;   // 16-deep steps of the reduction (0: elementwise)
  int mtu, nt;  // a warp unit: mtu m-tiles x nt n-tiles
  int woff;     // first element of its weights in the weight array
  int boff;     // first float of its bias in the vector array
};

struct BlockSpec {
  int ci, co, stride, win, wout, ld_in, ld_out;
  ConvSpec conv[3];
  int w1off, wdoff;   // C_in == 1: taps [3][co] and shortcut [co], else -1
};
constexpr int kDimsPerBlock = 24;

template <typename T>
struct StackArgs {
  const T* x;          // [rows, w0]
  T* out;              // [rows, co_last, wout_last]
  const void* w;       // [K_pad, co] per conv
  const float* vec;    // biases, and the 1-channel taps
  int rows, w0, tile_rows, row_elems, nvec, wfrag, nblk;
  BlockSpec blk[kMaxBlocks];
};

__host__ __device__ constexpr int align16(int v) { return (v + 15) / 16 * 16; }

struct Layout {
  int vec, w, zero, slots, total;
};

__host__ __device__ inline Layout layout(int nvec, int wfrag, int tile_rows,
                                         int row_elems, int esize) {
  Layout l;
  l.vec = 0;
  l.w = align16(nvec * 4);
  l.zero = l.w + align16(wfrag * 2);
  l.slots = l.zero + kZeroBytes;
  l.total = l.slots + 3 * tile_rows * row_elems * esize;
  return l;
}

// An activation in shared memory: [row][width][ld], read at stride*w + d.
template <typename T>
struct Operand {
  const T* p;
  int width, ld, stride;
};

template <typename T>
struct Conv {
  Operand<T> src;      // the taps
  int cc;              // 8-channel chunks of src
  Operand<T> sc;       // the shortcut's chunks (ncs of them, 0: none)
  int ncs;
  const T* x1;         // 1-channel shortcut added in the epilogue, or null
  const float* wd;
  int x1_width, x1_stride;
  T* dst;
  int ld_dst, wout, co, m;   // m: positions of the tile
  wf::FastDiv by_wout, by_cc;   // position -> (row, w); chunk -> tap
  const float* bias;
  ConvSpec spec;
};

// The shared-memory row holding chunk q of the reduction for output
// position w of tile row r: tap d of the source, a shortcut chunk, or the
// zero row (outside the row, past the tile, or reduction padding).
template <typename T>
__device__ __forceinline__ const T* chunk_row(const Conv<T>& c, const T* zero,
                                              int q, bool valid, int r,
                                              int w) {
  if (!valid) return zero;
  const int nmain = 3 * c.cc;
  if (q < nmain) {
    const int d = c.by_cc.div(q), c8 = q - d * c.cc;
    const int p = c.src.stride * w + d - 1;
    if (p < 0 || p >= c.src.width) return zero;
    return c.src.p + (r * c.src.width + p) * c.src.ld + 8 * c8;
  }
  q -= nmain;
  if (q < c.ncs)
    return c.sc.p + (r * c.sc.width + c.sc.stride * w) * c.sc.ld + 8 * q;
  return zero;
}

// A warp's unit: MTU m-tiles of 16 positions x NT n-tiles of 8 channels,
// on CUDA cores: thread (gid, tig) owns rows gid and gid + 8 of each
// m-tile, columns 2 tig and 2 tig + 1 of each n-tile; the weights [K_pad,
// co] are read from device memory.
template <int MTU, int NT>
__device__ __forceinline__ void unit_product(float (&acc)[MTU][NT][4],
                                             const Conv<float>& c,
                                             const float* zero,
                                             const void* wsrc, int mt0,
                                             int nt0) {
  const int lane = threadIdx.x & 31, gid = lane >> 2, tig = lane & 3;
  int r[MTU][2], w[MTU][2];
  bool valid[MTU][2];
#pragma unroll
  for (int u = 0; u < MTU; ++u)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int m = (mt0 + u) * 16 + gid + 8 * h;
      valid[u][h] = m < c.m;
      r[u][h] = c.by_wout.div(m);
      w[u][h] = m - r[u][h] * c.wout;
    }
  const float* wk = static_cast<const float*>(wsrc) + c.spec.woff + nt0 * 8 +
                    2 * tig;
  for (int q = 0; q < 2 * c.spec.ksteps; ++q) {
    const float* a[MTU][2];
#pragma unroll
    for (int u = 0; u < MTU; ++u)
#pragma unroll
      for (int h = 0; h < 2; ++h)
        a[u][h] = chunk_row(c, zero, q, valid[u][h], r[u][h], w[u][h]);
#pragma unroll
    for (int e = 0; e < 8; ++e) {
      float2 wv[NT];
#pragma unroll
      for (int nt = 0; nt < NT; ++nt)
        wv[nt] = __ldg(reinterpret_cast<const float2*>(
            wk + (size_t)(q * 8 + e) * c.co + nt * 8));
#pragma unroll
      for (int u = 0; u < MTU; ++u) {
        const float x0 = a[u][0][e], x1 = a[u][1][e];
#pragma unroll
        for (int nt = 0; nt < NT; ++nt) {
          acc[u][nt][0] += x0 * wv[nt].x;
          acc[u][nt][1] += x0 * wv[nt].y;
          acc[u][nt][2] += x1 * wv[nt].x;
          acc[u][nt][3] += x1 * wv[nt].y;
        }
      }
    }
  }
}

__device__ __forceinline__ void store2(float* p, float a, float b) {
  *reinterpret_cast<float2*>(p) = make_float2(a, b);
}

// dst = silu(the conv's GEMM + bias [+ the 1-channel shortcut]) for every
// position of the tile; the warps take the units in turn.
template <typename T, int MTU, int NT>
__device__ void run_units(const Conv<T>& c, const T* zero,
                          const void* wsrc) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int gid = lane >> 2, tig = lane & 3;
  const int ngroups = c.co / 8 / NT;
  const int mgroups = ((c.m + 15) / 16 + MTU - 1) / MTU;
  for (int unit = warp; unit < mgroups * ngroups; unit += kWarps) {
    const int mg = unit / ngroups;
    const int mt0 = mg * MTU, nt0 = (unit - mg * ngroups) * NT;
    float acc[MTU][NT][4];
#pragma unroll
    for (int u = 0; u < MTU; ++u)
#pragma unroll
      for (int nt = 0; nt < NT; ++nt)
#pragma unroll
        for (int q = 0; q < 4; ++q) acc[u][nt][q] = 0.f;
    unit_product<MTU, NT>(acc, c, zero, wsrc, mt0, nt0);
#pragma unroll
    for (int nt = 0; nt < NT; ++nt) {
      const int col = (nt0 + nt) * 8 + 2 * tig;
      const float b0 = c.bias[col], b1 = c.bias[col + 1];
#pragma unroll
      for (int u = 0; u < MTU; ++u)
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int m = (mt0 + u) * 16 + gid + 8 * h;
          if (m >= c.m) continue;
          float v0 = acc[u][nt][2 * h] + b0, v1 = acc[u][nt][2 * h + 1] + b1;
          if (c.x1 != nullptr) {
            const int r = c.by_wout.div(m), w = m - r * c.wout;
            const float xv =
                wf::to_f(c.x1[r * c.x1_width + c.x1_stride * w]);
            v0 += xv * c.wd[col];
            v1 += xv * c.wd[col + 1];
          }
          store2(c.dst + m * c.ld_dst + col, wf::silu(v0), wf::silu(v1));
        }
    }
  }
}

// The unit shapes a plan may choose (MTU x NT <= 4 accumulator tiles).
__host__ __device__ constexpr bool unit_shape_ok(int mtu, int nt) {
  return (mtu == 1 && (nt == 1 || nt == 2 || nt == 4)) ||
         (mtu == 2 && (nt == 1 || nt == 2)) || (mtu == 4 && nt == 1);
}

template <typename T>
__device__ void run_conv(const Conv<T>& c, const T* zero, const void* wsrc) {
  switch (c.spec.mtu * 8 + c.spec.nt) {
    case 1 * 8 + 1: run_units<T, 1, 1>(c, zero, wsrc); break;
    case 1 * 8 + 2: run_units<T, 1, 2>(c, zero, wsrc); break;
    case 1 * 8 + 4: run_units<T, 1, 4>(c, zero, wsrc); break;
    case 2 * 8 + 1: run_units<T, 2, 1>(c, zero, wsrc); break;
    case 2 * 8 + 2: run_units<T, 2, 2>(c, zero, wsrc); break;
    case 4 * 8 + 1: run_units<T, 4, 1>(c, zero, wsrc); break;
  }
}

__device__ __forceinline__ void store8(float* p, const float (&v)[8]) {
  float4* q = reinterpret_cast<float4*>(p);
  q[0] = make_float4(v[0], v[1], v[2], v[3]);
  q[1] = make_float4(v[4], v[5], v[6], v[7]);
}

// The first conv of ConvBlock1, C_in = 1: a thread makes the co outputs of
// one position, 8 at a time, from its 3 taps.
template <typename T>
__device__ void conv_first(const T* x1, int win, int stride, T* dst, int ld,
                           int wout, int co, int m, const float* w1,
                           const float* b) {
  const wf::FastDiv by_wout(wout);
  for (int e = threadIdx.x; e < m; e += kThreads) {
    const int r = by_wout.div(e), w = e - r * wout;
    float xv[3];
#pragma unroll
    for (int d = 0; d < 3; ++d) {
      const int p = stride * w + d - 1;
      xv[d] = 0.f;
      if (p >= 0 && p < win) xv[d] = wf::to_f(x1[r * win + p]);
    }
    for (int c0 = 0; c0 < co; c0 += 8) {
      float v[8];
#pragma unroll
      for (int o = 0; o < 8; ++o) {
        const int c = c0 + o;
        v[o] = wf::silu(b[c] + xv[0] * w1[c] + xv[1] * w1[co + c] +
                        xv[2] * w1[2 * co + c]);
      }
      store8(dst + e * ld + c0, v);
    }
  }
}

// fp32: the tiles of the whole block take each conv in turn, a block barrier
// after each.
template <typename T>
__device__ __forceinline__ void stack_fma(const StackArgs<T>& a) {
  extern __shared__ __align__(16) unsigned char smem[];
  const Layout l =
      layout(a.nvec, a.wfrag, a.tile_rows, a.row_elems, (int)sizeof(T));
  float* vec = reinterpret_cast<float*>(smem + l.vec);
  const T* zero = reinterpret_cast<const T*>(smem + l.zero);
  T* slots = reinterpret_cast<T*>(smem + l.slots);
  const int slot_elems = a.tile_rows * a.row_elems;
  const int tid = threadIdx.x;

  // the block's constants, once: vectors, the zero row
  for (int e = tid; e < a.nvec; e += kThreads) vec[e] = a.vec[e];
  const void* wsrc = a.w;
  for (int e = tid; e < kZeroBytes / 16; e += kThreads)
    reinterpret_cast<uint4*>(smem + l.zero)[e] = make_uint4(0, 0, 0, 0);

  const int ntiles = (a.rows + a.tile_rows - 1) / a.tile_rows;
  for (int tile = blockIdx.x; tile < ntiles; tile += gridDim.x) {
    const int row0 = tile * a.tile_rows;
    const int valid = min(a.tile_rows, a.rows - row0);
    __syncthreads();   // the previous tile's output has left its slot
    for (int e = tid; e < a.tile_rows * a.w0; e += kThreads) {
      T v = wf::from_f<T>(0.f);
      if (e < valid * a.w0) v = a.x[(size_t)row0 * a.w0 + e];
      slots[e] = v;
    }
    __syncthreads();
    int xs = 0;
    for (int k = 0; k < a.nblk; ++k) {
      const BlockSpec& b = a.blk[k];
      const int s1 = xs == 2 ? 0 : xs + 1, s2 = s1 == 2 ? 0 : s1 + 1;
      T* x = slots + xs * slot_elems;
      T* h1 = slots + s1 * slot_elems;
      T* h2 = slots + s2 * slot_elems;
      const int m = a.tile_rows * b.wout;
      Conv<T> c;
      c.ncs = 0;
      c.x1 = nullptr;
      c.wd = nullptr;
      c.x1_width = b.win;
      c.x1_stride = b.stride;
      c.sc = Operand<T>{x, b.win, b.ld_in, b.stride};
      c.ld_dst = b.ld_out;
      c.wout = b.wout;
      c.by_wout = wf::FastDiv(b.wout);
      c.co = b.co;
      c.m = m;
      // conv1: x -> h1
      if (b.ci == 1) {
        conv_first(x, b.win, b.stride, h1, b.ld_out, b.wout, b.co, m,
                   vec + b.w1off, vec + b.conv[0].boff);
      } else {
        c.src = Operand<T>{x, b.win, b.ld_in, b.stride};
        c.cc = b.ci / 8;
        c.by_cc = wf::FastDiv(c.cc);
        c.dst = h1;
        c.bias = vec + b.conv[0].boff;
        c.spec = b.conv[0];
        run_conv(c, zero, wsrc);
      }
      __syncthreads();
      // conv2: h1 -> h2
      c.src = Operand<T>{h1, b.wout, b.ld_out, 1};
      c.cc = b.co / 8;
      c.by_cc = wf::FastDiv(c.cc);
      c.dst = h2;
      c.bias = vec + b.conv[1].boff;
      c.spec = b.conv[1];
      run_conv(c, zero, wsrc);
      __syncthreads();
      // conv3 + the strided shortcut of x: h2, x -> h1
      c.src = Operand<T>{h2, b.wout, b.ld_out, 1};
      c.dst = h1;
      c.bias = vec + b.conv[2].boff;
      c.spec = b.conv[2];
      if (b.ci == 1) {
        c.x1 = x;
        c.wd = vec + b.wdoff;
      } else {
        c.ncs = b.ci / 8;
      }
      run_conv(c, zero, wsrc);
      __syncthreads();
      xs = s1;
    }
    // the last block's output: [row][w][ld] -> [row][c][w] in device memory
    const BlockSpec& lb = a.blk[a.nblk - 1];
    const T* o = slots + xs * slot_elems;
    const int per = lb.co * lb.wout;
    const wf::FastDiv by_per(per), by_wout(lb.wout);
    T* dst = a.out + (size_t)row0 * per;
    for (int e = tid; e < valid * per; e += kThreads) {
      const int r = by_per.div(e), rem = e - r * per;
      const int c = by_wout.div(rem), w = rem - c * lb.wout;
      dst[e] = o[(r * lb.wout + w) * lb.ld_out + c];
    }
  }
}

// ===========================================================================
// bf16: wgmma, each warpgroup on its own row tiles
// ===========================================================================
constexpr int kMaxWGs = 5;
constexpr int kWThreads = 128 * kMaxWGs;
constexpr int kMaxWNT = 8;                 // N = 8 NT <= 64
constexpr int kMaxConvs = 3 * kMaxBlocks;
constexpr int kMaxKsteps = 160;
constexpr int kMTile = 64;                 // wgmma's M: positions
constexpr int kPos = 16;                   // bytes a position of a plane
// Bytes after the last region that an m-tile's views may read past their
// buffer: 64 positions and the two a view is shifted by.
constexpr int kSlack = (kMTile + 4) * kPos;

// One conv of the plan (conv_stack.py::wgmma_plan), 16 ints.  Offsets
// into the warpgroup's region are bytes.
struct WConv {
  int kind;       // 0: wgmma GEMM; 1: ConvBlock1's C_in = 1 conv, elementwise
  int nt;         // C_out / 8
  int ksteps;     // k-steps of the GEMM
  int kfirst;     // its first entry in the k-step table
  int woff;       // bytes into the staged weights: B of k-step 0
  int boff;       // first float of its bias in the vectors
  int mp;         // output positions of a tile: rows x q
  int q;          // positions a row: W_out + 2, zero at both ends
  int dst;        // the output buffer
  int dst_pb;     // bytes a plane of it
  int dst_p;      // 1: a plane a chunk; 2: even / odd planes of rows of
                  // dst_q positions (a stride-2 block reads it); 0: the
                  // stack's output, [row][C_out][W_out]
  int dst_q;
  int wdoff;      // 1-channel shortcut added in the epilogue: its taps in
                  // the vectors, or -1
  int stride;     // the block's stride (the 1-channel reads of x)
  int w1off;      // kind 1: taps [3][C_out] in the vectors
  int co;
};
static_assert(sizeof(WConv) == 16 * sizeof(int), "16 ints a conv");

struct WArgs {
  const bf16* x;     // [rows, w0]
  bf16* out;         // [rows, co_last, wout_last]
  const void* w;     // wgmma B k-steps of every GEMM conv
  const float* vec;  // biases, and the 1-channel taps
  int rows, w0, tile_rows, wgs, nvec, wfrag, nblk, region, xbuf, nkst;
  WConv conv[kMaxConvs];
  int2 kst[kMaxKsteps];   // (A at output position 0, LBO), bytes
};

template <>
struct StackArgs<bf16> : WArgs {};

struct WLayout {
  int vec, w, tables, regions, total;
};

__host__ __device__ inline WLayout wlayout(const WArgs& a) {
  WLayout l;
  l.vec = 0;
  l.w = align16(a.nvec * 4);
  l.tables = l.w + align16(a.wfrag * 2);
  l.regions = l.tables + align16((3 * a.nblk * 16 + 2 * a.nkst) * 4);
  l.total = l.regions + a.wgs * a.region + kSlack;
  return l;
}

// The warpgroup's own barrier (id 0 is the block's).
__device__ __forceinline__ void bar_wg(int wg) {
  asm volatile("bar.sync %0, 128;" ::"r"(wg + 1) : "memory");
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}

// wf::silu, __fdividef(v, 1 + __expf(-v)), with the exponential flushed to
// zero below 2^-126: __expf's rescaling of such results (a compare and two
// predicated multiplies a SiLU) is dropped.  The same bits for every v:
// the exponential's argument is the same product, and a flushed result
// would have been added to 1 below its last bit.
__device__ __forceinline__ float silu_ftz(float v) {
  float e;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(e) : "f"(v * -1.44269504088896341f));
  return __fdividef(v, 1.0f + e);
}

// What a warpgroup's threads share about where things are.
struct Ctx {
  unsigned char* region;   // the warpgroup's shared memory
  uint32_t raddr;          // its shared address
  uint32_t waddr;          // the staged weights' shared address
  const float* vec;
  const uint64_t* kst;     // each k-step's A descriptor, less the region
  const bf16* xs;          // the tile's input rows: row r at xs + r w0
  int w0, t;               // t: thread of the warpgroup
  int xmax;                // the last element of the tile's input rows
};

// wgmma_bf16 (wgmma.cuh) with its scale of D a constant 1: the helper
// there derives the predicate from the descriptor at run time, a compare
// and a vote a product, which the small products here cannot afford.
template <int NT>
__device__ __forceinline__ void wgmma_acc(float (&d)[4 * NT], uint64_t a,
                                          uint64_t b);

#define WF_ACC4(i)                                                    \
  "+f"(d[4 * (i)]), "+f"(d[4 * (i) + 1]), "+f"(d[4 * (i) + 2]),       \
      "+f"(d[4 * (i) + 3])
#define CS_WGMMA(NT, N, ONE)                                               \
  template <>                                                              \
  __device__ __forceinline__ void wgmma_acc<NT>(float(&d)[4 * NT],         \
                                                uint64_t a, uint64_t b) {  \
    asm volatile(                                                          \
        "{\n.reg .pred p;\nsetp.ne.b32 p, %" #ONE ", 0;\n"                 \
        "wgmma.mma_async.sync.aligned.m64n" #N                             \
        "k16.f32.bf16.bf16 {" WF_S##NT "}, %0, %1, p, 1, 1, 0, 0;\n}\n"    \
        : "+l"(a), "+l"(b), WF_C##NT                                       \
        : "r"(1));                                                         \
  }
CS_WGMMA(1, 8, 6)
CS_WGMMA(2, 16, 10)
CS_WGMMA(3, 24, 14)
CS_WGMMA(4, 32, 18)
CS_WGMMA(5, 40, 22)
CS_WGMMA(6, 48, 26)
CS_WGMMA(7, 56, 30)
CS_WGMMA(8, 64, 34)
#undef CS_WGMMA
#undef WF_ACC4

// n / d for 0 <= n < 2^16 and 3 <= d < 2^11 by a multiply-high on the
// ALU (exact in that range: the rounding of ceil(2^32 / d) adds less than
// n d / 2^32 < 1 / d), leaving the SFU to the SiLUs.
struct MagicDiv {
  uint32_t magic;
  int d;
  __device__ explicit MagicDiv(int divisor = 3)
      : magic(0xFFFFFFFFu / (uint32_t)divisor + 1u), d(divisor) {}
  __device__ __forceinline__ int div(int n) const {
    return (int)__umulhi((uint32_t)n, magic);
  }
};

// What a conv's epilogue needs, in registers for the conv's life (read
// from shared memory, the values would be reloaded after every store).
struct Epi {
  int mp, q, dst, dst_pb, dst_q, stride, co, xmax;
  MagicDiv by_q;
  const float* wd;      // the 1-channel shortcut's taps, or null
};

// A thread's place in an m-tile: position 64 mt + 16 warp + gid + 8 h,
// channels 8 n + 2 tig and + 1 (acc[4 n + 2 h] and acc[4 n + 2 h + 1]).
struct Slot {
  int m, r, j;
  bool pad;
};

__device__ __forceinline__ Slot slot_of(const Ctx& c, const Epi& e, int mt,
                                        int h) {
  Slot p;
  p.m = mt * kMTile + (c.t >> 5) * 16 + ((c.t & 31) >> 2) + 8 * h;
  p.r = e.by_q.div(p.m);
  p.j = p.m - p.r * e.q;
  p.pad = p.j == 0 || p.j == e.q - 1;
  return p;
}

// The epilogue of a group of MT m-tiles from the registers (the bias is
// the accumulators' initial value), given each slot's place and x (the
// 1-channel shortcut's input, where the conv has one), both worked out
// while the products ran.  First every SiLU of the group, branch-free, so
// that the 4 MT NT SiLUs of a thread interleave on the SFU; then the
// stores: bf16 pairs, zero at a row's two pad positions, nothing past the
// tile's positions.  P: the output's planes (1, or 2 even / odd), or 0:
// the stack's output, [row][C][W], with no pads.
template <int NT, int MT, int P>
__device__ __forceinline__ void epilogue(float (&acc)[MT][4 * NT],
                                         const Slot (&sl)[MT][2],
                                         const float (&xv)[MT][2],
                                         const Ctx& c, const Epi& e,
                                         int mt0, int mts) {
  const int tig = c.t & 3;
  if (e.wd != nullptr) {
#pragma unroll
    for (int n = 0; n < NT; ++n) {
      const float2 d = *reinterpret_cast<const float2*>(e.wd + 8 * n);
#pragma unroll
      for (int u = 0; u < MT; ++u)
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          acc[u][4 * n + 2 * h] += xv[u][h] * d.x;
          acc[u][4 * n + 2 * h + 1] += xv[u][h] * d.y;
        }
    }
  }
#pragma unroll
  for (int u = 0; u < MT; ++u) {
#pragma unroll
    for (int i = 0; i < 4 * NT; ++i) acc[u][i] = silu_ftz(acc[u][i]);
    // computed here, for every slot: left to the compiler, each pair's
    // SiLUs would sink into the branches of the stores, a pair at a time
    wf::fence_acc(acc[u]);
  }
#pragma unroll
  for (int u = 0; u < MT; ++u) {
    if (mt0 + u >= mts) continue;
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const Slot& p = sl[u][h];
      if (p.m >= e.mp) continue;
      if (P == 0) {
        if (p.pad) continue;
        const int wout = e.q - 2;
        bf16* o = reinterpret_cast<bf16*>(c.region + e.dst) +
                  (p.r * e.co + 2 * tig) * wout + p.j - 1;
#pragma unroll
        for (int n = 0; n < NT; ++n) {
          o[8 * n * wout] = __float2bfloat16_rn(acc[u][4 * n + 2 * h]);
          o[(8 * n + 1) * wout] =
              __float2bfloat16_rn(acc[u][4 * n + 2 * h + 1]);
        }
      } else {
        // the pair's bytes in chunk 0's plane; chunk n a stride further
        const int at = (P == 1 ? e.dst + p.m * kPos
                               : e.dst + (p.j & 1) * e.dst_pb +
                                     (p.r * e.dst_q + (p.j >> 1)) * kPos) +
                       4 * tig;
        const int step = P * e.dst_pb;
#pragma unroll
        for (int n = 0; n < NT; ++n)
          *reinterpret_cast<uint32_t*>(c.region + at + n * step) =
              p.pad ? 0u
                    : pack_bf16(acc[u][4 * n + 2 * h],
                                acc[u][4 * n + 2 * h + 1]);
      }
    }
  }
}

// Accumulator tiles (m-tiles x 8-column n-tiles) a thread holds at once: a
// group is kGroupTiles / NT m-tiles (at least 1), so that one wait covers
// enough products and the epilogue has independent SiLUs to overlap.
constexpr int kGroupTiles = 2;

template <int NT>
__host__ __device__ constexpr int group_mts() {
  return NT >= kGroupTiles ? 1 : kGroupTiles / NT;
}

// One GEMM conv of the warpgroup's tile, a group of m-tiles at a time:
// every k-step one m64n(8 NT)k16 wgmma an m-tile whose A is a view of the
// warpgroup's activations (the table's offset, moved 64 positions an
// m-tile; core matrices of 8 positions x 16 bytes, SBO 128, LBO from the
// table) and whose B is the k-step's staged weights (LBO 128 along K, SBO
// 256 along N), onto the bias as the accumulators' start; one commit, each
// slot's place worked out while the products run, one wait, then the
// group's epilogue from the registers.  A group past the last m-tile
// repeats it (no wgmma is conditional) and drops the copy.  While one
// warpgroup waits for its products, the others' epilogues run.
template <int NT, int P>
__device__ __forceinline__ void conv_wgmma(const Ctx& c, const WConv& cv) {
  constexpr int MT = group_mts<NT>();
  Epi e;
  e.mp = cv.mp; e.q = cv.q; e.dst = cv.dst; e.dst_pb = cv.dst_pb;
  e.dst_q = cv.dst_q; e.stride = cv.stride;
  e.co = cv.co; e.xmax = c.xmax;
  e.by_q = MagicDiv(cv.q);
  e.wd = cv.wdoff >= 0 ? c.vec + cv.wdoff + 2 * (c.t & 3) : nullptr;
  float2 b[NT];   // this thread's two columns of each n-tile
  const float* bias = c.vec + cv.boff + 2 * (c.t & 3);
#pragma unroll
  for (int n = 0; n < NT; ++n)
    b[n] = *reinterpret_cast<const float2*>(bias + 8 * n);
  // descriptors: B of k-step 0 (LBO 128 along K, SBO 256 along N), the
  // region's part of A's
  const uint64_t db0 = wf::gmma_desc(c.waddr + cv.woff, 128, 256, 0);
  const uint64_t a0 = c.raddr >> 4;
  const uint64_t* ks = c.kst + cv.kfirst;
  const int ksteps = cv.ksteps;
  const int mts = (e.mp + kMTile - 1) / kMTile;
  float acc[MT][4 * NT];
  for (int mt0 = 0; mt0 < mts; mt0 += MT) {
#pragma unroll
    for (int u = 0; u < MT; ++u) {
#pragma unroll
      for (int i = 0; i < 4 * NT; ++i)
        acc[u][i] = i & 1 ? b[i / 4].y : b[i / 4].x;
      wf::fence_acc(acc[u]);
    }
    wf::wgmma_fence();
    uint64_t db = db0;
    // by 2, not the compiler's 16: a conv has 2-14 k-steps, and the code of
    // the convs the warpgroups are in at once has to stay in the
    // instruction cache (unrolled by 16 the kernel ran ~5% slower)
#pragma unroll 2
    for (int s = 0; s < ksteps; ++s) {
      const uint64_t da = ks[s] + a0;
#pragma unroll
      for (int u = 0; u < MT; ++u) {
        const uint32_t mt = min(mt0 + u, mts - 1);
        wgmma_acc<NT>(acc[u], da + mt * (kMTile * kPos / 16), db);
      }
      db += 256 * NT / 16;   // the next k-step's 16 x N weights
    }
    wf::wgmma_commit();
    // the slots' places (and x), while the products run
    Slot sl[MT][2];
    float xv[MT][2];
#pragma unroll
    for (int u = 0; u < MT; ++u)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        sl[u][h] = slot_of(c, e, mt0 + u, h);
        xv[u][h] = 0.f;
        if (e.wd != nullptr)
          xv[u][h] = __bfloat162float(c.xs[min(
              max(sl[u][h].r * c.w0 + e.stride * (sl[u][h].j - 1), 0),
              e.xmax)]);
      }
    wf::wgmma_wait<0>();
#pragma unroll
    for (int u = 0; u < MT; ++u) wf::fence_acc(acc[u]);
    epilogue<NT, MT, P>(acc, sl, xv, c, e, mt0, mts);
  }
}

template <int NT>
__device__ __forceinline__ void conv(const Ctx& c, const WConv& cv) {
  if (cv.dst_p == 0)
    conv_wgmma<NT, 0>(c, cv);
  else if (cv.dst_p == 1)
    conv_wgmma<NT, 1>(c, cv);
  else
    conv_wgmma<NT, 2>(c, cv);
}

// ConvBlock1's first conv, C_in = 1: 8 output channels at a time, their
// taps and biases held in registers; a thread makes the 8 outputs of one
// position (one 16-byte store) from its 3 taps.
__device__ __forceinline__ void conv_first_w(const Ctx& c, const WConv& cv) {
  const wf::FastDiv by_q(cv.q);
  const int mp = cv.mp, q = cv.q, co = cv.co, stride = cv.stride;
  const int dst = cv.dst, dst_pb = cv.dst_pb;
  for (int c0 = 0; c0 < co; c0 += 8) {
    float w[3][8], b[8];
#pragma unroll
    for (int o = 0; o < 8; ++o) {
      b[o] = c.vec[cv.boff + c0 + o];
#pragma unroll
      for (int d = 0; d < 3; ++d) w[d][o] = c.vec[cv.w1off + d * co + c0 + o];
    }
    for (int p0 = c.t; p0 < mp; p0 += 128) {
      const int r = by_q.div(p0), j = p0 - r * q;
      const bool pad = j == 0 || j == q - 1;
      float xv[3];
#pragma unroll
      for (int d = 0; d < 3; ++d) {
        const int p = stride * (j - 1) + d - 1;
        xv[d] = 0.f;
        if (!pad && p >= 0 && p < c.w0)
          xv[d] = __bfloat162float(c.xs[r * c.w0 + p]);
      }
      float y[8];
#pragma unroll
      for (int o = 0; o < 8; ++o)
        y[o] = silu_ftz(b[o] + xv[0] * w[0][o] + xv[1] * w[1][o] +
                        xv[2] * w[2][o]);
      wf::fence_acc(y);   // all 8 SiLUs together, not behind the pad test
      uint32_t u[4];
#pragma unroll
      for (int o = 0; o < 8; o += 2)
        u[o / 2] = pad ? 0u : pack_bf16(y[o], y[o + 1]);
      *reinterpret_cast<uint4*>(c.region + dst + (c0 / 8) * dst_pb +
                                p0 * kPos) = make_uint4(u[0], u[1], u[2], u[3]);
    }
  }
}

// The tile's input rows, from their 16-byte-aligned cover in device memory
// into the warpgroup's buffer, asynchronously; returns the elements the
// first row starts after.
__device__ __forceinline__ int fetch_x(const WArgs& a, unsigned char* xbuf,
                                       int tile, int t) {
  const int row0 = tile * a.tile_rows;
  const int valid = min(a.tile_rows, a.rows - row0);
  const uintptr_t s = reinterpret_cast<uintptr_t>(a.x + (size_t)row0 * a.w0);
  const uintptr_t e = reinterpret_cast<uintptr_t>(
      a.x + ((size_t)row0 + valid) * a.w0);
  const uintptr_t s16 = s & ~(uintptr_t)15;
  const int words = (int)((((e + 15) & ~(uintptr_t)15) - s16) / 16);
  for (int i = t; i < words; i += 128)
    wf::cp_async16(xbuf + 16 * i, reinterpret_cast<const void*>(s16 + 16 * i));
  wf::cp_async_commit();
  return (int)(s - s16) / 2;
}

__device__ __forceinline__ void stack_wgmma(const WArgs& a) {
  extern __shared__ __align__(16) unsigned char smem[];
  const WLayout l = wlayout(a);
  const int tid = threadIdx.x, nthreads = 128 * a.wgs;
  // zeros first: every byte a k-step may read is then finite (a view past
  // its plane reads the next one, or the next buffer, region or the slack,
  // and feeds only outputs that are dropped, or zero weights)
  for (int e = tid; e < l.total / 16; e += nthreads)
    reinterpret_cast<uint4*>(smem)[e] = make_uint4(0, 0, 0, 0);
  __syncthreads();
  float* vec = reinterpret_cast<float*>(smem + l.vec);
  for (int e = tid; e < a.nvec; e += nthreads) vec[e] = a.vec[e];
  {
    uint4* ws = reinterpret_cast<uint4*>(smem + l.w);
    const uint4* wg = static_cast<const uint4*>(a.w);
    for (int e = tid; e < a.wfrag / 8; e += nthreads) ws[e] = wg[e];
  }
  WConv* convs = reinterpret_cast<WConv*>(smem + l.tables);
  uint64_t* kst = reinterpret_cast<uint64_t*>(convs + 3 * a.nblk);
  for (int e = tid; e < 3 * a.nblk; e += nthreads) convs[e] = a.conv[e];
  // A's descriptor at output position 0, its address relative to the
  // warpgroup's region (a warpgroup adds its region's, and an m-tile
  // 64 positions: the 14-bit address field cannot carry, all of shared
  // memory lying below 256 KB)
  for (int e = tid; e < a.nkst; e += nthreads)
    kst[e] = wf::gmma_desc(a.kst[e].x, a.kst[e].y, 128, 0);
  __syncthreads();

  const int wg = tid >> 7;
  Ctx c;
  c.region = smem + l.regions + wg * a.region;
  c.raddr = wf::smem_addr(c.region);
  c.waddr = wf::smem_addr(smem + l.w);
  c.vec = vec;
  c.kst = kst;
  c.w0 = a.w0;
  c.xmax = a.tile_rows * a.w0 - 1;
  c.t = tid & 127;
  const int ntiles = (a.rows + a.tile_rows - 1) / a.tile_rows;
  const int step = gridDim.x * a.wgs;
  const WConv& last = convs[3 * a.nblk - 1];
  const int per = last.co * (last.q - 2);   // elements of an output row
  int tile = blockIdx.x * a.wgs + wg;
  int xoff = tile < ntiles ? fetch_x(a, c.region, tile, c.t) : 0;
  for (; tile < ntiles; tile += step) {
    wf::cp_async_wait<0>();
    bar_wg(wg);   // the input rows landed; the last tile's output has left
    c.xs = reinterpret_cast<const bf16*>(c.region) + xoff;
    for (int k = 0; k < 3 * a.nblk; ++k) {
      const WConv cv = convs[k];
      if (cv.kind == 1) {
        conv_first_w(c, cv);
      } else {
        switch (cv.nt) {
          case 1: conv<1>(c, cv); break;
          case 2: conv<2>(c, cv); break;
          case 3: conv<3>(c, cv); break;
          case 4: conv<4>(c, cv); break;
          case 5: conv<5>(c, cv); break;
          case 6: conv<6>(c, cv); break;
          case 7: conv<7>(c, cv); break;
          case 8: conv<8>(c, cv); break;
        }
      }
      // the epilogue's stores, seen by the next conv's wgmma reads
      wf::fence_proxy_async();
      bar_wg(wg);
      // the input rows are read for the last time by block 0's conv3:
      // fetch the next tile's
      if (k == 2 && tile + step < ntiles)
        xoff = fetch_x(a, c.region, tile + step, c.t);
    }
    // the output rows, [row][C][W] in the last slot, are contiguous in
    // device memory: 16-byte copies
    const int row0 = tile * a.tile_rows;
    const int valid = min(a.tile_rows, a.rows - row0);
    const uint4* src = reinterpret_cast<const uint4*>(c.region + last.dst);
    uint4* dst = reinterpret_cast<uint4*>(a.out + (size_t)row0 * per);
    for (int i = c.t; i < valid * per / 8; i += 128) dst[i] = src[i];
  }
}

template <typename T>
__global__ void __launch_bounds__(sizeof(T) == 2 ? kWThreads : kThreads, 1)
    conv_stack_kernel(const StackArgs<T> a) {
  if constexpr (sizeof(T) == 2)
    stack_wgmma(a);
  else
    stack_fma(a);
}

// The plan must add up: channels in 8s, rows 16-byte aligned and wide
// enough, enough reduction steps for the chunks, blocks chained.
bool plan_ok(const StackArgs<int>& a, int esize, size_t smem) {
  if (a.nblk < 1 || a.nblk > kMaxBlocks || a.tile_rows < 1 ||
      a.row_elems % 8 != 0 || a.row_elems < a.w0 || a.wfrag % 8 != 0 ||
      (esize == 4 && a.wfrag != 0))
    return false;
  int cin = 1, win = a.w0, ld = 1;
  for (int k = 0; k < a.nblk; ++k) {
    const BlockSpec& b = a.blk[k];
    if (b.ci != cin || b.win != win || b.ld_in != ld || b.co % 8 != 0 ||
        (b.ci != 1 && b.ci % 8 != 0) || b.ld_out % 8 != 0 ||
        b.ld_out < b.co || b.stride < 1 ||
        b.wout != (b.win - 1) / b.stride + 1 ||
        b.wout * b.ld_out > a.row_elems || b.ld_out * esize > kZeroBytes)
      return false;
    const int chunks[3] = {3 * b.ci / 8, 3 * b.co / 8,
                           3 * b.co / 8 + (b.ci == 1 ? 0 : b.ci / 8)};
    for (int j = 0; j < 3; ++j) {
      const ConvSpec& s = b.conv[j];
      if (j == 0 && b.ci == 1) continue;
      if (2 * s.ksteps < chunks[j] || !unit_shape_ok(s.mtu, s.nt) ||
          (b.co / 8) % s.nt != 0 ||
          s.woff < 0 || s.woff % 8 != 0 || s.boff < 0 ||
          s.boff + b.co > a.nvec)
        return false;
    }
    if (b.ci == 1 && (b.w1off < 0 || b.wdoff < 0 ||
                      b.w1off + 3 * b.co > a.nvec || b.wdoff + b.co > a.nvec))
      return false;
    cin = b.co;
    win = b.wout;
    ld = b.ld_out;
  }
  const Layout l = layout(a.nvec, a.wfrag, a.tile_rows, a.row_elems, esize);
  return (size_t)l.total == smem && l.total <= kSmemLimit;
}

template <typename T>
int run(const void* x, void* out, int rows, int w0, int tile_rows,
        int row_elems, int grid, int nblk, const int* dims, const void* w,
        const float* vec, int nvec, int wfrag, size_t smem, void* stream) {
  if (nblk < 1 || nblk > kMaxBlocks || grid < 1 || rows < 1)
    return (int)cudaErrorInvalidValue;
  StackArgs<int> shape{};
  shape.rows = rows;
  shape.w0 = w0;
  shape.tile_rows = tile_rows;
  shape.row_elems = row_elems;
  shape.nvec = nvec;
  shape.wfrag = wfrag;
  shape.nblk = nblk;
  for (int k = 0; k < nblk; ++k) {
    const int* d = dims + kDimsPerBlock * k;
    BlockSpec& b = shape.blk[k];
    b.ci = d[0]; b.co = d[1]; b.stride = d[2]; b.win = d[3]; b.wout = d[4];
    b.ld_in = d[5]; b.ld_out = d[6];
    for (int j = 0; j < 3; ++j) {
      const int* cj = d + 7 + 5 * j;
      b.conv[j] = ConvSpec{cj[0], cj[1], cj[2], cj[3], cj[4]};
    }
    b.w1off = d[22]; b.wdoff = d[23];
  }
  if (!plan_ok(shape, (int)sizeof(T), smem)) return (int)cudaErrorInvalidValue;
  StackArgs<T> a{};
  a.x = static_cast<const T*>(x);
  a.out = static_cast<T*>(out);
  a.w = w;
  a.vec = vec;
  a.rows = rows; a.w0 = w0; a.tile_rows = tile_rows;
  a.row_elems = row_elems; a.nvec = nvec; a.wfrag = wfrag; a.nblk = nblk;
  for (int k = 0; k < nblk; ++k) a.blk[k] = shape.blk[k];
  cudaError_t err = cudaFuncSetAttribute(
      conv_stack_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return (int)err;
  conv_stack_kernel<T><<<grid, kThreads, smem,
                         static_cast<cudaStream_t>(stream)>>>(a);
  return (int)cudaGetLastError();
}

// The bf16 plan must add up: every conv's widths chained from w0, its
// k-steps' views and its writes inside the warpgroup's region, its weights
// and vectors inside theirs, the shared memory as the plan counts it.
bool plan_ok_w(const WArgs& a, size_t smem) {
  if (a.nblk < 1 || a.nblk > kMaxBlocks || a.wgs < 2 || a.wgs > kMaxWGs ||
      a.tile_rows < 1 || a.rows < 1 || a.w0 < 1 || a.nkst < 1 ||
      a.nkst > kMaxKsteps || a.wfrag % 8 != 0 || a.region % 16 != 0 ||
      a.xbuf % 16 != 0 || a.xbuf < a.tile_rows * a.w0 * 2 + 32 ||
      a.region < a.xbuf)
    return false;
  int win = a.w0;
  for (int i = 0; i < 3 * a.nblk; ++i) {
    const WConv& c = a.conv[i];
    const int k = i / 3, j = i % 3;
    const bool last = i == 3 * a.nblk - 1;
    if (c.nt < 1 || c.nt > kMaxWNT || c.co != 8 * c.nt ||
        (c.stride != 1 && c.stride != 2) || c.q < 3 || c.q >= 2048 ||
        c.mp + kMTile >= (1 << 16) ||
        c.q - 2 != (j == 0 ? (win - 1) / c.stride + 1 : win) ||
        c.mp != a.tile_rows * c.q || c.boff < 0 || c.boff % 2 != 0 ||
        c.boff + c.co > a.nvec || c.dst < a.xbuf || c.dst % 16 != 0 ||
        c.dst_pb % 16 != 0 || (c.dst_p == 0) != last || c.dst_p < 0 ||
        c.dst_p > 2)
      return false;
    win = c.q - 2;
    if (c.kind == 1) {
      if (i != 0 || c.dst_p != 1 || c.w1off < 0 ||
          c.w1off + 3 * c.co > a.nvec)
        return false;
    } else {
      if (c.kind != 0 || c.ksteps < 1 || c.kfirst < 0 ||
          c.kfirst + c.ksteps > a.nkst || c.woff < 0 || c.woff % 16 != 0 ||
          c.woff + c.ksteps * 256 * c.nt > a.wfrag * 2)
        return false;
      const int span = (c.mp + kMTile - 1) / kMTile * kMTile * kPos;
      for (int s = 0; s < c.ksteps; ++s) {
        const int2 v = a.kst[c.kfirst + s];
        if (v.x < 0 || v.x % 16 != 0 || v.y < 16 || v.y % 16 != 0 ||
            v.y >= (1 << 18) || v.x + v.y + span > a.region + kSlack)
          return false;
      }
    }
    if (c.wdoff >= 0 && (k != 0 || j != 2 || c.wdoff % 2 != 0 ||
                         c.wdoff + c.co > a.nvec))
      return false;
    // the planes hold every position written
    if (c.dst_p == 0) {
      if (c.dst + a.tile_rows * c.co * win * 2 > a.region) return false;
    } else if (c.dst_p == 1) {
      if (c.dst_pb < c.mp * kPos || c.dst + c.nt * c.dst_pb > a.region)
        return false;
    } else {
      if (c.dst_q < (c.q - 1) / 2 + 1 ||
          c.dst_pb < a.tile_rows * c.dst_q * kPos ||
          c.dst + 2 * c.nt * c.dst_pb > a.region)
        return false;
    }
  }
  const WLayout l = wlayout(a);
  return (size_t)l.total == smem && l.total <= kSmemLimit;
}

int run_wgmma(const void* x, void* out, int rows, int w0, int tile_rows,
              int wgs, int grid, int nblk, const int* dims, const void* w,
              const float* vec, int nvec, int wfrag, size_t smem,
              void* stream) {
  if (nblk < 1 || nblk > kMaxBlocks || grid < 1 || dims[2] < 1 ||
      dims[2] > kMaxKsteps || reinterpret_cast<uintptr_t>(out) % 16 != 0 ||
      reinterpret_cast<uintptr_t>(w) % 16 != 0)
    return (int)cudaErrorInvalidValue;
  StackArgs<bf16> a{};
  a.x = static_cast<const bf16*>(x);
  a.out = static_cast<bf16*>(out);
  a.w = w;
  a.vec = vec;
  a.rows = rows; a.w0 = w0; a.tile_rows = tile_rows; a.wgs = wgs;
  a.nvec = nvec; a.wfrag = wfrag; a.nblk = nblk;
  a.region = dims[0]; a.xbuf = dims[1]; a.nkst = dims[2];
  const int* d = dims + 3;
  for (int i = 0; i < 3 * nblk; ++i, d += 16)
    a.conv[i] = WConv{d[0], d[1], d[2],  d[3],  d[4],  d[5],  d[6],  d[7],
                      d[8], d[9], d[10], d[11], d[12], d[13], d[14], d[15]};
  for (int s = 0; s < a.nkst; ++s, d += 2) a.kst[s] = make_int2(d[0], d[1]);
  if (!plan_ok_w(a, smem)) return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaFuncSetAttribute(
      conv_stack_kernel<bf16>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return (int)err;
  conv_stack_kernel<bf16><<<grid, 128 * wgs, smem,
                            static_cast<cudaStream_t>(stream)>>>(a);
  return (int)cudaGetLastError();
}

}  // namespace

// float32: tile_rows and row_elems as named; dims per block 24 ints (ci,
// co, stride, win, wout, ld_in, ld_out, then per conv ksteps, mtu, nt, woff,
// boff, then w1off, wdoff).  bfloat16: tile_rows the rows of a
// warpgroup's tile, row_elems the warpgroups a block; dims region, xbuf,
// k-steps, then 16 ints a conv (WConv) and 2 a k-step.  A host array.
extern "C" int conv_stack_forward(int dtype, const void* x, void* out,
                                  int rows, int w0, int tile_rows,
                                  int row_elems, int grid, int nblk,
                                  const int* dims, const void* w,
                                  const float* vec, int nvec, int wfrag,
                                  size_t smem_bytes, void* stream) {
  if (dtype == wf::kF32)
    return run<float>(x, out, rows, w0, tile_rows, row_elems, grid, nblk, dims,
                      w, vec, nvec, wfrag, smem_bytes, stream);
  if (dtype == wf::kBF16)
    return run_wgmma(x, out, rows, w0, tile_rows, row_elems, grid, nblk,
                     dims, w, vec, nvec, wfrag, smem_bytes, stream);
  return (int)cudaErrorInvalidValue;
}

WF_EXPORT_ERROR_STRING
