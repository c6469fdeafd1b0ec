// The whole eval conv stack of WiFlow per (sample, time) row, for sm_90a.
//
// Replaces wiflow_tpu/ops/pallas/conv_stack.py:fused_conv_stack_eval
// (kernel body _make_kernel).  A row is one time step's features (240 in
// the flagship, 272 in MM-Fi); it goes through ConvBlock1 (1 -> 8
// channels, stride 1) and four stride-2 blocks (8/16/32/64 channels, width
// 240 -> 120 -> 60 -> 30 -> 15).  Each block, with BatchNorm folded in:
//   h1  = silu(conv1x3(x, stride) + b1)       reads x[s*w + d - 1], pad 1
//   h2  = silu(conv1x3(h1) + b2)
//   out = silu(conv1x3(h2) + b3 + x[s*w] @ D + e)
// h1, h2 and out are rounded to the storage type, as the Pallas kernel does.
//
// What bounds it on the H100: ~2.1 MFLOP per row (172 GFLOP at batch 4096)
// against 2.4 KB of device traffic per row in bf16, so by the card's
// roofline it is bound by operations (0.17 ms at the bf16 tensor-core
// peak).  What it really pays is shared-memory traffic (every product
// reads its operands from shared memory: 8-64 channels give short
// reductions and narrow tiles), the SiLU of 14,400 outputs a row, and one
// block barrier after each of the 15 convolutions.
//
// Design.  The launch plan (rows a tile, paddings, weight offsets, tiles of
// the products, grid) is ops/kernels/conv_stack.py::conv_stack_plan; the
// C side refuses a plan that does not add up.
//   Layout.  Activations are channel-last in shared memory, [row][position]
//     [channel], one position a padded row of ld elements: ld is a multiple
//     of 8 channels (16 bytes in bf16, one ldmatrix row) and an odd number
//     of 16-byte words, so the 8 rows of an ldmatrix fall in 8 different
//     bank groups.  Three slots take turns as a block's input, h1 and h2;
//     the block output overwrites h1 and is the next block's input.  The
//     row of 16-byte zeros stands in for every tap outside [0, W).
//   Products.  Every (1,3) conv with C_in >= 8 is an implicit GEMM on
//     mma.sync m16n8k16 (bf16 in, fp32 accumulation): M = the positions of
//     all rows of the tile, flattened, so a 16-row tile may span rows and
//     no row is padded; N = C_out; K = 8-channel chunks, tap-major.  Each
//     lane of an ldmatrix gives the address of its own 16-byte row, so a
//     chunk is a shifted view of the source: position s*w + d - 1 of the
//     lane's row, or the zero row.  conv3 and the strided 1x1 shortcut are
//     one GEMM with K = 3*C_out + C_in, one epilogue.  A warp's unit is
//     1-4 m-tiles of 16 positions x 1-4 n-tiles of 8 channels (at most 4
//     accumulator tiles; each A fragment feeds every n-tile, each B
//     fragment every m-tile); the plan picks the shape per conv from the
//     rounds of the 24 warps and the instructions a unit costs.  Index arithmetic uses wf::FastDiv, not integer division: the
//     kernel is bound by the instructions around its products (addresses,
//     epilogues, barriers), not by the tensor cores.  The epilogue adds the bias, applies SiLU once per element and
//     stores bf16x2 pairs.
//   Weights are packed once by the packer, bf16, in the order the B
//     fragments are read (one 8-byte load a lane a fragment), ~87 KB for
//     the five blocks.  A block stages them once and keeps them for its
//     life: the grid is one block an SM, 24 warps, walking many row tiles.
//   ConvBlock1's first conv (C_in = 1) is elementwise on CUDA cores: a
//     thread makes the 8 outputs of one position, one 16-byte store; its
//     1-channel shortcut is added in conv3's epilogue.
//   fp32, the check type, runs the same tiles and layout on CUDA-core FMAs,
//     its [K, N] weights read from device memory (L1) instead of staged.
//   The last block's output goes from its slot to device memory as [R,
//   C_last, W_last], rows of the tile contiguous, in coalesced stores.  No
//   atomics: a launch repeats bit for bit.
// The TPU kernel's space-to-depth banded layout exists for the (8, 128)
// tiles and is not carried over.
#include "common.cuh"
#include "mma.cuh"

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
  const void* w;       // bf16: B fragments; fp32: [K_pad, co] per conv
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

// A warp's unit: MTU m-tiles of 16 positions x NT n-tiles of 8 channels.
// Each A fragment feeds NT products and each B fragment MTU, and the
// unit's fixed costs (its rows' coordinates, the epilogue's bias) are paid
// once for MTU x NT tiles.  acc[u][nt] += positions (mt0 + u) * 16 .. x
// channels (nt0 + nt) * 8 ..; bf16 on the tensor cores, the B fragments
// packed as [kstep][n-tile][lane].
template <int MTU, int NT>
__device__ __forceinline__ void unit_product(float (&acc)[MTU][NT][4],
                                             const Conv<bf16>& c,
                                             const bf16* zero,
                                             const void* wsrc, int mt0,
                                             int nt0) {
  const int lane = threadIdx.x & 31;
  int r[MTU], w[MTU];
  bool valid[MTU];
#pragma unroll
  for (int u = 0; u < MTU; ++u) {
    const int m = (mt0 + u) * 16 + (lane & 15);
    valid[u] = m < c.m;
    r[u] = c.by_wout.div(m);
    w[u] = m - r[u] * c.wout;
  }
  const int ntot = c.co / 8;
  const uint2* bp =
      static_cast<const uint2*>(wsrc) + c.spec.woff / 4 + nt0 * 32 + lane;
  for (int ks = 0; ks < c.spec.ksteps; ++ks) {
    uint32_t bfr[NT][2];
#pragma unroll
    for (int nt = 0; nt < NT; ++nt) {
      const uint2 b2 = bp[(ks * ntot + nt) * 32];
      bfr[nt][0] = b2.x;
      bfr[nt][1] = b2.y;
    }
    // lanes 0-15 give chunk 2 ks of rows 0-15, lanes 16-31 chunk 2 ks + 1
    const int q = 2 * ks + (lane >> 4);
#pragma unroll
    for (int u = 0; u < MTU; ++u) {
      uint32_t af[4];
      wf::ldmatrix_x4(af, chunk_row(c, zero, q, valid[u], r[u], w[u]));
#pragma unroll
      for (int nt = 0; nt < NT; ++nt) wf::mma_bf16(acc[u][nt], af, bfr[nt]);
    }
  }
}

// The same tiles and accumulator layout in fp32 on CUDA cores: thread
// (gid, tig) owns rows gid and gid + 8 of each m-tile, columns 2 tig and
// 2 tig + 1 of each n-tile; the weights [K_pad, co] are read from device
// memory.
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
__device__ __forceinline__ void store2(bf16* p, float a, float b) {
  *reinterpret_cast<__nv_bfloat162*>(p) = __floats2bfloat162_rn(a, b);
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
__device__ __forceinline__ void store8(bf16* p, const float (&v)[8]) {
  uint4 u;
  u.x = wf::pack2(__float2bfloat16_rn(v[0]), __float2bfloat16_rn(v[1]));
  u.y = wf::pack2(__float2bfloat16_rn(v[2]), __float2bfloat16_rn(v[3]));
  u.z = wf::pack2(__float2bfloat16_rn(v[4]), __float2bfloat16_rn(v[5]));
  u.w = wf::pack2(__float2bfloat16_rn(v[6]), __float2bfloat16_rn(v[7]));
  *reinterpret_cast<uint4*>(p) = u;
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

template <typename T>
__global__ void __launch_bounds__(kThreads, 1)
    conv_stack_kernel(const StackArgs<T> a) {
  extern __shared__ __align__(16) unsigned char smem[];
  const Layout l =
      layout(a.nvec, a.wfrag, a.tile_rows, a.row_elems, (int)sizeof(T));
  float* vec = reinterpret_cast<float*>(smem + l.vec);
  const T* zero = reinterpret_cast<const T*>(smem + l.zero);
  T* slots = reinterpret_cast<T*>(smem + l.slots);
  const int slot_elems = a.tile_rows * a.row_elems;
  const int tid = threadIdx.x;

  // the block's constants, once: vectors, bf16 weights, the zero row
  for (int e = tid; e < a.nvec; e += kThreads) vec[e] = a.vec[e];
  const void* wsrc = a.w;
  if (sizeof(T) == 2) {
    uint4* ws = reinterpret_cast<uint4*>(smem + l.w);
    const uint4* wg = static_cast<const uint4*>(a.w);
    for (int e = tid; e < a.wfrag / 8; e += kThreads) ws[e] = wg[e];
    wsrc = ws;
  }
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

}  // namespace

// dims: per block 24 ints (ci, co, stride, win, wout, ld_in, ld_out, then
// per conv ksteps, mtu, nt, woff, boff, then w1off, wdoff), a host array.
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
    return run<bf16>(x, out, rows, w0, tile_rows, row_elems, grid, nblk, dims,
                     w, vec, nvec, wfrag, smem_bytes, stream);
  return (int)cudaErrorInvalidValue;
}

WF_EXPORT_ERROR_STRING
