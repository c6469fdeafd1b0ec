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
// operations.  In practice two more things bound it: the weights (up to
// three 540 x 540 matrices, 1.75 MB a level in bf16), which every block
// reads from L2 once per tile of rows, and the shared-memory traffic of
// mma.sync's operands.
//
// Design.  The launch plan (rows a tile, layouts, ring, weight offsets,
// grid) is ops/kernels/tcn_level.py::tcn_plan; the C side refuses a plan
// that does not add up.  One launch a level, one block an SM (16 warps, at
// most 128 registers a thread), each block walking tiles of whole samples
// (3 of T = 20, 60 rows padded to 64, in bf16), so the causal dilated taps
// never leave the block.
//   Activations live in two shared-memory buffers, channel-last, in one of
//     two layouts.  Dense: channel c at column c, the row padded to 16
//     channels (a k-step) and to an odd number of 16-byte words, so that
//     ldmatrix meets no bank conflict; the pointwise products read it.
//     Group-padded: group g's channels start at column g * cgp, cgp the
//     group width rounded up to 8 (16 bytes), so that every 8-channel chunk
//     of a group is one ldmatrix row; the grouped convs read it.  The
//     buffers take turns: x (grouped) -> h1 (dense) -> h2 (grouped) -> h3
//     (dense); x is read again, dense, for the residual.
//   Pointwise products on mma.sync m16n8k16 (bf16, fp32 accumulation): the
//     16 warps are 2 x 8, a warp's tile is 32 rows x up to 9 n-tiles of 8
//     columns (every n-tile eighth, so the last ones are shared out evenly),
//     so each A fragment feeds up to 9 products and each B fragment 2; one
//     pass over K covers all of N.  The weights, packed by the packer in
//     the order the B fragments are read (one 8-byte load a lane a
//     fragment), stream through a ring of 4 stages in shared memory, one
//     16-deep k-step of all N columns a stage, each filled by one bulk copy
//     (the TMA's 1-D form) that thread 0 issues, with no register staging.
//     mbarriers say when a slot has landed and when every warp has released
//     it, so no block barrier runs in the loop and a warp may run ahead of
//     the slowest by two k-steps.  The stream runs P1, P2 and D of every
//     tile of the block back to back, so P2's first stages arrive while the
//     grouped conv before it runs, and the next tile's P1 while this tile's
//     epilogue runs.  The shortcut D accumulates on top of y + e in the same
//     registers: out = silu(y + e + x @ D), staged through shared memory so
//     that the tile leaves in coalesced stores.
//   Grouped convs on mma.sync too: a warp takes one group and 32 rows; K is
//     the 3 taps x cgp channels in 8-channel chunks, each chunk an ldmatrix
//     of the group's columns at rows shifted by (2 - j) * d, or the zero
//     row where t < shift.  Their weights (up to 123 KB a conv, which does
//     not fit beside the activations and the ring) are read as packed B
//     fragments from device memory through L1, each feeding both 16-row
//     halves.
//   fp32, the check type, runs the same layouts on CUDA-core FMAs with 32
//     rows a tile, its weights read from device memory.
//   No atomics: a launch repeats bit for bit.
// The TPU kernel's block-diagonal packing of the grouped taps is not
// carried over.
#include "common.cuh"
#include "mma.cuh"

namespace {

using bf16 = __nv_bfloat16;
constexpr int kThreads = 512;
constexpr int kWarps = kThreads / 32;
constexpr int kWarpRows = 2;          // warps along M
constexpr int kWarpCols = kWarps / kWarpRows;
constexpr int kMaxNTW = 9;            // n-tiles of a warp in a product
constexpr int kMaxNTG = 4;            // n-tiles of a group (32 channels)
constexpr int kStages = 4;            // the weight ring
constexpr int kZeroBytes = 32;        // one 8-channel chunk of zeros
constexpr int kSmemLimit = 232448;

// m-tiles (16 rows) of a warp: bf16 64 rows a tile, fp32 32.
template <typename T>
struct Tiles {
  static constexpr int kMT = sizeof(T) == 2 ? 2 : 1;
  static constexpr int kRows = kWarpRows * kMT * 16;
};

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
  int cgp_in, cgp_out;                // padded group widths
  int ldg_in, ldd_in, ldg_out, ldd_out;
  int buf0, buf1;                     // elements a row of each buffer
  int ntiles;                         // n-tiles of the pointwise products
  int ks_g1, ks_g2, ks_p1, ks_p2, ks_d;
  int off_g1, off_g2, off_p1, off_p2, off_d;   // elements of w
  int smem;
};

__host__ __device__ constexpr int align16(int v) { return (v + 15) / 16 * 16; }

struct Layout {
  int buf0, buf1, zero, tab, ring, bars, total;
};

__host__ __device__ inline Layout layout(const LevelArgs& a, int esize,
                                         int rows) {
  Layout l;
  l.buf0 = 0;
  l.buf1 = l.buf0 + align16(rows * a.buf0 * esize);
  l.zero = l.buf1 + align16(rows * a.buf1 * esize);
  l.tab = l.zero + kZeroBytes;
  l.ring = l.tab + align16(2 * (a.cin + a.cout));
  l.bars = l.ring + (esize == 2 ? kStages * a.ntiles * 256 : 0);
  l.total = l.bars + (esize == 2 ? 2 * kStages * 8 : 0);
  return l;
}

// ---------------------------------------------------------------------------
// the weight ring (bf16): the block's stream of 16-deep k-steps of P1, P2
// and D, tile after tile of rows; thread 0 copies, every warp consumes
// ---------------------------------------------------------------------------
struct Ring {
  unsigned char* base;        // kStages slots of `bytes`
  const unsigned char* src;   // the stream of one tile of rows
  int bytes;                  // a slot: ntiles * 256
  int per_tile;               // k-steps of the stream per tile of rows
  int total;                  // k-steps this block will use
  int issued, used;
  uint64_t* full;             // [kStages]: the slot's copy has landed
  uint64_t* empty;            // [kStages]: every warp is done with it

  __device__ void init() {    // one thread
    for (int s = 0; s < kStages; ++s) {
      wf::mbar_init(full + s, 1);
      wf::mbar_init(empty + s, kWarps);
    }
    wf::mbar_init_fence();
  }
  // Thread 0 copies the next k-step into its slot, once every warp has
  // released the k-step that slot held.
  __device__ void issue() {
    if (issued < total) {
      const int slot = issued % kStages;
      if (issued >= kStages) wf::mbar_wait(empty + slot, (issued / kStages - 1) & 1);
      wf::bulk_copy_g2s(base + slot * bytes,
                        src + (size_t)(issued % per_tile) * bytes, bytes,
                        full + slot);
    }
    ++issued;
  }
  __device__ void start() {
    if (threadIdx.x == 0)
      for (int s = 0; s < kStages - 1; ++s) issue();
  }
  // The next k-step's slot, once its copy has landed.  A warp waits for
  // no other warp: it may run up to kStages - 2 k-steps ahead of the
  // slowest.
  __device__ const uint2* acquire() {
    if (threadIdx.x == 0) issue();
    const int slot = used % kStages;
    wf::mbar_wait(full + slot, (used / kStages) & 1);
    ++used;
    return reinterpret_cast<const uint2*>(base + slot * bytes);
  }
  // The warp is done with the slot acquire() gave it last.
  __device__ void release() {
    __syncwarp();
    if ((threadIdx.x & 31) == 0) wf::mbar_arrive(empty + (used - 1) % kStages);
  }
};

// ---------------------------------------------------------------------------
// pointwise products: acc[mt][i] += A[rows of the warp, K] x W[K, n-tile
// wn + 8 i]; thread slot q of an accumulator is row gid + 8 (q / 2),
// column 2 tig + q % 2
// ---------------------------------------------------------------------------
template <typename T>
using Acc = float[Tiles<T>::kMT][kMaxNTW][4];

__device__ __forceinline__ void pw_product(Acc<bf16>& acc, const bf16* a,
                                           int lda, int ksteps, int ntiles,
                                           Ring& ring, const void*) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int wm = warp / kWarpCols, wn = warp % kWarpCols;
  constexpr int MT = Tiles<bf16>::kMT;
  const bf16* arow = a + (wm * MT * 16 + (lane & 15)) * lda + 8 * (lane >> 4);
  for (int ks = 0; ks < ksteps; ++ks) {
    const uint2* tile = ring.acquire();
    uint32_t af[MT][4];
#pragma unroll
    for (int mt = 0; mt < MT; ++mt)
      wf::ldmatrix_x4(af[mt], arow + mt * 16 * lda + ks * 16);
#pragma unroll
    for (int i = 0; i < kMaxNTW; ++i) {
      const int j = wn + kWarpCols * i;
      if (j >= ntiles) break;
      const uint2 b2 = tile[j * 32 + lane];
      const uint32_t bfr[2] = {b2.x, b2.y};
#pragma unroll
      for (int mt = 0; mt < MT; ++mt) wf::mma_bf16(acc[mt][i], af[mt], bfr);
    }
    ring.release();
  }
}

// fp32: the weights [K_pad, ntiles * 8] from device memory
__device__ __forceinline__ void pw_product(Acc<float>& acc, const float* a,
                                           int lda, int ksteps, int ntiles,
                                           Ring&, const void* wsrc) {
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

template <typename T>
__device__ __forceinline__ void zero_acc(Acc<T>& acc) {
#pragma unroll
  for (int mt = 0; mt < Tiles<T>::kMT; ++mt)
#pragma unroll
    for (int i = 0; i < kMaxNTW; ++i)
#pragma unroll
      for (int q = 0; q < 4; ++q) acc[mt][i][q] = 0.f;
}

// Calls f(row, col, acc slot) for every slot of the warp's tile inside
// [0, rows) x [0, n).
template <typename T, typename F>
__device__ __forceinline__ void for_each_slot(Acc<T>& acc, int ntiles, int n,
                                              F&& f) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int wm = warp / kWarpCols, wn = warp % kWarpCols;
  const int gid = lane >> 2, tig = lane & 3;
  constexpr int MT = Tiles<T>::kMT;
#pragma unroll
  for (int mt = 0; mt < MT; ++mt)
#pragma unroll
    for (int i = 0; i < kMaxNTW; ++i) {
      const int j = wn + kWarpCols * i;
      if (j >= ntiles) break;
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        const int row = (wm * MT + mt) * 16 + gid + 8 * (q >> 1);
        const int col = j * 8 + 2 * tig + (q & 1);
        if (col < n) f(row, col, acc[mt][i][q]);
      }
    }
}

// ---------------------------------------------------------------------------
// grouped causal convs: dst (dense) = silu(b + sum_j x[t - (2-j) d] @ W_j)
// per group, src group-padded
// ---------------------------------------------------------------------------
struct Grouped {
  int ch, groups, cgp, lds, ldd, ksteps, dil;
  wf::FastDiv by_steps;   // row -> time step
};

// The shared-memory row of chunk q (tap j = q / cc8, 8 channels c8 = q %
// cc8 of group g) for tile row m at time t, or the zero row.
template <typename T>
__device__ __forceinline__ const T* group_row(const T* src, const T* zero,
                                              const Grouped& c, int g, int q,
                                              int m, int t) {
  const int cc8 = c.cgp / 8;
  const int j = q / cc8;
  if (j >= 3) return zero;
  const int shift = (2 - j) * c.dil;
  if (t < shift) return zero;
  return src + (m - shift) * c.lds + g * c.cgp + 8 * (q - j * cc8);
}

__device__ __forceinline__ void group_product(
    float (&acc)[Tiles<bf16>::kMT][kMaxNTG][4], const bf16* src,
    const bf16* zero, const Grouped& c, int g, int m0, int ntg,
    const void* wsrc) {
  constexpr int MT = Tiles<bf16>::kMT;
  const int lane = threadIdx.x & 31;
  int m[MT], t[MT];
#pragma unroll
  for (int mt = 0; mt < MT; ++mt) {
    m[mt] = m0 + mt * 16 + (lane & 15);
    t[mt] = c.by_steps.mod(m[mt]);
  }
  // the group's B fragments, [kstep][n-tile][lane], from device memory
  // (loading them all first, or 3 k-steps at a time, spilled registers and
  // measured slower on the H100)
  const uint2* wg = static_cast<const uint2*>(wsrc) +
                    (size_t)g * c.ksteps * ntg * 32 + lane;
  for (int ks = 0; ks < c.ksteps; ++ks) {
    uint32_t af[MT][4];
#pragma unroll
    for (int mt = 0; mt < MT; ++mt)
      wf::ldmatrix_x4(af[mt], group_row(src, zero, c, g, 2 * ks + (lane >> 4),
                                        m[mt], t[mt]));
#pragma unroll
    for (int nt = 0; nt < kMaxNTG; ++nt) {
      if (nt >= ntg) break;
      const uint2 b2 = __ldg(wg + (ks * ntg + nt) * 32);
      const uint32_t bfr[2] = {b2.x, b2.y};
#pragma unroll
      for (int mt = 0; mt < MT; ++mt) wf::mma_bf16(acc[mt][nt], af[mt], bfr);
    }
  }
}

// fp32: the group's weights [K_pad, ntg * 8] from device memory
__device__ __forceinline__ void group_product(
    float (&acc)[Tiles<float>::kMT][kMaxNTG][4], const float* src,
    const float* zero, const Grouped& c, int g, int m0, int ntg,
    const void* wsrc) {
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
        acc[0][nt][0] += x0 * wv.x;
        acc[0][nt][1] += x0 * wv.y;
        acc[0][nt][2] += x1 * wv.x;
        acc[0][nt][3] += x1 * wv.y;
      }
    }
  }
}

// A warp takes a group and one of the two row halves of the tile.
template <typename T>
__device__ void grouped_conv(const T* src, T* dst, const T* zero,
                             const Grouped& c, const void* wsrc,
                             const float* __restrict__ bias) {
  constexpr int MT = Tiles<T>::kMT;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int gid = lane >> 2, tig = lane & 3;
  const int cg = c.ch / c.groups, ntg = (cg + 7) / 8;
  for (int u = warp; u < c.groups * kWarpRows; u += kWarps) {
    const int g = u / kWarpRows, m0 = (u - g * kWarpRows) * MT * 16;
    float acc[MT][kMaxNTG][4];
#pragma unroll
    for (int mt = 0; mt < MT; ++mt)
#pragma unroll
      for (int nt = 0; nt < kMaxNTG; ++nt)
#pragma unroll
        for (int q = 0; q < 4; ++q) acc[mt][nt][q] = 0.f;
    group_product(acc, src, zero, c, g, m0, ntg, wsrc);
#pragma unroll
    for (int mt = 0; mt < MT; ++mt)
#pragma unroll
      for (int nt = 0; nt < kMaxNTG; ++nt) {
        if (nt >= ntg) break;
#pragma unroll
        for (int q = 0; q < 4; ++q) {
          const int o = nt * 8 + 2 * tig + (q & 1);
          if (o >= cg) continue;
          const int row = m0 + mt * 16 + gid + 8 * (q >> 1);
          const int col = g * cg + o;
          dst[row * c.ldd + col] =
              wf::from_f<T>(wf::silu(acc[mt][nt][q] + bias[col]));
        }
      }
  }
}

// ---------------------------------------------------------------------------
// the level
// ---------------------------------------------------------------------------
template <typename T>
__global__ void __launch_bounds__(kThreads, 1) tcn_level_kernel(
    const LevelArgs a) {
  extern __shared__ __align__(16) unsigned char smem[];
  constexpr int ROWS = Tiles<T>::kRows;
  const Layout l = layout(a, (int)sizeof(T), ROWS);
  T* buf0 = reinterpret_cast<T*>(smem + l.buf0);
  T* buf1 = reinterpret_cast<T*>(smem + l.buf1);
  const T* zero = reinterpret_cast<const T*>(smem + l.zero);
  // the group-padded column of each channel, in and out
  short* gpos_in = reinterpret_cast<short*>(smem + l.tab);
  short* gpos_out = gpos_in + a.cin;
  const T* x = static_cast<const T*>(a.x);
  T* out = static_cast<T*>(a.out);
  const T* w = static_cast<const T*>(a.w);
  const int tid = threadIdx.x;
  const int cg_in = a.cin / a.groups, cg_out = a.cout / a.groups;
  const int tile_rows = a.samples * a.steps;
  const int ntm = (a.batch + a.samples - 1) / a.samples;

  // every row of both buffers starts finite (zero): padding columns and
  // rows are multiplied by zero weights or never stored
  for (int e = tid; e < l.ring / 16; e += kThreads)
    reinterpret_cast<uint4*>(smem)[e] = make_uint4(0, 0, 0, 0);
  __syncthreads();
  for (int c = tid; c < a.cin; c += kThreads)
    gpos_in[c] = (short)(c / cg_in * a.cgp_in + c % cg_in);
  for (int c = tid; c < a.cout; c += kThreads)
    gpos_out[c] = (short)(c / cg_out * a.cgp_out + c % cg_out);

  Ring ring;
  ring.base = smem + l.ring;
  ring.src = reinterpret_cast<const unsigned char*>(w + a.off_p1);
  ring.bytes = a.ntiles * 256;
  ring.per_tile = a.ks_p1 + a.ks_p2 + a.ks_d;
  const int my_tiles =
      (int)blockIdx.x < ntm ? (ntm - 1 - blockIdx.x) / gridDim.x + 1 : 0;
  ring.total = sizeof(T) == 2 ? my_tiles * ring.per_tile : 0;
  ring.issued = ring.used = 0;
  ring.full = reinterpret_cast<uint64_t*>(smem + l.bars);
  ring.empty = ring.full + kStages;
  if (sizeof(T) == 2 && tid == 0) ring.init();
  __syncthreads();
  if (sizeof(T) == 2) ring.start();

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
      const T* xr = x + (row0 + m) * a.cin;
      for (int c = lane; c < a.cin; c += 32)
        buf0[m * a.ldg_in + gpos_in[c]] = xr[c];
    }
    __syncthreads();
    grouped_conv(buf0, buf1, zero, gc1, w + a.off_g1, a.g1b);   // h1
    __syncthreads();
    Acc<T> acc;
    zero_acc<T>(acc);
    pw_product(acc, buf1, a.ldd_in, a.ks_p1, a.ntiles, ring, w + a.off_p1);
    for_each_slot<T>(acc, a.ntiles, a.cout, [&](int row, int col, float v) {
      buf0[row * a.ldg_out + gpos_out[col]] =   // h2, group-padded
          wf::from_f<T>(wf::silu(v + a.p1b[col]));
    });
    __syncthreads();
    grouped_conv(buf0, buf1, zero, gc2, w + a.off_g2, a.g2b);   // h3
    __syncthreads();
    // x again, dense, for the residual
    for (int m = warp; m < valid; m += kWarps) {
      const T* xr = x + (row0 + m) * a.cin;
      for (int c = lane; c < a.cin; c += 32) buf0[m * a.ldd_in + c] = xr[c];
    }
    __syncthreads();
    zero_acc<T>(acc);
    pw_product(acc, buf1, a.ldd_out, a.ks_p2, a.ntiles, ring, w + a.off_p2);
    if (a.db != nullptr) {
      // y + e, then the shortcut accumulates on top
      for_each_slot<T>(acc, a.ntiles, a.cout, [&](int, int col, float& v) {
        v = wf::silu(v + a.p2b[col]) + a.db[col];
      });
      pw_product(acc, buf0, a.ldd_in, a.ks_d, a.ntiles, ring, w + a.off_d);
    } else {
      for_each_slot<T>(acc, a.ntiles, a.cout, [&](int row, int col, float& v) {
        v = wf::silu(v + a.p2b[col]) + wf::to_f(buf0[row * a.ldd_in + col]);
      });
    }
    // out = silu(acc), staged through buf1 (every warp is done with h3)
    // so that the tile's rows, contiguous in device memory, leave in
    // coalesced stores
    __syncthreads();
    for_each_slot<T>(acc, a.ntiles, a.cout, [&](int row, int col, float v) {
      buf1[row * a.ldd_out + col] = wf::from_f<T>(wf::silu(v));
    });
    __syncthreads();
    T* dst = out + row0 * a.cout;
    for (int e = tid; e < valid * a.cout; e += kThreads) {
      const int r = by_cout.div(e);
      dst[e] = buf1[r * a.ldd_out + e - r * a.cout];
    }
  }
}

int ceil_div(int a, int b) { return (a + b - 1) / b; }

// The plan must add up: layouts wide enough and aligned, enough k-steps
// for every reduction, the weight stream contiguous and 16-byte aligned.
bool plan_ok(const LevelArgs& a, int esize) {
  const int rows = esize == 2 ? Tiles<bf16>::kRows : Tiles<float>::kRows;
  if (a.groups < 1 || a.cin % a.groups || a.cout % a.groups || a.steps < 1 ||
      a.samples < 1 || a.samples * a.steps > rows || a.batch < 1 ||
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
  const Layout l = layout(a, esize, rows);
  return l.total == a.smem && a.smem <= kSmemLimit;
}

template <typename T>
int run(const LevelArgs& a, int grid, void* stream) {
  if (!plan_ok(a, (int)sizeof(T)) || grid < 1)
    return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaFuncSetAttribute(
      tcn_level_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      a.smem);
  if (err != cudaSuccess) return (int)err;
  tcn_level_kernel<T><<<grid, kThreads, a.smem,
                        static_cast<cudaStream_t>(stream)>>>(a);
  return (int)cudaGetLastError();
}

}  // namespace

// dims (host array, 28 ints): batch, steps, cin, cout, groups, dil,
// samples, cgp_in, cgp_out, ldg_in, ldd_in, ldg_out, ldd_out, buf0, buf1,
// ntiles, ks_g1, ks_g2, ks_p1, ks_p2, ks_d, grid, smem, off_g1, off_g2,
// off_p1, off_p2, off_d.  db null: the identity residual.
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
  if (dtype == wf::kF32) return run<float>(a, grid, stream);
  if (dtype == wf::kBF16) return run<bf16>(a, grid, stream);
  return (int)cudaErrorInvalidValue;
}

WF_EXPORT_ERROR_STRING
