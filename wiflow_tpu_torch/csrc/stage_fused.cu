// One train-mode stage, forward and backward, for sm_90a:
//   BatchNorm apply -> SiLU -> dropout -> convolution -> the next
//   BatchNorm's per-channel sums.
//
// Replaces wiflow_tpu/ops/pallas/stage_fused.py:stage, its forward
// (_fwd_kernel) and its backward (_bwd_kernel).  On x [rows, W_in, C_in]
// (channel-last), with the optional prologue vectors m, a, b [C_in], the
// optional keep-mask and the weight in torch's layout [C_out, C_in / G, K]:
//   act  = mask ? silu((x - m) * a + b) / keep : 0       (each part optional)
//   out[r, wo, co] = bias[co] + sum_{j, ci} act[r, wo * stride
//                    + (j - pad) * dil, ci] * w[co, ci, j]   (zero outside W)
//   sums = [sum, sum of squares] of out, rounded to the compute type, over
//          every (r, wo), per output channel: [2, C_out]
// which covers the model's five geometries: the grouped causal k=3 conv
// over T (pad 2, dilation d), the pointwise conv, the (1,3) conv over W
// with pad 1 and stride 1 or 2, and the 1x1 conv with stride 2.  The
// backward recomputes the prologue from x; with the output's total
// cotangent g = go + g_sum + 2 * out * g_sumsq, rounded to the compute
// type before the two products, it gives gx, gw (in the weight's layout),
// gbias (from the unrounded g) and, per input channel, A = sum(gu * x) and
// B = sum(gu) of the cotangent gu of u = (x - m) * a + b, returned as
// g_m = -a B, g_a = A - m B, g_b = B.
//
// What bounds it on the H100, at batch 256: by the rule of bytes and
// operations every stage is a few microseconds (the TCN's dense pointwise
// stages are 0.6-3.0 GFLOP against 5-11 MB, the grouped causal stages and
// every conv-stack stage 1-64 channels over up to 1.2 M positions, 10-40
// MB, bound by bytes).  What the kernels really pay is the instructions of
// the per-element work around the products (the prologue with its exp, the
// cotangent, the epilogues), run by too few warps to hide their
// latencies, and in the dense stages the weight matrix that every block
// pulls from L2.  So each element is transformed once, the products run
// on the tensor cores, and tiles and grids are sized for two blocks an SM.
//
// Design.  The launch plan (path, tiles, padding, grid, shared memory) is
// made by ops/kernels/stage_fused.py::stage_plan and checked here.
//   Staging, once per element.  A block owns a tile of whole rows of W
//     positions (or a strip of one long row with its halo) and every
//     channel of its groups.  It reads the operand tile with 8- or 16-byte
//     loads (a 540- or 340-channel bf16 row is no multiple of 16 bytes, so
//     a vector is 4 channels; 1 where a group's channels are odd), applies
//     the prologue and the mask (forward, weight gradient) or forms the
//     cotangent (input and weight gradient) once per element in registers,
//     and writes the compute-type tile to shared memory.  A thread starts
//     the loads of several positions before it uses any, and keeps one
//     channel vector for the whole tile, so its m, a, b are loaded once.
//     The taps are shifted views of that tile: a table maps (tap, output
//     position) to a tile row, or to a row of zeros outside [0, W).  The
//     loads go through registers, not cp.async, because every element is
//     transformed on the way.
//   Products.  bf16: mma.sync m16n8k16 fed by ldmatrix, fp32 accumulation
//     (mma.cuh).  Forward and input gradient are implicit GEMMs with M =
//     positions of the tile, N = the block's channels, K = taps x channels
//     of a group, padded to 16 (K) and 8 (N) in shared memory only; rows
//     are padded by 16 bytes so that ldmatrix meets no bank conflict.  A
//     warp takes units of 16 positions x up to 32 channels.  The weight
//     gradient is the GEMM with positions as K: both operands are
//     position-major in shared memory and are read with ldmatrix.trans;
//     a narrow stage's few output tiles are shared by the warps along K.
//     fp32 (the check type) runs the same tiles on CUDA-core FMAs with
//     float4 reads, no TF32.
//   Weights are converted to the compute type as they enter shared memory,
//     read along their contiguous axis.  Narrow and grouped stages keep all
//     of theirs for the block's life and walk many tiles.  The dense bf16
//     pointwise stages stream theirs: each warp pulls its own 8-column
//     slices through a cp.async ring (stage_stream_kernel).
//   The dense stages' weight gradient would stage its operands once per
//     tile of channels, so there the input gradient leaves them in device
//     memory as it made them (the rounded cotangent, the activation) and
//     the weight gradient copies them.
//   C_in = 1 (the conv stack's first two stages) is an elementwise pass: a
//     thread computes all outputs of one position and stores them as one
//     16-byte vector.
//   Reductions over positions (sums, A and B, gw, gbias) go through
//     per-block fp32 partials added in a fixed order (shuffles, then shared
//     memory) and wf::reduce_rows / wf::reduce_affine_grads in float64: no
//     atomics, the same bits every launch.
// The TPU kernel's block-diagonal packing of the grouped taps, its
// space-to-depth chunks and its sequential-grid accumulation are not
// carried over.
#include "mma.cuh"
#include "stage_common.cuh"


namespace {

using wf::kThreads;
using wf::round_to;
using wf::to_f;
using bf16 = __nv_bfloat16;

constexpr int kWarps = kThreads / 32;
constexpr int kMaxNT = 4;        // 8-column tiles of one warp unit
constexpr int kMaxUnits = 12;    // weight-gradient tiles of one warp
constexpr int kMaxDirectCo = 8;
constexpr int kSmemLimit = 232448;
enum Path : int { kDirect = 0, kMma = 1, kFma = 2, kStream = 3 };

struct Geom {
  int rows, win, wout, ci, co, groups, ktaps, stride, dil, pad;
};

struct ConvPlan {
  int path, rows, strip, strips, arows, gpb, kpad, npad, tnc, nchunks, nt,
      mtiles, vec, smem, grid_x;
};

struct WgradPlan {
  int path, rows, strip, strips, arows, kp, tmw, tnw, ntm, ntn, splits,
      steps_per_split, vec_g, vec_a, smem;
};

template <typename T>
struct StageArgs {
  const T* x;            // [rows, win, ci]
  const float* m;        // [ci] or null: no prologue
  const float* a;
  const float* b;
  wf::Mask mask;
  const float* w;        // [co, ci / groups, ktaps]
  const float* bias;     // [co] or null
  T* out;                // [rows, wout, co]
  float* partial;        // forward: [grid_x, 2, co], or null
  const T* go;           // backward: [rows, wout, co]
  const float* gsums;    // [2, co] or null
  T* gx;                 // [rows, win, ci]
  float* partial_ab;     // [grid_x, 2, ci], or null
  float* partial_w;      // [splits, ldw]: gw, then gbias when ldw > nw
  int ldw;
  // The operands of the weight gradient as the input gradient made them
  // (null: the weight gradient makes its own): the rounded cotangent
  // [rows, wout, co] and the activation [rows, win, ci].
  T* g_made;
  T* act_made;
  Geom g;
};

__host__ __device__ constexpr int align16(int v) { return (v + 15) / 16 * 16; }

// The sigmoid with the fast divide (2 ulp of fp32, far inside the fp32
// tolerance): the prologue runs once per element and these kernels are
// bound by the instructions they run, not by memory.
__device__ __forceinline__ float fast_sigmoid(float v) {
  return __fdividef(1.0f, 1.0f + __expf(-v));
}

// ---------------------------------------------------------------------------
// vectors of V channels: global loads, shared stores
// ---------------------------------------------------------------------------

template <int V>
__device__ __forceinline__ void load_vec(const float* p, float (&v)[V]) {
  if constexpr (V == 4) {
    const float4 q = *reinterpret_cast<const float4*>(p);
    v[0] = q.x; v[1] = q.y; v[2] = q.z; v[3] = q.w;
  } else {
    v[0] = *p;
  }
}

template <int V>
__device__ __forceinline__ void load_vec(const bf16* p, float (&v)[V]) {
  if constexpr (V == 4) {
    const uint2 q = *reinterpret_cast<const uint2*>(p);
    const __nv_bfloat162 lo = *reinterpret_cast<const __nv_bfloat162*>(&q.x);
    const __nv_bfloat162 hi = *reinterpret_cast<const __nv_bfloat162*>(&q.y);
    v[0] = __bfloat162float(lo.x); v[1] = __bfloat162float(lo.y);
    v[2] = __bfloat162float(hi.x); v[3] = __bfloat162float(hi.y);
  } else {
    v[0] = __bfloat162float(*p);
  }
}

template <int V>
__device__ __forceinline__ void store_vec(float* p, const float (&v)[V]) {
  if constexpr (V == 4) {
    *reinterpret_cast<float4*>(p) = make_float4(v[0], v[1], v[2], v[3]);
  } else {
    *p = v[0];
  }
}

template <int V>
__device__ __forceinline__ void store_vec(bf16* p, const float (&v)[V]) {
  if constexpr (V == 4) {
    uint2 q;
    q.x = wf::pack2(__float2bfloat16_rn(v[0]), __float2bfloat16_rn(v[1]));
    q.y = wf::pack2(__float2bfloat16_rn(v[2]), __float2bfloat16_rn(v[3]));
    *reinterpret_cast<uint2*>(p) = q;
  } else {
    *p = __float2bfloat16_rn(v[0]);
  }
}

// ---------------------------------------------------------------------------
// what a tile is made of: the activation the convolution reads, and the
// output's total cotangent.  A thread keeps the per-channel constants of
// its vector (Col) for the whole tile.
// ---------------------------------------------------------------------------

template <typename T>
struct Activation {
  const T* x;
  const float* m;
  const float* a;
  const float* b;
  wf::Mask mask;
  int channels;
  float inv_keep;   // 1 / mask.keep: kept values are scaled by it

  __device__ Activation(const T* x_, const float* m_, const float* a_,
                        const float* b_, const wf::Mask& mask_, int channels_)
      : x(x_), m(m_), a(a_), b(b_), mask(mask_), channels(channels_),
        inv_keep(1.0f / mask_.keep) {}

  template <int V>
  struct Col {
    float m[V], a[V], b[V];
  };
  template <int V>
  struct Raw {
    float v[V];
    uint32_t on;   // the mask, one byte per channel
  };

  template <int V>
  __device__ __forceinline__ void init(Col<V>& s, int c) const {
    if (a == nullptr) return;
#pragma unroll
    for (int i = 0; i < V; ++i) {
      s.m[i] = round_to<T>(m[c + i]);
      s.a[i] = round_to<T>(a[c + i]);
      s.b[i] = round_to<T>(b[c + i]);
    }
  }

  // what position q, channels c .. c + V, needs from device memory
  template <int V>
  __device__ __forceinline__ void load(Raw<V>& r, int q, int c) const {
    load_vec<V>(x + (size_t)q * channels + c, r.v);
    if (mask.bits != nullptr) {
      const uint8_t* mb = mask.bits + (size_t)(q / mask.div) * channels + c;
      if constexpr (V == 4) {
        r.on = *reinterpret_cast<const uint32_t*>(mb);
      } else {
        r.on = *mb;
      }
    }
  }

  // the values as the compute type holds them
  template <int V>
  __device__ __forceinline__ void finish(const Col<V>& s, const Raw<V>& r,
                                         float (&v)[V]) const {
#pragma unroll
    for (int i = 0; i < V; ++i) {
      v[i] = r.v[i];
      if (a != nullptr) {
        const float u = wf::bn_apply<T>(v[i], s.m[i], s.a[i], s.b[i]);
        v[i] = round_to<T>(u * fast_sigmoid(u));
      }
      if (mask.bits != nullptr)
        v[i] = (r.on >> (8 * i)) & 0xffu ? round_to<T>(v[i] * inv_keep) : 0.f;
    }
  }
};

template <typename T>
struct Cotangent {
  const T* go;
  const T* out;
  const float* gsums;    // [2, channels] or null
  int channels;

  template <int V>
  struct Col {
    float s0[V], s1[V];
  };
  template <int V>
  struct Raw {
    float g[V], o[V];
  };

  template <int V>
  __device__ __forceinline__ void init(Col<V>& s, int c) const {
    if (gsums == nullptr) return;
#pragma unroll
    for (int i = 0; i < V; ++i) {
      s.s0[i] = gsums[c + i];
      s.s1[i] = gsums[channels + c + i];
    }
  }

  template <int V>
  __device__ __forceinline__ void load(Raw<V>& r, int p, int c) const {
    load_vec<V>(go + (size_t)p * channels + c, r.g);
    if (gsums != nullptr) load_vec<V>(out + (size_t)p * channels + c, r.o);
  }

  // in fp32, before the rounding that the products see
  template <int V>
  __device__ __forceinline__ void finish(const Col<V>& s, const Raw<V>& r,
                                         float (&v)[V]) const {
#pragma unroll
    for (int i = 0; i < V; ++i) {
      v[i] = r.g[i];
      if (gsums != nullptr) v[i] += s.s0[i] + 2.f * r.o[i] * s.s1[i];
    }
  }
};

// How 256 threads share a tile of ncv channel vectors: `width` (a power of
// two) vectors side by side, kThreads / width positions per pass.
__device__ __forceinline__ int stage_width(int ncv) {
  int width = 1;
  while (width < ncv && width < kThreads) width <<= 1;
  return width;
}

// loads a thread has in flight while it stages: 4 where registers allow,
// 2 where it stages the cotangent (two loads an element) or holds the
// weight gradient's 48 accumulators
constexpr int kStageBatch = 4;
constexpr int kStageBatchSmall = 2;

// what stage_tile hands every valid vector to, where nobody wants them
struct NotSeen {
  template <int V>
  __device__ __forceinline__ void operator()(const float (&)[V]) const {}
};

// dst[p][col(c)] = f(pos0 + p, cb + c) for p < nvalid, 0 for nvalid <= p <
// npos; c runs over nca channels in groups of ca, group gl at column
// gl * kpad.  `seen` gets every valid vector in fp32, before rounding.  A
// thread starts the loads of B positions before it uses any.  `mirror`, if
// not null, is a tensor [positions, mirror_ld] that gets the valid values
// as the tile holds them.
template <typename T, int V, int B, typename F, typename Seen>
__device__ __forceinline__ void stage_tile(T* __restrict__ dst, int ld,
                                           const F& f, int pos0, int npos,
                                           int nvalid, int cb, int nca, int ca,
                                           int kpad, Seen&& seen,
                                           T* __restrict__ mirror,
                                           int mirror_ld) {
  const int ncv = nca / V, width = stage_width(ncv);
  const int step = kThreads / width;
  const int lane_c = threadIdx.x % width, p_first = threadIdx.x / width;
  for (int cv0 = 0; cv0 < ncv; cv0 += width) {
    const int cv = cv0 + lane_c;
    if (cv >= ncv) continue;
    const int cl = cv * V, gl = cl / ca;
    T* col = dst + gl * kpad + (cl - gl * ca);
    typename F::template Col<V> st;
    f.template init<V>(st, cb + cl);
    for (int p0 = p_first; p0 < npos; p0 += B * step) {
      typename F::template Raw<V> raw[B];
#pragma unroll
      for (int u = 0; u < B; ++u)
        if (p0 + u * step < nvalid)
          f.template load<V>(raw[u], pos0 + p0 + u * step, cb + cl);
#pragma unroll
      for (int u = 0; u < B; ++u) {
        const int p = p0 + u * step;
        if (p >= npos) break;
        float v[V];
        if (p < nvalid) {
          f.template finish<V>(st, raw[u], v);
          seen(v);
          if (mirror != nullptr)
            store_vec<V>(mirror + (size_t)(pos0 + p) * mirror_ld + cb + cl, v);
        } else {
#pragma unroll
          for (int i = 0; i < V; ++i) v[i] = 0.f;
        }
        store_vec<V>(col + (size_t)p * ld, v);
      }
    }
  }
}

template <int B = kStageBatch, typename T, typename F, typename Seen>
__device__ __forceinline__ void stage_tile_v(int vec, T* dst, int ld,
                                             const F& f, int pos0, int npos,
                                             int nvalid, int cb, int nca,
                                             int ca, int kpad, Seen&& seen,
                                             T* mirror = nullptr,
                                             int mirror_ld = 0) {
  if (vec == 4)
    stage_tile<T, 4, B>(dst, ld, f, pos0, npos, nvalid, cb, nca, ca, kpad,
                        seen, mirror, mirror_ld);
  else
    stage_tile<T, 1, B>(dst, ld, f, pos0, npos, nvalid, cb, nca, ca, kpad,
                        seen, mirror, mirror_ld);
}

// ---------------------------------------------------------------------------
// a tile of rows, or a strip of one row with its halo
// ---------------------------------------------------------------------------

struct Tile {
  int row0, rv;        // first row, valid rows
  int w0, sw;          // first output position of the strip, its length
  int a_lo, na;        // first A-side position staged per row, their count
};

__device__ __forceinline__ int floor_div(int a, int b) {
  return a >= 0 ? a / b : -((-a + b - 1) / b);
}

// Tile t of a launch whose rows hold wa A-side and wo output positions.
template <bool DGRAD>
__device__ __forceinline__ Tile tile_of(int t, const Geom& g, int rows_per,
                                        int strip, int strips, int wa,
                                        int wo) {
  Tile tl;
  tl.row0 = (t / strips) * rows_per;
  tl.rv = min(rows_per, g.rows - tl.row0);
  tl.w0 = (t % strips) * strip;
  tl.sw = min(strip, wo - tl.w0);
  tl.a_lo = 0;
  tl.na = wa;
  if (strips > 1) {
    int lo, hi;
    if (!DGRAD) {
      lo = tl.w0 * g.stride - g.pad * g.dil;
      hi = (tl.w0 + tl.sw - 1) * g.stride + (g.ktaps - 1 - g.pad) * g.dil;
    } else {
      lo = -floor_div(-(tl.w0 - (g.ktaps - 1 - g.pad) * g.dil), g.stride);
      hi = floor_div(tl.w0 + tl.sw - 1 + g.pad * g.dil, g.stride);
    }
    tl.a_lo = max(lo, 0);
    tl.na = max(0, min(hi, wa - 1) - tl.a_lo + 1);
  }
  return tl;
}

// src[j * mrows + m]: the tile row that tap j of output position m reads,
// zero_row outside; opos[m]: the output position in the tensor, or -1.
template <bool DGRAD>
__device__ __forceinline__ void fill_tables(int* src, int* opos, int mrows,
                                            const Tile& tl, const Geom& g,
                                            int strips, int rows_per, int wa,
                                            int wo, int zero_row) {
  for (int e = threadIdx.x; e < (g.ktaps + 1) * mrows; e += kThreads) {
    const int j = e / mrows, m = e - j * mrows;
    int r = 0, w = tl.w0 + m;
    bool valid = m < tl.sw;
    if (strips == 1) {
      r = m / wo;
      w = m - r * wo;
      valid = r < rows_per;
    }
    if (j == g.ktaps) {
      if (opos != nullptr)
        opos[m] = valid && r < tl.rv ? (tl.row0 + r) * wo + w : -1;
      continue;
    }
    int row = zero_row;
    if (valid) {
      int ai;
      bool ok;
      if (!DGRAD) {
        ai = w * g.stride + (j - g.pad) * g.dil;
        ok = ai >= 0 && ai < wa;
      } else {
        const int t = w - (j - g.pad) * g.dil;
        ai = t / g.stride;
        ok = t >= 0 && t % g.stride == 0 && ai < wa;
      }
      if (ok) row = r * tl.na + ai - tl.a_lo;
    }
    src[e] = row;
  }
}

// ---------------------------------------------------------------------------
// forward and input gradient: the implicit GEMM
// ---------------------------------------------------------------------------

template <typename T>
struct ConvSmem {
  int lda, ldb, as, ws, src, opos, colsum, run, total;
};

template <typename T>
__host__ __device__ ConvSmem<T> conv_smem(const ConvPlan& p, int ktaps) {
  ConvSmem<T> l;
  const int pad = 16 / (int)sizeof(T), mrows = p.mtiles * 16;
  l.lda = p.gpb * p.kpad + pad;
  l.ldb = ktaps * p.kpad + pad;
  l.as = 0;
  l.ws = l.as + align16((p.arows + 1) * l.lda * (int)sizeof(T));
  l.src = l.ws + align16(p.tnc * l.ldb * (int)sizeof(T));
  l.opos = l.src + ktaps * mrows * 4;
  l.colsum = l.opos + mrows * 4;
  l.run = l.colsum + 2 * p.mtiles * p.tnc * 4;
  l.total = l.run + 2 * p.nchunks * p.tnc * 4;
  return l;
}

// acc[nt][..] += rows mt*16.. of the tile (columns acol0..) x the weight
// tile's rows nrow0 + 8 nt.., every tap.  Accumulator slot q of a thread
// is row gid + 8 (q / 2), column 2 tig + q % 2 of its 8-column tile.
__device__ __forceinline__ void unit_product(
    float (&acc)[kMaxNT][4], const bf16* as, int lda, const int* src,
    int mrows, int zero_row, int mt, int acol0, const bf16* ws, int ldb,
    int nrow0, int nts, int ktaps, int kpad) {
  const int lane = threadIdx.x & 31;
  for (int j = 0; j < ktaps; ++j) {
    const int row = src[j * mrows + mt * 16 + (lane & 15)];
    if (__all_sync(0xffffffffu, row == zero_row)) continue;
    const bf16* ap = as + row * lda + acol0 + 8 * (lane >> 4);
    const bf16* bp =
        ws + (nrow0 + (lane & 7)) * ldb + j * kpad + 8 * ((lane >> 3) & 1);
    for (int ks = 0; ks < kpad; ks += 16) {
      uint32_t af[4];
      wf::ldmatrix_x4(af, ap + ks);
#pragma unroll
      for (int nt = 0; nt < kMaxNT; ++nt) {
        if (nt >= nts) break;
        uint32_t bfr[2];
        wf::ldmatrix_x2(bfr, bp + nt * 8 * ldb + ks);
        wf::mma_bf16(acc[nt], af, bfr);
      }
    }
  }
}

// the same product and accumulator layout in fp32 on CUDA cores
__device__ __forceinline__ void unit_product(
    float (&acc)[kMaxNT][4], const float* as, int lda, const int* src,
    int mrows, int zero_row, int mt, int acol0, const float* ws, int ldb,
    int nrow0, int nts, int ktaps, int kpad) {
  const int lane = threadIdx.x & 31, gid = lane >> 2, tig = lane & 3;
  for (int j = 0; j < ktaps; ++j) {
    const int r0 = src[j * mrows + mt * 16 + gid];
    const int r1 = src[j * mrows + mt * 16 + gid + 8];
    const float* a0 = as + r0 * lda + acol0;
    const float* a1 = as + r1 * lda + acol0;
    const float* wp = ws + (nrow0 + 2 * tig) * ldb + j * kpad;
    for (int k = 0; k < kpad; k += 4) {
      const float4 x0 = *reinterpret_cast<const float4*>(a0 + k);
      const float4 x1 = *reinterpret_cast<const float4*>(a1 + k);
#pragma unroll
      for (int nt = 0; nt < kMaxNT; ++nt) {
        if (nt >= nts) break;
#pragma unroll
        for (int c = 0; c < 2; ++c) {
          const float4 w4 = *reinterpret_cast<const float4*>(
              wp + (nt * 8 + c) * ldb + k);
          acc[nt][c] += x0.x * w4.x + x0.y * w4.y + x0.z * w4.z + x0.w * w4.w;
          acc[nt][2 + c] +=
              x1.x * w4.x + x1.y * w4.y + x1.z * w4.z + x1.w * w4.w;
        }
      }
    }
  }
}

// Two neighbouring elements at once, where the pair is whole and starts at
// an even index: one 4-byte (bf16) or 8-byte (fp32) access.
__device__ __forceinline__ void load_pair(const float* p, float (&v)[2]) {
  const float2 q = *reinterpret_cast<const float2*>(p);
  v[0] = q.x;
  v[1] = q.y;
}
__device__ __forceinline__ void load_pair(const bf16* p, float (&v)[2]) {
  const __nv_bfloat162 q = *reinterpret_cast<const __nv_bfloat162*>(p);
  v[0] = __bfloat162float(q.x);
  v[1] = __bfloat162float(q.y);
}
__device__ __forceinline__ void store_pair(float* p, const float (&v)[2]) {
  *reinterpret_cast<float2*>(p) = make_float2(v[0], v[1]);
}
__device__ __forceinline__ void store_pair(bf16* p, const float (&v)[2]) {
  *reinterpret_cast<uint32_t*>(p) =
      wf::pack2(__float2bfloat16_rn(v[0]), __float2bfloat16_rn(v[1]));
}

// What happens to two neighbouring results of the forward (channels c and
// c + 1 of position p, `count` of them real): bias, rounding, the store,
// and the summands of the next BatchNorm's moments.
template <typename T>
struct ForwardEpilogue {
  const StageArgs<T>& s;
  __device__ __forceinline__ void operator()(const float (&acc)[2], int p,
                                             int c, int count, float (&s0)[2],
                                             float (&s1)[2]) const {
    const size_t at = (size_t)p * s.g.co + c;
    float y[2];
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      y[i] = acc[i] + (s.bias != nullptr && i < count ? s.bias[c + i] : 0.f);
      const float f = i < count ? round_to<T>(y[i]) : 0.f;
      s0[i] = f;
      s1[i] = f * f;
    }
    if (count == 2 && (at & 1) == 0) {
      store_pair(s.out + at, y);
    } else {
#pragma unroll
      for (int i = 0; i < 2; ++i)
        if (i < count) s.out[at + i] = wf::from_f<T>(y[i]);
    }
  }
};

// Two neighbouring results of the input gradient: the mask, the
// prologue's derivative, the store, and the summands of A and B.
template <typename T>
struct DgradEpilogue {
  const StageArgs<T>& s;
  __device__ __forceinline__ void operator()(const float (&acc)[2], int q,
                                             int c, int count, float (&s0)[2],
                                             float (&s1)[2]) const {
    const size_t at = (size_t)q * s.g.ci + c;
    const bool whole = count == 2 && (at & 1) == 0;
    float gx[2] = {acc[0], acc[1]};
    if (s.mask.bits != nullptr) {
      const float inv_keep = 1.0f / s.mask.keep;
      const uint8_t* mb =
          s.mask.bits + (size_t)(q / s.mask.div) * s.g.ci + c;
#pragma unroll
      for (int i = 0; i < 2; ++i)
        gx[i] = i < count && mb[i] != 0 ? gx[i] * inv_keep : 0.f;
    }
    if (s.a != nullptr || s.act_made != nullptr) {
      float xv[2] = {0.f, 0.f};
      if (whole) {
        load_pair(s.x + at, xv);
      } else {
#pragma unroll
        for (int i = 0; i < 2; ++i)
          if (i < count) xv[i] = to_f(s.x[at + i]);
      }
      float act[2] = {xv[0], xv[1]};
      if (s.a != nullptr) {
#pragma unroll
        for (int i = 0; i < 2; ++i) {
          if (i >= count) break;
          const float ar = round_to<T>(s.a[c + i]);
          const float u = wf::bn_apply<T>(xv[i], round_to<T>(s.m[c + i]), ar,
                                          round_to<T>(s.b[c + i]));
          const float sig = fast_sigmoid(u);
          act[i] = round_to<T>(u * sig);
          const float gu = gx[i] * wf::dsilu(u, sig);
          gx[i] = gu * ar;
          s0[i] = gu * xv[i];
          s1[i] = gu;
        }
      }
      if (s.act_made != nullptr) {
        // the activation the convolution read, as Activation makes it
        if (s.mask.bits != nullptr) {
          const float inv_keep = 1.0f / s.mask.keep;
          const uint8_t* mb =
              s.mask.bits + (size_t)(q / s.mask.div) * s.g.ci + c;
#pragma unroll
          for (int i = 0; i < 2; ++i)
            act[i] = i < count && mb[i] != 0 ? round_to<T>(act[i] * inv_keep)
                                             : 0.f;
        }
        if (whole) {
          store_pair(s.act_made + at, act);
        } else {
#pragma unroll
          for (int i = 0; i < 2; ++i)
            if (i < count) s.act_made[at + i] = wf::from_f<T>(act[i]);
        }
      }
    }
    if (whole) {
      store_pair(s.gx + at, gx);
    } else {
#pragma unroll
      for (int i = 0; i < 2; ++i)
        if (i < count) s.gx[at + i] = wf::from_f<T>(gx[i]);
    }
  }
};

// One 8-column tile of a warp unit after its products: every thread hands
// its two pairs (rows gid and gid + 8, columns 2 tig and 2 tig + 1) to the
// epilogue and gets the four column summands back, added over its rows.
// n0 is the tile's first channel within the group, cbase the group's first
// channel in the tensor.
template <typename T, bool DGRAD>
__device__ __forceinline__ void tile_epilogue(const StageArgs<T>& s,
                                              const float (&acc)[4],
                                              const int (&pr)[2], int n0,
                                              int cn, int cbase,
                                              float (&sum)[2][2]) {
  const int tig = threadIdx.x & 3;
  const int n = n0 + 2 * tig, count = min(2, cn - n);
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    if (pr[h] < 0 || count <= 0) continue;
    const float pair[2] = {acc[2 * h], acc[2 * h + 1]};
    float s0[2] = {0.f, 0.f}, s1[2] = {0.f, 0.f};
    if (DGRAD)
      DgradEpilogue<T>{s}(pair, pr[h], cbase + n, count, s0, s1);
    else
      ForwardEpilogue<T>{s}(pair, pr[h], cbase + n, count, s0, s1);
#pragma unroll
    for (int c = 0; c < 2; ++c) {
      sum[0][c] += s0[c];
      sum[1][c] += s1[c];
    }
  }
}

// The weights of block columns [chunk * tnc, (chunk + 1) * tnc) as
// ws[col][j * kpad + k] in the compute type, zero where padded.  The
// forward's column is an output channel and k an input channel; the input
// gradient's the other way round.  Lanes run along the weight's contiguous
// axis.
template <typename T, bool DGRAD>
__device__ __forceinline__ void stage_weights(T* ws, int ldb,
                                              const float* __restrict__ w,
                                              const Geom& g, const ConvPlan& p,
                                              int g0, int chunk) {
  const int cig = g.ci / g.groups, cog = g.co / g.groups;
  const int ca = DGRAD ? cog : cig, cn = DGRAD ? cig : cog;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  if (!DGRAD) {
    const int flat = p.kpad * g.ktaps;
    for (int col = warp; col < p.tnc; col += kWarps) {
      const int bc = chunk * p.tnc + col;
      const int gl = p.gpb > 1 ? bc / p.npad : 0, n = bc - gl * p.npad;
      const bool valid = n < cn && g0 + gl < g.groups;
      const float* wr = w + (size_t)((g0 + gl) * cog + n) * cig * g.ktaps;
      for (int f = lane; f < flat; f += 32) {
        const int k = f / g.ktaps, j = f - k * g.ktaps;
        const float v = valid && k < ca ? wr[f] : 0.f;
        ws[col * ldb + j * p.kpad + k] = wf::from_f<T>(v);
      }
    }
  } else {
    const int flat = p.tnc * g.ktaps;
    for (int k = warp; k < p.kpad; k += kWarps) {
      for (int f = lane; f < flat; f += 32) {
        const int col = f / g.ktaps, j = f - col * g.ktaps;
        const int bc = chunk * p.tnc + col;
        const int gl = p.gpb > 1 ? bc / p.npad : 0, n = bc - gl * p.npad;
        float v = 0.f;
        if (k < ca && n < cn && g0 + gl < g.groups)
          v = w[((size_t)((g0 + gl) * cog + k) * cig + n) * g.ktaps + j];
        ws[col * ldb + j * p.kpad + k] = wf::from_f<T>(v);
      }
    }
  }
}

template <typename T, bool DGRAD>
__global__ void __launch_bounds__(kThreads, 2) stage_conv_kernel(
    const StageArgs<T> s, const ConvPlan p) {
  extern __shared__ __align__(16) unsigned char smem[];
  const Geom g = s.g;
  const int cig = g.ci / g.groups, cog = g.co / g.groups;
  const int ca = DGRAD ? cog : cig, cn = DGRAD ? cig : cog;
  const int ctot_n = DGRAD ? g.ci : g.co;
  const int wa = DGRAD ? g.wout : g.win, wo = DGRAD ? g.win : g.wout;
  const ConvSmem<T> l = conv_smem<T>(p, g.ktaps);
  T* as = reinterpret_cast<T*>(smem + l.as);
  T* ws = reinterpret_cast<T*>(smem + l.ws);
  int* src = reinterpret_cast<int*>(smem + l.src);
  int* opos = reinterpret_cast<int*>(smem + l.opos);
  float* colsum = reinterpret_cast<float*>(smem + l.colsum);
  float* run = reinterpret_cast<float*>(smem + l.run);
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int gid = lane >> 2, tig = lane & 3;
  const int mrows = p.mtiles * 16, zero_row = p.arows;
  const int g0 = blockIdx.y * p.gpb;
  const int gcount = min(p.gpb, g.groups - g0);
  float* partial = DGRAD ? s.partial_ab : s.partial;
  const bool do_sums = partial != nullptr;

  // padding columns, the row of zeros and the running sums start at zero
  for (int e = tid; e < l.ws / 16; e += kThreads)
    reinterpret_cast<uint4*>(smem)[e] = make_uint4(0, 0, 0, 0);
  for (int e = tid; e < 2 * p.nchunks * p.tnc; e += kThreads) run[e] = 0.f;
  if (p.nchunks == 1) stage_weights<T, DGRAD>(ws, l.ldb, s.w, g, p, g0, 0);

  Activation<T> act(s.x, s.m, s.a, s.b, s.mask, g.ci);
  Cotangent<T> cot{s.go, s.out, s.gsums, g.co};
  const int ntiles = (g.rows + p.rows - 1) / p.rows * p.strips;
  for (int t = blockIdx.x; t < ntiles; t += gridDim.x) {
    const Tile tl = tile_of<DGRAD>(t, g, p.rows, p.strip, p.strips, wa, wo);
    __syncthreads();
    if (p.strips > 1 || t == (int)blockIdx.x)
      fill_tables<DGRAD>(src, opos, mrows, tl, g, p.strips, p.rows, wa, wo,
                         zero_row);
    else
      for (int m = tid; m < mrows; m += kThreads) {
        const int r = m / wo;
        opos[m] = r < tl.rv ? (tl.row0 + r) * wo + m - r * wo : -1;
      }
    const int pos0 = tl.row0 * wa + tl.a_lo;
    const int nvalid = p.strips > 1 ? tl.na : tl.rv * wa;
    if (DGRAD)
      stage_tile_v<kStageBatchSmall>(p.vec, as, l.lda, cot, pos0, p.arows,
                                     nvalid, g0 * ca, gcount * ca, ca, p.kpad,
                                     NotSeen{});
    else
      stage_tile_v(p.vec, as, l.lda, act, pos0, p.arows, nvalid, g0 * ca,
                   gcount * ca, ca, p.kpad, NotSeen{});
    for (int chunk = 0; chunk < p.nchunks; ++chunk) {
      if (p.nchunks > 1)
        stage_weights<T, DGRAD>(ws, l.ldb, s.w, g, p, g0, chunk);
      __syncthreads();
      // 8-column tiles of a group in this chunk that hold a channel
      const int ntg = p.gpb > 1 ? p.npad / 8
                                : (min(p.tnc, p.npad - chunk * p.tnc)) / 8;
      const int upg = (ntg + p.nt - 1) / p.nt;
      // a unit is 16 positions x up to nt 8-column tiles of one group;
      // the warps take the row tiles of each column group in turn, the
      // first one a different warp's every time
      const int ngl = p.gpb > 1 ? gcount : 1;
      for (int v = 0, gl = 0, k = 0; v < ngl * upg;
           ++v, gl += (k + 1 == upg), k = (k + 1 == upg) ? 0 : k + 1)
      for (int mt = (warp + v) % kWarps; mt < p.mtiles; mt += kWarps) {
        const int nt0 = gl * (p.npad / 8) * (p.gpb > 1) + k * p.nt;
        const int nts = min(p.nt, ntg - k * p.nt);
        float acc[kMaxNT][4];
#pragma unroll
        for (int nt = 0; nt < kMaxNT; ++nt)
#pragma unroll
          for (int q = 0; q < 4; ++q) acc[nt][q] = 0.f;
        unit_product(acc, as, l.lda, src, mrows, zero_row, mt, gl * p.kpad,
                     ws, l.ldb, nt0 * 8, nts, g.ktaps, p.kpad);
        const int pr[2] = {opos[mt * 16 + gid], opos[mt * 16 + gid + 8]};
#pragma unroll
        for (int nt = 0; nt < kMaxNT; ++nt) {
          if (nt >= nts) break;
          float sum[2][2] = {{0.f, 0.f}, {0.f, 0.f}};
          const int col = (nt0 + nt) * 8;
          tile_epilogue<T, DGRAD>(
              s, acc[nt], pr,
              p.gpb > 1 ? col - gl * p.npad : chunk * p.tnc + col, cn,
              (g0 + gl) * cn, sum);
          if (do_sums) {
#pragma unroll
            for (int which = 0; which < 2; ++which)
#pragma unroll
              for (int c = 0; c < 2; ++c) {
                float v2 = sum[which][c];
                v2 += __shfl_xor_sync(0xffffffffu, v2, 4);
                v2 += __shfl_xor_sync(0xffffffffu, v2, 8);
                v2 += __shfl_xor_sync(0xffffffffu, v2, 16);
                if (gid == 0)
                  colsum[(which * p.mtiles + mt) * p.tnc + (nt0 + nt) * 8 +
                         2 * tig + c] = v2;
              }
          }
        }
      }
      __syncthreads();
      if (do_sums) {
        const int live = (p.gpb > 1 ? gcount * (p.npad / 8) : ntg) * 8;
        for (int e = tid; e < 2 * p.tnc; e += kThreads) {
          const int which = e / p.tnc, col = e - which * p.tnc;
          if (col >= live) continue;
          float tsum = 0.f;
          for (int mt = 0; mt < p.mtiles; ++mt)
            tsum += colsum[(which * p.mtiles + mt) * p.tnc + col];
          run[(which * p.nchunks + chunk) * p.tnc + col] += tsum;
        }
      }
    }
  }
  __syncthreads();
  if (do_sums) {
    const int ncb = p.nchunks * p.tnc;
    for (int e = tid; e < 2 * ncb; e += kThreads) {
      const int which = e / ncb, bc = e - which * ncb;
      const int gl = p.gpb > 1 ? bc / p.npad : 0, n = bc - gl * p.npad;
      if (n < cn && gl < gcount)
        partial[((size_t)blockIdx.x * 2 + which) * ctot_n + (g0 + gl) * cn +
                n] = run[e];
    }
  }
}

// ---------------------------------------------------------------------------
// the dense pointwise stages in bf16: the weights stream through rings
// ---------------------------------------------------------------------------
//
// A pointwise stage of a few hundred channels each way is paid for by its
// weight matrix, which every block reads whole from L2 (1.17 MB of fp32 at
// 540 x 540) for only 40-80 positions.  The block keeps its activation
// tile in shared memory as above.  Warp w owns columns 8 w .. 8 w + 8 of
// each 64-column chunk for every position of the tile, so it needs only
// its own 8 x 32 slice of each weight tile: it pulls that slice through a
// ring of its own with 16-byte cp.async, four slices in flight, and waits
// for nobody but itself (no block barrier in the loop; a column's sums
// never leave the warp either).  No thread holds a weight in a register on
// the way: the B fragments are read from the fp32 slice and rounded to
// bf16 as they are packed.  The blocks of one row tile share its column
// chunks (blockIdx.y), so that two blocks sit on every SM.

constexpr int kStreamCols = 64;    // columns of a chunk: 8 a warp
constexpr int kStreamDepth = 32;   // reduction depth of a weight tile
constexpr int kStreamStages = 4;
constexpr int kStreamMaxMT = 5;

using wf::cp_async16;
using wf::cp_async_commit;
using wf::cp_async_wait;

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}

// A warp's slice of a weight tile in floats.  Forward: its 8 output
// channels as rows of 32 input channels, 8 floats of padding a row; input
// gradient: 32 output channels (the reduction) as rows of its 8 input
// channels, 4 of padding.  With these strides the B fragments (pairs along
// a row, or across two rows) meet no bank conflict.
__host__ __device__ constexpr int stream_ld(bool dgrad) {
  return dgrad ? 8 + 4 : kStreamDepth + 8;
}
__host__ __device__ constexpr int stream_slice(bool dgrad) {
  return (dgrad ? kStreamDepth : 8) * stream_ld(dgrad);
}

struct StreamSmem {
  int lda, as, ring, src, opos, run, total;
};

__host__ __device__ inline StreamSmem stream_smem(const ConvPlan& p,
                                                  bool dgrad) {
  StreamSmem l;
  const int mrows = p.mtiles * 16;
  l.lda = p.kpad + 8;
  l.as = 0;
  l.ring = l.as + align16((p.arows + 1) * l.lda * 2);
  l.src = l.ring + kWarps * kStreamStages * stream_slice(dgrad) * 4;
  l.opos = l.src + mrows * 4;
  l.run = l.opos + mrows * 4;
  l.total = l.run + 2 * p.nchunks * kStreamCols * 4;
  return l;
}

template <bool DGRAD>
__global__ void __launch_bounds__(kThreads, 2) stage_stream_kernel(
    const StageArgs<bf16> s, const ConvPlan p) {
  using T = bf16;
  constexpr int LD = stream_ld(DGRAD), SLICE = stream_slice(DGRAD);
  extern __shared__ __align__(16) unsigned char smem[];
  const Geom g = s.g;
  const int ca = DGRAD ? g.co : g.ci, cn = DGRAD ? g.ci : g.co;
  const int wa = DGRAD ? g.wout : g.win, wo = DGRAD ? g.win : g.wout;
  const StreamSmem l = stream_smem(p, DGRAD);
  T* as = reinterpret_cast<T*>(smem + l.as);
  int* src = reinterpret_cast<int*>(smem + l.src);
  int* opos = reinterpret_cast<int*>(smem + l.opos);
  float* run = reinterpret_cast<float*>(smem + l.run);
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int gid = lane >> 2, tig = lane & 3;
  float* ring =
      reinterpret_cast<float*>(smem + l.ring) + warp * kStreamStages * SLICE;
  const int mrows = p.mtiles * 16, zero_row = p.arows;
  const int kchunks = (p.kpad + kStreamDepth - 1) / kStreamDepth;
  // the blocks of one row tile share its column chunks: blockIdx.y takes
  // chunks y, y + nsplit, ... (p.nt is the split on this path)
  const int nsplit = gridDim.y;
  const int total = (p.nchunks - blockIdx.y + nsplit - 1) / nsplit * kchunks;
  float* partial = DGRAD ? s.partial_ab : s.partial;
  const bool do_sums = partial != nullptr;

  for (int e = tid; e < l.ring / 16; e += kThreads)
    reinterpret_cast<uint4*>(smem)[e] = make_uint4(0, 0, 0, 0);
  for (int e = tid; e < 2 * p.nchunks * kStreamCols; e += kThreads)
    run[e] = 0.f;

  // The warp's slices in order: column chunk blockIdx.y, blockIdx.y +
  // nsplit, .., each with its kchunks reduction chunks.  A lane copies two
  // 16-byte pieces of a slice, always at the same place in it.
  const int pr0 = DGRAD ? lane >> 1 : lane >> 3;         // its first row
  const int pc4 = (DGRAD ? lane & 1 : lane & 7) * 4;     // its column
  constexpr int kRowStep = DGRAD ? 16 : 4;               // to its second row
  int fetched = 0, fetch_nc = blockIdx.y, fetch_kc = 0;
  auto fetch = [&]() {   // the next slice into its slot; past the end, an
                         // empty group
    if (fetched < total) {
      float* dst = ring + (fetched % kStreamStages) * SLICE + pr0 * LD + pc4;
      const int n0 = fetch_nc * kStreamCols + 8 * warp;
      const int k0 = fetch_kc * kStreamDepth;
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        const int r = pr0 + kRowStep * i;
        // forward: a row is an output channel, the columns input channels;
        // input gradient: a row is an output channel too (it is the
        // reduction there), the columns input channels
        const int n = n0 + (DGRAD ? pc4 : r), k = k0 + (DGRAD ? r : pc4);
        const bool ok = n < cn && k < ca;
        const float* from =
            s.w + (DGRAD ? (size_t)k * cn + n : (size_t)n * ca + k);
        cp_async16(dst + kRowStep * i * LD, ok ? from : s.w, ok);
      }
      ++fetched;
      if (++fetch_kc == kchunks) {
        fetch_kc = 0;
        fetch_nc += nsplit;
      }
    }
    cp_async_commit();
  };

  Activation<T> act(s.x, s.m, s.a, s.b, s.mask, g.ci);
  Cotangent<T> cot{s.go, s.out, s.gsums, g.co};
  const int ntiles = (g.rows + p.rows - 1) / p.rows * p.strips;
  for (int t = blockIdx.x; t < ntiles; t += gridDim.x) {
    const Tile tl = tile_of<DGRAD>(t, g, p.rows, p.strip, p.strips, wa, wo);
    __syncthreads();
    fetched = 0, fetch_nc = blockIdx.y, fetch_kc = 0;
    for (int i = 0; i < kStreamStages - 1; ++i) fetch();
    fill_tables<DGRAD>(src, opos, mrows, tl, g, p.strips, p.rows, wa, wo,
                       zero_row);
    const int pos0 = tl.row0 * wa + tl.a_lo;
    const int nvalid = p.strips > 1 ? tl.na : tl.rv * wa;
    if (DGRAD)
      stage_tile_v<kStageBatchSmall>(
          p.vec, as, l.lda, cot, pos0, p.arows, nvalid, 0, ca, ca, p.kpad,
          NotSeen{}, blockIdx.y == 0 ? s.g_made : nullptr, g.co);
    else
      stage_tile_v(p.vec, as, l.lda, act, pos0, p.arows, nvalid, 0, ca, ca,
                   p.kpad, NotSeen{});
    __syncthreads();   // the tile and its tables; from here on a warp
                       // waits only for its own copies
    float acc[kStreamMaxMT][4];
    const T* arow[kStreamMaxMT];
#pragma unroll
    for (int mt = 0; mt < kStreamMaxMT; ++mt)
      arow[mt] = as + src[min(mt, p.mtiles - 1) * 16 + (lane & 15)] * l.lda +
                 8 * (lane >> 4);
    for (int i = 0, nc = blockIdx.y, kc = 0; i < total;
         ++i, nc += (kc + 1 == kchunks) ? nsplit : 0,
             kc = (kc + 1 == kchunks) ? 0 : kc + 1) {
      cp_async_wait<kStreamStages - 2>();
      __syncwarp();   // slice i has landed; slice i - 1's slot is free
      fetch();
      if (kc == 0) {
#pragma unroll
        for (int mt = 0; mt < kStreamMaxMT; ++mt)
#pragma unroll
          for (int q = 0; q < 4; ++q) acc[mt][q] = 0.f;
      }
      const float* wt = ring + (i % kStreamStages) * SLICE;
#pragma unroll
      for (int ks = 0; ks < kStreamDepth; ks += 16) {
        if (kc * kStreamDepth + ks >= p.kpad) break;
        uint32_t bfr[2];
        if (!DGRAD) {
          const float* bp = wt + gid * LD + ks + 2 * tig;
          const float2 lo = *reinterpret_cast<const float2*>(bp);
          const float2 hi = *reinterpret_cast<const float2*>(bp + 8);
          bfr[0] = pack_bf16(lo.x, lo.y);
          bfr[1] = pack_bf16(hi.x, hi.y);
        } else {
          const float* bp = wt + (ks + 2 * tig) * LD + gid;
          bfr[0] = pack_bf16(bp[0], bp[LD]);
          bfr[1] = pack_bf16(bp[8 * LD], bp[9 * LD]);
        }
#pragma unroll
        for (int mt = 0; mt < kStreamMaxMT; ++mt) {
          if (mt >= p.mtiles) break;
          uint32_t af[4];
          wf::ldmatrix_x4(af, arow[mt] + kc * kStreamDepth + ks);
          wf::mma_bf16(acc[mt], af, bfr);
        }
      }
      if (kc != kchunks - 1) continue;
      float sum[2][2] = {{0.f, 0.f}, {0.f, 0.f}};
#pragma unroll
      for (int mt = 0; mt < kStreamMaxMT; ++mt) {
        if (mt >= p.mtiles) break;
        const int pr[2] = {opos[mt * 16 + gid], opos[mt * 16 + gid + 8]};
        tile_epilogue<T, DGRAD>(s, acc[mt], pr, nc * kStreamCols + warp * 8,
                                cn, 0, sum);
      }
      if (do_sums) {
#pragma unroll
        for (int which = 0; which < 2; ++which)
#pragma unroll
          for (int c = 0; c < 2; ++c) {
            float v = sum[which][c];
            v += __shfl_xor_sync(0xffffffffu, v, 4);
            v += __shfl_xor_sync(0xffffffffu, v, 8);
            v += __shfl_xor_sync(0xffffffffu, v, 16);
            if (gid == 0)
              run[(which * p.nchunks + nc) * kStreamCols + warp * 8 + 2 * tig +
                  c] += v;
          }
      }
    }
  }
  cp_async_wait<0>();
  __syncthreads();
  if (do_sums) {
    const int ncb = p.nchunks * kStreamCols;
    for (int e = tid; e < 2 * ncb; e += kThreads) {
      const int which = e / ncb, n = e - which * ncb;
      if (n < cn && n / kStreamCols % nsplit == (int)blockIdx.y)
        partial[((size_t)blockIdx.x * 2 + which) * cn + n] = run[e];
    }
  }
}

// ---------------------------------------------------------------------------
// forward with one input channel: an elementwise pass
// ---------------------------------------------------------------------------

template <typename T>
__global__ void __launch_bounds__(kThreads) stage_direct_kernel(
    const StageArgs<T> s, int chunk) {
  __shared__ float wsm[kMaxDirectCo * 3];
  __shared__ float bsm[kMaxDirectCo];
  __shared__ float red[2][kWarps][kMaxDirectCo];
  const Geom g = s.g;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  for (int e = tid; e < kMaxDirectCo * 3; e += kThreads) {
    const int c = e / 3, j = e - 3 * c;
    wsm[e] = c < g.co && j < g.ktaps ? round_to<T>(s.w[c * g.ktaps + j]) : 0.f;
  }
  if (tid < kMaxDirectCo)
    bsm[tid] = tid < g.co && s.bias != nullptr ? s.bias[tid] : 0.f;
  __syncthreads();
  Activation<T> act(s.x, s.m, s.a, s.b, s.mask, 1);
  typename Activation<T>::template Col<1> st;
  act.template init<1>(st, 0);
  const int npos = g.rows * g.wout;
  const int pbeg = blockIdx.x * chunk, pend = min(npos, pbeg + chunk);
  float cs[kMaxDirectCo], cq[kMaxDirectCo];
#pragma unroll
  for (int c = 0; c < kMaxDirectCo; ++c) cs[c] = cq[c] = 0.f;
  for (int p = pbeg + tid; p < pend; p += kThreads) {
    const int r = p / g.wout, wo = p - r * g.wout;
    float acc[kMaxDirectCo];
#pragma unroll
    for (int c = 0; c < kMaxDirectCo; ++c) acc[c] = bsm[c];
    for (int j = 0; j < g.ktaps; ++j) {
      const int wi = wo * g.stride + (j - g.pad) * g.dil;
      if (wi < 0 || wi >= g.win) continue;
      typename Activation<T>::template Raw<1> raw;
      act.template load<1>(raw, r * g.win + wi, 0);
      float v[1];
      act.template finish<1>(st, raw, v);
#pragma unroll
      for (int c = 0; c < kMaxDirectCo; ++c) acc[c] += v[0] * wsm[c * 3 + j];
    }
    __align__(16) T ov[kMaxDirectCo];
#pragma unroll
    for (int c = 0; c < kMaxDirectCo; ++c) {
      ov[c] = wf::from_f<T>(acc[c]);
      const float f = c < g.co ? to_f(ov[c]) : 0.f;
      cs[c] += f;
      cq[c] += f * f;
    }
    T* dst = s.out + (size_t)p * g.co;
    if ((g.co * sizeof(T)) % 16 == 0) {
#pragma unroll
      for (int e = 0; e < (int)(kMaxDirectCo * sizeof(T) / 16); ++e)
        if (e * 16 < (int)(g.co * sizeof(T)))
          reinterpret_cast<uint4*>(dst)[e] =
              reinterpret_cast<const uint4*>(ov)[e];
    } else {
#pragma unroll
      for (int c = 0; c < kMaxDirectCo; ++c)
        if (c < g.co) dst[c] = ov[c];
    }
  }
  if (s.partial == nullptr) return;
#pragma unroll
  for (int c = 0; c < kMaxDirectCo; ++c) {
#pragma unroll
    for (int d = 16; d > 0; d >>= 1) {
      cs[c] += __shfl_xor_sync(0xffffffffu, cs[c], d);
      cq[c] += __shfl_xor_sync(0xffffffffu, cq[c], d);
    }
    if (lane == 0) {
      red[0][warp][c] = cs[c];
      red[1][warp][c] = cq[c];
    }
  }
  __syncthreads();
  if (tid < 2 * kMaxDirectCo) {
    const int which = tid / kMaxDirectCo, c = tid % kMaxDirectCo;
    if (c < g.co) {
      float t = 0.f;
      for (int wp = 0; wp < kWarps; ++wp) t += red[which][wp][c];
      s.partial[((size_t)blockIdx.x * 2 + which) * g.co + c] = t;
    }
  }
}

// ---------------------------------------------------------------------------
// weight gradient: gw[co][c][j] = sum_p g[p][co] * act[p * stride + ...][c]
// ---------------------------------------------------------------------------

struct WgradSmem {
  int ldg, lda, gs, as, src, bred, total;
};

// 16 x 8 tiles of one block's part of the weight gradient, all taps
__host__ __device__ inline int wgrad_units(const WgradPlan& p, int ktaps) {
  return (p.tmw / 16) * (p.tnw / 8) * ktaps;
}

template <typename T>
__host__ __device__ WgradSmem wgrad_smem(const WgradPlan& p, int ktaps) {
  WgradSmem l;
  const int pad = 16 / (int)sizeof(T);
  l.ldg = p.tmw + pad;
  l.lda = p.tnw + pad;
  l.gs = 0;
  l.as = l.gs + align16(p.kp * l.ldg * (int)sizeof(T));
  l.src = l.as + align16((p.arows + 1) * l.lda * (int)sizeof(T));
  l.bred = l.src + ktaps * p.kp * 4;
  l.total = l.bred + kThreads * 4 * 4;
  // the warps' partial tiles, added at the end of a block that splits the
  // positions over its warps, take the place of the operand tiles
  if (sizeof(T) == 2 && wgrad_units(p, ktaps) <= kMaxUnits)
    l.total = max(l.total, kWarps * wgrad_units(p, ktaps) * 512);
  return l;
}

// bf16.  A block whose part of the weight gradient is at most kMaxUnits
// tiles of 16 x 8 (the narrow stages: 8 x 8 x 3 taps is three) splits the
// positions over its warps: warp w takes the 16-position steps w, w + 8, ..
// of every tile, and the warps' partial tiles are added in order at the
// end.  Otherwise the warps split the tiles: warp w keeps row tile
// w % mtiles and every (8-column tile, tap) pair v = w / mtiles + i * (8 /
// mtiles).
struct WgradMma {
  float acc[kMaxUnits][4];
  __device__ __forceinline__ void zero() {
#pragma unroll
    for (int i = 0; i < kMaxUnits; ++i)
#pragma unroll
      for (int q = 0; q < 4; ++q) acc[i][q] = 0.f;
  }
  __device__ __forceinline__ void step(const bf16* gs, int ldg, const bf16* as,
                                       int lda, const int* src,
                                       const WgradPlan& p, int ktaps) {
    const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
    const int mtiles = p.tmw / 16, ntiles = p.tnw / 8;
    const int pairs = ntiles * ktaps;
    const bf16* ga = gs + ((lane & 7) + 8 * (lane >> 4)) * ldg +
                     8 * ((lane >> 3) & 1);
    if (mtiles * pairs <= kMaxUnits) {
      for (int ks = warp * 16; ks < p.kp; ks += kWarps * 16) {
        uint32_t af[4];
#pragma unroll
        for (int i = 0; i < kMaxUnits; ++i) {
          if (i >= mtiles * pairs) break;
          const int mt = i / pairs, v = i - mt * pairs;
          const int j = v / ntiles, nt = v - j * ntiles;
          if (v == 0) wf::ldmatrix_x4_trans(af, ga + ks * ldg + mt * 16);
          const int row = src[j * p.kp + ks + (lane & 15)];
          uint32_t bfr[2];
          wf::ldmatrix_x2_trans(bfr, as + row * lda + nt * 8);
          wf::mma_bf16(acc[i], af, bfr);
        }
      }
      return;
    }
    const int mt = warp % mtiles, v0 = warp / mtiles, vstep = kWarps / mtiles;
    for (int ks = 0; ks < p.kp; ks += 16) {
      uint32_t af[4];
      wf::ldmatrix_x4_trans(af, ga + ks * ldg + mt * 16);
#pragma unroll
      for (int i = 0; i < kMaxUnits; ++i) {
        const int v = v0 + i * vstep;
        if (v >= pairs) break;
        const int j = v / ntiles, nt = v - j * ntiles;
        const int row = src[j * p.kp + ks + (lane & 15)];
        uint32_t bfr[2];
        wf::ldmatrix_x2_trans(bfr, as + row * lda + nt * 8);
        wf::mma_bf16(acc[i], af, bfr);
      }
    }
  }
  // f(m, n, j, value) for every result of the block; `red` is shared
  // memory that the operand tiles no longer need
  template <typename F>
  __device__ __forceinline__ void each(const WgradPlan& p, int ktaps,
                                       float* red, F&& f) {
    const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
    const int mtiles = p.tmw / 16, ntiles = p.tnw / 8;
    const int pairs = ntiles * ktaps, units = mtiles * pairs;
    if (units <= kMaxUnits) {
      __syncthreads();
#pragma unroll
      for (int i = 0; i < kMaxUnits; ++i) {
        if (i >= units) break;
        *reinterpret_cast<float4*>(red + ((warp * units + i) * 32 + lane) * 4) =
            make_float4(acc[i][0], acc[i][1], acc[i][2], acc[i][3]);
      }
      __syncthreads();
      for (int e = threadIdx.x; e < units * 128; e += kThreads) {
        const int i = e >> 7, ln = (e >> 2) & 31, q = e & 3;
        float t = 0.f;
        for (int w = 0; w < kWarps; ++w)
          t += red[((w * units + i) * 32 + ln) * 4 + q];
        const int mt = i / pairs, v = i - mt * pairs;
        const int j = v / ntiles, nt = v - j * ntiles;
        f(mt * 16 + (ln >> 2) + 8 * (q >> 1), nt * 8 + 2 * (ln & 3) + (q & 1),
          j, t);
      }
      return;
    }
    const int gid = lane >> 2, tig = lane & 3;
    const int mt = warp % mtiles, v0 = warp / mtiles, vstep = kWarps / mtiles;
#pragma unroll
    for (int i = 0; i < kMaxUnits; ++i) {
      const int v = v0 + i * vstep;
      if (v >= pairs) break;
      const int j = v / ntiles, nt = v - j * ntiles;
#pragma unroll
      for (int q = 0; q < 4; ++q)
        f(mt * 16 + gid + 8 * (q >> 1), nt * 8 + 2 * tig + (q & 1), j,
          acc[i][q]);
    }
  }
};

// fp32: thread (tm, tn) keeps 4 x 4 channels of every tap.
struct WgradFma {
  float acc[3][4][4];
  __device__ __forceinline__ void zero() {
#pragma unroll
    for (int j = 0; j < 3; ++j)
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int k = 0; k < 4; ++k) acc[j][i][k] = 0.f;
  }
  __device__ __forceinline__ void step(const float* gs, int ldg,
                                       const float* as, int lda,
                                       const int* src, const WgradPlan& p,
                                       int ktaps) {
    const int tnq = p.tnw / 4;
    const int tm = threadIdx.x / tnq, tn = threadIdx.x - tm * tnq;
    if (tm >= p.tmw / 4) return;
    for (int k = 0; k < p.kp; ++k) {
      const float4 g4 = *reinterpret_cast<const float4*>(gs + k * ldg + 4 * tm);
      const float gv[4] = {g4.x, g4.y, g4.z, g4.w};
#pragma unroll
      for (int j = 0; j < 3; ++j) {
        if (j >= ktaps) break;
        const float4 a4 = *reinterpret_cast<const float4*>(
            as + src[j * p.kp + k] * lda + 4 * tn);
        const float av[4] = {a4.x, a4.y, a4.z, a4.w};
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int c = 0; c < 4; ++c) acc[j][i][c] += gv[i] * av[c];
      }
    }
  }
  template <typename F>
  __device__ __forceinline__ void each(const WgradPlan& p, int ktaps, float*,
                                       F&& f) {
    const int tnq = p.tnw / 4;
    const int tm = threadIdx.x / tnq, tn = threadIdx.x - tm * tnq;
    if (tm >= p.tmw / 4) return;
#pragma unroll
    for (int j = 0; j < 3; ++j) {
      if (j >= ktaps) break;
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int c = 0; c < 4; ++c) f(4 * tm + i, 4 * tn + c, j, acc[j][i][c]);
    }
  }
};

template <typename T>
struct WgradProduct;
template <>
struct WgradProduct<bf16> {
  using type = WgradMma;
};
template <>
struct WgradProduct<float> {
  using type = WgradFma;
};

template <typename T>
__global__ void __launch_bounds__(kThreads, 2) stage_wgrad_kernel(
    const StageArgs<T> s, const WgradPlan p) {
  extern __shared__ __align__(16) unsigned char smem[];
  const Geom g = s.g;
  const int cig = g.ci / g.groups, cog = g.co / g.groups;
  const WgradSmem l = wgrad_smem<T>(p, g.ktaps);
  T* gs = reinterpret_cast<T*>(smem + l.gs);
  T* as = reinterpret_cast<T*>(smem + l.as);
  int* src = reinterpret_cast<int*>(smem + l.src);
  float* bred = reinterpret_cast<float*>(smem + l.bred);
  const int tid = threadIdx.x;
  const int grp = blockIdx.y / (p.ntm * p.ntn);
  const int rem = blockIdx.y - grp * (p.ntm * p.ntn);
  const int m0 = (rem / p.ntn) * p.tmw, n0 = (rem % p.ntn) * p.tnw;
  const int mcount = min(p.tmw, cog - m0), ncount = min(p.tnw, cig - n0);
  const int nw = g.co * cig * g.ktaps;
  const bool do_bias = s.ldw > nw && n0 == 0;
  const int zero_row = p.arows;

  for (int e = tid; e < l.src / 16; e += kThreads)
    reinterpret_cast<uint4*>(smem)[e] = make_uint4(0, 0, 0, 0);
  // the operands: made here from the stage's inputs, or copied as the
  // input gradient left them
  const bool act_made = s.act_made != nullptr, g_made = s.g_made != nullptr;
  const wf::Mask no_mask{nullptr, 1, 1.f};
  const Activation<T> act(act_made ? s.act_made : s.x,
                          act_made ? nullptr : s.m, act_made ? nullptr : s.a,
                          act_made ? nullptr : s.b,
                          act_made ? no_mask : s.mask, g.ci);
  const Cotangent<T> cot{g_made ? s.g_made : s.go, g_made ? nullptr : s.out,
                         g_made ? nullptr : s.gsums, g.co};
  typename WgradProduct<T>::type prod;
  prod.zero();
  float bsum[4] = {0.f, 0.f, 0.f, 0.f};
  auto add_bias = [&](const auto& v) {
    constexpr int V = sizeof(v) / sizeof(float);
#pragma unroll
    for (int i = 0; i < V; ++i) bsum[i] += v[i];
  };

  const int steps = (g.rows + p.rows - 1) / p.rows * p.strips;
  const int sbeg = blockIdx.x * p.steps_per_split;
  const int send = min(steps, sbeg + p.steps_per_split);
  for (int st = sbeg; st < send; ++st) {
    const Tile tl =
        tile_of<false>(st, g, p.rows, p.strip, p.strips, g.win, g.wout);
    __syncthreads();
    if (p.strips > 1 || st == sbeg)
      fill_tables<false>(src, nullptr, p.kp, tl, g, p.strips, p.rows, g.win,
                         g.wout, zero_row);
    const int gpos0 = tl.row0 * g.wout + tl.w0;
    const int gvalid = p.strips > 1 ? tl.sw : tl.rv * g.wout;
    if (do_bias)
      stage_tile_v<kStageBatchSmall>(p.vec_g, gs, l.ldg, cot, gpos0, p.kp,
                                     gvalid, grp * cog + m0, mcount, mcount, 0,
                                     add_bias);
    else
      stage_tile_v<kStageBatchSmall>(p.vec_g, gs, l.ldg, cot, gpos0, p.kp,
                                     gvalid, grp * cog + m0, mcount, mcount, 0,
                                     NotSeen{});
    const int apos0 = tl.row0 * g.win + tl.a_lo;
    const int avalid = p.strips > 1 ? tl.na : tl.rv * g.win;
    stage_tile_v<kStageBatchSmall>(p.vec_a, as, l.lda, act, apos0, p.arows,
                                   avalid, grp * cig + n0, ncount, ncount, 0,
                                   NotSeen{});
    __syncthreads();
    prod.step(gs, l.ldg, as, l.lda, src, p, g.ktaps);
  }

  float* part = s.partial_w + (size_t)blockIdx.x * s.ldw;
  prod.each(p, g.ktaps, reinterpret_cast<float*>(smem),
            [&](int m, int n, int j, float v) {
    if (m < mcount && n < ncount)
      part[((size_t)(grp * cog + m0 + m) * cig + n0 + n) * g.ktaps + j] = v;
  });
  if (do_bias) {
    // add the threads that shared a channel vector, in order
    const int vec = p.vec_g, width = stage_width(mcount / vec);
    __syncthreads();
#pragma unroll
    for (int i = 0; i < 4; ++i) bred[tid * 4 + i] = bsum[i];
    __syncthreads();
    if (tid < mcount) {
      const int cv = tid / vec, i = tid - cv * vec;
      float t = 0.f;
      for (int pf = 0; pf < kThreads / width; ++pf)
        t += bred[(pf * width + cv) * 4 + i];
      part[nw + grp * cog + m0 + tid] = t;
    }
  }
}

// ---------------------------------------------------------------------------
// launches
// ---------------------------------------------------------------------------

bool bad_geom(const Geom& g) {
  return g.rows < 1 || g.win < 1 || g.wout < 1 || g.ci < 1 || g.co < 1 ||
         g.groups < 1 || g.ci % g.groups || g.co % g.groups || g.ktaps < 1 ||
         g.ktaps > 3 || g.stride < 1 || g.dil < 1 || g.pad < 0 ||
         (long long)g.rows * g.win * g.ci >= (1ll << 31) ||
         (long long)g.rows * g.wout * g.co >= (1ll << 31);
}

// A-side positions that `strip` output positions of one row read
int halo(const Geom& g, int strip, bool dgrad) {
  const int reach = (g.ktaps - 1) * g.dil;
  return dgrad ? (strip - 1 + reach) / g.stride + 1
               : (strip - 1) * g.stride + reach + 1;
}

// a kernel that needs more than 48 KB of shared memory says so once
template <typename K>
int allow_smem(K kernel, int bytes, int& allowed) {
  if (bytes <= allowed) return 0;
  const cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, kSmemLimit);
  if (err != cudaSuccess) return (int)err;
  allowed = kSmemLimit;
  return 0;
}

template <typename T, bool DGRAD>
int launch_conv(const StageArgs<T>& s, const ConvPlan& p, cudaStream_t st) {
  static int allowed = 48 * 1024;
  const Geom& g = s.g;
  const int cig = g.ci / g.groups, cog = g.co / g.groups;
  const int ca = DGRAD ? cog : cig, cn = DGRAD ? cig : cog;
  const int wa = DGRAD ? g.wout : g.win, wo = DGRAD ? g.win : g.wout;
  const int want = sizeof(T) == 2 ? kMma : kFma;
  if (p.path != want || p.rows < 1 || p.strips < 1 || p.gpb < 1 ||
      g.groups % p.gpb || (p.gpb > 1 && p.nchunks != 1) ||
      p.kpad % 16 || p.kpad < ca || p.npad % 8 || p.npad < cn ||
      p.tnc % 8 || p.tnc < 8 || p.nchunks * p.tnc < p.gpb * p.npad ||
      (p.gpb > 1 && p.tnc != p.gpb * p.npad) || p.nt < 1 || p.nt > kMaxNT ||
      p.mtiles * 16 < p.rows * p.strip || (p.strips == 1 && p.strip != wo) ||
      (p.strips > 1 && p.rows != 1) || p.strips * p.strip < wo ||
      p.arows < (p.strips == 1 ? p.rows * wa : 1) ||
      (p.vec != 1 && (p.vec != 4 || ca % 4)) || p.grid_x < 1 ||
      (p.strips > 1 && p.arows < halo(g, p.strip, DGRAD)) ||
      conv_smem<T>(p, g.ktaps).total != p.smem || p.smem > kSmemLimit)
    return (int)cudaErrorInvalidValue;
  auto kernel = stage_conv_kernel<T, DGRAD>;
  const int rc = allow_smem(kernel, p.smem, allowed);
  if (rc != 0) return rc;
  const dim3 grid(p.grid_x, g.groups / p.gpb);
  WF_LAUNCH(kernel, grid, kThreads, p.smem, st, s, p);
  return (int)cudaGetLastError();
}

template <bool DGRAD>
int launch_stream(const StageArgs<bf16>& s, const ConvPlan& p,
                  cudaStream_t st) {
  static int allowed = 48 * 1024;
  const Geom& g = s.g;
  const int ca = DGRAD ? g.co : g.ci, cn = DGRAD ? g.ci : g.co;
  const int wa = DGRAD ? g.wout : g.win, wo = DGRAD ? g.win : g.wout;
  if (g.groups != 1 || g.ktaps != 1 || g.ci % 4 || g.co % 4 || p.rows < 1 ||
      p.strips < 1 || p.gpb != 1 || p.kpad % 16 || p.kpad < ca ||
      p.tnc != kStreamCols || p.nchunks * kStreamCols < cn || p.mtiles < 1 ||
      p.mtiles > kStreamMaxMT || p.mtiles * 16 < p.rows * p.strip ||
      (p.strips == 1 && p.strip != wo) || (p.strips > 1 && p.rows != 1) ||
      p.strips * p.strip < wo ||
      p.arows < (p.strips == 1 ? p.rows * wa : halo(g, p.strip, DGRAD)) ||
      p.vec != 4 || p.grid_x < 1 || p.nt < 1 || p.nt > p.nchunks ||
      reinterpret_cast<uintptr_t>(s.w) % 16 != 0 ||
      stream_smem(p, DGRAD).total != p.smem || p.smem > kSmemLimit)
    return (int)cudaErrorInvalidValue;
  auto kernel = stage_stream_kernel<DGRAD>;
  const int rc = allow_smem(kernel, p.smem, allowed);
  if (rc != 0) return rc;
  WF_LAUNCH(kernel, dim3(p.grid_x, p.nt), kThreads, p.smem, st, s, p);
  return (int)cudaGetLastError();
}

// the dense bf16 stages go through the streaming kernel, the rest through
// the tiled one
template <typename T, bool DGRAD>
int launch_product(const StageArgs<T>& s, const ConvPlan& p, cudaStream_t st) {
  if constexpr (sizeof(T) == 2) {
    if (p.path == kStream) return launch_stream<DGRAD>(s, p, st);
  }
  return launch_conv<T, DGRAD>(s, p, st);
}

template <typename T>
int launch_wgrad(const StageArgs<T>& s, const WgradPlan& p, cudaStream_t st) {
  static int allowed = 48 * 1024;
  const Geom& g = s.g;
  const int cig = g.ci / g.groups, cog = g.co / g.groups;
  const bool mma = sizeof(T) == 2;
  const int mtiles = p.tmw / 16;
  if (p.path != (mma ? kMma : kFma) || p.rows < 1 || p.strips < 1 ||
      p.tmw < 4 || p.tnw < 4 || p.ntm * p.tmw < cog || p.ntn * p.tnw < cig ||
      p.kp % 16 || p.kp < p.rows * p.strip ||
      (p.strips == 1 && p.strip != g.wout) || (p.strips > 1 && p.rows != 1) ||
      p.strips * p.strip < g.wout ||
      p.arows < (p.strips == 1 ? p.rows * g.win : halo(g, p.strip, false)) ||
      p.splits < 1 ||
      p.steps_per_split < 1 ||
      (long long)p.splits * p.steps_per_split <
          (long long)((g.rows + p.rows - 1) / p.rows) * p.strips ||
      (p.vec_g != 1 && (p.vec_g != 4 || cog % 4)) ||
      (p.vec_a != 1 && (p.vec_a != 4 || cig % 4)) || p.tmw > 128 ||
      wgrad_smem<T>(p, g.ktaps).total != p.smem || p.smem > kSmemLimit)
    return (int)cudaErrorInvalidValue;
  if (mma) {
    if (p.tmw % 16 || (mtiles & (mtiles - 1)) || mtiles > kWarps ||
        p.tnw % 8 ||
        (wgrad_units(p, g.ktaps) > kMaxUnits &&
         (p.tnw / 8 * g.ktaps + kWarps / mtiles - 1) / (kWarps / mtiles) >
             kMaxUnits))
      return (int)cudaErrorInvalidValue;
  } else if (p.tmw % 4 || p.tnw % 4 || (p.tmw / 4) * (p.tnw / 4) > kThreads) {
    return (int)cudaErrorInvalidValue;
  }
  auto kernel = stage_wgrad_kernel<T>;
  const int rc = allow_smem(kernel, p.smem, allowed);
  if (rc != 0) return rc;
  const dim3 grid(p.splits, g.groups * p.ntm * p.ntn);
  WF_LAUNCH(kernel, grid, kThreads, p.smem, st, s, p);
  return (int)cudaGetLastError();
}

template <typename T>
int run_forward(StageArgs<T> s, float* sums, const ConvPlan& p,
                cudaStream_t st) {
  if (bad_geom(s.g)) return (int)cudaErrorInvalidValue;
  int rc;
  if (p.path == kDirect) {
    // p.rows: the positions of one block
    if (s.g.ci != 1 || s.g.co > kMaxDirectCo || p.rows < 1 || p.grid_x < 1 ||
        (long long)p.rows * p.grid_x < (long long)s.g.rows * s.g.wout)
      return (int)cudaErrorInvalidValue;
    auto kernel = stage_direct_kernel<T>;
    WF_LAUNCH(kernel, p.grid_x, kThreads, 0, st, s, p.rows);
    rc = (int)cudaGetLastError();
  } else {
    rc = launch_product<T, false>(s, p, st);
  }
  if (rc != 0 || s.partial == nullptr) return rc;
  const int cols = 2 * s.g.co;
  auto reduce = wf::reduce_rows;
  WF_LAUNCH(reduce, (cols + wf::kReduceCols - 1) / wf::kReduceCols, kThreads,
            0, st, s.partial, p.grid_x, cols, cols, sums);
  return (int)cudaGetLastError();
}

template <typename T>
int run_backward(StageArgs<T> s, float* gmab, float* gw, const ConvPlan& pd,
                 const WgradPlan& pw, int bf16_vectors, cudaStream_t st) {
  if (bad_geom(s.g) || (s.act_made != nullptr && s.gx == nullptr) ||
      (s.g_made != nullptr &&
       (s.gx == nullptr || pd.path != kStream || s.ldw > s.g.co * s.g.ci)))
    return (int)cudaErrorInvalidValue;
  int rc;
  if (s.gx != nullptr) {
    rc = launch_product<T, true>(s, pd, st);
    if (rc != 0) return rc;
    if (s.a != nullptr) {
      wf::AffineGradArgs ag{s.partial_ab, pd.grid_x, 2 * s.g.ci, s.g.ci,
                            bf16_vectors, {s.m, nullptr}, {s.a, nullptr},
                            gmab};
      auto reduce = wf::reduce_affine_grads;
      const dim3 grid((s.g.ci + wf::kReduceCols - 1) / wf::kReduceCols, 1);
      WF_LAUNCH(reduce, grid, kThreads, 0, st, ag);
      rc = (int)cudaGetLastError();
      if (rc != 0) return rc;
    }
  }
  rc = launch_wgrad<T>(s, pw, st);
  if (rc != 0) return rc;
  auto reduce = wf::reduce_rows;
  WF_LAUNCH(reduce, (s.ldw + wf::kReduceCols - 1) / wf::kReduceCols, kThreads,
            0, st, s.partial_w, pw.splits, s.ldw, s.ldw, gw);
  return (int)cudaGetLastError();
}

template <typename T>
StageArgs<T> make_args(const void* x, const void* m, const void* a,
                       const void* b, const void* mask, int mask_div,
                       float keep, const void* w, const Geom& g) {
  StageArgs<T> s{};
  s.x = static_cast<const T*>(x);
  s.m = static_cast<const float*>(m);
  s.a = static_cast<const float*>(a);
  s.b = static_cast<const float*>(b);
  s.mask = wf::Mask{static_cast<const uint8_t*>(mask),
                    mask_div < 1 ? 1 : mask_div, keep};
  s.w = static_cast<const float*>(w);
  s.g = g;
  return s;
}

template <typename T>
int forward_as(const void* x, const void* m, const void* a, const void* b,
               const void* mask, int mask_div, float keep, const void* w,
               const void* bias, void* out, void* partial, void* sums,
               const Geom& g, const ConvPlan& p, cudaStream_t st) {
  auto s = make_args<T>(x, m, a, b, mask, mask_div, keep, w, g);
  s.bias = static_cast<const float*>(bias);
  s.out = static_cast<T*>(out);
  s.partial = static_cast<float*>(partial);
  return run_forward(s, static_cast<float*>(sums), p, st);
}

template <typename T>
int backward_as(const void* x, const void* m, const void* a, const void* b,
                const void* mask, int mask_div, float keep, const void* w,
                const void* out, const void* go, const void* gsums, void* gx,
                void* partial_ab, void* gmab, void* partial_w, void* gw,
                void* g_made, void* act_made, int ldw, const Geom& g,
                const ConvPlan& pd, const WgradPlan& pw, cudaStream_t st) {
  auto s = make_args<T>(x, m, a, b, mask, mask_div, keep, w, g);
  s.out = const_cast<T*>(static_cast<const T*>(out));
  s.go = static_cast<const T*>(go);
  s.gsums = static_cast<const float*>(gsums);
  s.gx = static_cast<T*>(gx);
  s.partial_ab = s.a != nullptr ? static_cast<float*>(partial_ab) : nullptr;
  s.partial_w = static_cast<float*>(partial_w);
  s.ldw = ldw;
  s.g_made = static_cast<T*>(g_made);
  s.act_made = static_cast<T*>(act_made);
  return run_backward(s, static_cast<float*>(gmab), static_cast<float*>(gw),
                      pd, pw, sizeof(T) == 2, st);
}

}  // namespace

// The plan's integers are ConvPlan's (and WgradPlan's) fields in order.
extern "C" int stage_forward(int dtype, const void* x, const void* m,
                             const void* a, const void* b, const void* mask,
                             int mask_div, float keep, const void* w,
                             const void* bias, void* out, void* partial,
                             void* sums, int rows, int win, int wout, int ci,
                             int co, int groups, int ktaps, int stride,
                             int dil, int pad, int path, int prows, int strip,
                             int strips, int arows, int gpb, int kpad,
                             int npad, int tnc, int nchunks, int nt,
                             int mtiles, int vec, int smem, int grid_x,
                             void* stream) {
  const Geom g{rows, win, wout, ci, co, groups, ktaps, stride, dil, pad};
  const ConvPlan p{path, prows, strip, strips, arows, gpb, kpad, npad,
                   tnc, nchunks, nt, mtiles, vec, smem, grid_x};
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == wf::kF32)
    return forward_as<float>(x, m, a, b, mask, mask_div, keep, w, bias, out,
                             partial, sums, g, p, st);
  if (dtype == wf::kBF16)
    return forward_as<bf16>(x, m, a, b, mask, mask_div, keep, w, bias, out,
                            partial, sums, g, p, st);
  return (int)cudaErrorInvalidValue;
}

// gx null: no input gradient (and no g_m, g_a, g_b).  gw is [ldw]: the
// weight's gradient in its own layout, then gbias when ldw = nw + co.
// g_made and act_made, if not null, are scratch that the input gradient
// fills and the weight gradient reads in place of making the operand
// again: the activation from any input gradient, the rounded cotangent
// from the streaming one, and only of a stage without bias, whose gradient
// is the sum of the cotangent before rounding.
extern "C" int stage_backward(
    int dtype, const void* x, const void* m, const void* a, const void* b,
    const void* mask, int mask_div, float keep, const void* w,
    const void* out, const void* go, const void* gsums, void* gx,
    void* partial_ab, void* gmab, void* partial_w, void* gw, void* g_made,
    void* act_made, int ldw, int rows, int win, int wout, int ci, int co, int groups, int ktaps,
    int stride, int dil, int pad, int d_path, int d_rows, int d_strip,
    int d_strips, int d_arows, int d_gpb, int d_kpad, int d_npad, int d_tnc,
    int d_nchunks, int d_nt, int d_mtiles, int d_vec, int d_smem,
    int d_grid_x, int w_path, int w_rows, int w_strip, int w_strips,
    int w_arows, int w_kp, int w_tmw, int w_tnw, int w_ntm, int w_ntn,
    int w_splits, int w_steps_per_split, int w_vec_g, int w_vec_a, int w_smem,
    void* stream) {
  const Geom g{rows, win, wout, ci, co, groups, ktaps, stride, dil, pad};
  const ConvPlan pd{d_path, d_rows, d_strip, d_strips, d_arows,
                    d_gpb, d_kpad, d_npad, d_tnc, d_nchunks,
                    d_nt, d_mtiles, d_vec, d_smem, d_grid_x};
  const WgradPlan pw{w_path, w_rows, w_strip, w_strips, w_arows,
                     w_kp, w_tmw, w_tnw, w_ntm, w_ntn,
                     w_splits, w_steps_per_split, w_vec_g, w_vec_a, w_smem};
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == wf::kF32)
    return backward_as<float>(x, m, a, b, mask, mask_div, keep, w, out, go,
                              gsums, gx, partial_ab, gmab, partial_w, gw,
                              g_made, act_made, ldw, g, pd, pw, st);
  if (dtype == wf::kBF16)
    return backward_as<bf16>(x, m, a, b, mask, mask_div, keep, w, out, go,
                             gsums, gx, partial_ab, gmab, partial_w, gw,
                             g_made, act_made, ldw, g, pd, pw, st);
  return (int)cudaErrorInvalidValue;
}

WF_EXPORT_ERROR_STRING
