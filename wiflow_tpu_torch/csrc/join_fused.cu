// The residual tail of a train-mode block, forward and backward, for
// sm_90a:
//   out = silu( dropout( act_h ? silu(norm_h(h)) : norm_h(h) )
//               + (norm_r(res) or res) )
// with norm(x) = (x - m) * a + b per channel, on h and res [positions, C].
//
// Replaces wiflow_tpu/ops/pallas/stage_fused.py:join, its forward
// (_join_fwd_kernel) and its backward (_join_bwd_kernel).  The backward
// recomputes everything from h and res and gives gh, gres and, per
// channel and branch, A = sum(gu * x) and B = sum(gu) of the cotangent gu
// of u = (x - m) * a + b, returned as g_m = -a B, g_a = A - m B, g_b = B.
//
// What bounds it on the H100: bytes, and close behind them the element
// math.  The forward reads h and res and writes out, the backward reads h,
// res and go and writes gh and gres (at batch 256 the conv stack's widest
// join is 19.7 MB a tensor in bf16, the TCN's 5.5 MB): a few to a few tens
// of microseconds at 3.35 TB/s.  Each element also takes some 40
// (forward) to 70 (backward, the TCN's joins with their second SiLU and
// divisions) instructions, every step rounded to T as the reference
// rounds it; bf16 conversions issue at a quarter of the fp32 rate.
//
// Design (the launch plan is ops/kernels/stage_fused.py::join_plan, one a
// direction; the C side refuses a plan that does not add up; the choices
// were timed on an H100 by join_sweep.py):
//   Chunks.  A row of C channels is C / V chunks of V channels, V the
//     widest of 8, 4, 2, 1 (bf16; 4, 2, 1 in fp32) that divides C, at most
//     4 in the backward, so a chunk is one aligned copy of up to 16 bytes.
//     A thread owns one chunk of the row for the whole launch and holds the
//     six per-channel vectors of its V channels, rounded to T once, in
//     registers (as T, two to a register in bf16).  The backward's 4 V fp32
//     sums a thread are why it stops at 4 channels: at 8 they spill.
//   Blocks.  A block takes `cols` neighbouring chunks of a row (its slice
//     of the channels; `slices` blocks across a row) and `rows` rows a
//     pass, rows x cols threads, the chunk fastest: a warp reads
//     neighbouring chunks, one run of memory when the slice is the whole
//     row (at C = 8 a forward thread holds a row and a warp 512 bytes).  A
//     persistent grid, 3 blocks an SM (2 for a forward of 16-byte chunks,
//     whose registers allow no more), walks the passes with a fixed
//     stride; the last may be part-filled.
//   Loads in flight.  A thread copies the chunks of its next row (h, res,
//     go and the mask bytes) into a ring of kStages rows in shared memory
//     with cp.async while it computes the row before, so the copies need
//     no registers; narrower chunks (bf16 with V = 1) and masks (V < 4)
//     are read directly.  Two stages timed fastest.
//   Arithmetic.  Each step of the element math is done on the thread's V
//     values at once and rounded two at a time with cvt.rn.bf16x2.f32, the
//     same bits as one cvt.rn.bf16.f32 each at half the conversions.  The
//     SiLU of the main branch is a template parameter.
//   Backward sums.  A thread keeps 4 V fp32 sums (A_h, B_h, A_r, B_r of its
//     channels) over its rows; the block adds its row lanes in a fixed
//     order through shared memory (the ring's) and writes one float4
//     partial a channel into partial[blockIdx.x, c, 4].  The last block of
//     a slice to finish (an int32 counter per slice, which it resets to 0)
//     sums the slice's partials over the blocks in float64 in a fixed order
//     and applies the chain rule into gvec: one launch, no float atomics,
//     so two launches on the same inputs give the same bits.  The
//     backward's slices exist for that finish: join_plan cuts a row into
//     the fewest slices at which one block sums at most 2,048 partials, so
//     wide rows (the TCN's 540 channels) finish in parallel, one block a
//     slice; the forward takes the fewest slices of at most 256 channels.
//   The element math (bn_apply, the SiLUs, the division by keep, each
//   rounding) does not depend on the plan, so out, gh and gres are the same
//   bits under every plan; A and B are summed in the plan's order.
#include "stage_common.cuh"

namespace {

using wf::round_to;
using wf::to_f;

constexpr int kMaxThreads = 256;   // a block's rows x cols
// blocks an SM at the launch bounds: 3 (at most 85 registers a thread)
// where a thread's chunk is at most 8 bytes in the forward and at most 4
// channels in the backward (4 V fp32 sums a thread), else 2 (128)
template <typename T, int V>
__host__ __device__ constexpr int forward_blocks_per_sm() {
  return V * (int)sizeof(T) <= 8 ? 3 : 2;
}
template <int V>
__host__ __device__ constexpr int backward_blocks_per_sm() {
  return V <= 4 ? 3 : 2;
}
constexpr int kStages = 2;         // rows a thread has in flight
constexpr int kLoadBatch = 8;      // partials in flight a thread, finish

// V values of type E in one aligned load or store
template <typename E, int V>
struct alignas(V * sizeof(E)) Chunk {
  E e[V];
};

// B bytes from device to shared memory, asynchronously (B = 4, 8 or 16)
template <int B>
__device__ __forceinline__ void cp_async(void* dst, const void* src) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  if constexpr (B == 16)
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(d),
                 "l"(src));
  else
    asm volatile("cp.async.ca.shared.global [%0], [%1], %2;\n" ::"r"(d),
                 "l"(src), "n"(B));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

// wait until at most kStages - 1 of this thread's groups are in flight
__device__ __forceinline__ void cp_async_wait_oldest() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(kStages - 1));
}

// A thread's ring of kStages rows in dynamic shared memory: NQ chunks of
// V values of T (h, res and, backward, go) and, with V >= 4, the row's V
// mask bytes.  cp.async copies 4, 8 or 16 bytes: narrower chunks (bf16
// with V = 1) and masks (V < 4) are read from device memory directly.
template <typename T, int V, int NQ>
struct Ring {
  static constexpr int kChunk = V * (int)sizeof(T);
  static constexpr bool kData = kChunk >= 4;
  static constexpr bool kMask = V >= 4;
  static constexpr int kRow = (kData ? NQ * kChunk : 0) + (kMask ? V : 0);
  unsigned char* base;
  int threads;
  __device__ Chunk<T, V>* chunk(int stage, int q) const {
    return reinterpret_cast<Chunk<T, V>*>(
        base + ((size_t)(stage * NQ + q) * threads + threadIdx.x) * kChunk);
  }
  __device__ Chunk<uint8_t, V>* mask(int stage) const {
    return reinterpret_cast<Chunk<uint8_t, V>*>(
        base + (size_t)kStages * threads * (kData ? NQ * kChunk : 0) +
        ((size_t)stage * threads + threadIdx.x) * V);
  }
  static size_t bytes(int threads) {
    return (size_t)kStages * threads * kRow;
  }
};

template <typename T>
struct JoinArgs {
  const T* h;            // [npos, c]
  const float* mh;       // [c]
  const float* ah;
  const float* bh;
  wf::Mask mask;
  const T* res;          // [npos, c]
  const float* mr;       // [c] or null: the residual is added as it is
  const float* ar;
  const float* br;
  T* out;                // forward
  const T* go;           // backward
  T* gh;
  T* gres;
  float* partial;        // [gridDim.x, c, 4]: A_h, B_h, A_r, B_r
  int* counters;         // [slices], 0 between launches
  float* gvec;           // [2, 3, c]
  int npos, c, cols, rows, act_h;
};

// A thread's place: its chunk of the row (channels ch .. ch + V - 1, the
// slot-th of its block's slice) and its row lane in a pass.
struct Place {
  int lane, slot, ch;
  bool live;
  __device__ Place(int cols, int c, int v) {
    slot = threadIdx.x % cols;
    lane = threadIdx.x / cols;
    ch = (blockIdx.y * cols + slot) * v;
    live = ch < c;
  }
};

// bf16 conversions two at a time: one cvt.rn.bf16x2.f32 rounds a pair as
// two cvt.rn.bf16.f32 would (the same bits), and the card issues
// conversions at a quarter of its fp32 rate
constexpr bool kPairs = true;

// x[0 .. V) rounded to T
template <typename T, int V>
__device__ __forceinline__ void round_all(float (&x)[V]) {
  if constexpr (sizeof(T) == 2 && kPairs) {
#pragma unroll
    for (int k = 0; k + 1 < V; k += 2) {
      const float2 f =
          __bfloat1622float2(__floats2bfloat162_rn(x[k], x[k + 1]));
      x[k] = f.x;
      x[k + 1] = f.y;
    }
    if constexpr (V % 2 == 1) x[V - 1] = round_to<T>(x[V - 1]);
  } else {
#pragma unroll
    for (int k = 0; k < V; ++k) x[k] = round_to<T>(x[k]);
  }
}

// x[0 .. V) as a chunk of T
template <typename T, int V>
__device__ __forceinline__ Chunk<T, V> to_chunk(const float (&x)[V]) {
  Chunk<T, V> o;
  if constexpr (sizeof(T) == 2 && kPairs) {
#pragma unroll
    for (int k = 0; k + 1 < V; k += 2)
      *reinterpret_cast<__nv_bfloat162*>(&o.e[k]) =
          __floats2bfloat162_rn(x[k], x[k + 1]);
    if constexpr (V % 2 == 1) o.e[V - 1] = wf::from_f<T>(x[V - 1]);
  } else {
#pragma unroll
    for (int k = 0; k < V; ++k) o.e[k] = wf::from_f<T>(x[k]);
  }
  return o;
}

template <typename T, int V>
__device__ __forceinline__ void from_chunk(float (&x)[V],
                                           const Chunk<T, V>& c) {
#pragma unroll
  for (int k = 0; k < V; ++k) x[k] = to_f(c.e[k]);
}

// The per-channel vectors of a thread's V channels, rounded to T once and
// held as chunks of T (in bf16 two to a register), read back as fp32.
template <typename T, int V>
struct Vectors {
  Chunk<T, V> m, a, b;
  __device__ void load(const float* mv, const float* av, const float* bv,
                       int ch) {
    float x[V];
#pragma unroll
    for (int k = 0; k < V; ++k) x[k] = mv[ch + k];
    m = to_chunk<T>(x);
#pragma unroll
    for (int k = 0; k < V; ++k) x[k] = av[ch + k];
    a = to_chunk<T>(x);
#pragma unroll
    for (int k = 0; k < V; ++k) x[k] = bv[ch + k];
    b = to_chunk<T>(x);
  }
  // u = (x - m) * a + b in place, each step rounded to T (wf::bn_apply)
  __device__ __forceinline__ void apply(float (&x)[V]) const {
#pragma unroll
    for (int k = 0; k < V; ++k) x[k] -= to_f(m.e[k]);
    round_all<T>(x);
#pragma unroll
    for (int k = 0; k < V; ++k) x[k] *= to_f(a.e[k]);
    round_all<T>(x);
#pragma unroll
    for (int k = 0; k < V; ++k) x[k] += to_f(b.e[k]);
    round_all<T>(x);
  }
};

template <typename T, int V>
__device__ __forceinline__ Chunk<T, V> load_chunk(const T* base, size_t i) {
  return *reinterpret_cast<const Chunk<T, V>*>(base + i);
}

// the V mask bytes of row p at channel ch
__device__ __forceinline__ const uint8_t* mask_at(const wf::Mask& m, int p,
                                                  int c, int ch) {
  const size_t row = m.div == 1 ? (size_t)p : (size_t)(p / m.div);
  return m.bits + row * c + ch;
}

// Walks a thread's rows: in tile i of its block's walk (tiles blockIdx.x,
// blockIdx.x + gridDim.x, ..., each `rows` rows) the row rows x tile +
// lane, with the copies of the next kStages - 1 rows in flight while it
// computes one.  row(e, x, m) gets the element offset of the thread's
// chunk, its NQ chunks (of src[0 .. NQ)) and its mask bytes.
template <typename T, int V, int NQ, typename F>
__device__ __forceinline__ void walk(const JoinArgs<T>& j, const Place& at,
                                     const T* const (&src)[NQ],
                                     unsigned char* smem, F&& row) {
  using R = Ring<T, V, NQ>;
  const R ring{smem, j.rows * j.cols};
  const bool masked = j.mask.bits != nullptr;
  const int tiles = (j.npos + j.rows - 1) / j.rows;
  const int mine = (int)blockIdx.x < tiles
                       ? (tiles - 1 - (int)blockIdx.x) / (int)gridDim.x + 1
                       : 0;
  auto first = [&](int i) {
    return ((int)blockIdx.x + i * (int)gridDim.x) * j.rows + at.lane;
  };
  auto fetch = [&](int i) {
    const int p = first(i);
    if (p < j.npos) {
      const int stage = i % kStages;
      const size_t e = (size_t)p * j.c + at.ch;
      if constexpr (R::kData) {
#pragma unroll
        for (int q = 0; q < NQ; ++q)
          cp_async<R::kChunk>(ring.chunk(stage, q), src[q] + e);
      }
      if constexpr (R::kMask) {
        if (masked) cp_async<V>(ring.mask(stage), mask_at(j.mask, p, j.c,
                                                          at.ch));
      }
    }
    cp_async_commit();
  };
#pragma unroll
  for (int i = 0; i < kStages - 1; ++i) fetch(i);
  for (int i = 0; i < mine; ++i) {
    fetch(i + kStages - 1);
    cp_async_wait_oldest();
    const int p = first(i);
    if (p >= j.npos) continue;
    const int stage = i % kStages;
    const size_t e = (size_t)p * j.c + at.ch;
    Chunk<T, V> x[NQ];
#pragma unroll
    for (int q = 0; q < NQ; ++q) {
      if constexpr (R::kData)
        x[q] = *ring.chunk(stage, q);
      else
        x[q] = load_chunk<T, V>(src[q], e);
    }
    Chunk<uint8_t, V> m{};
    if (masked) {
      if constexpr (R::kMask)
        m = *ring.mask(stage);
      else
        m = *reinterpret_cast<const Chunk<uint8_t, V>*>(
            mask_at(j.mask, p, j.c, at.ch));
    }
    row(e, x, m);
  }
  asm volatile("cp.async.wait_all;\n" ::);
}

template <typename T, int V, bool ACT>
__global__ void __launch_bounds__(kMaxThreads,
                                  forward_blocks_per_sm<T, V>())
    join_forward_kernel(JoinArgs<T> j) {
  extern __shared__ __align__(16) unsigned char ring[];
  const Place at(j.cols, j.c, V);
  if (!at.live) return;
  const bool rn = j.ar != nullptr, masked = j.mask.bits != nullptr;
  Vectors<T, V> vh, vr;
  vh.load(j.mh, j.ah, j.bh, at.ch);
  if (rn) vr.load(j.mr, j.ar, j.br, at.ch);
  const T* src[2] = {j.h, j.res};
  walk<T, V>(j, at, src, ring, [&](size_t e, const Chunk<T, V> (&x)[2],
                                   const Chunk<uint8_t, V>& m) {
    float v[V], r[V];
    from_chunk(v, x[0]);
    vh.apply(v);
    if constexpr (ACT) {
#pragma unroll
      for (int k = 0; k < V; ++k) v[k] *= wf::sigmoid(v[k]);
      round_all<T>(v);
    }
    if (masked) {
#pragma unroll
      for (int k = 0; k < V; ++k)
        v[k] = m.e[k] != 0 ? v[k] / j.mask.keep : 0.f;
      round_all<T>(v);
    }
    from_chunk(r, x[1]);
    if (rn) vr.apply(r);
#pragma unroll
    for (int k = 0; k < V; ++k) v[k] += r[k];
    round_all<T>(v);
#pragma unroll
    for (int k = 0; k < V; ++k) v[k] *= wf::sigmoid(v[k]);
    *reinterpret_cast<Chunk<T, V>*>(j.out + e) = to_chunk<T>(v);
  });
}

__device__ __forceinline__ void add4(float4& s, const float4& v) {
  s.x += v.x;
  s.y += v.y;
  s.z += v.z;
  s.w += v.w;
}

// (g_m, g_a, g_b) = (-a B, A - m B, B) of one channel into out [3, c],
// with m and a rounded to T as the kernels read them
template <typename T>
__device__ __forceinline__ void chain_rule(float* out, int c, int ch,
                                           float m, float a, double ta,
                                           double tb) {
  m = round_to<T>(m);
  a = round_to<T>(a);
  out[ch] = (float)(-(double)a * tb);
  out[c + ch] = (float)(ta - (double)m * tb);
  out[2 * c + ch] = (float)tb;
}

// The float64 finish of one slice: the partials of its n channels summed
// over the gridDim.x blocks, `parts` strided ranges of blocks a channel,
// then the parts in order; the chain rule into gvec.
template <typename T>
__device__ void finish_slice(const JoinArgs<T>& j, int n, int ch0,
                             double (*fin)[kMaxThreads]) {
  const int threads = j.rows * j.cols;
  int parts = 1;
  while (2 * parts * n <= threads) parts *= 2;
  const int t = threadIdx.x;
  if (t < parts * n) {
    const int col = t % n, part = t / n, ch = ch0 + col;
    double s[4] = {0.0, 0.0, 0.0, 0.0};
    if (ch < j.c) {
      const float4* src = reinterpret_cast<const float4*>(j.partial) + ch;
      for (int r0 = part; r0 < (int)gridDim.x; r0 += kLoadBatch * parts) {
        float4 v[kLoadBatch];
#pragma unroll
        for (int b = 0; b < kLoadBatch; ++b) {
          const int r = r0 + b * parts;
          v[b] = r < (int)gridDim.x ? __ldcg(src + (size_t)r * j.c)
                                    : make_float4(0.f, 0.f, 0.f, 0.f);
        }
#pragma unroll
        for (int b = 0; b < kLoadBatch; ++b) {
          s[0] += (double)v[b].x;
          s[1] += (double)v[b].y;
          s[2] += (double)v[b].z;
          s[3] += (double)v[b].w;
        }
      }
    }
#pragma unroll
    for (int q = 0; q < 4; ++q) fin[q][t] = s[q];
  }
  __syncthreads();
  const int ch = ch0 + t;
  if (t < n && ch < j.c) {
    double tot[4] = {0.0, 0.0, 0.0, 0.0};
    for (int part = 0; part < parts; ++part)
#pragma unroll
      for (int q = 0; q < 4; ++q) tot[q] += fin[q][part * n + t];
    chain_rule<T>(j.gvec, j.c, ch, j.mh[ch], j.ah[ch], tot[0], tot[1]);
    if (j.ar != nullptr)
      chain_rule<T>(j.gvec + 3 * j.c, j.c, ch, j.mr[ch], j.ar[ch], tot[2],
                    tot[3]);
  }
}

// The backward's scratch after its walk, in the ring's shared memory:
// red [lane][slot * V + k] and red2 [part][channel of the slice] float4,
// fin [4][part * n + channel] double.
template <int V>
__host__ __device__ constexpr size_t reduction_bytes() {
  return (size_t)(kMaxThreads * V + kMaxThreads) * 16 +
         (size_t)4 * kMaxThreads * 8;
}

template <typename T, int V, bool ACT>
__global__ void __launch_bounds__(kMaxThreads, backward_blocks_per_sm<V>())
    join_backward_kernel(JoinArgs<T> j) {
  extern __shared__ __align__(16) unsigned char ring[];
  __shared__ bool last;
  const Place at(j.cols, j.c, V);
  const bool rn = j.ar != nullptr, masked = j.mask.bits != nullptr;
  Vectors<T, V> vh, vr;
  float acc[V][4];
#pragma unroll
  for (int k = 0; k < V; ++k)
    acc[k][0] = acc[k][1] = acc[k][2] = acc[k][3] = 0.f;
  if (at.live) {
    vh.load(j.mh, j.ah, j.bh, at.ch);
    if (rn) vr.load(j.mr, j.ar, j.br, at.ch);
    const T* src[3] = {j.h, j.res, j.go};
    walk<T, V>(j, at, src, ring, [&](size_t e, const Chunk<T, V> (&x)[3],
                                     const Chunk<uint8_t, V>& m) {
      float uh[V], sig_h[V], v[V], g[V];
      from_chunk(uh, x[0]);
      vh.apply(uh);
#pragma unroll
      for (int k = 0; k < V; ++k) v[k] = uh[k];
      if constexpr (ACT) {
#pragma unroll
        for (int k = 0; k < V; ++k) {
          sig_h[k] = wf::sigmoid(uh[k]);
          v[k] = uh[k] * sig_h[k];
        }
        round_all<T>(v);
      }
      if (masked) {
#pragma unroll
        for (int k = 0; k < V; ++k)
          v[k] = m.e[k] != 0 ? v[k] / j.mask.keep : 0.f;
        round_all<T>(v);
      }
      {
        float r[V];
        from_chunk(r, x[1]);
        if (rn) vr.apply(r);
#pragma unroll
        for (int k = 0; k < V; ++k) v[k] += r[k];
      }
      round_all<T>(v);
      // g: the cotangent of the residual sum, then of u_h
      from_chunk(g, x[2]);
#pragma unroll
      for (int k = 0; k < V; ++k) g[k] *= wf::dsilu(v[k], wf::sigmoid(v[k]));
      Chunk<T, V> gro;
      if (rn) {
        float t[V];
#pragma unroll
        for (int k = 0; k < V; ++k) {
          t[k] = g[k] * to_f(vr.a.e[k]);
          acc[k][2] += g[k] * to_f(x[1].e[k]);
          acc[k][3] += g[k];
        }
        gro = to_chunk<T>(t);
      } else {
        gro = to_chunk<T>(g);
      }
      if (masked) {
#pragma unroll
        for (int k = 0; k < V; ++k)
          g[k] = m.e[k] != 0 ? g[k] / j.mask.keep : 0.f;
      }
      if constexpr (ACT) {
#pragma unroll
        for (int k = 0; k < V; ++k) g[k] *= wf::dsilu(uh[k], sig_h[k]);
      }
      float t[V];
#pragma unroll
      for (int k = 0; k < V; ++k) {
        t[k] = g[k] * to_f(vh.a.e[k]);
        acc[k][0] += g[k] * to_f(x[0].e[k]);
        acc[k][1] += g[k];
      }
      const Chunk<T, V> gho = to_chunk<T>(t);
      *reinterpret_cast<Chunk<T, V>*>(j.gh + e) = gho;
      *reinterpret_cast<Chunk<T, V>*>(j.gres + e) = gro;
    });
  }
  // the block's row lanes, in a fixed order: `parts` strided ranges of
  // lanes a channel, then the parts in order; the ring's memory reused
  // once every thread is done with its own part of it
  float4* red = reinterpret_cast<float4*>(ring);
  float4* red2 = red + kMaxThreads * V;
  auto fin = reinterpret_cast<double(*)[kMaxThreads]>(red2 + kMaxThreads);
  const int n = j.cols * V, threads = j.rows * j.cols;
  const int ch0 = blockIdx.y * n;
  __syncthreads();
#pragma unroll
  for (int k = 0; k < V; ++k)
    red[at.lane * n + at.slot * V + k] =
        make_float4(acc[k][0], acc[k][1], acc[k][2], acc[k][3]);
  __syncthreads();
  int parts = 1;
  while (2 * parts * n <= threads) parts *= 2;
  const int t = threadIdx.x;
  if (t < parts * n) {
    const int col = t % n;
    float4 s = make_float4(0.f, 0.f, 0.f, 0.f);
    for (int l = t / n; l < j.rows; l += parts) add4(s, red[l * n + col]);
    red2[t] = s;
  }
  __syncthreads();
  if (t < n && ch0 + t < j.c) {
    float4 s = red2[t];
    for (int part = 1; part < parts; ++part) add4(s, red2[part * n + t]);
    reinterpret_cast<float4*>(j.partial)[(size_t)blockIdx.x * j.c + ch0 + t] =
        s;
  }
  // the last block of the slice to finish sums the slice's partials: the
  // barrier orders the block's partials before thread 0's fence, which
  // makes them visible to every block before its count; in the last block
  // thread 0's second fence orders the others' partials before the reads
  // that follow the barrier (from L2, __ldcg)
  __syncthreads();
  if (t == 0) {
    __threadfence();
    last = atomicAdd(j.counters + blockIdx.y, 1) == (int)gridDim.x - 1;
    if (last) __threadfence();
  }
  __syncthreads();
  if (!last) return;
  finish_slice(j, n, ch0, fin);
  if (t == 0) j.counters[blockIdx.y] = 0;
}

bool aligned(const void* p, int bytes) {
  return p == nullptr || reinterpret_cast<uintptr_t>(p) % bytes == 0;
}

// The plan adds up: V divides C and is one of the widths this dtype takes,
// a block's rows x cols threads and cols x V channels fit, the slices
// cover the row, the stages are the kernels' own, and every pointer takes
// V-wide accesses.
template <typename T>
bool plan_ok(const JoinArgs<T>& j, int v, int slices, int stages,
             int grid_x) {
  const int vmax = 16 / (int)sizeof(T);
  const int groups = j.c / v;
  return j.npos >= 1 && j.c >= 1 && v >= 1 && v <= vmax && (v & (v - 1)) == 0
      && j.c % v == 0 && j.cols >= 1 && j.rows >= 1
      && j.rows * j.cols <= kMaxThreads && j.cols * v <= kMaxThreads
      && slices == (groups + j.cols - 1) / j.cols && stages == kStages
      && grid_x >= 1 && (long long)j.npos * j.c < (1ll << 31)
      && aligned(j.h, v * sizeof(T)) && aligned(j.res, v * sizeof(T))
      && aligned(j.out, v * sizeof(T)) && aligned(j.go, v * sizeof(T))
      && aligned(j.gh, v * sizeof(T)) && aligned(j.gres, v * sizeof(T))
      && aligned(j.mask.bits, v) && aligned(j.partial, 16);
}

// Launches `kernel` with `smem` bytes of dynamic shared memory; the first
// time, raises its limit above the default 48 KB (to the most any of the
// dtype's kernels takes) and asks for the SM's largest shared-memory
// carveout, so that the kernels' blocks an SM fit.
template <typename K, typename T>
int launch_with(K kernel, bool& ready, dim3 grid, int threads, size_t smem,
                cudaStream_t st, const JoinArgs<T>& j) {
  if (!ready) {
    constexpr int vmax = 16 / (int)sizeof(T);
    const size_t most = Ring<T, vmax, 3>::bytes(kMaxThreads) >
                                reduction_bytes<vmax>()
                            ? Ring<T, vmax, 3>::bytes(kMaxThreads)
                            : reduction_bytes<vmax>();
    cudaError_t e = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)most);
    if (e == cudaSuccess)
      e = cudaFuncSetAttribute(kernel,
                               cudaFuncAttributePreferredSharedMemoryCarveout,
                               (int)cudaSharedmemCarveoutMaxShared);
    if (e != cudaSuccess) return (int)e;
    ready = true;
  }
  WF_LAUNCH(kernel, grid, threads, smem, st, j);
  return (int)cudaGetLastError();
}

template <typename T, int V, bool ACT>
int launch_act(bool backward, const JoinArgs<T>& j, int slices, int stages,
               int grid_x, cudaStream_t st) {
  if (!plan_ok(j, V, slices, stages, grid_x))
    return (int)cudaErrorInvalidValue;
  const dim3 grid(grid_x, slices);
  const int threads = j.rows * j.cols;
  if (backward) {
    if (j.partial == nullptr || j.counters == nullptr || j.gvec == nullptr)
      return (int)cudaErrorInvalidValue;
    static bool ready = false;
    const size_t ring = Ring<T, V, 3>::bytes(threads);
    return launch_with(join_backward_kernel<T, V, ACT>, ready, grid, threads,
                       ring > reduction_bytes<V>() ? ring
                                                   : reduction_bytes<V>(),
                       st, j);
  }
  static bool ready = false;
  return launch_with(join_forward_kernel<T, V, ACT>, ready, grid, threads,
                     Ring<T, V, 2>::bytes(threads), st, j);
}

template <typename T, int V>
int launch(bool backward, const JoinArgs<T>& j, int slices, int stages,
           int grid_x, cudaStream_t st) {
  return j.act_h
             ? launch_act<T, V, true>(backward, j, slices, stages, grid_x, st)
             : launch_act<T, V, false>(backward, j, slices, stages, grid_x,
                                       st);
}

template <typename T>
int run(bool backward, const JoinArgs<T>& j, int v, int slices, int stages,
        int grid_x, cudaStream_t st) {
  switch (v) {
    case 1: return launch<T, 1>(backward, j, slices, stages, grid_x, st);
    case 2: return launch<T, 2>(backward, j, slices, stages, grid_x, st);
    case 4: return launch<T, 4>(backward, j, slices, stages, grid_x, st);
    case 8:
      if constexpr (sizeof(T) == 2)
        return launch<T, 8>(backward, j, slices, stages, grid_x, st);
  }
  return (int)cudaErrorInvalidValue;
}

template <typename T>
JoinArgs<T> make_args(const void* h, const void* mh, const void* ah,
                      const void* bh, const void* mask, int mask_div,
                      float keep, const void* res, const void* mr,
                      const void* ar, const void* br, int act_h, int npos,
                      int c, int cols, int rows) {
  JoinArgs<T> j{};
  j.h = static_cast<const T*>(h);
  j.mh = static_cast<const float*>(mh);
  j.ah = static_cast<const float*>(ah);
  j.bh = static_cast<const float*>(bh);
  j.mask = wf::Mask{static_cast<const uint8_t*>(mask),
                    mask_div < 1 ? 1 : mask_div, keep};
  j.res = static_cast<const T*>(res);
  j.mr = static_cast<const float*>(mr);
  j.ar = static_cast<const float*>(ar);
  j.br = static_cast<const float*>(br);
  j.act_h = act_h;
  j.npos = npos;
  j.c = c;
  j.cols = cols;
  j.rows = rows;
  return j;
}

}  // namespace

// plan: v, cols, rows, slices, stages, grid_x of join_plan
extern "C" int join_forward(int dtype, const void* h, const void* mh,
                            const void* ah, const void* bh, const void* mask,
                            int mask_div, float keep, const void* res,
                            const void* mr, const void* ar, const void* br,
                            int act_h, void* out, int npos, int c, int v,
                            int cols, int rows, int slices, int stages,
                            int grid_x, void* stream) {
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == wf::kF32) {
    auto j = make_args<float>(h, mh, ah, bh, mask, mask_div, keep, res, mr,
                              ar, br, act_h, npos, c, cols, rows);
    j.out = static_cast<float*>(out);
    return run(false, j, v, slices, stages, grid_x, st);
  }
  if (dtype == wf::kBF16) {
    auto j = make_args<__nv_bfloat16>(h, mh, ah, bh, mask, mask_div, keep,
                                      res, mr, ar, br, act_h, npos, c, cols,
                                      rows);
    j.out = static_cast<__nv_bfloat16*>(out);
    return run(false, j, v, slices, stages, grid_x, st);
  }
  return (int)cudaErrorInvalidValue;
}

// partial is [grid_x, c, 4] fp32 and counters [slices] int32, zero before
// the launch and after it; gvec is [2, 3, c]: (g_m, g_a, g_b) of the main
// branch, then of the residual branch (written only when mr, ar, br are
// given).
extern "C" int join_backward(int dtype, const void* h, const void* mh,
                             const void* ah, const void* bh, const void* mask,
                             int mask_div, float keep, const void* res,
                             const void* mr, const void* ar, const void* br,
                             int act_h, const void* go, void* gh, void* gres,
                             void* partial, void* counters, void* gvec,
                             int npos, int c, int v, int cols, int rows,
                             int slices, int stages, int grid_x,
                             void* stream) {
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == wf::kF32) {
    auto j = make_args<float>(h, mh, ah, bh, mask, mask_div, keep, res, mr,
                              ar, br, act_h, npos, c, cols, rows);
    j.go = static_cast<const float*>(go);
    j.gh = static_cast<float*>(gh);
    j.gres = static_cast<float*>(gres);
    j.partial = static_cast<float*>(partial);
    j.counters = static_cast<int*>(counters);
    j.gvec = static_cast<float*>(gvec);
    return run(true, j, v, slices, stages, grid_x, st);
  }
  if (dtype == wf::kBF16) {
    using B = __nv_bfloat16;
    auto j = make_args<B>(h, mh, ah, bh, mask, mask_div, keep, res, mr, ar,
                          br, act_h, npos, c, cols, rows);
    j.go = static_cast<const B*>(go);
    j.gh = static_cast<B*>(gh);
    j.gres = static_cast<B*>(gres);
    j.partial = static_cast<float*>(partial);
    j.counters = static_cast<int*>(counters);
    j.gvec = static_cast<float*>(gvec);
    return run(true, j, v, slices, stages, grid_x, st);
  }
  return (int)cudaErrorInvalidValue;
}

WF_EXPORT_ERROR_STRING
