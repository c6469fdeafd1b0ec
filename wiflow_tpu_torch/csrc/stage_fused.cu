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
// What bounds it on the H100: at batch 256 the largest stage (a 540 x 540
// pointwise conv over 5,120 rows) is 3 GFLOP against 11 MB, and the conv
// stack's stages are a few hundred MFLOP against 10-40 MB each: bytes for
// the conv stack, operations for the TCN's pointwise convs, all of it
// tens of microseconds at the card's rates.
//
// Design: three tiled products on CUDA cores with fp32 accumulation, the
// operands rounded to the compute type when a tile is staged in shared
// memory (so that fp32 FMAs of bf16 values give the tensor-core result up
// to the order of the sum).  256 threads hold a TM x TN tile, 4 x 4 each.
//   forward: M = output positions, N = output channels of one group, the
//     reduction runs over taps and input channels; the prologue and the
//     mask are applied as the activation tile is loaded.
//   input gradient: M = input positions, N = input channels of one group,
//     the reduction over taps and output channels; the epilogue applies
//     the mask and the prologue's derivative.
//   weight gradient: M = (tap, input channel), N = output channel, the
//     reduction over positions, split over blockIdx.x; small tiles split
//     the reduction over slices of the block as well.
// The TPU kernel's block-diagonal packing of the grouped taps, its
// space-to-depth chunks and its sequential-grid accumulation are not
// carried over: blocks walk the row tiles with a fixed stride and keep
// their column sums in registers, write them to partial[block, ...], and
// wf::reduce_rows / wf::reduce_affine_grads add the partials in float64.
#include "stage_common.cuh"

namespace {

using wf::kThreads;
using wf::round_to;
using wf::to_f;

constexpr int kTK = 16;   // reduction depth of one staged tile

struct Geom {
  int rows, win, wout, ci, co, groups, ktaps, stride, dil, pad;
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
  float* partial;        // forward: [gridDim.x, 2, co], or null
  const T* go;           // backward: [rows, wout, co]
  const float* gsums;    // [2, co] or null
  T* gx;                 // [rows, win, ci]
  float* partial_ab;     // [gridDim.x, 2, ci], or null
  float* partial_w;      // [splits, ldw]: gw, then gbias when ldw > nw
  int ldw, chunk;        // positions per split of the weight gradient
  Geom g;
};

// the activation the convolution reads at position q = r * win + wi
template <typename T>
__device__ __forceinline__ float activation(const StageArgs<T>& s, size_t q,
                                            int c) {
  float v = to_f(s.x[q * s.g.ci + c]);
  if (s.a != nullptr) {
    const float u = wf::bn_apply<T>(v, round_to<T>(s.m[c]),
                                    round_to<T>(s.a[c]), round_to<T>(s.b[c]));
    v = wf::silu_to<T>(u);
  }
  if (s.mask.bits != nullptr)
    v = s.mask.on(q, s.g.ci, c) ? round_to<T>(v / s.mask.keep) : 0.f;
  return v;
}

// the output's total cotangent at position p = r * wout + wo, in fp32
template <typename T>
__device__ __forceinline__ float cotangent(const StageArgs<T>& s, size_t p,
                                           int co) {
  float g = to_f(s.go[p * s.g.co + co]);
  if (s.gsums != nullptr)
    g += s.gsums[co] +
         2.f * to_f(s.out[p * s.g.co + co]) * s.gsums[s.g.co + co];
  return g;
}

// Sum red[which][0 .. ty_count)[n] in order; thread tid < 2 TN owns column
// n = tid % TN of which = tid / TN.
template <int TN>
__device__ __forceinline__ float column_sum(const float* red, int ty_count) {
  const int which = threadIdx.x / TN, n = threadIdx.x % TN;
  float t = 0.f;
  for (int y = 0; y < ty_count; ++y) t += red[(which * ty_count + y) * TN + n];
  return t;
}

template <typename T, int TN>
__global__ void __launch_bounds__(kThreads) stage_forward_kernel(
    StageArgs<T> s) {
  constexpr int TM = 4096 / TN, TX = TN / 4, TY = kThreads / TX;
  __shared__ __align__(16) float as[kTK * TM];
  __shared__ __align__(16) float bs[kTK * TN];
  __shared__ float red[2 * TY * TN];
  __shared__ int rowq[TM];
  __shared__ int roww[TM];
  const Geom g = s.g;
  const int cig = g.ci / g.groups, cog = g.co / g.groups;
  const int ntn = (cog + TN - 1) / TN;
  const int grp = blockIdx.y / ntn, n0 = (blockIdx.y % ntn) * TN;
  const int npos = g.rows * g.wout, ntiles = (npos + TM - 1) / TM;
  const int tid = threadIdx.x, tx = tid % TX, ty = tid / TX;
  float run = 0.f;

  for (int tile = blockIdx.x; tile < ntiles; tile += gridDim.x) {
    const int p0 = tile * TM;
    __syncthreads();
    for (int m = tid; m < TM; m += kThreads) {
      const int p = p0 + m;
      if (p < npos) {
        const int r = p / g.wout;
        rowq[m] = r * g.win;
        roww[m] = p - r * g.wout;
      } else {
        rowq[m] = -1;
      }
    }
    float acc[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;

    for (int j = 0; j < g.ktaps; ++j) {
      const int shift = (j - g.pad) * g.dil;
      for (int c0 = 0; c0 < cig; c0 += kTK) {
        __syncthreads();
        for (int e = tid; e < TM * kTK; e += kThreads) {
          const int k = e % kTK, m = e / kTK, c = c0 + k;
          float v = 0.f;
          if (rowq[m] >= 0 && c < cig) {
            const int wi = roww[m] * g.stride + shift;
            if (wi >= 0 && wi < g.win)
              v = activation(s, (size_t)(rowq[m] + wi), grp * cig + c);
          }
          as[k * TM + m] = v;
        }
        for (int e = tid; e < kTK * TN; e += kThreads) {
          const int n = e % TN, k = e / TN;
          float v = 0.f;
          if (c0 + k < cig && n0 + n < cog)
            v = round_to<T>(s.w[((size_t)(grp * cog + n0 + n) * cig + c0 + k) *
                                    g.ktaps + j]);
          bs[k * TN + n] = v;
        }
        __syncthreads();
        wf::tile_fma<TM, TN>(acc, as, bs, ty, tx, 0, kTK);
      }
    }

    float cs[4] = {0.f, 0.f, 0.f, 0.f}, cq[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int p = p0 + 4 * ty + i;
      if (p >= npos) continue;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int n = n0 + 4 * tx + j;
        if (n >= cog) continue;
        const int co = grp * cog + n;
        const float y = acc[i][j] + (s.bias != nullptr ? s.bias[co] : 0.f);
        const T o = wf::from_f<T>(y);
        s.out[(size_t)p * g.co + co] = o;
        const float f = to_f(o);
        cs[j] += f;
        cq[j] += f * f;
      }
    }
    if (s.partial != nullptr) {
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        red[(0 * TY + ty) * TN + 4 * tx + j] = cs[j];
        red[(1 * TY + ty) * TN + 4 * tx + j] = cq[j];
      }
      __syncthreads();
      if (tid < 2 * TN) run += column_sum<TN>(red, TY);
    }
  }
  if (s.partial != nullptr && tid < 2 * TN) {
    const int n = n0 + tid % TN;
    if (n < cog)
      s.partial[((size_t)blockIdx.x * 2 + tid / TN) * g.co + grp * cog + n] =
          run;
  }
}

template <typename T, int TN>
__global__ void __launch_bounds__(kThreads) stage_dgrad_kernel(
    StageArgs<T> s) {
  constexpr int TM = 4096 / TN, TX = TN / 4, TY = kThreads / TX;
  __shared__ __align__(16) float as[kTK * TM];
  __shared__ __align__(16) float bs[kTK * TN];
  __shared__ float red[2 * TY * TN];
  __shared__ int rowp[TM];
  __shared__ int roww[TM];
  const Geom g = s.g;
  const int cig = g.ci / g.groups, cog = g.co / g.groups;
  const int ntn = (cig + TN - 1) / TN;
  const int grp = blockIdx.y / ntn, n0 = (blockIdx.y % ntn) * TN;
  const int npos = g.rows * g.win, ntiles = (npos + TM - 1) / TM;
  const int tid = threadIdx.x, tx = tid % TX, ty = tid / TX;
  const bool prologue = s.a != nullptr;
  float run = 0.f;

  for (int tile = blockIdx.x; tile < ntiles; tile += gridDim.x) {
    const int q0 = tile * TM;
    __syncthreads();
    for (int m = tid; m < TM; m += kThreads) {
      const int q = q0 + m;
      if (q < npos) {
        const int r = q / g.win;
        rowp[m] = r * g.wout;
        roww[m] = q - r * g.win;
      } else {
        rowp[m] = -1;
      }
    }
    float acc[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;

    for (int j = 0; j < g.ktaps; ++j) {
      const int shift = (j - g.pad) * g.dil;
      for (int c0 = 0; c0 < cog; c0 += kTK) {
        __syncthreads();
        for (int e = tid; e < TM * kTK; e += kThreads) {
          const int k = e % kTK, m = e / kTK, c = c0 + k;
          float v = 0.f;
          if (rowp[m] >= 0 && c < cog) {
            // the output position that read this input through tap j
            const int t = roww[m] - shift;
            if (t >= 0 && t % g.stride == 0 && t / g.stride < g.wout)
              v = round_to<T>(cotangent(s, (size_t)(rowp[m] + t / g.stride),
                                        grp * cog + c));
          }
          as[k * TM + m] = v;
        }
        for (int e = tid; e < kTK * TN; e += kThreads) {
          const int n = e % TN, k = e / TN;
          float v = 0.f;
          if (c0 + k < cog && n0 + n < cig)
            v = round_to<T>(s.w[((size_t)(grp * cog + c0 + k) * cig + n0 + n) *
                                    g.ktaps + j]);
          bs[k * TN + n] = v;
        }
        __syncthreads();
        wf::tile_fma<TM, TN>(acc, as, bs, ty, tx, 0, kTK);
      }
    }

    float ca[4] = {0.f, 0.f, 0.f, 0.f}, cb[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int q = q0 + 4 * ty + i;
      if (q >= npos) continue;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int n = n0 + 4 * tx + j;
        if (n >= cig) continue;
        const int c = grp * cig + n;
        float gad = acc[i][j];
        if (s.mask.bits != nullptr)
          gad = s.mask.on((size_t)q, g.ci, c) ? gad / s.mask.keep : 0.f;
        float gx = gad;
        if (prologue) {
          const float xv = to_f(s.x[(size_t)q * g.ci + c]);
          const float at = round_to<T>(s.a[c]);
          const float u = wf::bn_apply<T>(xv, round_to<T>(s.m[c]), at,
                                          round_to<T>(s.b[c]));
          const float gu = gad * wf::dsilu(u, wf::sigmoid(u));
          gx = gu * at;
          ca[j] += gu * xv;
          cb[j] += gu;
        }
        s.gx[(size_t)q * g.ci + c] = wf::from_f<T>(gx);
      }
    }
    if (prologue) {
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        red[(0 * TY + ty) * TN + 4 * tx + j] = ca[j];
        red[(1 * TY + ty) * TN + 4 * tx + j] = cb[j];
      }
      __syncthreads();
      if (tid < 2 * TN) run += column_sum<TN>(red, TY);
    }
  }
  if (prologue && tid < 2 * TN) {
    const int n = n0 + tid % TN;
    if (n < cig)
      s.partial_ab[((size_t)blockIdx.x * 2 + tid / TN) * g.ci + grp * cig +
                   n] = run;
  }
}

template <typename T, int TM, int TN>
__global__ void __launch_bounds__(kThreads) stage_wgrad_kernel(
    StageArgs<T> s) {
  constexpr int TX = TN / 4, TY = TM / 4;
  constexpr int KS = kThreads / (TX * TY);         // slices of the reduction
  constexpr int TKB = KS * 8 > kTK ? KS * 8 : kTK;  // positions per tile
  constexpr int KPS = TKB / KS;
  __shared__ __align__(16) float as[TKB * TM];
  __shared__ __align__(16) float bs[TKB * TN];
  __shared__ float bu[TKB * TN];     // the cotangent before rounding
  __shared__ float accs[TM * TN];
  __shared__ int rowq[TKB];
  __shared__ int roww[TKB];
  const Geom g = s.g;
  const int cig = g.ci / g.groups, cog = g.co / g.groups;
  const int mtot = g.ktaps * cig;
  const int ntm = (mtot + TM - 1) / TM, ntn = (cog + TN - 1) / TN;
  const int grp = blockIdx.y / (ntm * ntn);
  const int rem = blockIdx.y % (ntm * ntn);
  const int m0 = (rem / ntn) * TM, n0 = (rem % ntn) * TN;
  const int npos = g.rows * g.wout;
  const int pbeg = blockIdx.x * s.chunk;
  const int pend = min(npos, pbeg + s.chunk);
  const int tid = threadIdx.x;
  const int slice = tid / (TX * TY), t2 = tid % (TX * TY);
  const int tx = t2 % TX, ty = t2 / TX;
  const bool do_bias = s.ldw > g.co * mtot && m0 == 0;
  float bsum = 0.f;
  float acc[4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;

  for (int pb = pbeg; pb < pend; pb += TKB) {
    __syncthreads();
    for (int kk = tid; kk < TKB; kk += kThreads) {
      const int p = pb + kk;
      if (p < pend) {
        const int r = p / g.wout;
        rowq[kk] = r * g.win;
        roww[kk] = p - r * g.wout;
      } else {
        rowq[kk] = -1;
      }
    }
    __syncthreads();
    for (int e = tid; e < TKB * TM; e += kThreads) {
      const int m = e % TM, kk = e / TM, mm = m0 + m;
      float v = 0.f;
      if (rowq[kk] >= 0 && mm < mtot) {
        const int j = mm / cig, c = mm - j * cig;
        const int wi = roww[kk] * g.stride + (j - g.pad) * g.dil;
        if (wi >= 0 && wi < g.win)
          v = activation(s, (size_t)(rowq[kk] + wi), grp * cig + c);
      }
      as[kk * TM + m] = v;
    }
    for (int e = tid; e < TKB * TN; e += kThreads) {
      const int n = e % TN, kk = e / TN;
      float v = 0.f;
      if (rowq[kk] >= 0 && n0 + n < cog)
        v = cotangent(s, (size_t)(pb + kk), grp * cog + n0 + n);
      bs[e] = round_to<T>(v);
      bu[e] = v;
    }
    __syncthreads();
    wf::tile_fma<TM, TN>(acc, as, bs, ty, tx, slice * KPS, (slice + 1) * KPS);
    if (do_bias && tid < TN)
      for (int kk = 0; kk < TKB; ++kk) bsum += bu[kk * TN + tid];
  }

  // add the slices in order
  for (int sl = 0; sl < KS; ++sl) {
    __syncthreads();
    if (slice == sl) {
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          float* dst = &accs[(4 * ty + i) * TN + 4 * tx + j];
          *dst = sl == 0 ? acc[i][j] : *dst + acc[i][j];
        }
    }
  }
  __syncthreads();
  float* part = s.partial_w + (size_t)blockIdx.x * s.ldw;
  for (int e = tid; e < TM * TN; e += kThreads) {
    const int n = e % TN, m = e / TN, mm = m0 + m;
    if (mm < mtot && n0 + n < cog) {
      const int j = mm / cig, c = mm - j * cig;
      part[((size_t)(grp * cog + n0 + n) * cig + c) * g.ktaps + j] = accs[e];
    }
  }
  if (do_bias && tid < TN && n0 + tid < cog)
    part[(size_t)g.co * mtot + grp * cog + n0 + tid] = bsum;
}

bool bad_geom(const Geom& g) {
  return g.rows < 1 || g.win < 1 || g.wout < 1 || g.ci < 1 || g.co < 1 ||
         g.groups < 1 || g.ci % g.groups || g.co % g.groups || g.ktaps < 1 ||
         g.stride < 1 || g.dil < 1 || g.pad < 0 ||
         (long long)g.rows * g.win * g.ci >= (1ll << 31) ||
         (long long)g.rows * g.wout * g.co >= (1ll << 31);
}

template <typename T, int TN>
int launch_forward(const StageArgs<T>& s, int grid_x, cudaStream_t st) {
  const int cog = s.g.co / s.g.groups;
  const dim3 grid(grid_x, s.g.groups * ((cog + TN - 1) / TN));
  auto kernel = stage_forward_kernel<T, TN>;
  WF_LAUNCH(kernel, grid, kThreads, 0, st, s);
  return (int)cudaGetLastError();
}

template <typename T, int TN>
int launch_dgrad(const StageArgs<T>& s, int grid_x, cudaStream_t st) {
  const int cig = s.g.ci / s.g.groups;
  const dim3 grid(grid_x, s.g.groups * ((cig + TN - 1) / TN));
  auto kernel = stage_dgrad_kernel<T, TN>;
  WF_LAUNCH(kernel, grid, kThreads, 0, st, s);
  return (int)cudaGetLastError();
}

template <typename T, int TM, int TN>
int launch_wgrad(const StageArgs<T>& s, int splits, cudaStream_t st) {
  const int cig = s.g.ci / s.g.groups, cog = s.g.co / s.g.groups;
  const int mtot = s.g.ktaps * cig;
  const dim3 grid(splits, s.g.groups * ((mtot + TM - 1) / TM) *
                              ((cog + TN - 1) / TN));
  auto kernel = stage_wgrad_kernel<T, TM, TN>;
  WF_LAUNCH(kernel, grid, kThreads, 0, st, s);
  return (int)cudaGetLastError();
}

template <typename T, int TM>
int launch_wgrad_tn(const StageArgs<T>& s, int tn, int splits,
                    cudaStream_t st) {
  switch (tn) {
    case 8: return launch_wgrad<T, TM, 8>(s, splits, st);
    case 16: return launch_wgrad<T, TM, 16>(s, splits, st);
    case 32: return launch_wgrad<T, TM, 32>(s, splits, st);
    case 64: return launch_wgrad<T, TM, 64>(s, splits, st);
  }
  return (int)cudaErrorInvalidValue;
}

template <typename T>
int run_forward(StageArgs<T> s, float* sums, int tn, int grid_x,
                cudaStream_t st) {
  if (bad_geom(s.g) || grid_x < 1) return (int)cudaErrorInvalidValue;
  int rc;
  switch (tn) {
    case 8: rc = launch_forward<T, 8>(s, grid_x, st); break;
    case 16: rc = launch_forward<T, 16>(s, grid_x, st); break;
    case 32: rc = launch_forward<T, 32>(s, grid_x, st); break;
    case 64: rc = launch_forward<T, 64>(s, grid_x, st); break;
    default: return (int)cudaErrorInvalidValue;
  }
  if (rc != 0 || s.partial == nullptr) return rc;
  const int cols = 2 * s.g.co;
  auto reduce = wf::reduce_rows;
  WF_LAUNCH(reduce, (cols + wf::kReduceCols - 1) / wf::kReduceCols, kThreads,
            0, st, s.partial, grid_x, cols, cols, sums);
  return (int)cudaGetLastError();
}

template <typename T>
int run_backward(StageArgs<T> s, float* gmab, float* gw, int tn_d,
                 int grid_x_d, int tm_w, int tn_w, int splits, int bf16,
                 cudaStream_t st) {
  if (bad_geom(s.g) || splits < 1 || s.chunk < 1)
    return (int)cudaErrorInvalidValue;
  int rc;
  if (s.gx != nullptr) {
    if (grid_x_d < 1) return (int)cudaErrorInvalidValue;
    switch (tn_d) {
      case 8: rc = launch_dgrad<T, 8>(s, grid_x_d, st); break;
      case 16: rc = launch_dgrad<T, 16>(s, grid_x_d, st); break;
      case 32: rc = launch_dgrad<T, 32>(s, grid_x_d, st); break;
      case 64: rc = launch_dgrad<T, 64>(s, grid_x_d, st); break;
      default: return (int)cudaErrorInvalidValue;
    }
    if (rc != 0) return rc;
    if (s.a != nullptr) {
      wf::AffineGradArgs ag{s.partial_ab, grid_x_d, 2 * s.g.ci, s.g.ci, bf16,
                            {s.m, nullptr}, {s.a, nullptr}, gmab};
      auto reduce = wf::reduce_affine_grads;
      const dim3 grid((s.g.ci + wf::kReduceCols - 1) / wf::kReduceCols, 1);
      WF_LAUNCH(reduce, grid, kThreads, 0, st, ag);
      rc = (int)cudaGetLastError();
      if (rc != 0) return rc;
    }
  }
  if (tm_w == 32)
    rc = launch_wgrad_tn<T, 32>(s, tn_w, splits, st);
  else if (tm_w == 64)
    rc = launch_wgrad_tn<T, 64>(s, tn_w, splits, st);
  else
    return (int)cudaErrorInvalidValue;
  if (rc != 0) return rc;
  auto reduce = wf::reduce_rows;
  WF_LAUNCH(reduce, (s.ldw + wf::kReduceCols - 1) / wf::kReduceCols, kThreads,
            0, st, s.partial_w, splits, s.ldw, s.ldw, gw);
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

}  // namespace

extern "C" int stage_forward(int dtype, const void* x, const void* m,
                             const void* a, const void* b, const void* mask,
                             int mask_div, float keep, const void* w,
                             const void* bias, void* out, void* partial,
                             void* sums, int rows, int win, int wout, int ci,
                             int co, int groups, int ktaps, int stride,
                             int dil, int pad, int tn, int grid_x,
                             void* stream) {
  const Geom g{rows, win, wout, ci, co, groups, ktaps, stride, dil, pad};
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == wf::kF32) {
    auto s = make_args<float>(x, m, a, b, mask, mask_div, keep, w, g);
    s.bias = static_cast<const float*>(bias);
    s.out = static_cast<float*>(out);
    s.partial = static_cast<float*>(partial);
    return run_forward(s, static_cast<float*>(sums), tn, grid_x, st);
  }
  if (dtype == wf::kBF16) {
    auto s = make_args<__nv_bfloat16>(x, m, a, b, mask, mask_div, keep, w, g);
    s.bias = static_cast<const float*>(bias);
    s.out = static_cast<__nv_bfloat16*>(out);
    s.partial = static_cast<float*>(partial);
    return run_forward(s, static_cast<float*>(sums), tn, grid_x, st);
  }
  return (int)cudaErrorInvalidValue;
}

// gx null: no input gradient (and no g_m, g_a, g_b).  gw is [ldw]: the
// weight's gradient in its own layout, then gbias when ldw = nw + co.
extern "C" int stage_backward(int dtype, const void* x, const void* m,
                              const void* a, const void* b, const void* mask,
                              int mask_div, float keep, const void* w,
                              const void* out, const void* go,
                              const void* gsums, void* gx, void* partial_ab,
                              void* gmab, void* partial_w, void* gw, int ldw,
                              int rows, int win, int wout, int ci, int co,
                              int groups, int ktaps, int stride, int dil,
                              int pad, int tn_d, int grid_x_d, int tm_w,
                              int tn_w, int splits, int chunk, void* stream) {
  const Geom g{rows, win, wout, ci, co, groups, ktaps, stride, dil, pad};
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == wf::kF32) {
    auto s = make_args<float>(x, m, a, b, mask, mask_div, keep, w, g);
    s.out = const_cast<float*>(static_cast<const float*>(out));
    s.go = static_cast<const float*>(go);
    s.gsums = static_cast<const float*>(gsums);
    s.gx = static_cast<float*>(gx);
    s.partial_ab = static_cast<float*>(partial_ab);
    s.partial_w = static_cast<float*>(partial_w);
    s.ldw = ldw;
    s.chunk = chunk;
    return run_backward(s, static_cast<float*>(gmab), static_cast<float*>(gw),
                        tn_d, grid_x_d, tm_w, tn_w, splits, 0, st);
  }
  if (dtype == wf::kBF16) {
    using B = __nv_bfloat16;
    auto s = make_args<B>(x, m, a, b, mask, mask_div, keep, w, g);
    s.out = const_cast<B*>(static_cast<const B*>(out));
    s.go = static_cast<const B*>(go);
    s.gsums = static_cast<const float*>(gsums);
    s.gx = static_cast<B*>(gx);
    s.partial_ab = static_cast<float*>(partial_ab);
    s.partial_w = static_cast<float*>(partial_w);
    s.ldw = ldw;
    s.chunk = chunk;
    return run_backward(s, static_cast<float*>(gmab), static_cast<float*>(gw),
                        tn_d, grid_x_d, tm_w, tn_w, splits, 1, st);
  }
  return (int)cudaErrorInvalidValue;
}

WF_EXPORT_ERROR_STRING
