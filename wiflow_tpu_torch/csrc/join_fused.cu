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
// What bounds it on the H100: bytes.  The forward reads h and res and
// writes out (three tensors; at batch 256 the TCN's widest level is 5.5 MB
// each in bf16, the conv stack's widest block 19.7 MB each), a few
// microseconds at 3.35 TB/s.
//
// Design: one thread per column of a block of `cw` (8, 16 or 32) channels,
// 256 / cw rows a pass, blocks walking the rows with a fixed stride, so
// that a warp reads whole rows of the channel block.  The backward keeps
// its four column sums in registers, adds the block's row lanes in order,
// and wf::reduce_affine_grads adds the blocks' partials in float64 (no
// atomics; the TPU kernel's sequential-grid accumulation is not carried
// over).
#include "stage_common.cuh"

namespace {

using wf::kThreads;
using wf::round_to;
using wf::to_f;

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
  float* partial;        // [gridDim.x, 4, c]: A_h, B_h, A_r, B_r
  int npos, c, cw, act_h;
};

template <typename T>
__global__ void __launch_bounds__(kThreads) join_forward_kernel(
    JoinArgs<T> j) {
  const int lanes = kThreads / j.cw;
  const int c = blockIdx.y * j.cw + threadIdx.x % j.cw;
  const int lane = threadIdx.x / j.cw;
  if (c >= j.c) return;
  const float mh = round_to<T>(j.mh[c]), ah = round_to<T>(j.ah[c]),
              bh = round_to<T>(j.bh[c]);
  const bool rn = j.ar != nullptr;
  const float mr = rn ? round_to<T>(j.mr[c]) : 0.f;
  const float ar = rn ? round_to<T>(j.ar[c]) : 0.f;
  const float br = rn ? round_to<T>(j.br[c]) : 0.f;
  for (int p = blockIdx.x * lanes + lane; p < j.npos;
       p += gridDim.x * lanes) {
    const size_t i = (size_t)p * j.c + c;
    float v = wf::bn_apply<T>(to_f(j.h[i]), mh, ah, bh);
    if (j.act_h) v = wf::silu_to<T>(v);
    if (j.mask.bits != nullptr)
      v = j.mask.on((size_t)p, j.c, c) ? round_to<T>(v / j.mask.keep) : 0.f;
    float r = to_f(j.res[i]);
    if (rn) r = wf::bn_apply<T>(r, mr, ar, br);
    const float sum = round_to<T>(v + r);
    j.out[i] = wf::from_f<T>(sum * wf::sigmoid(sum));
  }
}

template <typename T>
__global__ void __launch_bounds__(kThreads) join_backward_kernel(
    JoinArgs<T> j) {
  __shared__ float red[4][kThreads];
  const int lanes = kThreads / j.cw;
  const int cc = threadIdx.x % j.cw, lane = threadIdx.x / j.cw;
  const int c = blockIdx.y * j.cw + cc;
  const bool valid = c < j.c;
  const bool rn = j.ar != nullptr;
  float mh = 0.f, ah = 0.f, bh = 0.f, mr = 0.f, ar = 0.f, br = 0.f;
  if (valid) {
    mh = round_to<T>(j.mh[c]);
    ah = round_to<T>(j.ah[c]);
    bh = round_to<T>(j.bh[c]);
    if (rn) {
      mr = round_to<T>(j.mr[c]);
      ar = round_to<T>(j.ar[c]);
      br = round_to<T>(j.br[c]);
    }
  }
  float sums[4] = {0.f, 0.f, 0.f, 0.f};
  if (valid) {
    for (int p = blockIdx.x * lanes + lane; p < j.npos;
         p += gridDim.x * lanes) {
      const size_t i = (size_t)p * j.c + c;
      const float hv = to_f(j.h[i]);
      const float uh = wf::bn_apply<T>(hv, mh, ah, bh);
      float sig_h = 0.f, v = uh;
      if (j.act_h) {
        sig_h = wf::sigmoid(uh);
        v = round_to<T>(uh * sig_h);
      }
      bool kept = true;
      if (j.mask.bits != nullptr) {
        kept = j.mask.on((size_t)p, j.c, c);
        v = kept ? round_to<T>(v / j.mask.keep) : 0.f;
      }
      const float rv = to_f(j.res[i]);
      const float r = rn ? wf::bn_apply<T>(rv, mr, ar, br) : rv;
      const float sum = round_to<T>(v + r);
      const float gv = to_f(j.go[i]) * wf::dsilu(sum, wf::sigmoid(sum));
      // residual branch
      if (rn) {
        j.gres[i] = wf::from_f<T>(gv * ar);
        sums[2] += gv * rv;
        sums[3] += gv;
      } else {
        j.gres[i] = wf::from_f<T>(gv);
      }
      // main branch
      float gu = gv;
      if (j.mask.bits != nullptr) gu = kept ? gv / j.mask.keep : 0.f;
      if (j.act_h) gu *= wf::dsilu(uh, sig_h);
      j.gh[i] = wf::from_f<T>(gu * ah);
      sums[0] += gu * hv;
      sums[1] += gu;
    }
  }
#pragma unroll
  for (int s = 0; s < 4; ++s) red[s][threadIdx.x] = sums[s];
  __syncthreads();
  if (lane == 0 && valid) {
    for (int s = 0; s < 4; ++s) {
      float t = 0.f;
      for (int l = 0; l < lanes; ++l) t += red[s][l * j.cw + cc];
      j.partial[((size_t)blockIdx.x * 4 + s) * j.c + c] = t;
    }
  }
}

template <typename T>
int run(bool backward, JoinArgs<T> j, float* gvec, int grid_x, int bf16,
        cudaStream_t st) {
  if (j.npos < 1 || j.c < 1 || grid_x < 1 ||
      (j.cw != 8 && j.cw != 16 && j.cw != 32) ||
      (long long)j.npos * j.c >= (1ll << 31))
    return (int)cudaErrorInvalidValue;
  const dim3 grid(grid_x, (j.c + j.cw - 1) / j.cw);
  if (!backward) {
    auto kernel = join_forward_kernel<T>;
    WF_LAUNCH(kernel, grid, kThreads, 0, st, j);
    return (int)cudaGetLastError();
  }
  auto kernel = join_backward_kernel<T>;
  WF_LAUNCH(kernel, grid, kThreads, 0, st, j);
  int rc = (int)cudaGetLastError();
  if (rc != 0) return rc;
  wf::AffineGradArgs ag{j.partial, grid_x, 4 * j.c, j.c, bf16,
                        {j.mh, j.mr}, {j.ah, j.ar}, gvec};
  auto reduce = wf::reduce_affine_grads;
  const dim3 rgrid((j.c + wf::kReduceCols - 1) / wf::kReduceCols,
                   j.ar != nullptr ? 2 : 1);
  WF_LAUNCH(reduce, rgrid, kThreads, 0, st, ag);
  return (int)cudaGetLastError();
}

template <typename T>
JoinArgs<T> make_args(const void* h, const void* mh, const void* ah,
                      const void* bh, const void* mask, int mask_div,
                      float keep, const void* res, const void* mr,
                      const void* ar, const void* br, int act_h, int npos,
                      int c, int cw) {
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
  j.cw = cw;
  return j;
}

}  // namespace

extern "C" int join_forward(int dtype, const void* h, const void* mh,
                            const void* ah, const void* bh, const void* mask,
                            int mask_div, float keep, const void* res,
                            const void* mr, const void* ar, const void* br,
                            int act_h, void* out, int npos, int c, int cw,
                            int grid_x, void* stream) {
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == wf::kF32) {
    auto j = make_args<float>(h, mh, ah, bh, mask, mask_div, keep, res, mr,
                              ar, br, act_h, npos, c, cw);
    j.out = static_cast<float*>(out);
    return run(false, j, nullptr, grid_x, 0, st);
  }
  if (dtype == wf::kBF16) {
    auto j = make_args<__nv_bfloat16>(h, mh, ah, bh, mask, mask_div, keep,
                                      res, mr, ar, br, act_h, npos, c, cw);
    j.out = static_cast<__nv_bfloat16*>(out);
    return run(false, j, nullptr, grid_x, 1, st);
  }
  return (int)cudaErrorInvalidValue;
}

// gvec is [2, 3, c]: (g_m, g_a, g_b) of the main branch, then of the
// residual branch (written only when mr, ar, br are given).
extern "C" int join_backward(int dtype, const void* h, const void* mh,
                             const void* ah, const void* bh, const void* mask,
                             int mask_div, float keep, const void* res,
                             const void* mr, const void* ar, const void* br,
                             int act_h, const void* go, void* gh, void* gres,
                             void* partial, void* gvec, int npos, int c,
                             int cw, int grid_x, void* stream) {
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == wf::kF32) {
    auto j = make_args<float>(h, mh, ah, bh, mask, mask_div, keep, res, mr,
                              ar, br, act_h, npos, c, cw);
    j.go = static_cast<const float*>(go);
    j.gh = static_cast<float*>(gh);
    j.gres = static_cast<float*>(gres);
    j.partial = static_cast<float*>(partial);
    return run(true, j, static_cast<float*>(gvec), grid_x, 0, st);
  }
  if (dtype == wf::kBF16) {
    using B = __nv_bfloat16;
    auto j = make_args<B>(h, mh, ah, bh, mask, mask_div, keep, res, mr, ar,
                          br, act_h, npos, c, cw);
    j.go = static_cast<const B*>(go);
    j.gh = static_cast<B*>(gh);
    j.gres = static_cast<B*>(gres);
    j.partial = static_cast<float*>(partial);
    return run(true, j, static_cast<float*>(gvec), grid_x, 1, st);
  }
  return (int)cudaErrorInvalidValue;
}

WF_EXPORT_ERROR_STRING
