// bf16 tensor-core primitives shared by the port's kernels (sm_90a):
// mma.sync m16n8k16 with fp32 accumulation, the ldmatrix loads that feed
// it from shared memory, and the asynchronous copies (cp.async, and the
// bulk copy with its mbarriers) that fill shared-memory rings from device
// memory without passing through registers.
//
// Fragment layout of one warp (gid = lane / 4, tig = lane % 4):
//   A (16 x 16, row-major): a0 = A[gid][2 tig ..], a1 = A[gid + 8][2 tig ..],
//                           a2 = A[gid][2 tig + 8 ..], a3 = A[gid + 8][2 tig + 8 ..]
//   B (16 x 8):             b0 = B[2 tig ..][gid], b1 = B[2 tig + 8 ..][gid]
//   C (16 x 8, fp32):       c0, c1 = C[gid][2 tig, 2 tig + 1],
//                           c2, c3 = C[gid + 8][2 tig, 2 tig + 1]
// ldmatrix reads 8 x 8 matrices whose rows are 16 contiguous bytes; each
// lane gives the address of one row (lanes 8 i .. 8 i + 7 those of matrix
// i).  The plain form hands a thread the pair at [gid][2 tig ..] of each
// matrix: A from a [m][k] tile, B from a [n][k] tile.  The .trans form
// hands it the pair at [2 tig ..][gid]: A from a [k][m] tile, B from a
// [k][n] tile.
#pragma once

#include <cuda_bf16.h>
#include <stdint.h>

namespace wf {

__device__ __forceinline__ uint32_t pack2(__nv_bfloat16 lo, __nv_bfloat16 hi) {
  __nv_bfloat162 v;
  v.x = lo;
  v.y = hi;
  return *reinterpret_cast<uint32_t*>(&v);
}

__device__ __forceinline__ void mma_bf16(float (&d)[4], const uint32_t (&a)[4],
                                         const uint32_t (&b)[2]) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// Four 8x8 bf16 matrices from shared memory, one row address per lane.
__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4],
                                            const __nv_bfloat16* p) {
  const unsigned addr = static_cast<unsigned>(__cvta_generic_to_shared(p));
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(addr));
}

__device__ __forceinline__ void ldmatrix_x2(uint32_t (&r)[2],
                                            const __nv_bfloat16* p) {
  const unsigned addr = static_cast<unsigned>(__cvta_generic_to_shared(p));
  asm volatile("ldmatrix.sync.aligned.m8n8.x2.shared.b16 {%0, %1}, [%2];\n"
               : "=r"(r[0]), "=r"(r[1])
               : "r"(addr));
}

__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t (&r)[4],
                                                  const __nv_bfloat16* p) {
  const unsigned addr = static_cast<unsigned>(__cvta_generic_to_shared(p));
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(addr));
}

__device__ __forceinline__ void ldmatrix_x2_trans(uint32_t (&r)[2],
                                                  const __nv_bfloat16* p) {
  const unsigned addr = static_cast<unsigned>(__cvta_generic_to_shared(p));
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x2.trans.shared.b16 {%0, %1}, [%2];\n"
      : "=r"(r[0]), "=r"(r[1])
      : "r"(addr));
}

// 16 bytes from device to shared memory, asynchronously; with valid false
// the 16 bytes are filled with zeros (src is not read).
__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           bool valid = true) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  const int bytes = valid ? 16 : 0;
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(d),
               "l"(src), "r"(bytes));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

// Wait until at most N of this thread's committed groups are in flight.
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

// mbarriers in shared memory, and the bulk copy (the Tensor Memory
// Accelerator's 1-D form) that reports its bytes to one of them.
__device__ __forceinline__ unsigned smem_addr(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint64_t* bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;" ::"r"(smem_addr(bar)),
               "r"(count));
}

// Makes the initialised barriers visible to the other threads and to the
// asynchronous copies.
__device__ __forceinline__ void mbar_init_fence() {
  asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
}

__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];" ::"r"(
                   smem_addr(bar))
               : "memory");
}

// Waits until the barrier's phase of the given parity has completed.
__device__ __forceinline__ void mbar_wait(uint64_t* bar, int parity) {
  uint32_t done = 0;
  while (!done)
    asm volatile(
        "{ .reg .pred p; mbarrier.try_wait.parity.shared::cta.b64 p, [%1], "
        "%2; selp.u32 %0, 1, 0, p; }"
        : "=r"(done)
        : "r"(smem_addr(bar)), "r"(parity)
        : "memory");
}

// Arrives on the barrier and raises the bytes its phase waits for.
__device__ __forceinline__ void mbar_expect_tx(uint64_t* bar, int bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;" ::"r"(
                   smem_addr(bar)),
               "r"(bytes)
               : "memory");
}

// `bytes` (a multiple of 16, both addresses 16-byte aligned) from device to
// shared memory, counted against the barrier's expected bytes as they land.
__device__ __forceinline__ void bulk_copy_tx(void* dst, const void* src,
                                             int bytes, uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], "
      "[%1], %2, [%3];" ::"r"(smem_addr(dst)),
      "l"(src), "r"(bytes), "r"(smem_addr(bar))
      : "memory");
}

// One bulk copy; the barrier's phase completes when its bytes have landed.
// One thread arrives for the copy.
__device__ __forceinline__ void bulk_copy_g2s(void* dst, const void* src,
                                              int bytes, uint64_t* bar) {
  mbar_expect_tx(bar, bytes);
  bulk_copy_tx(dst, src, bytes, bar);
}

}  // namespace wf
