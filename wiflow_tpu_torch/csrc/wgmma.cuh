// Hopper's warpgroup matrix multiply (wgmma) for bf16 with fp32
// accumulation (sm_90a), and the shared-memory matrix descriptors it reads.
//
// A warpgroup (4 consecutive warps, the first a multiple of 4) issues
// wgmma.mma_async m64nNk16: D[64, N] += A[64, 16] x B[16, N], A and B read
// from shared memory through 64-bit descriptors, D in registers.  Thread
// slot d[4 j + q] of warp w (of the warpgroup), lane = 4 gid + tig, holds
// row 16 w + gid + 8 (q / 2), column 8 j + 2 tig + q % 2: the mma.sync
// m16n8 accumulator of each 8-column tile, one 16-row band a warp.
//
// Both operands here are K-major (K contiguous within a row of 16 bytes):
//   128-byte swizzle (layout 1): rows of 64 bf16 (128 bytes), 8 rows an
//     atom of 1024 bytes; 16-byte chunk c of row r sits at chunk c ^ (r %
//     8).  The hardware applies the swizzle to address bits, so an atom
//     starts on 1024 bytes; a 16-deep k-step inside the atom starts 32
//     bytes further; SBO = 1024 steps 8 rows.
//   no swizzle (layout 0): core matrices of 8 rows x 16 bytes, 128
//     contiguous bytes each; LBO steps one core matrix along K, SBO one
//     along M or N.
// Issue order: fence (registers written by other instructions), the
// products, commit, wait; fence_acc pins the accumulators so that the
// compiler reads them only after the wait.
#pragma once

#include <stdint.h>

namespace wf {

// A shared-memory matrix descriptor: start address, leading and stride
// byte offsets (16-byte units), layout (0 none, 1 128-byte swizzle).
__device__ __forceinline__ uint64_t gmma_desc(uint32_t addr, uint32_t lbo,
                                              uint32_t sbo, uint64_t layout) {
  return (uint64_t)((addr & 0x3FFFF) >> 4) | ((uint64_t)(lbo >> 4) << 16) |
         ((uint64_t)(sbo >> 4) << 32) | (layout << 62);
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;" ::: "memory");
}

__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;" ::: "memory");
}

// Waits until at most N committed groups of this warp are in flight.
template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;" ::"n"(N) : "memory");
}

template <int R>
__device__ __forceinline__ void fence_acc(float (&d)[R]) {
#pragma unroll
  for (int i = 0; i < R; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

// Writes by ordinary stores to shared memory, made visible to the
// asynchronous proxy that wgmma reads through (before a barrier).
__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
}

// wgmma_bf16<NT>(d, a, b): d[4 NT] += A x B, N = 8 NT, accumulating
// (scale-d is the predicate "a != 0", true of every descriptor).  The
// operand lists: %0, %1 the descriptors, then the accumulators.
template <int NT, int R>
__device__ __forceinline__ void wgmma_bf16(float (&d)[R], uint64_t a,
                                           uint64_t b);

#define WF_ACC4(i)                                                    \
  "+f"(d[4 * (i)]), "+f"(d[4 * (i) + 1]), "+f"(d[4 * (i) + 2]),       \
      "+f"(d[4 * (i) + 3])
#define WF_S1 "%2, %3, %4, %5"
#define WF_S2 WF_S1 ", %6, %7, %8, %9"
#define WF_S3 WF_S2 ", %10, %11, %12, %13"
#define WF_S4 WF_S3 ", %14, %15, %16, %17"
#define WF_S5 WF_S4 ", %18, %19, %20, %21"
#define WF_S6 WF_S5 ", %22, %23, %24, %25"
#define WF_S7 WF_S6 ", %26, %27, %28, %29"
#define WF_S8 WF_S7 ", %30, %31, %32, %33"
#define WF_S9 WF_S8 ", %34, %35, %36, %37"
#define WF_S10 WF_S9 ", %38, %39, %40, %41"
#define WF_S11 WF_S10 ", %42, %43, %44, %45"
#define WF_S12 WF_S11 ", %46, %47, %48, %49"
#define WF_S13 WF_S12 ", %50, %51, %52, %53"
#define WF_S14 WF_S13 ", %54, %55, %56, %57"
#define WF_S15 WF_S14 ", %58, %59, %60, %61"
#define WF_S16 WF_S15 ", %62, %63, %64, %65"
#define WF_S17 WF_S16 ", %66, %67, %68, %69"
#define WF_S18 WF_S17 ", %70, %71, %72, %73"
#define WF_S19 WF_S18 ", %74, %75, %76, %77"
#define WF_S20 WF_S19 ", %78, %79, %80, %81"
#define WF_S21 WF_S20 ", %82, %83, %84, %85"
#define WF_S22 WF_S21 ", %86, %87, %88, %89"
#define WF_S23 WF_S22 ", %90, %91, %92, %93"
#define WF_S24 WF_S23 ", %94, %95, %96, %97"
#define WF_C1 WF_ACC4(0)
#define WF_C2 WF_C1, WF_ACC4(1)
#define WF_C3 WF_C2, WF_ACC4(2)
#define WF_C4 WF_C3, WF_ACC4(3)
#define WF_C5 WF_C4, WF_ACC4(4)
#define WF_C6 WF_C5, WF_ACC4(5)
#define WF_C7 WF_C6, WF_ACC4(6)
#define WF_C8 WF_C7, WF_ACC4(7)
#define WF_C9 WF_C8, WF_ACC4(8)
#define WF_C10 WF_C9, WF_ACC4(9)
#define WF_C11 WF_C10, WF_ACC4(10)
#define WF_C12 WF_C11, WF_ACC4(11)
#define WF_C13 WF_C12, WF_ACC4(12)
#define WF_C14 WF_C13, WF_ACC4(13)
#define WF_C15 WF_C14, WF_ACC4(14)
#define WF_C16 WF_C15, WF_ACC4(15)
#define WF_C17 WF_C16, WF_ACC4(16)
#define WF_C18 WF_C17, WF_ACC4(17)
#define WF_C19 WF_C18, WF_ACC4(18)
#define WF_C20 WF_C19, WF_ACC4(19)
#define WF_C21 WF_C20, WF_ACC4(20)
#define WF_C22 WF_C21, WF_ACC4(21)
#define WF_C23 WF_C22, WF_ACC4(22)
#define WF_C24 WF_C23, WF_ACC4(23)

#define WF_WGMMA(NT, N)                                                    \
  template <>                                                              \
  __device__ __forceinline__ void wgmma_bf16<NT, 4 * NT>(                  \
      float(&d)[4 * NT], uint64_t a, uint64_t b) {                         \
    asm volatile(                                                          \
        "{\n.reg .pred p;\nsetp.ne.b64 p, %0, 0;\n"                        \
        "wgmma.mma_async.sync.aligned.m64n" #N                             \
        "k16.f32.bf16.bf16 {" WF_S##NT "}, %0, %1, p, 1, 1, 0, 0;\n}\n"    \
        : "+l"(a), "+l"(b), WF_C##NT);                                     \
  }
WF_WGMMA(1, 8)
WF_WGMMA(2, 16)
WF_WGMMA(3, 24)
WF_WGMMA(4, 32)
WF_WGMMA(5, 40)
WF_WGMMA(6, 48)
WF_WGMMA(7, 56)
WF_WGMMA(8, 64)
WF_WGMMA(9, 72)
WF_WGMMA(10, 80)
WF_WGMMA(11, 88)
WF_WGMMA(12, 96)
WF_WGMMA(13, 104)
WF_WGMMA(14, 112)
WF_WGMMA(15, 120)
WF_WGMMA(16, 128)
WF_WGMMA(17, 136)
WF_WGMMA(18, 144)
WF_WGMMA(19, 152)
WF_WGMMA(20, 160)
WF_WGMMA(21, 168)
WF_WGMMA(22, 176)
WF_WGMMA(23, 184)
WF_WGMMA(24, 192)

#undef WF_WGMMA
#undef WF_ACC4

}  // namespace wf
