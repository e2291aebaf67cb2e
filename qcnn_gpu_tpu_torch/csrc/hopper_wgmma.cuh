// Hopper primitives of the split-design kernels (qvrcnn_fused.cu, and
// through qvrcnn_split.cuh qvrcnn_pair.cu and qvrcnn_literal.cu): int8
// `wgmma` with both operands in shared memory, its descriptors and
// fences, and the asynchronous copies and proxy fence around it.
//
// Operand layout (PTX ISA, "Shared memory matrix layout", K-major, no
// swizzle): a core matrix is 8 rows x 16 bytes, 128 contiguous bytes. A
// k32 instruction reads two core matrices along K per 8 rows; the
// descriptor gives the start address, the leading-dimension byte offset
// (between the two K halves) and the stride byte offset (between
// consecutive 8-row groups), each in 16-byte units.

#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

namespace hopper {

// Descriptor of a K-major operand without swizzle. Address and offsets
// are in bytes and multiples of 16; all fit 14 bits after >> 4 while the
// shared memory of a block is under 256 KB.
__device__ __forceinline__ uint64_t desc(uint32_t addr, uint32_t lbo, uint32_t sbo) {
  return uint64_t((addr >> 4) & 0x3FFF) | (uint64_t((lbo >> 4) & 0x3FFF) << 16) |
         (uint64_t((sbo >> 4) & 0x3FFF) << 32);
}

// Adds `units` x 16 bytes to a descriptor's start address and `lbo_units`
// x 16 bytes to its (zero) leading offset; fields do not carry.
__device__ __forceinline__ uint64_t at(uint64_t d, uint32_t units, uint32_t lbo_units) {
  return d + units + (uint64_t(lbo_units) << 16);
}

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void wg_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wg_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
// Wait until at most N committed groups of this warpgroup are pending.
template <int N>
__device__ __forceinline__ void wg_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}
// After the wait: the accumulator registers are read only after it.
template <int L>
__device__ __forceinline__ void fence_regs(int (&d)[L]) {
#pragma unroll
  for (int i = 0; i < L; ++i) asm volatile("" : "+r"(d[i])::"memory");
}
// Generic-proxy shared-memory writes made visible to wgmma's async proxy
// (each writing thread, before the barrier that precedes the MMAs).
__device__ __forceinline__ void fence_async_smem() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(dst), "l"(src) : "memory");
}
__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.commit_group;\ncp.async.wait_all;\n" ::: "memory");
}

// d[O .. O + N/2) += A (64 x 32, s8) * B (32 x N, s8), s32: warp w of the
// warpgroup holds rows 16w + lane/4 (+ 8), and register 4j + 2h + e holds
// row +8h, column 8j + 2 (lane % 4) + e.
template <int O, int L>
__device__ __forceinline__ void mma_n8(int (&d)[L], uint64_t a, uint64_t b) {
  static_assert(O + 4 <= L, "accumulator range");
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %6, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n8k32.s32.s8.s8 {"
      "%0, %1, %2, %3"
      "}, %4, %5, p;\n}\n"
      :
        "+r"(d[O + 0]), "+r"(d[O + 1]), "+r"(d[O + 2]), "+r"(d[O + 3])
      : "l"(a), "l"(b), "r"(1));
}

template <int O, int L>
__device__ __forceinline__ void mma_n16(int (&d)[L], uint64_t a, uint64_t b) {
  static_assert(O + 8 <= L, "accumulator range");
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %10, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n16k32.s32.s8.s8 {"
      "%0, %1, %2, %3, %4, %5, %6, %7"
      "}, %8, %9, p;\n}\n"
      :
        "+r"(d[O + 0]), "+r"(d[O + 1]), "+r"(d[O + 2]), "+r"(d[O + 3]),
        "+r"(d[O + 4]), "+r"(d[O + 5]), "+r"(d[O + 6]), "+r"(d[O + 7])
      : "l"(a), "l"(b), "r"(1));
}

template <int O, int L>
__device__ __forceinline__ void mma_n48(int (&d)[L], uint64_t a, uint64_t b) {
  static_assert(O + 24 <= L, "accumulator range");
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %26, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n48k32.s32.s8.s8 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23"
      "}, %24, %25, p;\n}\n"
      :
        "+r"(d[O + 0]), "+r"(d[O + 1]), "+r"(d[O + 2]), "+r"(d[O + 3]),
        "+r"(d[O + 4]), "+r"(d[O + 5]), "+r"(d[O + 6]), "+r"(d[O + 7]),
        "+r"(d[O + 8]), "+r"(d[O + 9]), "+r"(d[O + 10]), "+r"(d[O + 11]),
        "+r"(d[O + 12]), "+r"(d[O + 13]), "+r"(d[O + 14]), "+r"(d[O + 15]),
        "+r"(d[O + 16]), "+r"(d[O + 17]), "+r"(d[O + 18]), "+r"(d[O + 19]),
        "+r"(d[O + 20]), "+r"(d[O + 21]), "+r"(d[O + 22]), "+r"(d[O + 23])
      : "l"(a), "l"(b), "r"(1));
}

template <int O, int L>
__device__ __forceinline__ void mma_n64(int (&d)[L], uint64_t a, uint64_t b) {
  static_assert(O + 32 <= L, "accumulator range");
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k32.s32.s8.s8 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31"
      "}, %32, %33, p;\n}\n"
      :
        "+r"(d[O + 0]), "+r"(d[O + 1]), "+r"(d[O + 2]), "+r"(d[O + 3]),
        "+r"(d[O + 4]), "+r"(d[O + 5]), "+r"(d[O + 6]), "+r"(d[O + 7]),
        "+r"(d[O + 8]), "+r"(d[O + 9]), "+r"(d[O + 10]), "+r"(d[O + 11]),
        "+r"(d[O + 12]), "+r"(d[O + 13]), "+r"(d[O + 14]), "+r"(d[O + 15]),
        "+r"(d[O + 16]), "+r"(d[O + 17]), "+r"(d[O + 18]), "+r"(d[O + 19]),
        "+r"(d[O + 20]), "+r"(d[O + 21]), "+r"(d[O + 22]), "+r"(d[O + 23]),
        "+r"(d[O + 24]), "+r"(d[O + 25]), "+r"(d[O + 26]), "+r"(d[O + 27]),
        "+r"(d[O + 28]), "+r"(d[O + 29]), "+r"(d[O + 30]), "+r"(d[O + 31])
      : "l"(a), "l"(b), "r"(1));
}

// The N = 16 and N = 48 products with A read as unsigned bytes
// (.s32.u8.s8): activations 0..255, as generation 1 keeps them (a table
// outside the solver's saturation window requantizes above 127).
template <int O, int L>
__device__ __forceinline__ void mma_u8_n16(int (&d)[L], uint64_t a, uint64_t b) {
  static_assert(O + 8 <= L, "accumulator range");
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %10, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n16k32.s32.u8.s8 {"
      "%0, %1, %2, %3, %4, %5, %6, %7"
      "}, %8, %9, p;\n}\n"
      :
        "+r"(d[O + 0]), "+r"(d[O + 1]), "+r"(d[O + 2]), "+r"(d[O + 3]),
        "+r"(d[O + 4]), "+r"(d[O + 5]), "+r"(d[O + 6]), "+r"(d[O + 7])
      : "l"(a), "l"(b), "r"(1));
}

template <int O, int L>
__device__ __forceinline__ void mma_u8_n48(int (&d)[L], uint64_t a, uint64_t b) {
  static_assert(O + 24 <= L, "accumulator range");
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %26, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n48k32.s32.u8.s8 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23"
      "}, %24, %25, p;\n}\n"
      :
        "+r"(d[O + 0]), "+r"(d[O + 1]), "+r"(d[O + 2]), "+r"(d[O + 3]),
        "+r"(d[O + 4]), "+r"(d[O + 5]), "+r"(d[O + 6]), "+r"(d[O + 7]),
        "+r"(d[O + 8]), "+r"(d[O + 9]), "+r"(d[O + 10]), "+r"(d[O + 11]),
        "+r"(d[O + 12]), "+r"(d[O + 13]), "+r"(d[O + 14]), "+r"(d[O + 15]),
        "+r"(d[O + 16]), "+r"(d[O + 17]), "+r"(d[O + 18]), "+r"(d[O + 19]),
        "+r"(d[O + 20]), "+r"(d[O + 21]), "+r"(d[O + 22]), "+r"(d[O + 23])
      : "l"(a), "l"(b), "r"(1));
}

}  // namespace hopper
