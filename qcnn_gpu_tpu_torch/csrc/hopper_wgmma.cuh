// Hopper primitives of the split-design kernels (qvrcnn_fused.cu, and
// through qvrcnn_split.cuh qvrcnn_pair.cu and qvrcnn_literal.cu): int8
// `wgmma` with both operands in shared memory, its descriptors and
// fences, and the asynchronous copies and proxy fence around it. The
// probe's chain (mma_probe.cu) adds A held in registers (the RS form, int8
// and bf16), the mbarriers of its staging ring and `setmaxnreg`.
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
template <int L>
__device__ __forceinline__ void fence_regs(float (&d)[L]) {
#pragma unroll
  for (int i = 0; i < L; ++i) asm volatile("" : "+f"(d[i])::"memory");
}
// The A fragments of the RS form, around the MMAs that read them.
template <int L>
__device__ __forceinline__ void fence_regs(uint32_t (&d)[L]) {
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


// Shared-memory barriers (mbarrier): init by one thread, then
// `mbar_init_fence` and a block barrier before any thread uses them.
__device__ __forceinline__ void mbar_init(uint32_t bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar), "r"(count) : "memory");
}
__device__ __forceinline__ void mbar_init_fence() {
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
}
__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(bar) : "memory");
}
// Wait until the phase of parity `parity` has completed (a fresh barrier
// is in phase 0, so parity 1 passes at once).
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  asm volatile(
      "{\n.reg .pred done;\n"
      "WAIT:\n"
      "mbarrier.try_wait.parity.shared::cta.b64 done, [%0], %1;\n"
      "@!done bra WAIT;\n}\n" ::"r"(bar),
      "r"(parity)
      : "memory");
}

// Register budget of the calling warpgroup (all its threads, at the top of
// a branch that never rejoins the others).
template <int R>
__device__ __forceinline__ void regs_dec() {
  asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(R));
}
template <int R>
__device__ __forceinline__ void regs_inc() {
  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(R));
}

// The products below follow mma_n8's accumulator layout. The N = 96 and
// N = 128 ones with A in shared memory serve tools/wgmma_rate; the `rs`
// ones take A from registers: warp w of the warpgroup holds rows 16w +
// lane/4 (a[0], a[2]) and + 8 (a[1], a[3]), bytes 4 (lane % 4) .. + 3 of
// the 32-byte k-slice (a[0], a[1]) and 16 bytes further (a[2], a[3]), the
// fragment of mma.sync m16n8k32 (int8) and m16n8k16 (bf16, two values a
// register). The bf16 products accumulate in f32, B K-major (no transpose).

template <int O, int L>
__device__ __forceinline__ void mma_n96(int (&d)[L], uint64_t a, uint64_t b) {
  static_assert(O + 48 <= L, "accumulator range");
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %50, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n96k32.s32.s8.s8 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, "
      "%40, %41, %42, %43, %44, %45, %46, %47"
      "}, %48, %49, p;\n}\n"
      :
        "+r"(d[O + 0]), "+r"(d[O + 1]), "+r"(d[O + 2]), "+r"(d[O + 3]),
        "+r"(d[O + 4]), "+r"(d[O + 5]), "+r"(d[O + 6]), "+r"(d[O + 7]),
        "+r"(d[O + 8]), "+r"(d[O + 9]), "+r"(d[O + 10]), "+r"(d[O + 11]),
        "+r"(d[O + 12]), "+r"(d[O + 13]), "+r"(d[O + 14]), "+r"(d[O + 15]),
        "+r"(d[O + 16]), "+r"(d[O + 17]), "+r"(d[O + 18]), "+r"(d[O + 19]),
        "+r"(d[O + 20]), "+r"(d[O + 21]), "+r"(d[O + 22]), "+r"(d[O + 23]),
        "+r"(d[O + 24]), "+r"(d[O + 25]), "+r"(d[O + 26]), "+r"(d[O + 27]),
        "+r"(d[O + 28]), "+r"(d[O + 29]), "+r"(d[O + 30]), "+r"(d[O + 31]),
        "+r"(d[O + 32]), "+r"(d[O + 33]), "+r"(d[O + 34]), "+r"(d[O + 35]),
        "+r"(d[O + 36]), "+r"(d[O + 37]), "+r"(d[O + 38]), "+r"(d[O + 39]),
        "+r"(d[O + 40]), "+r"(d[O + 41]), "+r"(d[O + 42]), "+r"(d[O + 43]),
        "+r"(d[O + 44]), "+r"(d[O + 45]), "+r"(d[O + 46]), "+r"(d[O + 47])
      : "l"(a), "l"(b), "r"(1));
}

template <int O, int L>
__device__ __forceinline__ void mma_n128(int (&d)[L], uint64_t a, uint64_t b) {
  static_assert(O + 64 <= L, "accumulator range");
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k32.s32.s8.s8 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, "
      "%40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, "
      "%56, %57, %58, %59, %60, %61, %62, %63"
      "}, %64, %65, p;\n}\n"
      :
        "+r"(d[O + 0]), "+r"(d[O + 1]), "+r"(d[O + 2]), "+r"(d[O + 3]),
        "+r"(d[O + 4]), "+r"(d[O + 5]), "+r"(d[O + 6]), "+r"(d[O + 7]),
        "+r"(d[O + 8]), "+r"(d[O + 9]), "+r"(d[O + 10]), "+r"(d[O + 11]),
        "+r"(d[O + 12]), "+r"(d[O + 13]), "+r"(d[O + 14]), "+r"(d[O + 15]),
        "+r"(d[O + 16]), "+r"(d[O + 17]), "+r"(d[O + 18]), "+r"(d[O + 19]),
        "+r"(d[O + 20]), "+r"(d[O + 21]), "+r"(d[O + 22]), "+r"(d[O + 23]),
        "+r"(d[O + 24]), "+r"(d[O + 25]), "+r"(d[O + 26]), "+r"(d[O + 27]),
        "+r"(d[O + 28]), "+r"(d[O + 29]), "+r"(d[O + 30]), "+r"(d[O + 31]),
        "+r"(d[O + 32]), "+r"(d[O + 33]), "+r"(d[O + 34]), "+r"(d[O + 35]),
        "+r"(d[O + 36]), "+r"(d[O + 37]), "+r"(d[O + 38]), "+r"(d[O + 39]),
        "+r"(d[O + 40]), "+r"(d[O + 41]), "+r"(d[O + 42]), "+r"(d[O + 43]),
        "+r"(d[O + 44]), "+r"(d[O + 45]), "+r"(d[O + 46]), "+r"(d[O + 47]),
        "+r"(d[O + 48]), "+r"(d[O + 49]), "+r"(d[O + 50]), "+r"(d[O + 51]),
        "+r"(d[O + 52]), "+r"(d[O + 53]), "+r"(d[O + 54]), "+r"(d[O + 55]),
        "+r"(d[O + 56]), "+r"(d[O + 57]), "+r"(d[O + 58]), "+r"(d[O + 59]),
        "+r"(d[O + 60]), "+r"(d[O + 61]), "+r"(d[O + 62]), "+r"(d[O + 63])
      : "l"(a), "l"(b), "r"(1));
}

template <int O, int L>
__device__ __forceinline__ void mma_rs_n8(int (&d)[L], const uint32_t (&a)[4], uint64_t b) {
  static_assert(O + 4 <= L, "accumulator range");
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %9, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n8k32.s32.s8.s8 {"
      "%0, %1, %2, %3"
      "}, {%4, %5, %6, %7}, %8, p;\n}\n"
      :
        "+r"(d[O + 0]), "+r"(d[O + 1]), "+r"(d[O + 2]), "+r"(d[O + 3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1));
}

template <int O, int L>
__device__ __forceinline__ void mma_rs_n96(int (&d)[L], const uint32_t (&a)[4], uint64_t b) {
  static_assert(O + 48 <= L, "accumulator range");
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %53, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n96k32.s32.s8.s8 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, "
      "%40, %41, %42, %43, %44, %45, %46, %47"
      "}, {%48, %49, %50, %51}, %52, p;\n}\n"
      :
        "+r"(d[O + 0]), "+r"(d[O + 1]), "+r"(d[O + 2]), "+r"(d[O + 3]),
        "+r"(d[O + 4]), "+r"(d[O + 5]), "+r"(d[O + 6]), "+r"(d[O + 7]),
        "+r"(d[O + 8]), "+r"(d[O + 9]), "+r"(d[O + 10]), "+r"(d[O + 11]),
        "+r"(d[O + 12]), "+r"(d[O + 13]), "+r"(d[O + 14]), "+r"(d[O + 15]),
        "+r"(d[O + 16]), "+r"(d[O + 17]), "+r"(d[O + 18]), "+r"(d[O + 19]),
        "+r"(d[O + 20]), "+r"(d[O + 21]), "+r"(d[O + 22]), "+r"(d[O + 23]),
        "+r"(d[O + 24]), "+r"(d[O + 25]), "+r"(d[O + 26]), "+r"(d[O + 27]),
        "+r"(d[O + 28]), "+r"(d[O + 29]), "+r"(d[O + 30]), "+r"(d[O + 31]),
        "+r"(d[O + 32]), "+r"(d[O + 33]), "+r"(d[O + 34]), "+r"(d[O + 35]),
        "+r"(d[O + 36]), "+r"(d[O + 37]), "+r"(d[O + 38]), "+r"(d[O + 39]),
        "+r"(d[O + 40]), "+r"(d[O + 41]), "+r"(d[O + 42]), "+r"(d[O + 43]),
        "+r"(d[O + 44]), "+r"(d[O + 45]), "+r"(d[O + 46]), "+r"(d[O + 47])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1));
}

template <int O, int L>
__device__ __forceinline__ void mma_rs_n128(int (&d)[L], const uint32_t (&a)[4], uint64_t b) {
  static_assert(O + 64 <= L, "accumulator range");
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k32.s32.s8.s8 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, "
      "%40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, "
      "%56, %57, %58, %59, %60, %61, %62, %63"
      "}, {%64, %65, %66, %67}, %68, p;\n}\n"
      :
        "+r"(d[O + 0]), "+r"(d[O + 1]), "+r"(d[O + 2]), "+r"(d[O + 3]),
        "+r"(d[O + 4]), "+r"(d[O + 5]), "+r"(d[O + 6]), "+r"(d[O + 7]),
        "+r"(d[O + 8]), "+r"(d[O + 9]), "+r"(d[O + 10]), "+r"(d[O + 11]),
        "+r"(d[O + 12]), "+r"(d[O + 13]), "+r"(d[O + 14]), "+r"(d[O + 15]),
        "+r"(d[O + 16]), "+r"(d[O + 17]), "+r"(d[O + 18]), "+r"(d[O + 19]),
        "+r"(d[O + 20]), "+r"(d[O + 21]), "+r"(d[O + 22]), "+r"(d[O + 23]),
        "+r"(d[O + 24]), "+r"(d[O + 25]), "+r"(d[O + 26]), "+r"(d[O + 27]),
        "+r"(d[O + 28]), "+r"(d[O + 29]), "+r"(d[O + 30]), "+r"(d[O + 31]),
        "+r"(d[O + 32]), "+r"(d[O + 33]), "+r"(d[O + 34]), "+r"(d[O + 35]),
        "+r"(d[O + 36]), "+r"(d[O + 37]), "+r"(d[O + 38]), "+r"(d[O + 39]),
        "+r"(d[O + 40]), "+r"(d[O + 41]), "+r"(d[O + 42]), "+r"(d[O + 43]),
        "+r"(d[O + 44]), "+r"(d[O + 45]), "+r"(d[O + 46]), "+r"(d[O + 47]),
        "+r"(d[O + 48]), "+r"(d[O + 49]), "+r"(d[O + 50]), "+r"(d[O + 51]),
        "+r"(d[O + 52]), "+r"(d[O + 53]), "+r"(d[O + 54]), "+r"(d[O + 55]),
        "+r"(d[O + 56]), "+r"(d[O + 57]), "+r"(d[O + 58]), "+r"(d[O + 59]),
        "+r"(d[O + 60]), "+r"(d[O + 61]), "+r"(d[O + 62]), "+r"(d[O + 63])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1));
}

template <int O, int L>
__device__ __forceinline__ void mma_bf16_rs_n96(float (&d)[L], const uint32_t (&a)[4], uint64_t b) {
  static_assert(O + 48 <= L, "accumulator range");
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %53, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n96k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, "
      "%40, %41, %42, %43, %44, %45, %46, %47"
      "}, {%48, %49, %50, %51}, %52, p, 1, 1, 0;\n}\n"
      :
        "+f"(d[O + 0]), "+f"(d[O + 1]), "+f"(d[O + 2]), "+f"(d[O + 3]),
        "+f"(d[O + 4]), "+f"(d[O + 5]), "+f"(d[O + 6]), "+f"(d[O + 7]),
        "+f"(d[O + 8]), "+f"(d[O + 9]), "+f"(d[O + 10]), "+f"(d[O + 11]),
        "+f"(d[O + 12]), "+f"(d[O + 13]), "+f"(d[O + 14]), "+f"(d[O + 15]),
        "+f"(d[O + 16]), "+f"(d[O + 17]), "+f"(d[O + 18]), "+f"(d[O + 19]),
        "+f"(d[O + 20]), "+f"(d[O + 21]), "+f"(d[O + 22]), "+f"(d[O + 23]),
        "+f"(d[O + 24]), "+f"(d[O + 25]), "+f"(d[O + 26]), "+f"(d[O + 27]),
        "+f"(d[O + 28]), "+f"(d[O + 29]), "+f"(d[O + 30]), "+f"(d[O + 31]),
        "+f"(d[O + 32]), "+f"(d[O + 33]), "+f"(d[O + 34]), "+f"(d[O + 35]),
        "+f"(d[O + 36]), "+f"(d[O + 37]), "+f"(d[O + 38]), "+f"(d[O + 39]),
        "+f"(d[O + 40]), "+f"(d[O + 41]), "+f"(d[O + 42]), "+f"(d[O + 43]),
        "+f"(d[O + 44]), "+f"(d[O + 45]), "+f"(d[O + 46]), "+f"(d[O + 47])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1));
}

template <int O, int L>
__device__ __forceinline__ void mma_bf16_rs_n128(float (&d)[L], const uint32_t (&a)[4], uint64_t b) {
  static_assert(O + 64 <= L, "accumulator range");
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, "
      "%40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, "
      "%56, %57, %58, %59, %60, %61, %62, %63"
      "}, {%64, %65, %66, %67}, %68, p, 1, 1, 0;\n}\n"
      :
        "+f"(d[O + 0]), "+f"(d[O + 1]), "+f"(d[O + 2]), "+f"(d[O + 3]),
        "+f"(d[O + 4]), "+f"(d[O + 5]), "+f"(d[O + 6]), "+f"(d[O + 7]),
        "+f"(d[O + 8]), "+f"(d[O + 9]), "+f"(d[O + 10]), "+f"(d[O + 11]),
        "+f"(d[O + 12]), "+f"(d[O + 13]), "+f"(d[O + 14]), "+f"(d[O + 15]),
        "+f"(d[O + 16]), "+f"(d[O + 17]), "+f"(d[O + 18]), "+f"(d[O + 19]),
        "+f"(d[O + 20]), "+f"(d[O + 21]), "+f"(d[O + 22]), "+f"(d[O + 23]),
        "+f"(d[O + 24]), "+f"(d[O + 25]), "+f"(d[O + 26]), "+f"(d[O + 27]),
        "+f"(d[O + 28]), "+f"(d[O + 29]), "+f"(d[O + 30]), "+f"(d[O + 31]),
        "+f"(d[O + 32]), "+f"(d[O + 33]), "+f"(d[O + 34]), "+f"(d[O + 35]),
        "+f"(d[O + 36]), "+f"(d[O + 37]), "+f"(d[O + 38]), "+f"(d[O + 39]),
        "+f"(d[O + 40]), "+f"(d[O + 41]), "+f"(d[O + 42]), "+f"(d[O + 43]),
        "+f"(d[O + 44]), "+f"(d[O + 45]), "+f"(d[O + 46]), "+f"(d[O + 47]),
        "+f"(d[O + 48]), "+f"(d[O + 49]), "+f"(d[O + 50]), "+f"(d[O + 51]),
        "+f"(d[O + 52]), "+f"(d[O + 53]), "+f"(d[O + 54]), "+f"(d[O + 55]),
        "+f"(d[O + 56]), "+f"(d[O + 57]), "+f"(d[O + 58]), "+f"(d[O + 59]),
        "+f"(d[O + 60]), "+f"(d[O + 61]), "+f"(d[O + 62]), "+f"(d[O + 63])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1));
}

}  // namespace hopper
