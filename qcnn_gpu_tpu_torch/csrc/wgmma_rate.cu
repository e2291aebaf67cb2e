// Issue rate of int8 `wgmma` on one Hopper GPU: a measurement of the
// card, with no TPU counterpart (tools/wgmma_rate.py runs it).
//
// Each warpgroup of a block issues ITERS rounds of CHUNKS back-to-back
// `wgmma.mma_async ... m64nNk32.s32.s8.s8` into one accumulator, one
// commit and one wait per round, as generation 3 (qvrcnn_fused.cu) issues
// a block's chunks. The A operand is read from shared memory the way that
// kernel reads it (channel-block-major, no swizzle, each chunk's
// descriptor moved by one position, the K halves one plane apart), or held
// in registers (RS: A is loaded once, so this measures the tensor cores
// without A's shared-memory reads). Every operand byte is 1, so every
// accumulator ends at ITERS * CHUNKS * 32; a thread that sees anything
// else counts itself in `bad`. Thread 0 of each block stores the clock64
// cycles of its warpgroup's loop.

#include <cuda_runtime.h>
#include <stdint.h>

#include "hopper_wgmma.cuh"

namespace {

using namespace hopper;

constexpr int CHUNKS = 16;
constexpr int PLANE = 1024;                   // A: 64 positions x 16 B per plane
constexpr int A_REGION = 4096;                // per warpgroup: 2 planes + shifts
constexpr int B_AT = 4 * A_REGION;            // B: N x 32 bytes
constexpr int SMEM_BYTES = B_AT + 128 * 32;   // 20,480

template <int O, int L>
__device__ __forceinline__ void rs_n16(int (&d)[L], const uint32_t (&a)[4], uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %13, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n16k32.s32.s8.s8 {"
      "%0, %1, %2, %3, %4, %5, %6, %7"
      "}, {%8, %9, %10, %11}, %12, p;\n}\n"
      : "+r"(d[O + 0]), "+r"(d[O + 1]), "+r"(d[O + 2]), "+r"(d[O + 3]),
        "+r"(d[O + 4]), "+r"(d[O + 5]), "+r"(d[O + 6]), "+r"(d[O + 7])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1));
}

template <int N, bool RS>
__global__ void wgmma_rate_kernel(int iters, long long* cycles, int* bad) {
  extern __shared__ __align__(128) uint8_t smem[];
  for (int i = threadIdx.x; i < SMEM_BYTES / 4; i += blockDim.x)
    reinterpret_cast<uint32_t*>(smem)[i] = 0x01010101u;
  fence_async_smem();
  __syncthreads();
  const uint32_t s = smem_addr(smem);
  const uint64_t da = desc(s + (threadIdx.x >> 7) * A_REGION, PLANE, 128);
  const uint64_t db = desc(s + B_AT, 128, 256);
  const uint32_t a[4] = {0x01010101u, 0x01010101u, 0x01010101u, 0x01010101u};
  int d[N / 2];
#pragma unroll
  for (int i = 0; i < N / 2; ++i) d[i] = 0;
  const long long t0 = clock64();
  for (int it = 0; it < iters; ++it) {
    __syncwarp();
    wg_fence();
#pragma unroll
    for (int j = 0; j < CHUNKS; ++j) {
      if constexpr (RS) {
        rs_n16<0>(d, a, db);
      } else if constexpr (N == 8) {
        mma_n8<0>(d, at(da, j, 0), db);
      } else if constexpr (N == 16) {
        mma_n16<0>(d, at(da, j, 0), db);
      } else if constexpr (N == 48) {
        mma_n48<0>(d, at(da, j, 0), db);
      } else if constexpr (N == 64) {
        mma_n64<0>(d, at(da, j, 0), db);
      } else if constexpr (N == 96) {
        mma_n96<0>(d, at(da, j, 0), db);
      } else {
        mma_n128<0>(d, at(da, j, 0), db);
      }
    }
    wg_commit();
    wg_wait<0>();
    fence_regs(d);
  }
  const long long t1 = clock64();
  bool ok = true;
#pragma unroll
  for (int i = 0; i < N / 2; ++i) ok &= d[i] == iters * CHUNKS * 32;
  if (!ok) atomicAdd(bad, 1);
  if (threadIdx.x == 0) cycles[blockIdx.x] = t1 - t0;
}

template <int N, bool RS>
int launch(int wgs, int blocks, int iters, long long* cycles, int* bad, cudaStream_t stream) {
  wgmma_rate_kernel<N, RS><<<blocks, 128 * wgs, SMEM_BYTES, stream>>>(iters, cycles, bad);
  return int(cudaGetLastError());
}

}  // namespace

extern "C" {

// One launch of `blocks` blocks of `wgs` warpgroups for N in {8, 16, 48,
// 64, 96, 128} (rs = 1: A in registers, N = 16 only). Returns a cudaError_t as int.
int wgmma_rate(int n, int rs, int wgs, int blocks, int iters, void* cycles, void* bad,
               void* stream) {
  auto c = static_cast<long long*>(cycles);
  auto b = static_cast<int*>(bad);
  auto st = static_cast<cudaStream_t>(stream);
  if (wgs < 1 || wgs > 8) return int(cudaErrorInvalidValue);
  if (rs) return n == 16 ? launch<16, true>(wgs, blocks, iters, c, b, st)
                         : int(cudaErrorInvalidValue);
  switch (n) {
    case 8: return launch<8, false>(wgs, blocks, iters, c, b, st);
    case 16: return launch<16, false>(wgs, blocks, iters, c, b, st);
    case 48: return launch<48, false>(wgs, blocks, iters, c, b, st);
    case 64: return launch<64, false>(wgs, blocks, iters, c, b, st);
    case 96: return launch<96, false>(wgs, blocks, iters, c, b, st);
    case 128: return launch<128, false>(wgs, blocks, iters, c, b, st);
    default: return int(cudaErrorInvalidValue);
  }
}

const char* qvrcnn_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
