// Matrix-rate probe for Hopper (sm_90a): chains of dependent products.
//
// Replaces the Pallas TPU kernel built by `build` (scripts/mfu_probe.py:36,
// launched at :57). Per block g of the grid it computes, for c = 0..15,
//
//   wc  = (w[c] + s)                       in w's type
//   acc += a[g] @ wc                       a[g]: [M, K], w[c]: [K, N]
//   s   = acc[0,0] % 3  (int, Python-style, in [0, 2])
//         acc[0,0] * 1e-30 (float)
//
// and writes acc to its own [M, N] slot of the output (on the TPU every
// grid step overwrote one output, so the TPU's result is the last block's
// slot). s makes each product depend on the previous one.
//
// Cases: int8 -> int32 on `mma.sync.m16n8k32.s8.s8.s32`; bf16 -> f32 on
// `mma.sync.m16n8k16.bf16`; f32 -> f32 as FFMA on the CUDA cores (no
// TF32). Operands are small integers, so every case is exact.
//
// Design. One block of 8 warps per grid index walks its M rows in M-tiles.
// A warp owns MT 16-row m-tiles x NTW 8-column n-tiles; its A fragments
// for the whole K stay in registers for the M-tile's 16 steps. Each step
// stages wc[c] = w[c] + s (pre-transposed to [N, K] by the wrapper) into
// shared memory, rows padded by 16 bytes so that the B-fragment loads of a
// warp hit 32 distinct banks; the raw w of the next step is prefetched into
// registers while the current step's MMAs run. The chain runs for real in
// the first M-tile: after each step, the warp holding acc[0,0] writes it
// to shared memory, a block barrier broadcasts it, and every thread
// derives the next s; the later M-tiles reuse the recorded s. It reaches
// about a quarter of the issue kernel's rate below: each step adds two
// block barriers and one shared-memory staging of wc, with one block (8
// warps) per SM to hide them; which of these costs most is not measured.
//
// Beside the chain, `mma_issue_kernel` measures the instruction's own
// ceiling: each warp issues ITERS rounds of NACC independent MMAs on
// register operands whose every element is 1, with no memory traffic, so
// that every accumulator ends at ITERS * K and each thread writes the sum
// of its 4 * NACC accumulators.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int CHAIN = 16;
constexpr int NWARPS = 8;
constexpr int NTHREADS = NWARPS * 32;

struct I8 {
  using Acc = int;
  static constexpr int EB = 1;  // bytes per element
  static constexpr int MT = 4;  // 16-row m-tiles per warp
  __device__ __forceinline__ static void mma(int (&c)[4], const uint32_t (&a)[4], uint32_t b0,
                                             uint32_t b1) {
    asm volatile(
        "mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 "
        "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
        : "+r"(c[0]), "+r"(c[1]), "+r"(c[2]), "+r"(c[3])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
  }
  __device__ __forceinline__ static int derive(int acc00) {
    const int r = acc00 % 3;
    return r < 0 ? r + 3 : r;
  }
  // four int8 weights + s, each wrapping to int8 like the TPU's astype
  __device__ __forceinline__ static uint32_t add(uint32_t w4, int s) {
    return __vadd4(w4, uint32_t(s) * 0x01010101u);
  }
};

struct BF16 {
  using Acc = float;
  static constexpr int EB = 2;
  static constexpr int MT = 2;
  __device__ __forceinline__ static void mma(float (&c)[4], const uint32_t (&a)[4], uint32_t b0,
                                             uint32_t b1) {
    asm volatile(
        "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
        "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
        : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
  }
  __device__ __forceinline__ static float derive(float acc00) { return __fmul_rn(acc00, 1e-30f); }
  __device__ __forceinline__ static uint32_t add1(uint32_t h, float s) {
    const float f = __fadd_rn(__uint_as_float(h << 16), s);
    return uint32_t(__bfloat16_as_ushort(__float2bfloat16_rn(f)));
  }
  // two bf16 weights + s, rounded back to bf16 (round to nearest even)
  __device__ __forceinline__ static uint32_t add(uint32_t w2, float s) {
    return add1(w2 & 0xffffu, s) | (add1(w2 >> 16, s) << 16);
  }
};

// Tensor-core chain. a: [grid, M, K], wt: [CHAIN, N, K] (w transposed),
// out: [grid, M, N].
template <class Op, int K, int N>
__global__ void __launch_bounds__(NTHREADS, 1)
mma_chain_kernel(const uint8_t* __restrict__ a, const uint32_t* __restrict__ wt,
                 typename Op::Acc* __restrict__ out, int M) {
  using Acc = typename Op::Acc;
  constexpr int KB = K * Op::EB;  // bytes per row of A and of wt
  constexpr int KC = KB / 32;     // 32-byte k-chunks (one MMA deep)
  constexpr int NT = N / 8;
  constexpr int WN = NT >= 4 ? 4 : NT;  // warps along N
  constexpr int NTW = NT / WN;
  constexpr int WM = NWARPS / WN;
  constexpr int MT = Op::MT;
  constexpr int MTILE = WM * MT * 16;
  constexpr int SROW = KB + 16;
  constexpr int ROW_WORDS = KB / 4;
  constexpr int WORDS = N * ROW_WORDS;
  constexpr int WPT = (WORDS + NTHREADS - 1) / NTHREADS;
  static_assert(KB % 32 == 0 && NT % WN == 0 && NWARPS % WN == 0, "shape");

  __shared__ __align__(16) uint8_t wsm[N * SROW];
  __shared__ Acc bcast;
  __shared__ Acc s_rec[CHAIN];

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  const int wm = warp / WN, wn = warp % WN;
  const uint8_t* ab = a + size_t(blockIdx.x) * M * KB;
  Acc* ob = out + size_t(blockIdx.x) * M * N;

  uint32_t pre[WPT];
  auto prefetch = [&](int c) {
#pragma unroll
    for (int i = 0; i < WPT; ++i) {
      const int idx = threadIdx.x + i * NTHREADS;
      pre[i] = idx < WORDS ? __ldg(wt + size_t(c) * WORDS + idx) : 0u;
    }
  };
  prefetch(0);

  for (int m0 = 0; m0 < M; m0 += MTILE) {
    uint32_t af[MT][KC][4];
#pragma unroll
    for (int mi = 0; mi < MT; ++mi) {
      const uint8_t* r0 = ab + size_t(m0 + (wm * MT + mi) * 16 + g) * KB + t * 4;
      const uint8_t* r1 = r0 + 8 * KB;
#pragma unroll
      for (int kc = 0; kc < KC; ++kc) {
        af[mi][kc][0] = __ldg(reinterpret_cast<const uint32_t*>(r0 + kc * 32));
        af[mi][kc][1] = __ldg(reinterpret_cast<const uint32_t*>(r1 + kc * 32));
        af[mi][kc][2] = __ldg(reinterpret_cast<const uint32_t*>(r0 + kc * 32 + 16));
        af[mi][kc][3] = __ldg(reinterpret_cast<const uint32_t*>(r1 + kc * 32 + 16));
      }
    }
    Acc acc[MT][NTW][4];
#pragma unroll
    for (int mi = 0; mi < MT; ++mi)
#pragma unroll
      for (int ni = 0; ni < NTW; ++ni) acc[mi][ni][0] = acc[mi][ni][1] = acc[mi][ni][2] = acc[mi][ni][3] = 0;

    for (int c = 0; c < CHAIN; ++c) {
      Acc s = 0;
      if (c > 0) s = m0 == 0 ? Op::derive(bcast) : s_rec[c];
      if (m0 == 0 && threadIdx.x == 0) s_rec[c] = s;
#pragma unroll
      for (int i = 0; i < WPT; ++i) {
        const int idx = threadIdx.x + i * NTHREADS;
        if (idx < WORDS) {
          const int n = idx / ROW_WORDS, kw = idx - n * ROW_WORDS;
          *reinterpret_cast<uint32_t*>(wsm + n * SROW + kw * 4) = Op::add(pre[i], s);
        }
      }
      __syncthreads();
      prefetch((c + 1) % CHAIN);  // next step, or step 0 of the next M-tile
#pragma unroll
      for (int kc = 0; kc < KC; ++kc) {
#pragma unroll
        for (int ni = 0; ni < NTW; ++ni) {
          const uint8_t* bp = wsm + ((wn * NTW + ni) * 8 + g) * SROW + kc * 32 + t * 4;
          const uint32_t b0 = *reinterpret_cast<const uint32_t*>(bp);
          const uint32_t b1 = *reinterpret_cast<const uint32_t*>(bp + 16);
#pragma unroll
          for (int mi = 0; mi < MT; ++mi) Op::mma(acc[mi][ni], af[mi][kc], b0, b1);
        }
      }
      if (m0 == 0 && threadIdx.x == 0) bcast = acc[0][0][0];  // acc[0,0]
      __syncthreads();
    }

#pragma unroll
    for (int mi = 0; mi < MT; ++mi) {
      const int row = m0 + (wm * MT + mi) * 16 + g;
#pragma unroll
      for (int ni = 0; ni < NTW; ++ni) {
        const int col = (wn * NTW + ni) * 8 + t * 2;
        ob[size_t(row) * N + col] = acc[mi][ni][0];
        ob[size_t(row) * N + col + 1] = acc[mi][ni][1];
        ob[size_t(row + 8) * N + col] = acc[mi][ni][2];
        ob[size_t(row + 8) * N + col + 1] = acc[mi][ni][3];
      }
    }
  }
}

// FFMA chain (float32 on the CUDA cores). a: [grid, M, K], w: [CHAIN, K, N],
// out: [grid, M, N]. One block per grid index walks 128-row M-tiles; a
// thread computes 8 rows x 8 columns (columns tx*4..+3 and 64+tx*4..+3)
// from the transposed A tile and wc in shared memory.
constexpr int F_MTILE = 128;
constexpr int F_AROW = F_MTILE + 4;  // padded row of the transposed A tile

template <int K, int N>
__global__ void __launch_bounds__(NTHREADS, 1)
ffma_chain_kernel(const float* __restrict__ a, const float* __restrict__ w,
                  float* __restrict__ out, int M) {
  static_assert(N == 128 && K % 4 == 0, "one thread computes 8 of 128 columns");
  extern __shared__ __align__(16) float fsm[];
  float* As = fsm;                // [K][F_AROW]
  float* Ws = fsm + K * F_AROW;   // [K][N]
  __shared__ float bcast;
  __shared__ float s_rec[CHAIN];
  const int tx = threadIdx.x & 15, ty = threadIdx.x >> 4;
  const float* ab = a + size_t(blockIdx.x) * M * K;
  float* ob = out + size_t(blockIdx.x) * M * N;

  for (int m0 = 0; m0 < M; m0 += F_MTILE) {
    for (int i = threadIdx.x; i < F_MTILE * K; i += NTHREADS) {
      const int r = i / K, k = i - r * K;
      As[k * F_AROW + r] = ab[size_t(m0 + r) * K + k];
    }
    float acc[8][8];
#pragma unroll
    for (int i = 0; i < 8; ++i)
#pragma unroll
      for (int j = 0; j < 8; ++j) acc[i][j] = 0.f;

    for (int c = 0; c < CHAIN; ++c) {
      float s = 0.f;
      if (c > 0) s = m0 == 0 ? __fmul_rn(bcast, 1e-30f) : s_rec[c];
      if (m0 == 0 && threadIdx.x == 0) s_rec[c] = s;
      const float4* wc = reinterpret_cast<const float4*>(w + size_t(c) * K * N);
      for (int i = threadIdx.x; i < K * N / 4; i += NTHREADS) {
        float4 v = __ldg(wc + i);
        v.x = __fadd_rn(v.x, s);
        v.y = __fadd_rn(v.y, s);
        v.z = __fadd_rn(v.z, s);
        v.w = __fadd_rn(v.w, s);
        reinterpret_cast<float4*>(Ws)[i] = v;
      }
      __syncthreads();
#pragma unroll 4
      for (int k = 0; k < K; ++k) {
        const float4 a0 = *reinterpret_cast<const float4*>(As + k * F_AROW + ty * 8);
        const float4 a1 = *reinterpret_cast<const float4*>(As + k * F_AROW + ty * 8 + 4);
        const float4 b0 = *reinterpret_cast<const float4*>(Ws + k * N + tx * 4);
        const float4 b1 = *reinterpret_cast<const float4*>(Ws + k * N + 64 + tx * 4);
        const float av[8] = {a0.x, a0.y, a0.z, a0.w, a1.x, a1.y, a1.z, a1.w};
        const float bv[8] = {b0.x, b0.y, b0.z, b0.w, b1.x, b1.y, b1.z, b1.w};
#pragma unroll
        for (int i = 0; i < 8; ++i)
#pragma unroll
          for (int j = 0; j < 8; ++j) acc[i][j] = fmaf(av[i], bv[j], acc[i][j]);
      }
      if (m0 == 0 && threadIdx.x == 0) bcast = acc[0][0];  // acc[0,0]
      __syncthreads();
    }

#pragma unroll
    for (int i = 0; i < 8; ++i) {
      float* orow = ob + size_t(m0 + ty * 8 + i) * N;
      *reinterpret_cast<float4*>(orow + tx * 4) =
          make_float4(acc[i][0], acc[i][1], acc[i][2], acc[i][3]);
      *reinterpret_cast<float4*>(orow + 64 + tx * 4) =
          make_float4(acc[i][4], acc[i][5], acc[i][6], acc[i][7]);
    }
    __syncthreads();  // As is rewritten by the next M-tile
  }
}

constexpr int NACC = 16;

template <class Op>
__global__ void __launch_bounds__(NTHREADS)
mma_issue_kernel(typename Op::Acc* __restrict__ out, int iters, uint32_t one) {
  using Acc = typename Op::Acc;
  const uint32_t a[4] = {one, one, one, one};
  Acc acc[NACC][4];
#pragma unroll
  for (int j = 0; j < NACC; ++j) acc[j][0] = acc[j][1] = acc[j][2] = acc[j][3] = 0;
  for (int i = 0; i < iters; ++i) {
#pragma unroll
    for (int j = 0; j < NACC; ++j) Op::mma(acc[j], a, one, one);
  }
  Acc sum = 0;
#pragma unroll
  for (int j = 0; j < NACC; ++j) sum += acc[j][0] + acc[j][1] + acc[j][2] + acc[j][3];
  out[size_t(blockIdx.x) * NTHREADS + threadIdx.x] = sum;
}

template <class Op, int K, int N>
int launch_mma(const void* a, const void* w, void* out, int grid, int M, cudaStream_t st) {
  constexpr int NT = N / 8, WN = NT >= 4 ? 4 : NT;
  constexpr int MTILE = (NWARPS / WN) * Op::MT * 16;
  if (M % MTILE) return int(cudaErrorInvalidValue);
  mma_chain_kernel<Op, K, N><<<grid, NTHREADS, 0, st>>>(
      static_cast<const uint8_t*>(a), static_cast<const uint32_t*>(w),
      static_cast<typename Op::Acc*>(out), M);
  return int(cudaGetLastError());
}

template <int K, int N>
int launch_ffma(const void* a, const void* w, void* out, int grid, int M, cudaStream_t st) {
  constexpr int SMEM = (K * F_AROW + K * N) * 4;
  if (M % F_MTILE) return int(cudaErrorInvalidValue);
  cudaError_t err = cudaFuncSetAttribute(ffma_chain_kernel<K, N>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, SMEM);
  if (err != cudaSuccess) return int(err);
  ffma_chain_kernel<K, N><<<grid, NTHREADS, SMEM, st>>>(
      static_cast<const float*>(a), static_cast<const float*>(w), static_cast<float*>(out), M);
  return int(cudaGetLastError());
}

}  // namespace

extern "C" {

// kind 0 = int8 -> int32, 1 = bf16 -> f32 (w given transposed, [CHAIN, N, K]),
// 2 = f32 -> f32 (w as [CHAIN, K, N]). Returns a cudaError_t; an
// uninstantiated (K, N) or an M that is not a whole number of M-tiles
// gives cudaErrorInvalidValue.
int mma_probe_run(int kind, const void* a, const void* w, void* out, int grid, int M, int K,
                  int N, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (kind == 0) {
    if (K == 128 && N == 128) return launch_mma<I8, 128, 128>(a, w, out, grid, M, st);
    if (K == 128 && N == 96) return launch_mma<I8, 128, 96>(a, w, out, grid, M, st);
    if (K == 96 && N == 96) return launch_mma<I8, 96, 96>(a, w, out, grid, M, st);
    if (K == 96 && N == 8) return launch_mma<I8, 96, 8>(a, w, out, grid, M, st);
  } else if (kind == 1) {
    if (K == 128 && N == 128) return launch_mma<BF16, 128, 128>(a, w, out, grid, M, st);
    if (K == 96 && N == 96) return launch_mma<BF16, 96, 96>(a, w, out, grid, M, st);
  } else if (kind == 2) {
    if (K == 128 && N == 128) return launch_ffma<128, 128>(a, w, out, grid, M, st);
  }
  return int(cudaErrorInvalidValue);
}

// kind 0 = int8 (operands 0x01010101), 1 = bf16 (0x3f803f80, i.e. 1.0):
// `blocks` blocks of NTHREADS threads, out: [blocks * NTHREADS] of the
// accumulator type.
int mma_issue_run(int kind, void* out, int blocks, int iters, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (kind == 0)
    mma_issue_kernel<I8><<<blocks, NTHREADS, 0, st>>>(static_cast<int*>(out), iters, 0x01010101u);
  else if (kind == 1)
    mma_issue_kernel<BF16><<<blocks, NTHREADS, 0, st>>>(static_cast<float*>(out), iters,
                                                          0x3f803f80u);
  else
    return int(cudaErrorInvalidValue);
  return int(cudaGetLastError());
}

int mma_issue_threads() { return NTHREADS; }

int mma_issue_nacc() { return NACC; }

const char* qvrcnn_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
