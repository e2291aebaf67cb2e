// Stage GEMMs of the QVRCNN tile kernels of generations 2 and 1, shared by
// qvrcnn_pair.cu (two frames per block, folded epilogue) and
// qvrcnn_literal.cu (one frame, literal BLU chain). Generation 3
// (qvrcnn_fused.cu) has a design of its own on hopper_wgmma.cuh.
//
// A block holds one 16x16 output tile of NF frames and, per frame, the
// input window and the S1-S3 activations in shared memory (an "activation
// region" of ACT_BYTES; frame f's region starts f * ACT_BYTES after frame
// 0's). Each stage is an implicit GEMM on `mma.sync.m16n8k32` with int32
// accumulators: M = the stage's output positions, N = its output channels,
// K = taps x input channels. A fragments are 32-bit shared-memory loads of
// 4 consecutive channels (S1 gathers its 4 taps byte by byte); B fragments
// come pre-arranged in fragment order from device memory
// (ops/fused.mma_b_fragments), one 8-byte load per lane, and each B load
// feeds the MMAs of all NF frames.
//
// Activations are stored as bytes: int8 in [0, 127] for the folded
// epilogue, uint8 in [0, 255] for the literal one (a table outside the
// solver's saturation window can requantize above 127). S1 reads the
// signed x-128 window; later stages read activations as signed
// (A_U8 = false) or unsigned (A_U8 = true) bytes.
//
// Every shared-memory byte an MMA reads is written first: the window and
// every stage's full output region (masked positions store 0) are written
// before the barrier that precedes their use; K-padding lanes get A = 0 in
// registers, never from shared memory.

#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

namespace qvrcnn {

constexpr int T = 16;        // output tile edge
constexpr int HALO = 6;      // receptive radius (models/topology.RECEPTIVE_RADIUS)
constexpr int R0 = T + 2 * HALO;  // input window edge: 28
constexpr int R1 = T + 8;    // S1 region edge: 24
constexpr int R2 = T + 4;    // S2 region edge: 20
constexpr int R3 = T + 2;    // S3 region edge: 18
constexpr int C1 = 64, C2 = 48, C3 = 48;
constexpr int S1_STRIDE = 80;  // bytes per S1 position: 64 ch + 16 pad
constexpr int S2_STRIDE = 48;
constexpr int S3_STRIDE = 48;
constexpr int NWARPS = 8;
constexpr int NTHREADS = NWARPS * 32;
constexpr int MAX_DEVICES = 64;

// one frame's activation region, offsets from its start
constexpr int ACT_WIN = 0;
constexpr int ACT_S1 = ((R0 * R0 + 15) / 16) * 16;  // 784
constexpr int ACT_S2 = ACT_S1 + R1 * R1 * S1_STRIDE;
constexpr int ACT_S3 = ACT_S2 + R2 * R2 * S2_STRIDE;
constexpr int ACT_BYTES = ACT_S3 + R3 * R3 * S3_STRIDE;  // 81,616

struct Bounds {
  int r_lo, r_hi, c_lo, c_hi;  // valid frame rectangle (already clipped)
  __device__ bool inside(int r, int c) const {
    return r >= r_lo && r < r_hi && c >= c_lo && c < c_hi;
  }
};

template <bool A_U8>
__device__ __forceinline__ void mma_k32(int (&c)[4], const uint32_t (&a)[4], uint2 b) {
  if constexpr (A_U8) {
    asm volatile(
        "mma.sync.aligned.m16n8k32.row.col.s32.u8.s8.s32 "
        "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
        : "+r"(c[0]), "+r"(c[1]), "+r"(c[2]), "+r"(c[3])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b.x), "r"(b.y));
  } else {
    asm volatile(
        "mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 "
        "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
        : "+r"(c[0]), "+r"(c[1]), "+r"(c[2]), "+r"(c[3])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b.x), "r"(b.y));
  }
}

// One warp's 16-row M tile of a stage for NF frames:
// acc[f][nt] += A_f[m, k] * W[k, nt*8 + n]. Output position m (row-major
// over an OUT_W x OUT_W region) reads input position (m / OUT_W + dy,
// m % OUT_W + dx) of an IN_W-wide region whose positions are IN_STRIDE
// bytes apart; k = (dy * KS + dx) * CIN + ch. Frame f's input starts at
// in + f * ACT_BYTES. Rows past M clamp their loads to position M-1 (their
// outputs are dropped by the caller).
template <int NF, bool A_U8, int CIN, int KS, int IN_W, int IN_STRIDE, int OUT_W, int NT>
__device__ __forceinline__ void mma_tile(const int8_t* in, const int8_t* __restrict__ wf,
                                         int mt, int (&acc)[NF][NT][4]) {
  constexpr int M = OUT_W * OUT_W;
  constexpr int K = KS * KS * CIN;
  constexpr int KC = (K + 31) / 32;
  const int lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  const int m0 = min(mt * 16 + g, M - 1);
  const int m1 = min(mt * 16 + g + 8, M - 1);
  const int base0 = ((m0 / OUT_W) * IN_W + m0 % OUT_W) * IN_STRIDE;
  const int base1 = ((m1 / OUT_W) * IN_W + m1 % OUT_W) * IN_STRIDE;
#pragma unroll
  for (int f = 0; f < NF; ++f)
#pragma unroll
    for (int nt = 0; nt < NT; ++nt)
      acc[f][nt][0] = acc[f][nt][1] = acc[f][nt][2] = acc[f][nt][3] = 0;
  const uint2* wp = reinterpret_cast<const uint2*>(wf) + lane;
#pragma unroll 2
  for (int kc = 0; kc < KC; ++kc) {
    uint32_t a[NF][4];
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int k = kc * 32 + h * 16 + t * 4;
      if constexpr (CIN % 4 == 0) {
        // 4 consecutive channels of one tap: one aligned 32-bit load
        uint32_t lo[NF], hi[NF];
#pragma unroll
        for (int f = 0; f < NF; ++f) lo[f] = hi[f] = 0;
        if (k < K) {
          const int tap = k / CIN, ch = k - tap * CIN;
          const int dy = tap / KS, dx = tap - dy * KS;
          const int off = (dy * IN_W + dx) * IN_STRIDE + ch;
#pragma unroll
          for (int f = 0; f < NF; ++f) {
            lo[f] = *reinterpret_cast<const uint32_t*>(in + f * ACT_BYTES + base0 + off);
            hi[f] = *reinterpret_cast<const uint32_t*>(in + f * ACT_BYTES + base1 + off);
          }
        }
#pragma unroll
        for (int f = 0; f < NF; ++f) {
          a[f][2 * h] = lo[f];
          a[f][2 * h + 1] = hi[f];
        }
      } else {
        // CIN == 1 (S1): the 4 k are 4 taps; gather byte by byte
#pragma unroll
        for (int f = 0; f < NF; ++f) {
          const int8_t* inf = in + f * ACT_BYTES;
          uint32_t lo = 0, hi = 0;
#pragma unroll
          for (int j = 0; j < 4; ++j) {
            const int tap = k + j;
            if (tap < K) {
              const int dy = tap / KS, dx = tap - dy * KS;
              const int off = (dy * IN_W + dx) * IN_STRIDE;
              lo |= uint32_t(uint8_t(inf[base0 + off])) << (8 * j);
              hi |= uint32_t(uint8_t(inf[base1 + off])) << (8 * j);
            }
          }
          a[f][2 * h] = lo;
          a[f][2 * h + 1] = hi;
        }
      }
    }
#pragma unroll
    for (int nt = 0; nt < NT; ++nt) {
      const uint2 b = __ldg(wp + (kc * NT + nt) * 32);
#pragma unroll
      for (int f = 0; f < NF; ++f) mma_k32<A_U8>(acc[f][nt], a[f], b);
    }
  }
}

// Folded BLU requant (ops/requant.requant_fast): per channel the int32 rows
// [b' | B | mul | shift] of COUT entries, b' = b + bias_pre, B = blu_q +
// bias_pre; v = min((clip(u + b', 0, B) * mul) >> shift, 127).
struct FoldedEpilogue {
  static constexpr int ROWS = 4;
  template <int COUT>
  __device__ __forceinline__ static int apply(const int* vec, int n, int acc) {
    int u = acc + vec[n];
    u = min(max(u, 0), vec[COUT + n]);
    return min((u * vec[2 * COUT + n]) >> vec[3 * COUT + n], 127);
  }
};

// Literal BLU requant (ops/requant.blu_requant_i32): rows
// [b | blu_q | mul | bias_pre | shift]; u = acc + b,
// v = u > blu_q ? 127 : u < 0 ? 0 : ((u + bias_pre) * mul) >> shift.
// The product is formed only on the kept branch, and in 64 bits, so no
// lane ever overflows (signed overflow is undefined in C++).
struct LiteralEpilogue {
  static constexpr int ROWS = 5;
  template <int COUT>
  __device__ __forceinline__ static int apply(const int* vec, int n, int acc) {
    const int u = acc + vec[n];
    if (u > vec[COUT + n]) return 127;
    if (u < 0) return 0;
    const long long p = (long long)(u + vec[3 * COUT + n]) * vec[2 * COUT + n];
    return int(p >> vec[4 * COUT + n]);
  }
};

// S1..S3 for NF frames: MMA + epilogue + frame-bounds mask, stored as one
// byte per channel. (org_r, org_c) is the frame position of the output
// region's (0, 0).
template <class Epi, int NF, bool A_U8, int CIN, int KS, int IN_W, int IN_STRIDE, int OUT_W,
          int OUT_STRIDE, int COUT>
__device__ __forceinline__ void conv_stage(const int8_t* in, int8_t* out,
                                           const int8_t* __restrict__ wf, const int* vec,
                                           int org_r, int org_c, Bounds bd) {
  constexpr int NT = COUT / 8;
  constexpr int M = OUT_W * OUT_W;
  constexpr int MT = (M + 15) / 16;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int g = lane >> 2, t = lane & 3;
  for (int mt = warp; mt < MT; mt += NWARPS) {
    int acc[NF][NT][4];
    mma_tile<NF, A_U8, CIN, KS, IN_W, IN_STRIDE, OUT_W, NT>(in, wf, mt, acc);
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int m = mt * 16 + g + 8 * half;
      if (m >= M) continue;
      const int r = m / OUT_W, c = m - (m / OUT_W) * OUT_W;
      const bool ok = bd.inside(org_r + r, org_c + c);
#pragma unroll
      for (int f = 0; f < NF; ++f) {
        uint8_t* dst = reinterpret_cast<uint8_t*>(out + f * ACT_BYTES) + m * OUT_STRIDE;
#pragma unroll
        for (int nt = 0; nt < NT; ++nt) {
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            const int n = nt * 8 + t * 2 + e;
            const int v = Epi::template apply<COUT>(vec, n, acc[f][nt][2 * half + e]);
            dst[n] = ok ? uint8_t(v) : uint8_t(0);
          }
        }
      }
    }
  }
}

// Per-channel vectors into shared memory, and each frame's input window in
// the x-128 domain (0 outside the frame bounds). Frame f of the block reads
// xf[f]; the caller synchronises.
template <int NF>
__device__ __forceinline__ void load_inputs(int* vec, const int* __restrict__ vec_g, int vec_len,
                                            int8_t* act, const uint8_t* const* xf, int W,
                                            int ty0, int tx0, Bounds bd) {
  for (int i = threadIdx.x; i < vec_len; i += NTHREADS) vec[i] = vec_g[i];
#pragma unroll
  for (int f = 0; f < NF; ++f) {
    int8_t* win = act + f * ACT_BYTES + ACT_WIN;
    for (int i = threadIdx.x; i < R0 * R0; i += NTHREADS) {
      const int r = ty0 - HALO + i / R0, c = tx0 - HALO + i % R0;
      win[i] = bd.inside(r, c) ? int8_t(int(xf[f][size_t(r) * W + c]) - 128) : int8_t(0);
    }
  }
}

// S1 -> S2 -> S3 for NF frames, activations in `act`; S2 and S3 read
// unsigned bytes when A_U8. On return the S3 region of every frame is
// complete (the final barrier included).
template <class Epi, int NF, bool A_U8>
__device__ __forceinline__ void stages_123(int8_t* act, const int8_t* __restrict__ w1,
                                           const int8_t* __restrict__ w2,
                                           const int8_t* __restrict__ w3, const int* vec,
                                           int ty0, int tx0, Bounds bd) {
  constexpr int V1 = Epi::ROWS * C1, V2 = Epi::ROWS * C2;
  conv_stage<Epi, NF, false, 1, 5, R0, 1, R1, S1_STRIDE, C1>(act + ACT_WIN, act + ACT_S1, w1,
                                                            vec, ty0 - 4, tx0 - 4, bd);
  __syncthreads();
  conv_stage<Epi, NF, A_U8, C1, 5, R1, S1_STRIDE, R2, S2_STRIDE, C2>(
      act + ACT_S1, act + ACT_S2, w2, vec + V1, ty0 - 2, tx0 - 2, bd);
  __syncthreads();
  conv_stage<Epi, NF, A_U8, C2, 3, R2, S2_STRIDE, R3, S3_STRIDE, C3>(
      act + ACT_S2, act + ACT_S3, w3, vec + V1 + V2, ty0 - 1, tx0 - 1, bd);
  __syncthreads();
}

// Launch helper: set the kernel's dynamic shared-memory size once per
// device. Returns a cudaError_t as int.
template <class Kernel>
inline int set_smem_once(Kernel kernel, int bytes, bool (&done)[MAX_DEVICES]) {
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return int(err);
  if (dev >= MAX_DEVICES || !done[dev]) {
    err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
    if (err != cudaSuccess) return int(err);
    if (dev < MAX_DEVICES) done[dev] = true;
  }
  return 0;
}

}  // namespace qvrcnn
