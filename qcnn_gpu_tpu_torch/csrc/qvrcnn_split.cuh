// The split-branch tile design of the three network kernels, as a
// template: generation 3 (qvrcnn_fused.cu: folded epilogue, one frame per
// work item, at each of its tiles, and its diagnostic variants), 2
// (qvrcnn_pair.cu: folded epilogue, frame pairs) and 1 (qvrcnn_literal.cu:
// literal BLU chain, uint8 activations, int16 residual) are instances of
// `Cfg`, launched by `launch`.
//
// The design, as qvrcnn_fused.cu describes it: split branch GEMMs
// with no zero taps; `wgmma` int8 with both operands in shared memory;
// channel-block-major activations ([16-channel plane][position][16 bytes])
// where a tap is the same descriptor moved by dy * pitch + dx positions;
// S1 on an expanded 15-tap window built on its own pitch; S4 tap-major;
// the 56,320-byte weight image (ops/fused.split_operand) resident in
// shared memory; a persistent grid. What an instance chooses:
//
// - a tile of any edge (Geometry<TH, TW>; ops/fused.layout(th, tw) holds
//   the same formulas);
// - work items of F frames: a block computes an item's tile of each of its
//   frames in turn, through the same buffers (generation 2 pairs frames);
// - the epilogue as a policy (Folded: b', B, mul, shift, the DPX clip, exact
//   inside the solver's saturation window only; Literal: b, blu_q, mul,
//   bias_pre, shift, exact for every table), and S2-S4 reading activations
//   as signed (.s8.s8) or unsigned (.u8.s8) bytes;
// - the output as uint8 restored frames (residual added) or the int16
//   residual clamped to +-255;
// - generation 3's diagnostic variants: the network truncated after stage
//   STAGES < 4 (`emit_stage`), or run on a window never read (ZERO_A1).
//
// Work items are (frame group of F frames, row tile, column tile); block b
// takes items b, b + gridDim.x, ... and in each computes frames
// F * item_frame_group, ..., up to the batch's last. Frame bounds
// (`Bounds`, the JAX kernels' row_bounds/col_bounds) give the rectangle of
// every frame that is valid: the window reads x - 128 inside it and 0
// outside, and every stage's activations are 0 outside it (SAME padding at
// a block's frame edge under a mesh); S4 still writes every position of
// the frame, and the caller keeps what it needs. The whole frame, (0, H,
// 0, W), is the network on the frame itself.
//
// No stale or unwritten byte reaches an MMA: on every tile the window
// expansion writes every position S1 reads, and each stage writes its
// whole output region (0 outside the bounds) and zeroes its tail before
// the barrier that precedes the next stage; buffers alias (S3 over S1, the
// expanded window and S4's shares over S2) only across such barriers, and
// every generic-proxy write is fenced for the async proxy before them.
// tests/torch_split_emulation.py emulates this in numpy, warpgroups
// interleaved, and checks it byte by byte.

#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

#include "hopper_wgmma.cuh"

namespace split {

using namespace hopper;

__host__ __device__ constexpr int cdiv(int a, int b) { return (a + b - 1) / b; }
__host__ __device__ constexpr int cmax(int a, int b) { return a > b ? a : b; }

// ---- weight image (ops/fused.SPLIT_CHUNKS / split_operand), in order:
// S1 (1 chunk, N 64); S2 centre (9 taps x 2, N 48), outer (16 x 2, N 16);
// S3 centre (2, N 48), other taps (8, N 16) then their plane-2 pairs (4);
// S4 tap-major (2, N 16: column t = tap t; planes 0+1, then 2 + zero half).
constexpr int N_S2 = 18 + 32, N_S3 = 2 + 12, N_S4 = 2;  // chunks (ops/fused.SPLIT_CHUNKS)
constexpr int W_S1 = 0, W_S2C = W_S1 + 32 * 64, W_S2O = W_S2C + 18 * 32 * 48;
constexpr int W_S3C = W_S2O + 32 * 32 * 16, W_S3O = W_S3C + 2 * 32 * 48;
constexpr int W_S4 = W_S3O + 12 * 32 * 16, W_BYTES = W_S4 + N_S4 * 32 * 16;
static_assert(W_BYTES == 56320, "ops/fused.SPLIT_BYTES");
static_assert(N_S2 == 50, "ops/fused.SPLIT_CHUNKS[0]");
static_assert(N_S3 == 14, "ops/fused.SPLIT_CHUNKS[1]");
static_assert(N_S4 == 2, "ops/fused.SPLIT_CHUNKS[2]");
constexpr int NCH = 64 + 48 + 48;  // channels of S1, S2, S3
constexpr int MAX_DEVICES = 64;
constexpr int NWG = 4, NTHREADS = 128 * NWG;  // 4 warpgroups, at most 128 registers

// ---- a TH x TW tile's regions (ops/fused.layout): row pitches and rows of
// the window, S1, S2, S3; 64-position blocks of S1..S4; plane sizes with
// the tails the next stage's last, shifted block reads; buffers A (S1,
// then S3) and B (expanded window, then S2, then S4's int32 shares).
template <int TH_, int TW_>
struct Geometry {
  static constexpr int TH = TH_, TW = TW_, HALO = 6;
  static constexpr int P0 = TW + 12, P1 = TW + 8, P2 = TW + 4, P3 = TW + 2;
  static constexpr int R0 = TH + 12, R1 = TH + 8, R2 = TH + 4, R3 = TH + 2;
  static constexpr int RAW = R0 * P0;
  static constexpr int MB1 = cdiv(R1 * P1, 64), MB2 = cdiv(R2 * P1, 64);
  static constexpr int MB3 = cdiv(R3 * P2, 64), MB4 = cdiv(R3 * P3, 64);
  static constexpr int EXP = MB1 * 64 + 3 * P1;
  static constexpr int PS1 = cmax(R1 * P1, MB2 * 64 + 4 * P1 + 4);
  static constexpr int PS2 = cmax(R2 * P2, MB3 * 64 + 2 * P2 + 3);
  static constexpr int PS3 = cmax(R3 * P3, MB4 * 64 + 1);
  static constexpr int BUF_A = cmax(4 * PS1, 3 * PS3) * 16;
  static constexpr int BUF_B = cmax(3 * PS2, EXP) * 16;
  // S4's per-tap shares, int32 [9][SHARE_STRIDE], over B (dead after S3);
  // the stride's +4 keeps a warp's stores in distinct banks
  static constexpr int SHARE_STRIDE = MB4 * 64 + 4;
  static constexpr int OFF_A = cdiv(RAW, 16) * 16, OFF_B = OFF_A + BUF_A;
  static constexpr int BYTES = OFF_B + BUF_B;  // the tile's buffers
  static_assert(9 * SHARE_STRIDE * 4 <= BUF_B, "S4 shares fit B");
};

// ---- epilogues of S1..S3. `load` reads channel n's vector from shared
// memory (V4 int4 per channel), `apply` requantizes an accumulator.

// The folded BLU requant (ops/requant.requant_fast), (b', B, mul, shift):
// min((clip(acc + b', 0, B) * mul) >> shift, 127), the clip one DPX
// instruction, the min implied: FusedWeights.from_engine admits only
// tables with (B * mul) >> shift == 127 (the saturation window).
struct Folded {
  static constexpr int VROWS = 4, V4 = 1;  // rows of FusedWeights.vec
  using V = int4;
  __device__ __forceinline__ static V load(const int4* v) { return v[0]; }
  __device__ __forceinline__ static int apply(const V& v, int acc) {
    return (__viaddmin_s32_relu(acc, v.x, v.y) * v.z) >> v.w;
  }
};

// The literal BLU chain (ops/requant.blu_requant_i32, pallas_pipeline.py:
// 117-119), (b, blu_q, mul, bias_pre) and (shift, 0, 0, 0):
// u = acc + b; u > blu_q ? 127 : u < 0 ? 0 : ((u + bias_pre) * mul) >> shift.
// u in int32 as the TPU kernel forms it (|acc| < 2^26: 64 x 25 taps of
// 255 x 128). On a kept lane 0 <= u <= blu_q, so u + bias_pre (bias_pre <
// 2^30) is exact as an unsigned 32-bit sum and its unsigned 32 x 32 ->
// 64-bit product with mul (< 2^31) is exact; on the other lanes the
// unsigned arithmetic wraps, defined, and the select drops them. No DPX
// clip and no dropped min: outside the window a kept value reaches up to
// 255 (LiteralWeights refuses more).
struct Literal {
  static constexpr int VROWS = 5, V4 = 2;  // rows of LiteralWeights.vec
  struct V {
    int4 a;
    int shift;
  };
  __device__ __forceinline__ static V load(const int4* v) { return {v[0], v[1].x}; }
  __device__ __forceinline__ static int apply(const V& v, int acc) {
    const int u = acc + v.a.x;
    const uint32_t sum = uint32_t(u) + uint32_t(v.a.w);
    const int kept = int((uint64_t(sum) * uint32_t(v.a.z)) >> v.shift);
    return u > v.a.y ? 127 : (u < 0 ? 0 : kept);
  }
};

// A kernel of this design: tile geometry, epilogue, activations of S2-S4
// unsigned (U8), frames per work item (F), int16 residual out (RES16) or
// restored uint8; a diagnostic variant truncated after stage STAGES < 4,
// or with the window unread (ZERO_A1).
template <class Geo_, class Epi_, bool U8_, int F_, bool RES16_, int STAGES_ = 4,
          bool ZERO_A1_ = false>
struct Cfg {
  using Geo = Geo_;
  using Epi = Epi_;
  static constexpr bool U8 = U8_, RES16 = RES16_, ZERO_A1 = ZERO_A1_;
  static constexpr int F = F_, STAGES = STAGES_;
  static_assert(STAGES >= 1 && STAGES <= 4, "stages 1..4");
  static_assert(STAGES == 4 || !RES16, "a truncated variant restores uint8 frames");
  static constexpr int RAW_PER_THREAD = cdiv(Geo::RAW, NTHREADS);
  // shared memory: weight image, vectors, then the tile's buffers
  static constexpr int SM_W = 0, SM_VEC = SM_W + W_BYTES;
  static constexpr int SM_BUF = SM_VEC + NCH * Epi::V4 * 16;
  static constexpr int SMEM_BYTES = SM_BUF + Geo::BYTES;
  static_assert(SMEM_BYTES <= 232448, "one block per SM");
};

// The valid rectangle of every frame: rows [r_lo, r_hi), columns [c_lo,
// c_hi), inside the frame.
struct Bounds {
  int r_lo, r_hi, c_lo, c_hi;
  __device__ __forceinline__ bool inside(int r, int c) const {
    return r >= r_lo && r < r_hi && c >= c_lo && c < c_hi;
  }
  // the caller's bounds clipped to an H x W frame (ops/fused.fused_forward's)
  static Bounds clipped(int r_lo, int r_hi, int c_lo, int c_hi, int H, int W) {
    return {r_lo > 0 ? r_lo : 0, r_hi < H ? r_hi : H, c_lo > 0 ? c_lo : 0, c_hi < W ? c_hi : W};
  }
};

// What the stages share: shared addresses, the frame and its bounds.
struct Ctx {
  uint32_t sw;      // shared address of the weight image
  const int4* vec;  // epilogue vectors, Epi::V4 int4 per channel of S1, S2, S3
  uint8_t* buf;     // the tile buffers
  uint32_t sbuf;    // their shared address
  int H, W;
  Bounds bd;
};

// Position lane/4 (+8) of warp w's 16 rows of a 64-position block.
__device__ __forceinline__ int row_of(int half) {
  return ((threadIdx.x >> 5) & 3) * 16 + ((threadIdx.x & 31) >> 2) + 8 * half;
}

// Epilogue of S1..S3 for one block: output position q = p0 + row, on the
// input pitch PIN, is region position (r, c); columns past the region's
// width and rows past its last are dropped, the rest stored on the region's
// pitch POUT, two channels per 16-bit store, 0 outside the bounds.
template <class Epi, int COUT, int PIN, int ROWS, int POUT, int PS>
__device__ __forceinline__ void store_stage(const int (&acc)[COUT / 2], int p0, uint8_t* out,
                                            const int4* vec, int org_r, int org_c,
                                            const Bounds& bd) {
  const int t = threadIdx.x & 3;
  bool keep[2], ok[2];
  uint8_t* dst[2];
#pragma unroll
  for (int half = 0; half < 2; ++half) {
    const int q = p0 + row_of(half);
    const int r = q / PIN, c = q - r * PIN;
    keep[half] = r < ROWS && c < POUT;
    ok[half] = bd.inside(org_r + r, org_c + c);
    dst[half] = out + (r * POUT + c) * 16 + 2 * t;
  }
#pragma unroll
  for (int j = 0; j < COUT / 8; ++j) {
    const typename Epi::V v0 = Epi::load(vec + (8 * j + 2 * t) * Epi::V4);
    const typename Epi::V v1 = Epi::load(vec + (8 * j + 2 * t + 1) * Epi::V4);
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int b0 = Epi::apply(v0, acc[4 * j + 2 * half]);
      const int b1 = Epi::apply(v1, acc[4 * j + 2 * half + 1]);
      if (keep[half])
        *reinterpret_cast<uint16_t*>(dst[half] + (j >> 1) * PS * 16 + (j & 1) * 8) =
            ok[half] ? uint16_t(b0 | (b1 << 8)) : uint16_t(0);
    }
  }
}

// Zero positions [N, PS) of every plane: the tail the next stage's last,
// shifted block reads (its outputs there are dropped).
template <int PLANES, int N, int PS>
__device__ __forceinline__ void zero_tails(uint8_t* out) {
  constexpr int T = PS - N;
  if constexpr (T > 0) {
    for (int i = threadIdx.x; i < PLANES * T; i += NTHREADS) {
      const int pl = i / T, p = N + (i - pl * T);
      *reinterpret_cast<uint4*>(out + (pl * PS + p) * 16) = make_uint4(0, 0, 0, 0);
    }
  }
}

template <int L>
__device__ __forceinline__ void zero(int (&d)[L]) {
#pragma unroll
  for (int i = 0; i < L; ++i) d[i] = 0;
}

// S2-S4's products on signed or unsigned activations.
template <bool U8, int O, int L>
__device__ __forceinline__ void mma16(int (&d)[L], uint64_t a, uint64_t b) {
  if constexpr (U8)
    mma_u8_n16<O>(d, a, b);
  else
    mma_n16<O>(d, a, b);
}
template <bool U8, int O, int L>
__device__ __forceinline__ void mma48(int (&d)[L], uint64_t a, uint64_t b) {
  if constexpr (U8)
    mma_u8_n48<O>(d, a, b);
  else
    mma_n48<O>(d, a, b);
}

// Raster index of the i-th 5x5 tap outside the centre 3x3, and of the
// i-th 3x3 tap other than the centre.
__host__ __device__ constexpr int outer5(int i) {
  return i < 5 ? i : (i < 11 ? (i - 5) / 2 * 5 + 5 + (i - 5) % 2 * 4 : i + 9);
}
__host__ __device__ constexpr int other3(int i) { return i < 4 ? i : i + 1; }

// Each stage: warpgroup wg takes blocks wg, wg + NWG, ...; a
// block's chunks are issued back to back, then one wait. Chunks of
// different widths accumulate into disjoint registers, added after the wait
// (an N = 16 wgmma into part of the N = 48 accumulator makes ptxas
// serialize the wgmma pipeline, warning C7511).

template <class C>
__device__ __forceinline__ void stage1(const Ctx& x, int ty0, int tx0) {
  using Geo = typename C::Geo;
  const uint64_t db = desc(x.sw + W_S1, 128, 256);
  zero_tails<4, Geo::R1 * Geo::P1, Geo::PS1>(x.buf + Geo::OFF_A);
  for (int mb = threadIdx.x >> 7; mb < Geo::MB1; mb += NWG) {
    int acc[32];
    zero(acc);
    __syncwarp();
    wg_fence();
    mma_n64<0>(acc, at(desc(x.sbuf + Geo::OFF_B + mb * 64 * 16, 0, 128), 0, 3 * Geo::P1), db);
    wg_commit();
    wg_wait<0>();
    fence_regs(acc);
    store_stage<typename C::Epi, 64, Geo::P1, Geo::R1, Geo::P1, Geo::PS1>(
        acc, mb * 64, x.buf + Geo::OFF_A, x.vec, ty0 - 4, tx0 - 4, x.bd);
  }
}

template <class C>
__device__ __forceinline__ void stage2(const Ctx& x, int ty0, int tx0) {
  using Geo = typename C::Geo;
  const uint64_t db = desc(x.sw, 128, 256);
  zero_tails<3, Geo::R2 * Geo::P2, Geo::PS2>(x.buf + Geo::OFF_B);
  for (int mb = threadIdx.x >> 7; mb < Geo::MB2; mb += NWG) {
    const uint64_t da = desc(x.sbuf + Geo::OFF_A + mb * 64 * 16, 0, 128);
    int acc[24], acc2[8];  // channels 0-47; C2_2's outer taps (32-47)
    zero(acc);
    zero(acc2);
    __syncwarp();
    wg_fence();
#pragma unroll
    for (int i = 0; i < 9; ++i) {  // centre taps: C2_1 ++ C2_2, channels 0-47
      const int s = (1 + i / 3) * Geo::P1 + 1 + i % 3;
#pragma unroll
      for (int c = 0; c < 2; ++c)
        mma48<C::U8, 0>(acc, at(da, 2 * c * Geo::PS1 + s, Geo::PS1),
                        at(db, (W_S2C + (2 * i + c) * 1536) / 16, 0));
    }
#pragma unroll
    for (int i = 0; i < 16; ++i) {  // outer taps: C2_2, channels 32-47
      const int s = outer5(i) / 5 * Geo::P1 + outer5(i) % 5;
#pragma unroll
      for (int c = 0; c < 2; ++c)
        mma16<C::U8, 0>(acc2, at(da, 2 * c * Geo::PS1 + s, Geo::PS1),
                        at(db, (W_S2O + (2 * i + c) * 512) / 16, 0));
    }
    wg_commit();
    wg_wait<0>();
    fence_regs(acc);
    fence_regs(acc2);
#pragma unroll
    for (int i = 0; i < 8; ++i) acc[16 + i] += acc2[i];
    store_stage<typename C::Epi, 48, Geo::P1, Geo::R2, Geo::P2, Geo::PS2>(
        acc, mb * 64, x.buf + Geo::OFF_B, x.vec + 64 * C::Epi::V4, ty0 - 2, tx0 - 2, x.bd);
  }
}

template <class C>
__device__ __forceinline__ void stage3(const Ctx& x, int ty0, int tx0) {
  using Geo = typename C::Geo;
  const uint64_t db = desc(x.sw, 128, 256);
  zero_tails<3, Geo::R3 * Geo::P3, Geo::PS3>(x.buf + Geo::OFF_A);
  constexpr int SC = Geo::P2 + 1;  // centre tap
  for (int mb = threadIdx.x >> 7; mb < Geo::MB3; mb += NWG) {
    const uint64_t da = desc(x.sbuf + Geo::OFF_B + mb * 64 * 16, 0, 128);
    int acc[24], acc1[8];  // channels 0-47; C3_1's other taps (0-15)
    zero(acc);
    zero(acc1);
    __syncwarp();
    wg_fence();
    // centre tap: C3_1 ++ C3_2, channels 0-47; planes 0+1, then 2 + zero half
    mma48<C::U8, 0>(acc, at(da, SC, Geo::PS2), at(db, W_S3C / 16, 0));
    mma48<C::U8, 0>(acc, at(da, 2 * Geo::PS2 + SC, 1), at(db, (W_S3C + 1536) / 16, 0));
#pragma unroll
    for (int i = 0; i < 8; ++i) {  // other taps: C3_1, channels 0-15
      const int s = other3(i) / 3 * Geo::P2 + other3(i) % 3;
      mma16<C::U8, 0>(acc1, at(da, s, Geo::PS2), at(db, (W_S3O + i * 512) / 16, 0));
    }
#pragma unroll
    for (int j = 0; j < 4; ++j) {  // plane 2 of taps 2j and 2j + 1
      const int sa = other3(2 * j) / 3 * Geo::P2 + other3(2 * j) % 3;
      const int sb = other3(2 * j + 1) / 3 * Geo::P2 + other3(2 * j + 1) % 3;
      mma16<C::U8, 0>(acc1, at(da, 2 * Geo::PS2 + sa, sb - sa),
                      at(db, (W_S3O + (8 + j) * 512) / 16, 0));
    }
    wg_commit();
    wg_wait<0>();
    fence_regs(acc);
    fence_regs(acc1);
#pragma unroll
    for (int i = 0; i < 8; ++i) acc[i] += acc1[i];
    store_stage<typename C::Epi, 48, Geo::P2, Geo::R3, Geo::P3, Geo::PS3>(
        acc, mb * 64, x.buf + Geo::OFF_A, x.vec + 112 * C::Epi::V4, ty0 - 1, tx0 - 1, x.bd);
  }
}

// S4 (48 -> 1), tap-major: each S3 position is read once, by two chunks
// against N = 16 columns of which column t holds tap t's weights, so
// acc[p, t] is tap t's share of the output at p - (dy_t * P3 + dx_t). The
// 9 shares go to shared memory and each output pixel sums its own; then
// the final requant (u4 * mul4 + 2^(shift4-1)) >> shift4 in 64 bits
// (|u4 - b4| <= 432 x 255 x 128 < 2^24; b4 and mul4 are int32, so the
// product fits 63 bits), and the residual added (uint8 out) or clamped to
// +-255 (int16 out).
template <class C>
__device__ __forceinline__ void stage4(const Ctx& x, const uint8_t* xf, void* outf, int ty0,
                                       int tx0, int b4, int mul4, int shift4) {
  using Geo = typename C::Geo;
  const int t = threadIdx.x & 3;
  const uint64_t db = desc(x.sw, 128, 256);
  int* share = reinterpret_cast<int*>(x.buf + Geo::OFF_B);
  for (int mb = threadIdx.x >> 7; mb < Geo::MB4; mb += NWG) {
    const uint64_t da = desc(x.sbuf + Geo::OFF_A + mb * 64 * 16, 0, 128);
    int acc[8];
    zero(acc);
    __syncwarp();
    wg_fence();
    mma16<C::U8, 0>(acc, at(da, 0, Geo::PS3), at(db, W_S4 / 16, 0));
    mma16<C::U8, 0>(acc, at(da, 2 * Geo::PS3, 1), at(db, (W_S4 + 512) / 16, 0));
    wg_commit();
    wg_wait<0>();
    fence_regs(acc);
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int p = mb * 64 + row_of(half);
#pragma unroll
      for (int j = 0; j < 2; ++j)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int tap = 8 * j + 2 * t + e;
          if (tap < 9) share[tap * Geo::SHARE_STRIDE + p] = acc[4 * j + 2 * half + e];
        }
    }
  }
  __syncthreads();
  for (int o = threadIdx.x; o < Geo::TH * Geo::TW; o += NTHREADS) {
    const int r = o / Geo::TW, c = o - (o / Geo::TW) * Geo::TW;
    const int fr = ty0 + r, fc = tx0 + c;
    if (fr >= x.H || fc >= x.W) continue;
    const int* sh = share + r * Geo::P3 + c;
    int u = 0;
#pragma unroll
    for (int tap = 0; tap < 9; ++tap) u += sh[tap * Geo::SHARE_STRIDE + tap / 3 * Geo::P3 + tap % 3];
    const long long v = (long long)u + b4;
    const long long res = (v * mul4 + (1LL << (shift4 - 1))) >> shift4;
    const size_t i = size_t(fr) * x.W + fc;
    if constexpr (C::RES16) {
      static_cast<int16_t*>(outf)[i] = int16_t(res < -255 ? -255 : (res > 255 ? 255 : res));
    } else {
      const long long rec = (long long)xf[i] + res;
      static_cast<uint8_t*>(outf)[i] = uint8_t(rec < 0 ? 0 : (rec > 255 ? 255 : rec));
    }
  }
}

// A variant truncated after stage K (1..3) writes, in place of S4, each
// output pixel's clamp(x + a, 0, 255), a = channel 0 of stage K's
// requantized, masked activation (0..127) at that pixel: byte 0 of plane 0
// of stage K's region (S1 and S3 in buffer A, S2 in B), whose origin lies
// 4, 2 or 1 positions before the tile's first output, on its own pitch.
template <class C, int K>
__device__ __forceinline__ void emit_stage(const Ctx& x, const uint8_t* xf, uint8_t* yf, int ty0,
                                           int tx0) {
  using Geo = typename C::Geo;
  static_assert(K >= 1 && K <= 3, "stages 1..3");
  constexpr int OFF = K == 1 ? 4 : (K == 2 ? 2 : 1);
  constexpr int P = K == 1 ? Geo::P1 : (K == 2 ? Geo::P2 : Geo::P3);
  const uint8_t* act = x.buf + (K == 2 ? Geo::OFF_B : Geo::OFF_A);
  for (int o = threadIdx.x; o < Geo::TH * Geo::TW; o += NTHREADS) {
    const int r = o / Geo::TW, c = o - (o / Geo::TW) * Geo::TW;
    const int fr = ty0 + r, fc = tx0 + c;
    if (fr >= x.H || fc >= x.W) continue;
    const size_t i = size_t(fr) * x.W + fc;
    const int rec = int(xf[i]) + int(act[((r + OFF) * P + c + OFF) * 16]);
    yf[i] = uint8_t(rec > 255 ? 255 : rec);
  }
}

// The tiles a block walks: item, and the frame f of it (F > 1 only); item
// >= items when the walk is over.
struct Walk {
  int item, f;
};

// A tile: its frame and its origin in the frame.
struct Tile {
  int f, ty0, tx0;
};

// The block's next tile. F = 1: the item gridDim.x on, whose frame
// `tile_at` derives (the flat walk, one division a tile). F > 1: the
// item's next frame (frames F * p up to min(F * p + F, B), p = the item's
// frame group), else the first frame of the item gridDim.x on. Every item
// has one: F * p < B for p < cdiv(B, F).
template <int F>
__device__ __forceinline__ void advance(Walk& w, int per_frame, int B) {
  if constexpr (F == 1) {
    w.item += gridDim.x;
  } else {
    if (++w.f < min(F * (w.item / per_frame) + F, B)) return;
    w.item += gridDim.x;
    w.f = F * (w.item / per_frame);
  }
}

// The walk's tile: the item's frame group p and its place in the frame.
template <class C>
__device__ __forceinline__ Tile tile_at(const Walk& w, int tiles_x, int per_frame) {
  const int p = w.item / per_frame, rem = w.item - p * per_frame, ty = rem / tiles_x;
  return {C::F == 1 ? p : w.f, ty * C::Geo::TH, (rem - ty * tiles_x) * C::Geo::TW};
}

// The window of a tile, x - 128 inside the bounds and 0 outside, loaded
// into registers (issued early, stored to shared memory later). ZERO_A1
// (the diagnostic variant) reads no pixel: x - 128 = 0 everywhere.
template <class C>
__device__ __forceinline__ void load_window(uint32_t (&pre)[C::RAW_PER_THREAD], const uint8_t* xf,
                                            int ty0, int tx0, const Ctx& x) {
  using Geo = typename C::Geo;
#pragma unroll
  for (int k = 0; k < C::RAW_PER_THREAD; ++k) {
    const int i = threadIdx.x + k * NTHREADS;
    const int r = ty0 - Geo::HALO + i / Geo::P0, c = tx0 - Geo::HALO + i % Geo::P0;
    pre[k] = (!C::ZERO_A1 && i < Geo::RAW && x.bd.inside(r, c)) ? uint32_t(xf[size_t(r) * x.W + c])
                                                                      : 128u;
  }
}

// The whole kernel body: weights and vectors into shared memory, then the
// block walks its tiles.
template <class C>
__device__ __forceinline__ void run(uint8_t* smem, const uint8_t* __restrict__ x, void* out,
                                    const int8_t* __restrict__ wsplit,
                                    const int* __restrict__ vec_g, int B, int H, int W, Bounds bd,
                                    int b4, int mul4, int shift4) {
  using Geo = typename C::Geo;
  using Epi = typename C::Epi;
  const uint32_t sbase = smem_addr(smem);
  for (int i = threadIdx.x; i < W_BYTES / 16; i += NTHREADS)
    cp_async16(sbase + C::SM_W + i * 16, wsplit + i * 16);
  int* vec = reinterpret_cast<int*>(smem + C::SM_VEC);
  for (int i = threadIdx.x; i < Epi::VROWS * NCH; i += NTHREADS) {  // [stage][row][C] -> [ch][row]
    constexpr int E1 = Epi::VROWS * 64, E2 = Epi::VROWS * 112;
    const int start = i < E1 ? 0 : (i < E2 ? E1 : E2);
    const int cout = i < E1 ? 64 : 48, ch0 = i < E1 ? 0 : (i < E2 ? 64 : 112);
    const int row = (i - start) / cout, ch = ch0 + (i - start) % cout;
    vec[4 * Epi::V4 * ch + row] = vec_g[i];
  }

  const Ctx ctx{sbase + C::SM_W, reinterpret_cast<const int4*>(smem + C::SM_VEC),
                smem + C::SM_BUF, sbase + C::SM_BUF, H, W, bd};
  const int tiles_x = cdiv(W, Geo::TW), per_frame = cdiv(H, Geo::TH) * tiles_x;
  const int items = cdiv(B, C::F) * per_frame;

  uint32_t pre[C::RAW_PER_THREAD];
  Walk w{int(blockIdx.x), C::F * (int(blockIdx.x) / per_frame)};
  if (w.item < items) {
    const Tile t = tile_at<C>(w, tiles_x, per_frame);
    load_window<C>(pre, x + size_t(t.f) * H * W, t.ty0, t.tx0, ctx);
  }
  cp_async_wait_all();
  fence_async_smem();
  __syncthreads();

  int8_t* raw = reinterpret_cast<int8_t*>(ctx.buf);
  while (w.item < items) {
    const Tile cur = tile_at<C>(w, tiles_x, per_frame);
    const int ty0 = cur.ty0, tx0 = cur.tx0;
#pragma unroll
    for (int k = 0; k < C::RAW_PER_THREAD; ++k) {
      const int i = threadIdx.x + k * NTHREADS;
      if (i < Geo::RAW) raw[i] = int8_t(int(pre[k]) - 128);
    }
    __syncthreads();
    advance<C::F>(w, per_frame, B);
    if (w.item < items) {
      const Tile t = tile_at<C>(w, tiles_x, per_frame);
      load_window<C>(pre, x + size_t(t.f) * H * W, t.ty0, t.tx0, ctx);
    }
    // expanded window on S1's pitch: position (r, c) holds window (r + i,
    // c + j) as byte 5i + j
    for (int e = threadIdx.x; e < Geo::EXP; e += NTHREADS) {
      uint32_t v[4] = {0, 0, 0, 0};
#pragma unroll
      for (int j = 0; j < 15; ++j) {
        const int idx = (e / Geo::P1 + j / 5) * Geo::P0 + e % Geo::P1 + j % 5;
        const uint32_t b = idx < Geo::RAW ? uint32_t(uint8_t(raw[idx])) : 0u;
        v[j >> 2] |= b << (8 * (j & 3));
      }
      *reinterpret_cast<uint4*>(ctx.buf + Geo::OFF_B + e * 16) = make_uint4(v[0], v[1], v[2], v[3]);
    }
    fence_async_smem();
    __syncthreads();
    // the tile's frame, in and out
    const size_t frame = size_t(cur.f) * H * W;
    const auto xf = [&] { return x + frame; };
    const auto outf = [&] { return static_cast<uint8_t*>(out) + frame * (C::RES16 ? 2 : 1); };
    stage1<C>(ctx, ty0, tx0);
    fence_async_smem();
    __syncthreads();
    if constexpr (C::STAGES == 1) {
      emit_stage<C, 1>(ctx, xf(), outf(), ty0, tx0);
      continue;
    }
    stage2<C>(ctx, ty0, tx0);
    fence_async_smem();
    __syncthreads();
    if constexpr (C::STAGES == 2) {
      emit_stage<C, 2>(ctx, xf(), outf(), ty0, tx0);
      continue;
    }
    stage3<C>(ctx, ty0, tx0);
    fence_async_smem();
    __syncthreads();
    if constexpr (C::STAGES == 3) {
      emit_stage<C, 3>(ctx, xf(), outf(), ty0, tx0);
      continue;
    }
    stage4<C>(ctx, xf(), outf(), ty0, tx0, b4, mul4, shift4);
  }
}

// Every instance's kernel (its name holds "qvrcnn_", which tools/profile
// reads in a trace).
template <class C>
__global__ void __launch_bounds__(NTHREADS, 1)
qvrcnn_kernel(const uint8_t* __restrict__ x, void* __restrict__ out,
              const int8_t* __restrict__ wsplit, const int* __restrict__ vec, int B, int H, int W,
              Bounds bd, int b4, int mul4, int shift4) {
  extern __shared__ __align__(128) uint8_t smem[];
  run<C>(smem, x, out, wsplit, vec, B, H, W, bd, b4, mul4, shift4);
}

// Launch bookkeeping: the current device's SM count, after setting
// `kernel`'s dynamic shared-memory size once per device (`sms` caches
// both). Returns a cudaError_t as int; 0 on success.
template <class Kernel>
inline int prepare(Kernel kernel, int smem_bytes, int (&sms)[MAX_DEVICES], int& count) {
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return int(err);
  if (dev >= MAX_DEVICES) return int(cudaErrorInvalidDevice);
  if (sms[dev] == 0) {
    err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem_bytes);
    if (err != cudaSuccess) return int(err);
    int n = 0;
    err = cudaDeviceGetAttribute(&n, cudaDevAttrMultiProcessorCount, dev);
    if (err != cudaSuccess) return int(err);
    sms[dev] = n;
  }
  count = sms[dev];
  return 0;
}

// Launch instance C on `stream` (a cudaStream_t) on the current device:
// one 512-thread block per SM, at most one per work item. Returns the
// cudaError_t of the device query, of the one-time attribute call for
// this device and instance, or of the launch (cudaGetLastError); 0 on
// success. Internal to each library: a template's static local is one
// object across every library of the process (a GNU unique symbol), so two
// builds of one instance loaded side by side (tools/compare_builds) would
// share `sm_count`, and the second would launch without its shared-memory
// attribute.
namespace {
template <class C>
int launch(const void* x, void* out, const void* wsplit, const void* vec, int B, int H, int W,
           Bounds bd, int b4, int mul4, int shift4, void* stream) {
  static int sm_count[MAX_DEVICES] = {};  // 0 until the device's first launch
  int sms = 0;
  const int err = prepare(qvrcnn_kernel<C>, C::SMEM_BYTES, sm_count, sms);
  if (err != 0) return err;
  const int items = cdiv(B, C::F) * cdiv(H, C::Geo::TH) * cdiv(W, C::Geo::TW);
  const int grid = items < sms ? items : sms;
  qvrcnn_kernel<C><<<grid, NTHREADS, C::SMEM_BYTES, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint8_t*>(x), out, static_cast<const int8_t*>(wsplit),
      static_cast<const int*>(vec), B, H, W, bd, b4, mul4, shift4);
  return int(cudaGetLastError());
}
}  // namespace

}  // namespace split
