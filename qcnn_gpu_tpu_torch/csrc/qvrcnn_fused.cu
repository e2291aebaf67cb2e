// Fused whole-network QVRCNN INT8 restore kernel for Hopper (sm_90a),
// generation 3.
//
// Replaces the Pallas TPU kernel `_make_kernel3` / `_kernel3_body`
// (qcnn_gpu_tpu/ops/pallas_pipeline3.py:271, :319), built by
// `build_pallas_forward3`. It computes what that kernel computes — the
// integer contract of qcnn_gpu_tpu/models/oracle.py:8-31, bit for bit:
//
//   x' = x_u8 - 128                       (0 outside the frame bounds)
//   S1 C1 5x5 1->64 | S2 Conc1 = C2_1 3x3 64->32 ++ C2_2 5x5 64->16 |
//   S3 Conc2 = C3_1 3x3 48->16 ++ C3_2 1x1 48->32   each: int8 x int8 ->
//      int32, folded BLU requant min((clip(u + b', 0, B) * mul) >> shift,
//      127), then every position outside the frame bounds set to 0
//      (per-layer SAME padding at the frame edge)
//   S4 C4 3x3 48->1, res = (u * mul4 + 2^(shift4-1)) >> shift4 (floor),
//   out = clamp(x_u8 + res, 0, 255)
//
// What bounds it on the H100: tensor-core work. The network is 54,512
// useful MACs per pixel against 1-2 bytes of device memory, so the int8
// peak (1,979 TOP/s) is the bound, 0.114 ms per 1080p frame. In practice
// the count of `wgmma` instructions bounds it more than their MACs: on an
// H100 SXM (700 W) an m64n16k32 with both operands in shared memory
// takes ~20 cycles per SM, an m64n64k32 ~32 (the int8 peak), i.e. a
// small-N chunk costs about its 2 KB A-operand read (tools/wgmma_rate).
// This kernel issues 1,362 per 24x40 tile (~31k cycles, about 0.27 ms per
// 1080p frame at that rate), and its integer epilogue
// requantizes 218k values per tile beside them. The design answers the
// four costs that held the first Hopper design (16x16 tiles, merged
// branches, `mma.sync`, weights from L2) at 18x its bound:
//
// - Split branches: no zero taps. S2's 9 centre taps carry C2_1 and
//   C2_2 together (N = 48), its 16 outer taps C2_2 alone (N = 16); S3's
//   centre tap carries C3_1 and C3_2 (N = 48), its 8 others C3_1 (N = 16).
//   56,320 MACs issued per computed position (1.03x the useful 54,512:
//   K and N padding of S1, S3 and S4).
// - Larger tiles: 24x40 outputs per tile by default (24 divides 1080, 40
//   divides 1920). S2-S4 compute on their input region's row pitch, S1 on
//   its own, so the halo, the wrapped columns and the last blocks' rows
//   cost 1.37x the output area, weighted by MACs (1.52x at 16x16). The
//   kernel is a template on its tile and compiled at every tile of
//   QVRCNN_TILES: a smaller tile costs more halo per pixel but can fill
//   the 132 SMs' last round of a small frame (ops/tuning.py picks the
//   tile per geometry from a measured table).
// - `wgmma` on both operands from shared memory, one warpgroup per
//   64-position block, all chunks of a block issued back to back. The
//   A operand needs no im2col: activations are channel-block-major
//   ([16-channel plane][position][16 bytes]), so the 8 x 16-byte core
//   matrices of 64 consecutive positions are contiguous, and tap
//   (dy, dx) is the same descriptor moved by dy * pitch + dx positions.
//   S1 (one input channel) reads an expanded window whose 16 bytes per
//   position are 15 taps (3 rows x 5 columns): one k32 chunk, halves 3
//   rows apart. S4 (one output channel) runs tap-major: each S3
//   position meets all 9 taps at once (N = 16) and each output sums its
//   9 shares, 36 `wgmma` per tile where one per tap would take 224.
// - Weights resident in shared memory: the 56,320-byte image
//   (ops/fused.split_operand) is copied once per block with cp.async; a
//   persistent grid (one 512-thread block per SM, 218,976 bytes of shared
//   memory at 24x40) walks the (frame, row tile, column tile) list, and the next
//   tile's window is loaded into registers while the current one computes.
//
// No stale or unwritten byte reaches an MMA: on every tile the window
// expansion writes every position S1 reads, and each stage writes its
// whole output region (0 where masked) and zeroes its tail (the positions
// past the region that the next stage's last, shifted block reads), before
// the barrier that precedes the next stage. Buffers alias (S3 over S1;
// the expanded window and S4's shares over S2) only across such barriers;
// every generic-proxy write is fenced for the async proxy before them.
// tests/test_torch_fused_split.py emulates this layout in numpy and checks
// that property byte by byte; ops/fused.py holds the same constants.
//
// Diagnostic instances (a separate library, never the main path's): built
// with -DQVRCNN_DIAG_TH=th -DQVRCNN_DIAG_TW=tw, this source compiles only
// `qvrcnn_fused_stages`, the th x tw tile's QVRCNN_STAGE_VARIANTS:
// generation 3 truncated after stage k (k = 1, 2, 3), writing
// clamp(x + channel 0 of stage k's masked activation, 0, 255) in place of
// S4, and the whole network on a window that is never read from global
// memory (`zero_a1`: x - 128 taken as 0 everywhere, the residual added to
// the true x). Timing them in turns splits the kernel's time by stage
// (tools/stage_marginals.py); ops/fused.fused_forward(stages=, _debug=)
// launches them and ops/fused.fused_forward_reference is their plain
// version. Without the defines (the main library) only
// `qvrcnn_fused_forward` is compiled, one instance per tile.

#include <cuda_runtime.h>
#include <stdint.h>

#include "qvrcnn_split.cuh"

// The tiles this kernel is compiled at, X(TH, TW) each (ops/fused.TILES):
// 24x40, the default, and those the measured table (ops/tuning.py) serves
// somewhere: 24x32 at 416x240, 32x32 from 832x480 up.
#define QVRCNN_TILES(X) X(24, 40) X(24, 32) X(32, 32)

// The diagnostic variants, X(stages, zero_a1) each (ops/fused.STAGE_VARIANTS):
// truncated after S1, S2, S3, and the whole network with the window unread.
#define QVRCNN_STAGE_VARIANTS(X) X(1, false) X(2, false) X(3, false) X(4, true)

namespace {

using namespace hopper;

__host__ __device__ constexpr int cdiv(int a, int b) { return (a + b - 1) / b; }

// ---- weight image (ops/fused.SPLIT_CHUNKS / split_operand), in order:
// S1 (1 chunk, N 64); S2 centre (9 taps x 2, N 48), outer (16 x 2, N 16);
// S3 centre (2, N 48), other taps (8, N 16) then their plane-2 pairs (4);
// S4 tap-major (2, N 16: column t = tap t; planes 0+1, then 2 + zero half).
constexpr int N_S2 = 18 + 32, N_S3 = 2 + 12, N_S4 = 2;
constexpr int W_S1 = 0, W_S2C = W_S1 + 32 * 64, W_S2O = W_S2C + 18 * 32 * 48;
constexpr int W_S3C = W_S2O + 32 * 32 * 16, W_S3O = W_S3C + 2 * 32 * 48;
constexpr int W_S4 = W_S3O + 12 * 32 * 16, W_BYTES = W_S4 + N_S4 * 32 * 16;

static_assert(W_BYTES == 56320, "ops/fused.SPLIT_BYTES");
static_assert(N_S2 == 50, "");
static_assert(N_S3 == 14, "");
static_assert(N_S4 == 2, "");

// per-channel epilogue vectors: ops/fused.FusedWeights.vec holds, for
// each of S1..S3, the int32 rows [b' | B | mul | shift] of C entries; the
// block keeps them as one int4 (b', B, mul, shift) per channel, channels
// of S1, S2, S3 in turn, so that an epilogue loads a channel's four in one
// 16-byte load.
constexpr int NCH = 64 + 48 + 48;
constexpr int VEC_LEN = 4 * NCH;
constexpr int NWG = 4, NTHREADS = 128 * NWG;  // 4 warpgroups, at most 128 registers

// ---- a tile instance (ops/fused.TILES). The regions of a TH x TW tile are
// split::Geometry's (ops/fused.layout(th, tw)): row pitches P0..P3 and
// rows R0..R3 of the window, S1, S2 and S3; the 64-position blocks MB1..MB4
// of S1..S4; S1's expanded positions EXP; the plane sizes PS1..PS3 (the
// region plus the tail the next stage's last, shifted block reads); S4's
// share stride. Shared memory: the weight image, the vectors, the raw
// window, then buffer A (S1, then S3) and buffer B (the expanded window,
// then S2, then S4's int32 shares).
template <int TH_, int TW_>
struct Geo3 : split::Geometry<TH_, TW_> {
  using G = split::Geometry<TH_, TW_>;
  static constexpr int SM_W = 0, SM_VEC = SM_W + W_BYTES, SM_RAW = SM_VEC + VEC_LEN * 4;
  static constexpr int SM_A = SM_RAW + G::OFF_A, SM_B = SM_RAW + G::OFF_B;
  static constexpr int SMEM_BYTES = SM_RAW + G::BYTES;
  static constexpr int RAW_PER_THREAD = cdiv(G::RAW, NTHREADS);
  static_assert(SMEM_BYTES <= 232448, "one block per SM");
};

// Each compiled instance's regions as ops/fused.layout(th, tw) gives them
// (tests/test_torch_fused_split.py holds these numbers against it): the
// blocks of S1..S4, S1's expanded positions, the planes of S1..S3, the
// tile's buffers (raw window, A, B) and the block's shared memory.
template <int TH, int TW>
constexpr bool regions(int mb1, int mb2, int mb3, int mb4, int exp, int ps1, int ps2, int ps3,
                       int bytes, int smem) {
  using G = Geo3<TH, TW>;
  return G::MB1 == mb1 && G::MB2 == mb2 && G::MB3 == mb3 && G::MB4 == mb4 && G::EXP == exp &&
         G::PS1 == ps1 && G::PS2 == ps2 && G::PS3 == ps3 && G::BYTES == bytes &&
         G::SMEM_BYTES == smem;
}
static_assert(regions<24, 40>(24, 21, 18, 18, 1680, 1540, 1243, 1153, 160096, 218976), "");
static_assert(regions<24, 32>(20, 18, 15, 14, 1400, 1316, 1035, 897, 135488, 194368), "");
static_assert(regions<32, 32>(25, 23, 20, 19, 1720, 1636, 1355, 1217, 171680, 230560), "");

struct Bounds {
  int r_lo, r_hi, c_lo, c_hi;  // valid frame rectangle (already clipped)
  __device__ bool inside(int r, int c) const {
    return r >= r_lo && r < r_hi && c >= c_lo && c < c_hi;
  }
};

struct Tile {
  int f, ty0, tx0;
};

template <class G>
__device__ __forceinline__ Tile tile_at(int t, int tiles_x, int per_frame) {
  const int f = t / per_frame, rem = t - f * per_frame;
  const int ty = rem / tiles_x;
  return {f, ty * G::TH, (rem - ty * tiles_x) * G::TW};
}

// The folded BLU requant (ops/requant.requant_fast) with channel vector
// v = (b', B, mul, shift): min((clip(acc + b', 0, B) * mul) >> shift, 127).
// The clip is one Hopper DPX instruction; the final min is implied, as
// FusedWeights.from_engine admits only tables with (B * mul) >> shift ==
// 127 and the value is monotone in the clipped sum.
__device__ __forceinline__ int requant(int4 v, int acc) {
  return (__viaddmin_s32_relu(acc, v.x, v.y) * v.z) >> v.w;
}

// Position lane/4 (+8) of warp w's 16 rows of a 64-position block.
__device__ __forceinline__ int row_of(int half) {
  return ((threadIdx.x >> 5) & 3) * 16 + ((threadIdx.x & 31) >> 2) + 8 * half;
}

// Epilogue of S1..S3 for one block: output position q = p0 + row, on the
// input pitch PIN, is region position (r, c); columns past the region's
// width and rows past its last are dropped, the rest stored on the region's
// pitch POUT, two channels per 16-bit store, 0 outside the frame bounds.
template <int COUT, int PIN, int ROWS, int POUT, int PS>
__device__ __forceinline__ void store_stage(const int (&acc)[COUT / 2], int p0, uint8_t* out,
                                            const int4* vec, int org_r, int org_c, Bounds bd) {
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
    const int4 v0 = vec[8 * j + 2 * t], v1 = vec[8 * j + 2 * t + 1];
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int b0 = requant(v0, acc[4 * j + 2 * half]);
      const int b1 = requant(v1, acc[4 * j + 2 * half + 1]);
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

// Raster index of the i-th 5x5 tap outside the centre 3x3, and of the
// i-th 3x3 tap other than the centre.
__host__ __device__ constexpr int outer5(int i) {
  return i < 5 ? i : (i < 11 ? (i - 5) / 2 * 5 + 5 + (i - 5) % 2 * 4 : i + 9);
}
__host__ __device__ constexpr int other3(int i) { return i < 4 ? i : i + 1; }

// Each stage: warpgroup wg takes blocks wg, wg + 4, ...; a block's
// chunks are issued back to back, then one wait. Chunks of different
// widths accumulate into disjoint registers, added after the wait (an
// N = 16 wgmma into part of the N = 48 accumulator makes ptxas serialize
// the wgmma pipeline, warning C7511).

template <class G>
__device__ __forceinline__ void stage1(uint32_t sbase, uint8_t* smem, Tile tl, Bounds bd) {
  const int wg = threadIdx.x >> 7;
  const uint64_t db = desc(sbase + G::SM_W + W_S1, 128, 256);
  zero_tails<4, G::R1 * G::P1, G::PS1>(smem + G::SM_A);
  for (int mb = wg; mb < G::MB1; mb += NWG) {
    int acc[32];
    zero(acc);
    __syncwarp();
    wg_fence();
    mma_n64<0>(acc, at(desc(sbase + G::SM_B + mb * 64 * 16, 0, 128), 0, 3 * G::P1), db);
    wg_commit();
    wg_wait<0>();
    fence_regs(acc);
    store_stage<64, G::P1, G::R1, G::P1, G::PS1>(
        acc, mb * 64, smem + G::SM_A, reinterpret_cast<const int4*>(smem + G::SM_VEC),
        tl.ty0 - 4, tl.tx0 - 4, bd);
  }
}

template <class G>
__device__ __forceinline__ void stage2(uint32_t sbase, uint8_t* smem, Tile tl, Bounds bd) {
  const int wg = threadIdx.x >> 7;
  const uint64_t db = desc(sbase + G::SM_W, 128, 256);
  zero_tails<3, G::R2 * G::P2, G::PS2>(smem + G::SM_B);
  for (int mb = wg; mb < G::MB2; mb += NWG) {
    const uint64_t da = desc(sbase + G::SM_A + mb * 64 * 16, 0, 128);
    int acc[24], acc2[8];  // channels 0-47; C2_2's outer taps (32-47)
    zero(acc);
    zero(acc2);
    __syncwarp();
    wg_fence();
#pragma unroll
    for (int i = 0; i < 9; ++i) {  // centre taps: C2_1 ++ C2_2, channels 0-47
      const int s = (1 + i / 3) * G::P1 + 1 + i % 3;
#pragma unroll
      for (int c = 0; c < 2; ++c)
        mma_n48<0>(acc, at(da, 2 * c * G::PS1 + s, G::PS1), at(db, (W_S2C + (2 * i + c) * 1536) / 16, 0));
    }
#pragma unroll
    for (int i = 0; i < 16; ++i) {  // outer taps: C2_2, channels 32-47
      const int s = outer5(i) / 5 * G::P1 + outer5(i) % 5;
#pragma unroll
      for (int c = 0; c < 2; ++c)
        mma_n16<0>(acc2, at(da, 2 * c * G::PS1 + s, G::PS1), at(db, (W_S2O + (2 * i + c) * 512) / 16, 0));
    }
    wg_commit();
    wg_wait<0>();
    fence_regs(acc);
    fence_regs(acc2);
#pragma unroll
    for (int i = 0; i < 8; ++i) acc[16 + i] += acc2[i];
    store_stage<48, G::P1, G::R2, G::P2, G::PS2>(
        acc, mb * 64, smem + G::SM_B, reinterpret_cast<const int4*>(smem + G::SM_VEC) + 64,
        tl.ty0 - 2, tl.tx0 - 2, bd);
  }
}

template <class G>
__device__ __forceinline__ void stage3(uint32_t sbase, uint8_t* smem, Tile tl, Bounds bd) {
  const int wg = threadIdx.x >> 7;
  const uint64_t db = desc(sbase + G::SM_W, 128, 256);
  zero_tails<3, G::R3 * G::P3, G::PS3>(smem + G::SM_A);
  constexpr int SC = G::P2 + 1;  // centre tap
  for (int mb = wg; mb < G::MB3; mb += NWG) {
    const uint64_t da = desc(sbase + G::SM_B + mb * 64 * 16, 0, 128);
    int acc[24], acc1[8];  // channels 0-47; C3_1's other taps (0-15)
    zero(acc);
    zero(acc1);
    __syncwarp();
    wg_fence();
    // centre tap: C3_1 ++ C3_2, channels 0-47; planes 0+1, then 2 + zero half
    mma_n48<0>(acc, at(da, SC, G::PS2), at(db, W_S3C / 16, 0));
    mma_n48<0>(acc, at(da, 2 * G::PS2 + SC, 1), at(db, (W_S3C + 1536) / 16, 0));
#pragma unroll
    for (int i = 0; i < 8; ++i) {  // other taps: C3_1, channels 0-15
      const int s = other3(i) / 3 * G::P2 + other3(i) % 3;
      mma_n16<0>(acc1, at(da, s, G::PS2), at(db, (W_S3O + i * 512) / 16, 0));
    }
#pragma unroll
    for (int j = 0; j < 4; ++j) {  // plane 2 of taps 2j and 2j + 1
      const int sa = other3(2 * j) / 3 * G::P2 + other3(2 * j) % 3;
      const int sb = other3(2 * j + 1) / 3 * G::P2 + other3(2 * j + 1) % 3;
      mma_n16<0>(acc1, at(da, 2 * G::PS2 + sa, sb - sa), at(db, (W_S3O + (8 + j) * 512) / 16, 0));
    }
    wg_commit();
    wg_wait<0>();
    fence_regs(acc);
    fence_regs(acc1);
#pragma unroll
    for (int i = 0; i < 8; ++i) acc[i] += acc1[i];
    store_stage<48, G::P2, G::R3, G::P3, G::PS3>(
        acc, mb * 64, smem + G::SM_A, reinterpret_cast<const int4*>(smem + G::SM_VEC) + 112,
        tl.ty0 - 1, tl.tx0 - 1, bd);
  }
}

// S4 (48 -> 1), tap-major: each S3 position is read once, by two chunks
// against N = 16 columns of which column t holds tap t's weights, so
// acc[p, t] is tap t's share of the output at p - (dy_t * P3 + dx_t). The
// 9 shares go to shared memory and each output pixel sums its own; then
// the final residual requant and the residual add.
template <class G>
__device__ __forceinline__ void stage4(uint32_t sbase, uint8_t* smem, const uint8_t* xf,
                                       uint8_t* yf, int H, int W, Tile tl, int b4, int mul4,
                                       int shift4) {
  const int wg = threadIdx.x >> 7, t = threadIdx.x & 3;
  const uint64_t db = desc(sbase + G::SM_W, 128, 256);
  int* share = reinterpret_cast<int*>(smem + G::SM_B);
  for (int mb = wg; mb < G::MB4; mb += NWG) {
    const uint64_t da = desc(sbase + G::SM_A + mb * 64 * 16, 0, 128);
    int acc[8];
    zero(acc);
    __syncwarp();
    wg_fence();
    mma_n16<0>(acc, at(da, 0, G::PS3), at(db, W_S4 / 16, 0));
    mma_n16<0>(acc, at(da, 2 * G::PS3, 1), at(db, (W_S4 + 512) / 16, 0));
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
          if (tap < 9) share[tap * G::SHARE_STRIDE + p] = acc[4 * j + 2 * half + e];
        }
    }
  }
  __syncthreads();
  for (int o = threadIdx.x; o < G::TH * G::TW; o += NTHREADS) {
    const int r = o / G::TW, c = o - (o / G::TW) * G::TW;
    const int fr = tl.ty0 + r, fc = tl.tx0 + c;
    if (fr >= H || fc >= W) continue;
    const int* sh = share + r * G::P3 + c;
    int u = 0;
#pragma unroll
    for (int tap = 0; tap < 9; ++tap) u += sh[tap * G::SHARE_STRIDE + tap / 3 * G::P3 + tap % 3];
    const long long v = (long long)u + b4;
    const long long res = (v * mul4 + (1LL << (shift4 - 1))) >> shift4;
    const size_t i = size_t(fr) * W + fc;
    const long long rec = (long long)xf[i] + res;
    yf[i] = uint8_t(rec < 0 ? 0 : (rec > 255 ? 255 : rec));
  }
}

// A build truncated after stage K (1..3) writes, in place of S4, each
// output pixel's clamp(x + a, 0, 255), a = channel 0 of stage K's
// requantized, masked activation (0..127) at that pixel: byte 0 of plane 0
// of stage K's region (S1 and S3 in buffer A, S2 in B), whose origin lies
// 4, 2 or 1 positions before the tile's first output, on its own pitch.
template <class G, int K>
__device__ __forceinline__ void emit_stage(const uint8_t* smem, const uint8_t* xf, uint8_t* yf,
                                           int H, int W, Tile tl) {
  static_assert(K >= 1 && K <= 3, "stages 1..3");
  constexpr int OFF = K == 1 ? 4 : (K == 2 ? 2 : 1);
  constexpr int P = K == 1 ? G::P1 : (K == 2 ? G::P2 : G::P3);
  const uint8_t* act = smem + (K == 2 ? G::SM_B : G::SM_A);
  for (int o = threadIdx.x; o < G::TH * G::TW; o += NTHREADS) {
    const int r = o / G::TW, c = o - (o / G::TW) * G::TW;
    const int fr = tl.ty0 + r, fc = tl.tx0 + c;
    if (fr >= H || fc >= W) continue;
    const size_t i = size_t(fr) * W + fc;
    const int rec = int(xf[i]) + int(act[((r + OFF) * P + c + OFF) * 16]);
    yf[i] = uint8_t(rec > 255 ? 255 : rec);
  }
}

// The window of a tile, x - 128 inside the frame bounds and 0 outside,
// loaded into registers (issued early, stored to shared memory later).
// ZERO (the `zero_a1` diagnostic) reads no pixel: x - 128 = 0 everywhere.
template <class G, bool ZERO>
__device__ __forceinline__ void load_window(uint32_t (&pre)[G::RAW_PER_THREAD], const uint8_t* x,
                                            int H, int W, Tile tl, Bounds bd) {
  const uint8_t* xf = x + size_t(tl.f) * H * W;
#pragma unroll
  for (int k = 0; k < G::RAW_PER_THREAD; ++k) {
    const int i = threadIdx.x + k * NTHREADS;
    const int r = tl.ty0 - G::HALO + i / G::P0, c = tl.tx0 - G::HALO + i % G::P0;
    pre[k] = (!ZERO && i < G::RAW && bd.inside(r, c)) ? uint32_t(xf[size_t(r) * W + c]) : 128u;
  }
}

// STAGES < 4: truncated after that stage (emit_stage); ZERO_A1: the window
// unread (load_window). The main path's instances are <G, 4, false>.
template <class G, int STAGES, bool ZERO_A1>
__global__ void __launch_bounds__(NTHREADS, 1)
qvrcnn_fused_kernel(const uint8_t* __restrict__ x, uint8_t* __restrict__ y,
                    const int8_t* __restrict__ wsplit, const int* __restrict__ vec_g,
                    int nframes, int H, int W, Bounds bd, int b4, int mul4, int shift4) {
  extern __shared__ __align__(128) uint8_t smem[];
  const uint32_t sbase = smem_addr(smem);
  for (int i = threadIdx.x; i < W_BYTES / 16; i += NTHREADS)
    cp_async16(sbase + G::SM_W + i * 16, wsplit + i * 16);
  int* vec = reinterpret_cast<int*>(smem + G::SM_VEC);
  for (int i = threadIdx.x; i < VEC_LEN; i += NTHREADS) {  // [stage][row][C] -> [ch][row]
    const int row_start = i < 256 ? 0 : (i < 448 ? 256 : 448);
    const int cout = i < 256 ? 64 : 48, ch0 = i < 256 ? 0 : (i < 448 ? 64 : 112);
    const int row = (i - row_start) / cout, ch = ch0 + (i - row_start) % cout;
    vec[4 * ch + row] = vec_g[i];
  }

  const int tiles_x = cdiv(W, G::TW), per_frame = cdiv(H, G::TH) * tiles_x;
  const int total = nframes * per_frame;
  uint32_t pre[G::RAW_PER_THREAD];
  int tile = blockIdx.x;
  load_window<G, ZERO_A1>(pre, x, H, W, tile_at<G>(tile, tiles_x, per_frame), bd);
  cp_async_wait_all();
  fence_async_smem();
  __syncthreads();

  int8_t* raw = reinterpret_cast<int8_t*>(smem + G::SM_RAW);
  for (; tile < total; tile += gridDim.x) {
    const Tile tl = tile_at<G>(tile, tiles_x, per_frame);
#pragma unroll
    for (int k = 0; k < G::RAW_PER_THREAD; ++k) {
      const int i = threadIdx.x + k * NTHREADS;
      if (i < G::RAW) raw[i] = int8_t(int(pre[k]) - 128);
    }
    __syncthreads();
    if (tile + int(gridDim.x) < total)
      load_window<G, ZERO_A1>(pre, x, H, W, tile_at<G>(tile + gridDim.x, tiles_x, per_frame),
                                bd);
    // expanded window on S1's pitch: position (r, c) holds window (r + i, c + j)
    // as byte 5i + j
    for (int e = threadIdx.x; e < G::EXP; e += NTHREADS) {
      uint32_t w[4] = {0, 0, 0, 0};
#pragma unroll
      for (int j = 0; j < 15; ++j) {
        const int idx = (e / G::P1 + j / 5) * G::P0 + e % G::P1 + j % 5;
        const uint32_t b = idx < G::RAW ? uint32_t(uint8_t(raw[idx])) : 0u;
        w[j >> 2] |= b << (8 * (j & 3));
      }
      *reinterpret_cast<uint4*>(smem + G::SM_B + e * 16) = make_uint4(w[0], w[1], w[2], w[3]);
    }
    fence_async_smem();
    __syncthreads();
    const size_t frame = size_t(tl.f) * H * W;
    stage1<G>(sbase, smem, tl, bd);
    fence_async_smem();
    __syncthreads();
    if constexpr (STAGES == 1) {
      emit_stage<G, 1>(smem, x + frame, y + frame, H, W, tl);
      continue;
    }
    stage2<G>(sbase, smem, tl, bd);
    fence_async_smem();
    __syncthreads();
    if constexpr (STAGES == 2) {
      emit_stage<G, 2>(smem, x + frame, y + frame, H, W, tl);
      continue;
    }
    stage3<G>(sbase, smem, tl, bd);
    fence_async_smem();
    __syncthreads();
    if constexpr (STAGES == 3) {
      emit_stage<G, 3>(smem, x + frame, y + frame, H, W, tl);
      continue;
    }
    stage4<G>(sbase, smem, x + frame, y + frame, H, W, tl, b4, mul4, shift4);
  }
}

// Launch instance G on `stream`: one block per SM (at most one per tile);
// the dynamic shared-memory attribute is set once per device.
template <class G, int STAGES = 4, bool ZERO_A1 = false>
int launch(const void* x, void* y, const void* wsplit, const void* vec, int B, int H, int W,
           Bounds bd, int b4, int mul4, int shift4, void* stream) {
  static int sm_count[split::MAX_DEVICES] = {};  // 0 until the device's first launch
  int sms = 0;
  const auto kernel = qvrcnn_fused_kernel<G, STAGES, ZERO_A1>;
  const int err = split::prepare(kernel, G::SMEM_BYTES, sm_count, sms);
  if (err != 0) return err;
  const int total = B * cdiv(H, G::TH) * cdiv(W, G::TW);
  const int grid = total < sms ? total : sms;
  kernel<<<grid, NTHREADS, G::SMEM_BYTES, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint8_t*>(x), static_cast<uint8_t*>(y),
      static_cast<const int8_t*>(wsplit), static_cast<const int*>(vec), B, H, W, bd, b4, mul4,
      shift4);
  return int(cudaGetLastError());
}

}  // namespace

extern "C" {

#ifndef QVRCNN_DIAG_TH
// Launch the th x tw instance (one of QVRCNN_TILES) on `stream` (a
// cudaStream_t) on the current device. Returns the cudaError_t of the
// device query, of the one-time attribute call for this device and
// instance, or of the launch (cudaGetLastError); cudaErrorInvalidValue for
// a tile that is not compiled; 0 on success.
int qvrcnn_fused_forward(const void* x, void* y, const void* wsplit, const void* vec, int B,
                         int H, int W, int row_lo, int row_hi, int col_lo, int col_hi, int b4,
                         int mul4, int shift4, int th, int tw, void* stream) {
  const Bounds bd{row_lo > 0 ? row_lo : 0, row_hi < H ? row_hi : H,
                  col_lo > 0 ? col_lo : 0, col_hi < W ? col_hi : W};
#define QVRCNN_LAUNCH(TH, TW)                                                                  \
  if (th == TH && tw == TW)                                                                    \
    return launch<Geo3<TH, TW>>(x, y, wsplit, vec, B, H, W, bd, b4, mul4, shift4, stream);
  QVRCNN_TILES(QVRCNN_LAUNCH)
#undef QVRCNN_LAUNCH
  return int(cudaErrorInvalidValue);
}
#else
#define QVRCNN_IS_DIAG_TILE(TH, TW) || (TH == QVRCNN_DIAG_TH && TW == QVRCNN_DIAG_TW)
static_assert(false QVRCNN_TILES(QVRCNN_IS_DIAG_TILE), "the diagnostic tile is one of QVRCNN_TILES");
#undef QVRCNN_IS_DIAG_TILE

// The diagnostic library's one entry: launch the variant (stages,
// zero_a1) of QVRCNN_STAGE_VARIANTS at the tile this library was built
// for, as qvrcnn_fused_forward launches the full network (same arguments
// and errors; cudaErrorInvalidValue for another tile or variant).
int qvrcnn_fused_stages(const void* x, void* y, const void* wsplit, const void* vec, int B,
                        int H, int W, int row_lo, int row_hi, int col_lo, int col_hi, int b4,
                        int mul4, int shift4, int th, int tw, int stages, int zero_a1,
                        void* stream) {
  using G = Geo3<QVRCNN_DIAG_TH, QVRCNN_DIAG_TW>;
  if (th != G::TH || tw != G::TW) return int(cudaErrorInvalidValue);
  const Bounds bd{row_lo > 0 ? row_lo : 0, row_hi < H ? row_hi : H,
                  col_lo > 0 ? col_lo : 0, col_hi < W ? col_hi : W};
#define QVRCNN_LAUNCH(S, Z)                                                                    \
  if (stages == S && (zero_a1 != 0) == Z)                                                      \
    return launch<G, S, Z>(x, y, wsplit, vec, B, H, W, bd, b4, mul4, shift4, stream);
  QVRCNN_STAGE_VARIANTS(QVRCNN_LAUNCH)
#undef QVRCNN_LAUNCH
  return int(cudaErrorInvalidValue);
}
#endif

const char* qvrcnn_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

// Dynamic shared memory of the th x tw instance's blocks; 0 for a tile
// that is not compiled.
int qvrcnn_smem_bytes(int th, int tw) {
#define QVRCNN_SMEM(TH, TW) \
  if (th == TH && tw == TW) return Geo3<TH, TW>::SMEM_BYTES;
  QVRCNN_TILES(QVRCNN_SMEM)
#undef QVRCNN_SMEM
  return 0;
}

}  // extern "C"
