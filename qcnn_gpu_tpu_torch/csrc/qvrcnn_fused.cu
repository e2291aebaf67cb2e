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
// The design is the template csrc/qvrcnn_split.cuh, which generations 2
// and 1 instantiate too: this file holds generation 3's instances (the
// folded epilogue, signed activations, one frame per work item, restored
// uint8 frames out) at each tile of QVRCNN_TILES, its diagnostic variants,
// and their C entries. The frame bounds (row_lo..col_hi, the JAX kernel's
// row_bounds/col_bounds) are what a block of a mesh passes.
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

// Generation 3 at a TH x TW tile (a diagnostic variant with STAGES < 4 or
// ZERO_A1). Shared memory: the weight image, one int4 (b', B, mul, shift)
// per channel, then the tile's buffers: the raw window, A (S1, then S3)
// and B (the expanded window, then S2, then S4's int32 shares).
template <int TH, int TW, int STAGES = 4, bool ZERO_A1 = false>
using Gen3 = split::Cfg<split::Geometry<TH, TW>, split::Folded, false, 1, false, STAGES, ZERO_A1>;

// Each compiled instance's regions as ops/fused.layout(th, tw) gives them
// (tests/test_torch_fused_split.py holds these numbers against it): the
// blocks of S1..S4, S1's expanded positions, the planes of S1..S3, the
// tile's buffers (raw window, A, B) and the block's shared memory.
template <int TH, int TW>
constexpr bool regions(int mb1, int mb2, int mb3, int mb4, int exp, int ps1, int ps2, int ps3,
                       int bytes, int smem) {
  using G = split::Geometry<TH, TW>;
  return G::MB1 == mb1 && G::MB2 == mb2 && G::MB3 == mb3 && G::MB4 == mb4 && G::EXP == exp &&
         G::PS1 == ps1 && G::PS2 == ps2 && G::PS3 == ps3 && G::BYTES == bytes &&
         Gen3<TH, TW>::SMEM_BYTES == smem;
}
static_assert(regions<24, 40>(24, 21, 18, 18, 1680, 1540, 1243, 1153, 160096, 218976), "");
static_assert(regions<24, 32>(20, 18, 15, 14, 1400, 1316, 1035, 897, 135488, 194368), "");
static_assert(regions<32, 32>(25, 23, 20, 19, 1720, 1636, 1355, 1217, 171680, 230560), "");

}  // namespace

extern "C" {

#ifndef QVRCNN_DIAG_TH
// Launch the th x tw instance (one of QVRCNN_TILES) on `stream` (a
// cudaStream_t) on the current device, under the frame bounds (clipped to
// the frame). Returns split::launch's cudaError_t; cudaErrorInvalidValue
// for a tile that is not compiled; 0 on success.
int qvrcnn_fused_forward(const void* x, void* y, const void* wsplit, const void* vec, int B,
                         int H, int W, int row_lo, int row_hi, int col_lo, int col_hi, int b4,
                         int mul4, int shift4, int th, int tw, void* stream) {
  const auto bd = split::Bounds::clipped(row_lo, row_hi, col_lo, col_hi, H, W);
#define QVRCNN_LAUNCH(TH, TW)                                                                   \
  if (th == TH && tw == TW)                                                                     \
    return split::launch<Gen3<TH, TW>>(x, y, wsplit, vec, B, H, W, bd, b4, mul4, shift4, stream);
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
  if (th != QVRCNN_DIAG_TH || tw != QVRCNN_DIAG_TW) return int(cudaErrorInvalidValue);
  const auto bd = split::Bounds::clipped(row_lo, row_hi, col_lo, col_hi, H, W);
#define QVRCNN_LAUNCH(S, Z)                                                                     \
  if (stages == S && (zero_a1 != 0) == Z)                                                       \
    return split::launch<Gen3<QVRCNN_DIAG_TH, QVRCNN_DIAG_TW, S, Z>>(                           \
        x, y, wsplit, vec, B, H, W, bd, b4, mul4, shift4, stream);
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
  if (th == TH && tw == TW) return Gen3<TH, TW>::SMEM_BYTES;
  QVRCNN_TILES(QVRCNN_SMEM)
#undef QVRCNN_SMEM
  return 0;
}

}  // extern "C"
