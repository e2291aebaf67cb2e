// Frame-pair QVRCNN INT8 restore kernel for Hopper (sm_90a), generation 2.
//
// Replaces the Pallas TPU kernel `_make_kernel2`
// (qcnn_gpu_tpu/ops/pallas_pipeline2.py:165), built by
// `build_pallas_forward2` (:251). It computes the same function as
// qvrcnn_fused.cu — the whole network with the folded BLU epilogue and the
// residual add, uint8 frames in and out, bit for bit the integer contract
// of qcnn_gpu_tpu/models/oracle.py — on frame pairs. An odd batch's last
// frame runs alone (the TPU pads a zero frame; the output is the same).
//
// Why the TPU paired frames: one weight pass of the 128x128 MXU serves two
// frames (pallas_pipeline2.py:1-17). On Hopper the resident weight image of
// generation 3's design (qvrcnn_split.cuh) already serves every tile a
// block computes, and the A operand, which is what a small-N `wgmma` costs
// (~18-20 cycles whatever N, tools/wgmma_rate), differs per frame. What a
// pair could still buy is overlap of one frame's integer epilogue with the
// other's `wgmma`. What bounds it: as generation 3, the `wgmma` issue
// beside an integer epilogue that 4 warpgroups on one tile overlap with it
// only in part.
//
// The schedule: a work item is the same 24x40 tile of the pair's two
// frames; a persistent block computes the tile of frame a, then of frame
// b, through the same buffers, as generation 3 computes consecutive tiles.
// It runs as fast as generation 3. Two tiles' buffers beside the weights
// fit only at a smaller tile (ops/fused.layout: 160,096 B at 24x40), so a
// ping-pong of two warpgroup pairs, one stage apart on the two frames'
// 16x24 tiles, was measured against it: about 2% of overlap, less than
// the 1.18x `wgmma` work per pixel its halo costs, so it lost (PERF.md).

#include <cuda_runtime.h>
#include <stdint.h>

#include "qvrcnn_split.cuh"

namespace {

using Geo = split::Geometry<24, 40>;  // ops/fused.layout(24, 40)
using Pair = split::Cfg<Geo, split::Folded, false, 2, false>;

static_assert(Geo::BYTES == 160096, "ops/fused.layout(24, 40).bytes");
static_assert(Pair::SMEM_BYTES == 218976, "weights, vectors, 24x40 buffers");

}  // namespace

extern "C" {

// Launch on `stream` (a cudaStream_t) on the current device, over whole
// frames (no frame bounds: under a mesh the port runs generations 3 and 1
// only, as the JAX package runs v3 only). Returns split::launch's
// cudaError_t; 0 on success.
int qvrcnn_pair_forward(const void* x, void* y, const void* wsplit, const void* vec, int B,
                        int H, int W, int b4, int mul4, int shift4, void* stream) {
  return split::launch<Pair>(x, y, wsplit, vec, B, H, W, split::Bounds{0, H, 0, W}, b4, mul4,
                             shift4, stream);
}

const char* qvrcnn_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

int qvrcnn_smem_bytes() { return Pair::SMEM_BYTES; }

}  // extern "C"
