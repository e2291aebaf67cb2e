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

__global__ void __launch_bounds__(split::NTHREADS, 1)
qvrcnn_pair_kernel(const uint8_t* __restrict__ x, uint8_t* __restrict__ y,
                   const int8_t* __restrict__ wsplit, const int* __restrict__ vec, int B, int H,
                   int W, int b4, int mul4, int shift4) {
  extern __shared__ __align__(128) uint8_t smem[];
  split::run<Pair>(smem, x, y, wsplit, vec, B, H, W, b4, mul4, shift4);
}

int sm_count[split::MAX_DEVICES] = {};  // 0 until the device's first launch

}  // namespace

extern "C" {

// Launch on `stream` (a cudaStream_t) on the current device: one block per
// SM (at most one per work item). Returns the cudaError_t of the device
// query, of the one-time attribute call for this device, or of the launch
// (cudaGetLastError); 0 on success.
int qvrcnn_pair_forward(const void* x, void* y, const void* wsplit, const void* vec, int B,
                        int H, int W, int b4, int mul4, int shift4, void* stream) {
  int sms = 0;
  const int err = split::prepare(qvrcnn_pair_kernel, Pair::SMEM_BYTES, sm_count, sms);
  if (err != 0) return err;
  const int total = (B + 1) / 2 * split::cdiv(H, Geo::TH) * split::cdiv(W, Geo::TW);
  const int grid = total < sms ? total : sms;
  qvrcnn_pair_kernel<<<grid, split::NTHREADS, Pair::SMEM_BYTES,
                       static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint8_t*>(x), static_cast<uint8_t*>(y),
      static_cast<const int8_t*>(wsplit), static_cast<const int*>(vec), B, H, W, b4, mul4,
      shift4);
  return int(cudaGetLastError());
}

const char* qvrcnn_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

int qvrcnn_smem_bytes() { return Pair::SMEM_BYTES; }

}  // extern "C"
