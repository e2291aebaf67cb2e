// Literal-requant QVRCNN INT8 residual kernel for Hopper (sm_90a),
// generation 1.
//
// Replaces the Pallas TPU kernel `_make_kernel`
// (qcnn_gpu_tpu/ops/pallas_pipeline.py:179), built by
// `build_pallas_forward` (:267). It computes what that kernel computes:
// the network on uint8 frames with the LITERAL BLU requant chain after
// S1-S3 (`_requant_vec`, :117-119)
//
//   u = acc + b;  v = u > blu_q ? 127 : u < 0 ? 0 : ((u + bias_pre) * mul) >> shift
//
// and S4's final requant res = (u4 * mul4 + 2^(shift4-1)) >> shift4, emitted
// as an int16 residual clamped to +-255 (:239-242). The residual add runs
// outside, as the TPU version leaves it to XLA (:344-347).
//
// Why a second kernel beside generation 3: the folded epilogue of
// qvrcnn_fused.cu equals this chain only for tables whose BLU bound
// requantizes to exactly 127 (the solver's saturation window); this kernel
// is exact for every table the engine accepts. Outside the window a kept
// value can exceed 127, so activations are stored as uint8 (0..255) and
// S2-S4 multiply them as unsigned bytes (`wgmma ... .s32.u8.s8`); the TPU
// kernel keeps them in bf16 for the same reason.
//
// Under a mesh, each halo-extended block runs under its frame bounds
// (row_lo..col_hi, as generation 3's): the window reads x - 128 inside
// them and 0 outside, and every stage's activations are 0 outside them.
// The whole frame is (0, H, 0, W), what the TPU kernel computes.
//
// What bounds it on the H100: tensor-core work, as for generation 3 (the
// same 56,320 MACs issued per computed position, 0.114 ms per 1080p frame
// at the int8 peak), in practice the `wgmma` issue (~20 cycles per small-N
// instruction, tools/wgmma_rate) beside the integer epilogue. The design
// is generation 3's (qvrcnn_split.cuh): split branch GEMMs on `wgmma` from
// shared memory, the weight image resident, a persistent grid of 512-thread
// blocks over 24x40 tiles. The literal epilogue costs more than the folded
// one: two compares, a select and a 64-bit multiply and shift per
// activation, five vector rows per channel (two int4: 5,120 B of shared
// memory where the folded epilogue needs 2,560), and no DPX clip.

#include <cuda_runtime.h>
#include <stdint.h>

#include "qvrcnn_split.cuh"

namespace {

using Geo = split::Geometry<24, 40>;  // ops/fused.layout(24, 40)
using Lit = split::Cfg<Geo, split::Literal, true, 1, true>;

static_assert(Geo::BYTES == 160096, "ops/fused.layout(24, 40).bytes");
static_assert(Lit::SMEM_BYTES == 221536, "weights, 2 int4 vectors a channel, buffers");

}  // namespace

extern "C" {

// Launch on `stream` (a cudaStream_t) on the current device, under the
// frame bounds (clipped to the frame). Returns split::launch's
// cudaError_t; 0 on success.
int qvrcnn_literal_residual(const void* x, void* res, const void* wsplit, const void* vec,
                            int B, int H, int W, int row_lo, int row_hi, int col_lo, int col_hi,
                            int b4, int mul4, int shift4, void* stream) {
  return split::launch<Lit>(x, res, wsplit, vec, B, H, W,
                            split::Bounds::clipped(row_lo, row_hi, col_lo, col_hi, H, W), b4,
                            mul4, shift4, stream);
}

const char* qvrcnn_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

int qvrcnn_smem_bytes() { return Lit::SMEM_BYTES; }

}  // extern "C"
