// Literal-requant QVRCNN INT8 residual kernel for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel `_make_kernel`
// (qcnn_gpu_tpu/ops/pallas_pipeline.py:179), built by
// `build_pallas_forward` (:267). It computes what that kernel computes:
// the branch-merged network on uint8 frames with the LITERAL BLU requant
// chain after S1-S3 (`_requant_vec`, :117-119)
//
//   u = acc + b;  v = u > blu_q ? 127 : u < 0 ? 0 : ((u + bias_pre) * mul) >> shift
//
// and S4's final requant res = (u4 * mul4 + 2^(shift4-1)) >> shift4, emitted
// as an int16 residual clamped to +-255 (:239-242). The residual add runs
// outside, as the TPU version leaves it to XLA (:344-347).
//
// Why a second kernel: the folded epilogue of qvrcnn_fused.cu equals this
// chain only for tables whose BLU bound requantizes to exactly 127 (the
// solver's saturation window); this kernel is exact for every table the
// engine accepts. Outside the window a kept value can exceed 127, so
// activations are stored as uint8 (0..255) and S2-S4 multiply them as
// unsigned bytes (`mma.sync.m16n8k32.s32.u8.s8.s32`); the TPU kernel keeps
// them in bf16 for the same reason. The epilogue selects before it
// multiplies, in 64 bits (signed overflow is undefined in C++, while the
// TPU's int32 product of a discarded lane just wraps).
//
// Design: the one-frame tile of qvrcnn_fused.cu (one block of 8 warps per
// (frame, 16x16 tile), activations in shared memory, stage GEMMs from
// qvrcnn_stage.cuh) with the literal epilogue and five per-channel rows
// [b | blu_q | mul | bias_pre | shift] per stage (3,200 B). Bound on the
// H100: tensor-core issue, as for the fused kernel; the literal epilogue
// adds two compares and a 64-bit multiply per activation.

#include <cuda_runtime.h>
#include <stdint.h>

#include "qvrcnn_stage.cuh"

namespace {

using namespace qvrcnn;

constexpr int VEC_LEN = LiteralEpilogue::ROWS * (C1 + C2 + C3);  // 800
constexpr int SMEM_VEC = 0;
constexpr int SMEM_ACT = SMEM_VEC + VEC_LEN * 4;  // 3200
constexpr int SMEM_BYTES = SMEM_ACT + ACT_BYTES;  // 84,816

__global__ void __launch_bounds__(NTHREADS, 2)
qvrcnn_literal_kernel(const uint8_t* __restrict__ x, int16_t* __restrict__ res_out,
                      const int8_t* __restrict__ w1, const int8_t* __restrict__ w2,
                      const int8_t* __restrict__ w3, const int8_t* __restrict__ w4,
                      const int* __restrict__ vec_g, int H, int W, int b4, int mul4,
                      int shift4) {
  extern __shared__ __align__(16) unsigned char smem[];
  int* vec = reinterpret_cast<int*>(smem + SMEM_VEC);
  int8_t* act = reinterpret_cast<int8_t*>(smem + SMEM_ACT);
  const Bounds bd{0, H, 0, W};

  const int tx0 = blockIdx.x * T, ty0 = blockIdx.y * T;
  const size_t frame = size_t(blockIdx.z) * H * W;
  const uint8_t* const xf[1] = {x + frame};

  load_inputs<1>(vec, vec_g, VEC_LEN, act, xf, W, ty0, tx0, bd);
  __syncthreads();
  stages_123<LiteralEpilogue, 1, true>(act, w1, w2, w3, vec, ty0, tx0, bd);

  // S4 (48 -> 1, N padded to 8) on uint8 activations + final requant
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int g = lane >> 2, t = lane & 3;
  int16_t* rf = res_out + frame;
  for (int mt = warp; mt < T * T / 16; mt += NWARPS) {
    int acc[1][1][4];
    mma_tile<1, true, C3, 3, R3, S3_STRIDE, T, 1>(act + ACT_S3, w4, mt, acc);
    if (t != 0) continue;  // output channel 0 lives in lanes with t == 0
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int m = mt * 16 + g + 8 * half;
      const int r = ty0 + m / T, c = tx0 + m % T;
      if (r >= H || c >= W) continue;
      const long long u = (long long)acc[0][0][2 * half] + b4;
      const long long res = (u * mul4 + (1LL << (shift4 - 1))) >> shift4;
      rf[size_t(r) * W + c] = int16_t(res < -255 ? -255 : (res > 255 ? 255 : res));
    }
  }
}

}  // namespace

extern "C" {

// Launch on `stream` (a cudaStream_t) on the current device. Returns the
// cudaError_t of the one-time shared-memory attribute call or of the
// launch; 0 on success.
int qvrcnn_literal_residual(const void* x, void* res, const void* w1, const void* w2,
                            const void* w3, const void* w4, const void* vec, int B, int H,
                            int W, int b4, int mul4, int shift4, void* stream) {
  static bool smem_set[MAX_DEVICES] = {};
  const int err = set_smem_once(qvrcnn_literal_kernel, SMEM_BYTES, smem_set);
  if (err != 0) return err;
  dim3 grid((W + T - 1) / T, (H + T - 1) / T, B);
  qvrcnn_literal_kernel<<<grid, NTHREADS, SMEM_BYTES, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint8_t*>(x), static_cast<int16_t*>(res),
      static_cast<const int8_t*>(w1), static_cast<const int8_t*>(w2),
      static_cast<const int8_t*>(w3), static_cast<const int8_t*>(w4),
      static_cast<const int*>(vec), H, W, b4, mul4, shift4);
  return int(cudaGetLastError());
}

const char* qvrcnn_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

int qvrcnn_smem_bytes() { return SMEM_BYTES; }

}  // extern "C"
