// Fused whole-network QVRCNN INT8 restore kernel for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel `_make_kernel3` / `_kernel3_body`
// (qcnn_gpu_tpu/ops/pallas_pipeline3.py:271, :319), built by
// `build_pallas_forward3`. It computes what that kernel computes — the
// integer contract of qcnn_gpu_tpu/models/oracle.py:8-31 on the
// branch-merged network, bit for bit:
//
//   x' = x_u8 - 128                       (0 outside the frame bounds)
//   S1 5x5  1->64 | S2 5x5 64->48 | S3 3x3 48->48   each: int8 x int8 ->
//      int32, folded BLU requant min((clip(u + b', 0, B) * mul) >> shift,
//      127), then every position outside the frame bounds set to 0
//      (per-layer SAME padding at the frame edge)
//   S4 3x3 48->1, res = (u * mul4 + 2^(shift4-1)) >> shift4 (floor),
//   out = clamp(x_u8 + res, 0, 255)
//
// It does not copy the TPU kernel's layout: no width-2 pixel packing, no
// six-plane S1 operand, no mask atlas, no band split — those exist to feed
// a 128x128 MXU out of VMEM.
//
// Design. One thread block (8 warps) per (frame, 16x16 output tile). The
// block reads the uint8 frame directly with a 6-px halo (the network's
// receptive radius) and keeps every activation in shared memory as int8:
// S1 on 24x24x64, S2 on 20x20x48, S3 on 18x18x48 (84 KB in all, two
// blocks per SM). Each stage is an implicit GEMM on the tensor cores with
// `mma.sync.m16n8k32.s8.s8.s32`: M = the stage's output positions, N = its
// output channels, K = taps x input channels. A fragments are 32-bit
// shared-memory loads of 4 consecutive channels (S1 gathers its 4 taps
// byte by byte); B fragments come pre-arranged in fragment order from
// device memory (ops/fused.py packs them), one 8-byte load per lane. The
// stage GEMMs live in qvrcnn_stage.cuh, shared with the pair and literal
// kernels.
//
// What bounds it on the H100. The network is 54,512 useful MACs/px; the
// merged stages run 99,568 (C2_1's 3x3 and C3_2's 1x1 taps zero-padded
// into S2's 5x5 and S3's 3x3), and the 6-px halo around a 16x16 tile
// recomputes S1-S3 on 1.5x the output area (S2 alone 120k MACs per output
// pixel): about 2.9x the useful work issued. So the kernel is bound by
// tensor-core issue and by the shared-memory and L1 bandwidth that feed
// `mma.sync` (4 A-words per k-chunk and one B load per n-tile), not by
// device memory: it reads 1 byte and writes 1 byte per pixel. The design
// keeps all intermediates on chip (no device-memory traffic between
// stages) and pads S1's position stride to 80 bytes so that the A loads
// of one warp hit 32 distinct banks. Separate GEMMs for the merged
// branches (no zero taps), larger tiles (less halo), wgmma with TMA-fed
// operands and an interior/edge split are the next steps.

#include <cuda_runtime.h>
#include <stdint.h>

#include "qvrcnn_stage.cuh"

namespace {

using namespace qvrcnn;

// per-channel epilogue vectors, int32: for each of S1..S3 the four rows
// [b' | B | mul | shift] of C entries (ops/fused.FusedWeights.vec)
constexpr int VEC_LEN = FoldedEpilogue::ROWS * (C1 + C2 + C3);
constexpr int SMEM_VEC = 0;
constexpr int SMEM_ACT = SMEM_VEC + VEC_LEN * 4;    // 2560
constexpr int SMEM_BYTES = SMEM_ACT + ACT_BYTES;    // 84,176

__global__ void __launch_bounds__(NTHREADS, 2)
qvrcnn_fused_kernel(const uint8_t* __restrict__ x, uint8_t* __restrict__ y,
                    const int8_t* __restrict__ w1, const int8_t* __restrict__ w2,
                    const int8_t* __restrict__ w3, const int8_t* __restrict__ w4,
                    const int* __restrict__ vec_g, int H, int W, Bounds bd,
                    int b4, int mul4, int shift4) {
  extern __shared__ __align__(16) unsigned char smem[];
  int* vec = reinterpret_cast<int*>(smem + SMEM_VEC);
  int8_t* act = reinterpret_cast<int8_t*>(smem + SMEM_ACT);
  int8_t* s3 = act + ACT_S3;

  const int tx0 = blockIdx.x * T, ty0 = blockIdx.y * T;
  const size_t frame = size_t(blockIdx.z) * H * W;
  const uint8_t* const xf[1] = {x + frame};

  load_inputs<1>(vec, vec_g, VEC_LEN, act, xf, W, ty0, tx0, bd);
  __syncthreads();
  stages_123<FoldedEpilogue, 1, false>(act, w1, w2, w3, vec, ty0, tx0, bd);

  // S4 (48 -> 1, N padded to 8) + final residual requant + residual add
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int g = lane >> 2, t = lane & 3;
  uint8_t* yf = y + frame;
  for (int mt = warp; mt < T * T / 16; mt += NWARPS) {
    int acc[1][1][4];
    mma_tile<1, false, C3, 3, R3, S3_STRIDE, T, 1>(s3, w4, mt, acc);
    if (t != 0) continue;  // output channel 0 lives in lanes with t == 0
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int m = mt * 16 + g + 8 * half;
      const int r = ty0 + m / T, c = tx0 + m % T;
      if (r >= H || c >= W) continue;
      const long long u = (long long)acc[0][0][2 * half] + b4;
      const long long res = (u * mul4 + (1LL << (shift4 - 1))) >> shift4;
      const long long rec = (long long)xf[0][size_t(r) * W + c] + res;
      yf[size_t(r) * W + c] = uint8_t(rec < 0 ? 0 : (rec > 255 ? 255 : rec));
    }
  }
}

}  // namespace

extern "C" {

// Launch on `stream` (a cudaStream_t) on the current device. Returns the
// cudaError_t of the device query, of the one-time shared-memory attribute
// call for this device, or of the launch (cudaGetLastError); 0 on success.
int qvrcnn_fused_forward(const void* x, void* y, const void* w1,
                         const void* w2, const void* w3, const void* w4,
                         const void* vec, int B, int H, int W, int row_lo,
                         int row_hi, int col_lo, int col_hi, int b4, int mul4,
                         int shift4, void* stream) {
  static bool smem_set[MAX_DEVICES] = {};
  const int err = set_smem_once(qvrcnn_fused_kernel, SMEM_BYTES, smem_set);
  if (err != 0) return err;
  Bounds bd{row_lo > 0 ? row_lo : 0, row_hi < H ? row_hi : H,
            col_lo > 0 ? col_lo : 0, col_hi < W ? col_hi : W};
  dim3 grid((W + T - 1) / T, (H + T - 1) / T, B);
  qvrcnn_fused_kernel<<<grid, NTHREADS, SMEM_BYTES,
                        static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint8_t*>(x), static_cast<uint8_t*>(y),
      static_cast<const int8_t*>(w1), static_cast<const int8_t*>(w2),
      static_cast<const int8_t*>(w3), static_cast<const int8_t*>(w4),
      static_cast<const int*>(vec), H, W, bd, b4, mul4, shift4);
  return int(cudaGetLastError());
}

const char* qvrcnn_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

int qvrcnn_smem_bytes() { return SMEM_BYTES; }

}  // extern "C"
