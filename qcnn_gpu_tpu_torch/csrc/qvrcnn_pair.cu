// Frame-pair QVRCNN INT8 restore kernel for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel `_make_kernel2`
// (qcnn_gpu_tpu/ops/pallas_pipeline2.py:165), built by
// `build_pallas_forward2` (:251). It computes the same function as
// qvrcnn_fused.cu — the whole branch-merged network with the folded BLU
// epilogue and the residual add, uint8 frames in and out, bit for bit the
// integer contract of qcnn_gpu_tpu/models/oracle.py — on frame pairs.
//
// What the TPU kernel is for: it packs two frames block-diagonally along K
// so that one weight pass of the 128x128 MXU serves both frames
// (pallas_pipeline2.py:1-17, :47-54). The Hopper counterpart of "one
// weight pass for two frames" is one B-fragment load for two frames: one
// block per (frame pair, 16x16 tile) holds both frames' windows and
// activations in shared memory, and every B fragment of every k-chunk
// feeds the `mma.sync` of both frames (qvrcnn_stage.cuh, NF = 2), halving
// the weight-fragment loads per output pixel. An odd batch's last block
// has no second frame and runs the one-frame path (the TPU pads a zero
// frame; the output is the same).
//
// What bounds it on the H100: the same tensor-core issue as the one-frame
// kernel (identical MMA count per frame), now with half the B loads from
// L1/L2. The cost: two frames' activation regions (2 x 81,616 B) plus the
// 2,560 B of vectors take 165,792 B of shared memory, so one block fits on
// an SM where the one-frame kernel fits two; fewer warps are in flight to
// hide the latency of the shared-memory A loads.

#include <cuda_runtime.h>
#include <stdint.h>

#include "qvrcnn_stage.cuh"

namespace {

using namespace qvrcnn;

constexpr int VEC_LEN = FoldedEpilogue::ROWS * (C1 + C2 + C3);
constexpr int SMEM_VEC = 0;
constexpr int SMEM_ACT = SMEM_VEC + VEC_LEN * 4;      // 2560
constexpr int SMEM_BYTES = SMEM_ACT + 2 * ACT_BYTES;  // 165,792

template <int NF>
__device__ __forceinline__ void pair_body(unsigned char* smem, const uint8_t* __restrict__ x,
                                          uint8_t* __restrict__ y, const int8_t* __restrict__ w1,
                                          const int8_t* __restrict__ w2,
                                          const int8_t* __restrict__ w3,
                                          const int8_t* __restrict__ w4,
                                          const int* __restrict__ vec_g, int H, int W,
                                          size_t frame0, int b4, int mul4, int shift4) {
  int* vec = reinterpret_cast<int*>(smem + SMEM_VEC);
  int8_t* act = reinterpret_cast<int8_t*>(smem + SMEM_ACT);
  const Bounds bd{0, H, 0, W};
  const int tx0 = blockIdx.x * T, ty0 = blockIdx.y * T;
  const size_t plane = size_t(H) * W;
  const uint8_t* xf[NF];
#pragma unroll
  for (int f = 0; f < NF; ++f) xf[f] = x + (frame0 + f) * plane;

  load_inputs<NF>(vec, vec_g, VEC_LEN, act, xf, W, ty0, tx0, bd);
  __syncthreads();
  stages_123<FoldedEpilogue, NF, false>(act, w1, w2, w3, vec, ty0, tx0, bd);

  // S4 (48 -> 1, N padded to 8) for both frames + residual requant + add
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int g = lane >> 2, t = lane & 3;
  for (int mt = warp; mt < T * T / 16; mt += NWARPS) {
    int acc[NF][1][4];
    mma_tile<NF, false, C3, 3, R3, S3_STRIDE, T, 1>(act + ACT_S3, w4, mt, acc);
    if (t != 0) continue;  // output channel 0 lives in lanes with t == 0
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int m = mt * 16 + g + 8 * half;
      const int r = ty0 + m / T, c = tx0 + m % T;
      if (r >= H || c >= W) continue;
#pragma unroll
      for (int f = 0; f < NF; ++f) {
        const long long u = (long long)acc[f][0][2 * half] + b4;
        const long long res = (u * mul4 + (1LL << (shift4 - 1))) >> shift4;
        const long long rec = (long long)xf[f][size_t(r) * W + c] + res;
        y[(frame0 + f) * plane + size_t(r) * W + c] =
            uint8_t(rec < 0 ? 0 : (rec > 255 ? 255 : rec));
      }
    }
  }
}

__global__ void __launch_bounds__(NTHREADS, 1)
qvrcnn_pair_kernel(const uint8_t* __restrict__ x, uint8_t* __restrict__ y,
                   const int8_t* __restrict__ w1, const int8_t* __restrict__ w2,
                   const int8_t* __restrict__ w3, const int8_t* __restrict__ w4,
                   const int* __restrict__ vec_g, int B, int H, int W, int b4, int mul4,
                   int shift4) {
  extern __shared__ __align__(16) unsigned char smem[];
  const size_t frame0 = size_t(blockIdx.z) * 2;
  if (frame0 + 1 < size_t(B))
    pair_body<2>(smem, x, y, w1, w2, w3, w4, vec_g, H, W, frame0, b4, mul4, shift4);
  else
    pair_body<1>(smem, x, y, w1, w2, w3, w4, vec_g, H, W, frame0, b4, mul4, shift4);
}

}  // namespace

extern "C" {

// Launch on `stream` (a cudaStream_t) on the current device: one block per
// (16x16 tile, frame pair). Returns the cudaError_t of the one-time
// shared-memory attribute call or of the launch; 0 on success.
int qvrcnn_pair_forward(const void* x, void* y, const void* w1, const void* w2,
                        const void* w3, const void* w4, const void* vec, int B, int H,
                        int W, int b4, int mul4, int shift4, void* stream) {
  static bool smem_set[MAX_DEVICES] = {};
  const int err = set_smem_once(qvrcnn_pair_kernel, SMEM_BYTES, smem_set);
  if (err != 0) return err;
  dim3 grid((W + T - 1) / T, (H + T - 1) / T, (B + 1) / 2);
  qvrcnn_pair_kernel<<<grid, NTHREADS, SMEM_BYTES, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint8_t*>(x), static_cast<uint8_t*>(y),
      static_cast<const int8_t*>(w1), static_cast<const int8_t*>(w2),
      static_cast<const int8_t*>(w3), static_cast<const int8_t*>(w4),
      static_cast<const int*>(vec), B, H, W, b4, mul4, shift4);
  return int(cudaGetLastError());
}

const char* qvrcnn_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

int qvrcnn_smem_bytes() { return SMEM_BYTES; }

}  // extern "C"
