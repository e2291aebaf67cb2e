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
// device memory (ops/fused.py packs them), one 8-byte load per lane.
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
//
// Every shared-memory byte an MMA reads is written first: the window and
// every stage's full output region (masked positions store 0) are written
// before the barrier that precedes their use; K-padding lanes get A = 0 in
// registers, never from shared memory.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int T = 16;        // output tile edge
constexpr int HALO = 6;      // receptive radius (topology.RECEPTIVE_RADIUS)
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

// per-channel epilogue vectors, int32: for each of S1..S3 the four rows
// [b' | B | mul | shift] of C entries (ops/fused.FusedWeights.vec)
constexpr int VEC_LEN = 4 * (C1 + C2 + C3);
constexpr int VEC_OFF1 = 0, VEC_OFF2 = 4 * C1, VEC_OFF3 = 4 * (C1 + C2);

constexpr int SMEM_VEC = 0;
constexpr int SMEM_WIN = SMEM_VEC + VEC_LEN * 4;              // 2560
constexpr int SMEM_S1 = SMEM_WIN + ((R0 * R0 + 15) / 16) * 16;  // +784
constexpr int SMEM_S2 = SMEM_S1 + R1 * R1 * S1_STRIDE;
constexpr int SMEM_S3 = SMEM_S2 + R2 * R2 * S2_STRIDE;
constexpr int SMEM_BYTES = SMEM_S3 + R3 * R3 * S3_STRIDE;      // 84,176
constexpr int MAX_DEVICES = 64;

struct Bounds {
  int r_lo, r_hi, c_lo, c_hi;  // valid frame rectangle (already clipped)
  __device__ bool inside(int r, int c) const {
    return r >= r_lo && r < r_hi && c >= c_lo && c < c_hi;
  }
};

__device__ __forceinline__ void mma_s8(int (&c)[4], const uint32_t (&a)[4],
                                       uint2 b) {
  asm volatile(
      "mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+r"(c[0]), "+r"(c[1]), "+r"(c[2]), "+r"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b.x), "r"(b.y));
}

// One warp's 16-row M tile of a stage: acc[nt] += A[m, k] * W[k, nt*8 + n].
// Output position m (row-major over an OUT_W x OUT_W region) reads input
// position (m / OUT_W + dy, m % OUT_W + dx) of an IN_W-wide region whose
// positions are IN_STRIDE bytes apart; k = (dy * KS + dx) * CIN + ch.
// Rows past M clamp their loads to position M-1 (their outputs are
// dropped by the caller).
template <int CIN, int KS, int IN_W, int IN_STRIDE, int OUT_W, int NT>
__device__ __forceinline__ void mma_tile(const int8_t* in,
                                         const int8_t* __restrict__ wf,
                                         int mt, int (&acc)[NT][4]) {
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
  for (int nt = 0; nt < NT; ++nt)
    acc[nt][0] = acc[nt][1] = acc[nt][2] = acc[nt][3] = 0;
  const uint2* wp = reinterpret_cast<const uint2*>(wf) + lane;
#pragma unroll 2
  for (int kc = 0; kc < KC; ++kc) {
    uint32_t a[4];
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int k = kc * 32 + h * 16 + t * 4;
      if constexpr (CIN % 4 == 0) {
        // 4 consecutive channels of one tap: one aligned 32-bit load
        uint32_t lo = 0, hi = 0;
        if (k < K) {
          const int tap = k / CIN, ch = k - tap * CIN;
          const int dy = tap / KS, dx = tap - dy * KS;
          const int off = (dy * IN_W + dx) * IN_STRIDE + ch;
          lo = *reinterpret_cast<const uint32_t*>(in + base0 + off);
          hi = *reinterpret_cast<const uint32_t*>(in + base1 + off);
        }
        a[2 * h] = lo;
        a[2 * h + 1] = hi;
      } else {
        // CIN == 1 (S1): the 4 k are 4 taps; gather byte by byte
        uint32_t lo = 0, hi = 0;
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const int tap = k + j;
          if (tap < K) {
            const int dy = tap / KS, dx = tap - dy * KS;
            const int off = (dy * IN_W + dx) * IN_STRIDE;
            lo |= uint32_t(uint8_t(in[base0 + off])) << (8 * j);
            hi |= uint32_t(uint8_t(in[base1 + off])) << (8 * j);
          }
        }
        a[2 * h] = lo;
        a[2 * h + 1] = hi;
      }
    }
#pragma unroll
    for (int nt = 0; nt < NT; ++nt) {
      const uint2 b = __ldg(wp + (kc * NT + nt) * 32);
      mma_s8(acc[nt], a, b);
    }
  }
}

// S1..S3: MMA + folded BLU requant + frame-bounds mask, stored as int8.
// (org_r, org_c) is the frame position of the output region's (0, 0).
template <int CIN, int KS, int IN_W, int IN_STRIDE, int OUT_W, int OUT_STRIDE,
          int COUT>
__device__ __forceinline__ void conv_stage(const int8_t* in, int8_t* out,
                                           const int8_t* __restrict__ wf,
                                           const int* vec, int org_r,
                                           int org_c, Bounds bd) {
  constexpr int NT = COUT / 8;
  constexpr int M = OUT_W * OUT_W;
  constexpr int MT = (M + 15) / 16;
  const int* bias = vec;
  const int* bound = vec + COUT;
  const int* mul = vec + 2 * COUT;
  const int* shift = vec + 3 * COUT;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int g = lane >> 2, t = lane & 3;
  for (int mt = warp; mt < MT; mt += NWARPS) {
    int acc[NT][4];
    mma_tile<CIN, KS, IN_W, IN_STRIDE, OUT_W, NT>(in, wf, mt, acc);
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int m = mt * 16 + g + 8 * half;
      if (m >= M) continue;
      const int r = m / OUT_W, c = m - (m / OUT_W) * OUT_W;
      const bool ok = bd.inside(org_r + r, org_c + c);
      int8_t* dst = out + m * OUT_STRIDE;
#pragma unroll
      for (int nt = 0; nt < NT; ++nt) {
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int n = nt * 8 + t * 2 + e;
          int u = acc[nt][2 * half + e] + bias[n];
          u = min(max(u, 0), bound[n]);
          const int v = min((u * mul[n]) >> shift[n], 127);
          dst[n] = ok ? int8_t(v) : int8_t(0);
        }
      }
    }
  }
}

__global__ void __launch_bounds__(NTHREADS, 2)
qvrcnn_fused_kernel(const uint8_t* __restrict__ x, uint8_t* __restrict__ y,
                    const int8_t* __restrict__ w1, const int8_t* __restrict__ w2,
                    const int8_t* __restrict__ w3, const int8_t* __restrict__ w4,
                    const int* __restrict__ vec_g, int H, int W, Bounds bd,
                    int b4, int mul4, int shift4) {
  extern __shared__ __align__(16) unsigned char smem[];
  int* vec = reinterpret_cast<int*>(smem + SMEM_VEC);
  int8_t* win = reinterpret_cast<int8_t*>(smem + SMEM_WIN);
  int8_t* s1 = reinterpret_cast<int8_t*>(smem + SMEM_S1);
  int8_t* s2 = reinterpret_cast<int8_t*>(smem + SMEM_S2);
  int8_t* s3 = reinterpret_cast<int8_t*>(smem + SMEM_S3);

  const int tx0 = blockIdx.x * T, ty0 = blockIdx.y * T;
  const size_t frame = size_t(blockIdx.z) * H * W;
  const uint8_t* xf = x + frame;

  for (int i = threadIdx.x; i < VEC_LEN; i += NTHREADS) vec[i] = vec_g[i];
  // input window in the x-128 domain; 0 outside the frame bounds
  for (int i = threadIdx.x; i < R0 * R0; i += NTHREADS) {
    const int r = ty0 - HALO + i / R0, c = tx0 - HALO + i % R0;
    win[i] = bd.inside(r, c) ? int8_t(int(xf[size_t(r) * W + c]) - 128)
                             : int8_t(0);
  }
  __syncthreads();
  conv_stage<1, 5, R0, 1, R1, S1_STRIDE, C1>(win, s1, w1, vec + VEC_OFF1,
                                             ty0 - 4, tx0 - 4, bd);
  __syncthreads();
  conv_stage<C1, 5, R1, S1_STRIDE, R2, S2_STRIDE, C2>(s1, s2, w2, vec + VEC_OFF2,
                                                      ty0 - 2, tx0 - 2, bd);
  __syncthreads();
  conv_stage<C2, 3, R2, S2_STRIDE, R3, S3_STRIDE, C3>(s2, s3, w3, vec + VEC_OFF3,
                                                      ty0 - 1, tx0 - 1, bd);
  __syncthreads();

  // S4 (48 -> 1, N padded to 8) + final residual requant + residual add
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int g = lane >> 2, t = lane & 3;
  uint8_t* yf = y + frame;
  for (int mt = warp; mt < T * T / 16; mt += NWARPS) {
    int acc[1][4];
    mma_tile<C3, 3, R3, S3_STRIDE, T, 1>(s3, w4, mt, acc);
    if (t != 0) continue;  // output channel 0 lives in lanes with t == 0
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int m = mt * 16 + g + 8 * half;
      const int r = ty0 + m / T, c = tx0 + m % T;
      if (r >= H || c >= W) continue;
      const long long u = (long long)acc[0][2 * half] + b4;
      const long long res = (u * mul4 + (1LL << (shift4 - 1))) >> shift4;
      const long long rec = (long long)xf[size_t(r) * W + c] + res;
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
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return int(err);
  if (dev >= MAX_DEVICES || !smem_set[dev]) {
    err = cudaFuncSetAttribute(qvrcnn_fused_kernel,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               SMEM_BYTES);
    if (err != cudaSuccess) return int(err);
    if (dev < MAX_DEVICES) smem_set[dev] = true;
  }
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
