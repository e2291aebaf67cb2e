// A hidden layer's bias add and BLU requant in one pass, for Hopper
// (sm_90a): int32 accumulators in, int8 activations out.
//
// Replaces no Pallas kernel. The JAX package runs this epilogue as XLA
// elementwise ops after its int8 convolutions (qcnn_gpu_tpu/models/wide.py,
// qcnn_gpu_tpu/ops/requant.py); the port's library GEMM route
// (ops/int8_conv.py) had run it as separate torch passes over the
// accumulators: the bias add, a clamp into a new tensor, the add, multiply
// and shift, a compare, a masked fill and the cast. This kernel computes,
// for each element of an [M, C] int32 matrix u with row stride ld and
// channel c,
//
//   v = u + b[c]                                   (int32, wrapping as torch's add)
//   out = v > blu_q ? 127 : ((min(max(v, 0), blu_q) + rb) * mul) >> shift,
//   rb = (1 << (shift - 1)) / mul
//
// which is `ops/requant.blu_requant_clamped_i32(u + b, blu_q, mul, shift)`
// bit for bit: the clamp bounds the product by (blu_q + rb) * mul, which
// `check_blu_requant_i32_safe` keeps below 2^31. The rows (blu_q, mul,
// shift) are one per layer (kernel arguments) or one per channel ([C]
// int32 vectors); rb is worked out here, once a thread for its channels.
//
// What bounds it on the H100: bytes. It reads 4 bytes and writes 1 a
// value and does a few integer operations: one 832x480 frame of a
// 256-channel layer is 409 MB in and 102 MB out, 0.153 ms at 3.35 TB/s.
// The design streams at that rate:
//
// - Vector path (C a multiple of 16, ld a multiple of 4, both pointers
//   16-byte aligned, C <= 16 * THREADS): a thread owns 16 consecutive
//   channels of a row: four 16-byte loads of the accumulators, marked
//   evict-first (`__ldcs`: read once), one 16-byte store of the int8
//   results. Consecutive threads cover consecutive channel groups and
//   then the next rows, so a warp reads and writes contiguous bytes.
// - A thread keeps its channels' bias and rows in registers and walks the
//   rows in a grid-stride loop, so the table is read once a thread; no
//   shared memory and no barrier.
// - The grid is the card's full occupancy (SMs x resident blocks of this
//   instance, queried once a device) or less where the work is smaller:
//   every SM has tens of warps with 64 bytes each in flight.
// - Element path for every other shape (C = 20, 3, an odd stride or
//   alignment): one value a thread, 4-byte loads and byte stores.
//
// The wrapper (`ops/requant.bias_blu_requant_i8`) chooses the path from
// the shape and the pointers; this entry checks the choice and refuses a
// vector launch the shape cannot take.

#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int THREADS = 256;  // ops/requant.THREADS
constexpr int GROUP = 16;     // channels a thread of the vector path owns (ops/requant.VECTOR)
constexpr int MAX_DEVICES = 64;

__device__ __forceinline__ int requant(int u, int b, int q, int rb, int mul, int shift) {
  const int v = static_cast<int>(static_cast<unsigned>(u) + static_cast<unsigned>(b));
  const int m = min(max(v, 0), q);
  return v > q ? 127 : ((m + rb) * mul) >> shift;
}

// PC: per-channel rows from qv, mv, sv; else the scalars q, mul, shift.
template <bool PC>
__global__ void __launch_bounds__(THREADS)
bias_blu_requant_vec(const int* __restrict__ u, long long ld, int8_t* __restrict__ out,
                     long long rows, int C, const int* __restrict__ bias,
                     const int* __restrict__ qv, const int* __restrict__ mv,
                     const int* __restrict__ sv, int q, int mul, int shift) {
  const int groups = C / GROUP;
  const int per_pass = THREADS / groups;  // rows a block covers in one pass
  const int lane_row = threadIdx.x / groups;
  if (lane_row >= per_pass) return;
  const int c0 = (threadIdx.x - lane_row * groups) * GROUP;
  int b[GROUP], cq[GROUP], cm[GROUP], cs[GROUP], crb[GROUP];
#pragma unroll
  for (int i = 0; i < GROUP; ++i) {
    b[i] = __ldg(bias + c0 + i);
    cq[i] = PC ? __ldg(qv + c0 + i) : q;
    cm[i] = PC ? __ldg(mv + c0 + i) : mul;
    cs[i] = PC ? __ldg(sv + c0 + i) : shift;
    crb[i] = (1 << (cs[i] - 1)) / cm[i];
  }
  const long long step = static_cast<long long>(gridDim.x) * per_pass;
  for (long long r = static_cast<long long>(blockIdx.x) * per_pass + lane_row; r < rows;
       r += step) {
    const int4* src = reinterpret_cast<const int4*>(u + r * ld + c0);
    int a[GROUP];
#pragma unroll
    for (int k = 0; k < GROUP / 4; ++k) {
      const int4 t = __ldcs(src + k);
      a[4 * k] = t.x;
      a[4 * k + 1] = t.y;
      a[4 * k + 2] = t.z;
      a[4 * k + 3] = t.w;
    }
    uint32_t w[GROUP / 4];
#pragma unroll
    for (int k = 0; k < GROUP / 4; ++k) {
      w[k] = 0;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int i = 4 * k + j;
        const uint32_t o = static_cast<uint32_t>(requant(a[i], b[i], cq[i], crb[i], cm[i], cs[i]));
        w[k] |= (o & 0xffu) << (8 * j);
      }
    }
    *reinterpret_cast<uint4*>(out + r * C + c0) = make_uint4(w[0], w[1], w[2], w[3]);
  }
}

template <bool PC>
__global__ void __launch_bounds__(THREADS)
bias_blu_requant_elem(const int* __restrict__ u, long long ld, int8_t* __restrict__ out,
                      long long rows, int C, const int* __restrict__ bias,
                      const int* __restrict__ qv, const int* __restrict__ mv,
                      const int* __restrict__ sv, int q, int mul, int shift) {
  const long long n = rows * C;
  const long long step = static_cast<long long>(gridDim.x) * THREADS;
  const int rb = PC ? 0 : (1 << (shift - 1)) / mul;
  for (long long i = static_cast<long long>(blockIdx.x) * THREADS + threadIdx.x; i < n;
       i += step) {
    const long long r = i / C;
    const int c = static_cast<int>(i - r * C);
    const int cq = PC ? __ldg(qv + c) : q;
    const int cm = PC ? __ldg(mv + c) : mul;
    const int cs = PC ? __ldg(sv + c) : shift;
    const int crb = PC ? (1 << (cs - 1)) / cm : rb;
    out[i] = static_cast<int8_t>(requant(__ldcs(u + r * ld + c), __ldg(bias + c), cq, crb, cm, cs));
  }
}

using Kernel = void (*)(const int*, long long, int8_t*, long long, int, const int*, const int*,
                        const int*, const int*, int, int, int);

// Blocks of `kernel` resident on the whole current device (SMs x blocks an
// SM holds at THREADS threads), cached in `cache` per device; 0 on error,
// with the error in `err`.
int resident_blocks(Kernel kernel, int (&cache)[MAX_DEVICES], cudaError_t& err) {
  int dev = 0;
  err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return 0;
  if (dev >= MAX_DEVICES) {
    err = cudaErrorInvalidDevice;
    return 0;
  }
  if (cache[dev] == 0) {
    int sms = 0, per_sm = 0;
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    if (err != cudaSuccess) return 0;
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, THREADS, 0);
    if (err != cudaSuccess) return 0;
    cache[dev] = sms * (per_sm > 0 ? per_sm : 1);
  }
  return cache[dev];
}

template <bool PC>
int launch(bool vec, const int* u, long long ld, int8_t* out, long long rows, int C,
           const int* bias, const int* qv, const int* mv, const int* sv, int q, int mul, int shift,
           cudaStream_t stream) {
  static int vec_blocks[MAX_DEVICES] = {};
  static int elem_blocks[MAX_DEVICES] = {};
  const Kernel kernel = vec ? &bias_blu_requant_vec<PC> : &bias_blu_requant_elem<PC>;
  cudaError_t err = cudaSuccess;
  const long long resident = resident_blocks(kernel, vec ? vec_blocks : elem_blocks, err);
  if (err != cudaSuccess) return int(err);
  const long long per_block = vec ? THREADS / (C / GROUP) : THREADS;
  const long long work = vec ? (rows + per_block - 1) / per_block
                             : (rows * C + per_block - 1) / per_block;
  const int grid = static_cast<int>(work < resident ? work : resident);
  kernel<<<grid, THREADS, 0, stream>>>(u, ld, out, rows, C, bias, qv, mv, sv, q, mul, shift);
  return int(cudaGetLastError());
}

}  // namespace

extern "C" {

// out[M, C] (int8, contiguous) = the epilogue of u[M, C] (int32, row
// stride ld) with bias[C] and the rows: per channel where blu_q_vec,
// mul_vec and shift_vec are given ([C] int32 each), else the scalars.
// `vec` asks for the vector path, which needs C % 16 == 0, C <= 16 *
// THREADS, ld % 4 == 0 and 16-byte aligned u and out. Launches on
// `stream` (a cudaStream_t) on the current device. Returns a cudaError_t
// as int: cudaErrorInvalidValue for a shape or a path it cannot take, else
// that of the device query or the launch; 0 on success.
int requant_epilogue(const void* u, long long ld, void* out, long long rows, int C,
                     const void* bias, const void* blu_q_vec, const void* mul_vec,
                     const void* shift_vec, int blu_q, int mul, int shift, int vec,
                     void* stream) {
  const bool pc = blu_q_vec != nullptr;
  if (C <= 0 || ld < C || rows < 0 || pc != (mul_vec != nullptr) ||
      pc != (shift_vec != nullptr))
    return int(cudaErrorInvalidValue);
  if (!pc && (mul <= 0 || shift <= 0 || shift > 31)) return int(cudaErrorInvalidValue);
  if (vec && (C % GROUP != 0 || C / GROUP > THREADS || ld % 4 != 0 ||
              reinterpret_cast<uintptr_t>(u) % 16 != 0 ||
              reinterpret_cast<uintptr_t>(out) % 16 != 0))
    return int(cudaErrorInvalidValue);
  if (rows == 0) return 0;
  const auto* ui = static_cast<const int*>(u);
  auto* o = static_cast<int8_t*>(out);
  const auto* b = static_cast<const int*>(bias);
  const auto* qv = static_cast<const int*>(blu_q_vec);
  const auto* mv = static_cast<const int*>(mul_vec);
  const auto* sv = static_cast<const int*>(shift_vec);
  const auto s = static_cast<cudaStream_t>(stream);
  return pc ? launch<true>(vec != 0, ui, ld, o, rows, C, b, qv, mv, sv, 0, 1, 1, s)
            : launch<false>(vec != 0, ui, ld, o, rows, C, b, qv, mv, sv, blu_q, mul, shift, s);
}

const char* qvrcnn_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
