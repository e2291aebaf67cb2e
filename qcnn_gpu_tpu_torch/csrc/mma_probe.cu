// Matrix-rate probe for Hopper (sm_90a): chains of dependent products.
//
// Replaces the Pallas TPU kernel built by `build` (scripts/mfu_probe.py:36,
// launched at :57). Per block g of the grid it computes, for c = 0..15,
//
//   wc  = (w[c] + s)                       in w's type
//   acc += a[g] @ wc                       a[g]: [M, K], w[c]: [K, N]
//   s   = acc[0,0] % 3  (int, Python-style, in [0, 2])
//         acc[0,0] * 1e-30 (float)
//
// and writes acc to its own [M, N] slot of the output (on the TPU every
// grid step overwrote one output, so the TPU's result is the last block's
// slot). s makes each product depend on the previous one.
//
// Cases: int8 -> int32 on `wgmma ... m64nNk32.s32.s8.s8`; bf16 -> f32 on
// `wgmma ... m64nNk16.f32.bf16.bf16`; f32 -> f32 as FFMA on the CUDA cores
// (no TF32). Operands are small integers, so every case is exact.
//
// Bound: operations at K = N = 128 (2 M K N CHAIN a block over the tensor
// cores' peak; the bytes, a read and acc written once, take 72% of that
// time in int8, 43% in bf16); bytes at K = 96, N = 8 (3.1x the operations).
//
// Design of the tensor-core chain (`wgmma_chain_kernel`), one block of
// three warpgroups per grid index, one block per SM:
//   - s off the tensor cores' critical path. s[c] depends only on row 0 of
//     a[g] and on column 0 of w[0..c], so each producer warp first derives
//     all 16 values from K-long dots in the accumulator type (int8 wraps
//     as `I8::add`, bf16 rounds as `BF16::add`), which `chain_scalars` in
//     tools/mma_probe.py mirrors. This is not a shortcut: every one of the
//     CHAIN * M * K * N MACs still runs on the tensor cores, each step's
//     product on its own wc, nothing factored into a @ sum(w), hoisted or
//     skipped.
//   - wc = w[c] + s[c] is staged into shared-memory buffers ahead of the
//     consumers by the producer warpgroup (16-byte loads of w in the
//     layout the product reads, s added in registers, stored, the
//     async-proxy fence, an mbarrier arrival). No block-wide barrier after
//     the set-up.
//   - Two consumer warpgroups, each holding MT m64 tiles of A (the RS
//     form: A in registers for the M-tile's 16 steps) and their
//     accumulators (MT x N/2 registers a thread) across the 16 steps; B
//     (wc) is read K-major without swizzle: 16-byte planes of K, N rows
//     each, so a k-slice's two K halves are one plane apart (LBO = 16 N)
//     and its 8-row groups 128 bytes apart (SBO). `setmaxnreg` moves
//     registers from the producer (56) to the consumers (224).
//   - What bounds it on the H100 is the staging, not the products: an
//     M-tile (2 MT 64 rows, at most 256 at these widths) needs all 16 wc,
//     and re-staging them in every M-tile (16 KB a step at int8 K = N =
//     128) held the chain well under the rate of its products. So
//     R of the 16 wc stay resident after the first M-tile, as many as the
//     227 KB of shared memory hold beside a ring of 2 slots through which
//     the other S stream in every M-tile, spread evenly over the chain
//     (int8 K = N = 128: 12 and 4; int8 N <= 96: all 16 resident; bf16
//     K = N = 128: 5 and 11). A streamed slot goes back to the producer
//     when the consumer warps' `wgmma.wait_group` shows its products done.
//
// Beside the chain, `mma_issue_kernel` measures `mma.sync`'s own ceiling:
// each warp issues ITERS rounds of NACC independent MMAs on register
// operands whose every element is 1, with no memory traffic, so that
// every accumulator ends at ITERS * K and each thread writes the sum of
// its 4 * NACC accumulators. It is the only `mma.sync` left here.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "hopper_wgmma.cuh"

namespace {

using namespace hopper;

constexpr int CHAIN = 16;
constexpr int NWARPS = 8;  // the FFMA chain's and the issue kernel's blocks
constexpr int NTHREADS = NWARPS * 32;

// the tensor-core chain: consumer warpgroups, block size, register split
constexpr int CONSUMERS = 2;
constexpr int CHAIN_THREADS = (CONSUMERS + 1) * 128;
constexpr int PRODUCER_REGS = 56, CONSUMER_REGS = 224;
constexpr int SMEM_LIMIT = 232448;     // dynamic shared memory a block may have (sm_90)
constexpr int RING = 2;                // ring slots beside the resident wc

__device__ __forceinline__ uint32_t ldg32(const uint8_t* p) {
  return __ldg(reinterpret_cast<const uint32_t*>(p));
}

struct I8 {
  using Acc = int;
  static constexpr int EB = 1;  // bytes per element
  // mma.sync, for the issue-rate kernel only
  __device__ __forceinline__ static void mma(int (&c)[4], const uint32_t (&a)[4], uint32_t b0,
                                             uint32_t b1) {
    asm volatile(
        "mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 "
        "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
        : "+r"(c[0]), "+r"(c[1]), "+r"(c[2]), "+r"(c[3])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
  }
  // acc (64 x N) += A (64 x 32, registers) * B (32 x N at descriptor b)
  template <int N, int L>
  __device__ __forceinline__ static void wgmma(int (&d)[L], const uint32_t (&a)[4], uint64_t b) {
    if constexpr (N == 8) {
      mma_rs_n8<0>(d, a, b);
    } else if constexpr (N == 96) {
      mma_rs_n96<0>(d, a, b);
    } else {
      static_assert(N == 128, "int8 chain widths: 8, 96, 128");
      mma_rs_n128<0>(d, a, b);
    }
  }
  __device__ __forceinline__ static int derive(int acc00) {
    const int r = acc00 % 3;
    return r < 0 ? r + 3 : r;
  }
  // four int8 weights + s, each wrapping to int8 like the TPU's astype
  __device__ __forceinline__ static uint32_t add(uint32_t w4, int s) {
    return __vadd4(w4, uint32_t(s) * 0x01010101u);
  }
  // the dot of four a's with four wc's
  __device__ __forceinline__ static int dot(uint32_t a4, uint32_t w4) {
    return __dp4a(int(a4), int(w4), 0);
  }
  __device__ __forceinline__ static int warp_sum(int v) { return __reduce_add_sync(~0u, v); }
};

struct BF16 {
  using Acc = float;
  static constexpr int EB = 2;
  __device__ __forceinline__ static void mma(float (&c)[4], const uint32_t (&a)[4], uint32_t b0,
                                             uint32_t b1) {
    asm volatile(
        "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
        "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
        : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
  }
  // acc (64 x N, f32) += A (64 x 16, registers) * B (16 x N at descriptor b)
  template <int N, int L>
  __device__ __forceinline__ static void wgmma(float (&d)[L], const uint32_t (&a)[4], uint64_t b) {
    if constexpr (N == 96) {
      mma_bf16_rs_n96<0>(d, a, b);
    } else {
      static_assert(N == 128, "bf16 chain widths: 96, 128");
      mma_bf16_rs_n128<0>(d, a, b);
    }
  }
  __device__ __forceinline__ static float derive(float acc00) { return __fmul_rn(acc00, 1e-30f); }
  __device__ __forceinline__ static float val(uint32_t h) { return __uint_as_float(h << 16); }
  // two bf16 weights + s, rounded back to bf16 (round to nearest even; one
  // cvt.rn.bf16x2.f32 for the pair)
  __device__ __forceinline__ static uint32_t add(uint32_t w2, float s) {
    const __nv_bfloat162 r = __floats2bfloat162_rn(__fadd_rn(__uint_as_float(w2 << 16), s),
                                                   __fadd_rn(__uint_as_float(w2 & 0xffff0000u), s));
    return *reinterpret_cast<const uint32_t*>(&r);
  }
  // exact for the probe's integer operands, as the tensor cores' sums are
  __device__ __forceinline__ static float dot(uint32_t a2, uint32_t w2) {
    return __fmaf_rn(val(a2 & 0xffffu), val(w2 & 0xffffu), __fmul_rn(val(a2 >> 16), val(w2 >> 16)));
  }
  __device__ __forceinline__ static float warp_sum(float v) {
#pragma unroll
    for (int o = 16; o; o >>= 1) v = __fadd_rn(v, __shfl_xor_sync(~0u, v, o));
    return __shfl_sync(~0u, v, 0);
  }
};

template <class Op>
__device__ __forceinline__ uint4 add16(uint4 v, typename Op::Acc s) {
  return make_uint4(Op::add(v.x, s), Op::add(v.y, s), Op::add(v.z, s), Op::add(v.w, s));
}

__device__ __forceinline__ void store2(int* o, int x, int y) {
  *reinterpret_cast<int2*>(o) = make_int2(x, y);
}
__device__ __forceinline__ void store2(float* o, float x, float y) {
  *reinterpret_cast<float2*>(o) = make_float2(x, y);
}

constexpr int pow2_floor(int x) { return x >= 8 ? 8 : x >= 4 ? 4 : x >= 2 ? 2 : 1; }

// The tensor-core chain's shape. B for one step (wc) is SB bytes: PLANES
// 16-byte planes of K, each N rows of 16 bytes (`kernel_operand` in
// tools/mma_probe.py writes w so, [CHAIN][PLANES][N][16 B]). R steps' wc
// stay resident after the first M-tile; the S others stream through a
// ring of D slots in every M-tile, spread evenly over the chain.
template <class Op, int K, int N, int MT_>
struct Chain {
  static constexpr int MT = MT_;                  // m64 tiles a consumer warpgroup
  static constexpr int KB = K * Op::EB;           // bytes per row of A and of wc
  static constexpr int KS = KB / 32;              // k-slices (one wgmma deep)
  static constexpr int SB = KB * N;               // bytes of one wc
  static constexpr int SB16 = SB / 16;            // its 16-byte chunks
  static constexpr int MTILE = CONSUMERS * MT * 64;
  static constexpr int FIT = (SMEM_LIMIT - 1024) / SB;  // wc that fit beside the rest
  static constexpr int R = FIT >= CHAIN ? CHAIN : FIT - RING;
  static constexpr int D = R == CHAIN ? 0 : RING;
  static constexpr int S = CHAIN - R;
  static constexpr int SS = S > 0 ? S : 1, DD = D > 0 ? D : 1;  // divisors when nothing streams
  static constexpr int SLOTS = R + D;
  static constexpr int BARS = SLOTS * SB;  // full[SLOTS], then empty[D]
  static constexpr int SMEM = BARS + 8 * (SLOTS + D) + 4 * CHAIN * int(sizeof(typename Op::Acc));
  // producer: U chunks a thread a step, loaded in units of UC chunks,
  // NCH units a step, P units in flight in registers
  static constexpr int U = (SB16 + 127) / 128;
  static constexpr int UC = U < 8 ? U : 8;
  static constexpr int NCH = (U + UC - 1) / UC;
  static constexpr int P = NCH > 1 ? 1 : pow2_floor(8 / UC);
  // D >= 2: a consumer frees a streamed slot one step late (after the next
  // step's products are issued), so two streamed steps in a row need two
  static_assert(KB % 32 == 0 && SB % 16 == 0 && R >= 0 && (S == 0 || D >= 2), "shape");
  static_assert(SMEM <= SMEM_LIMIT, "shared memory");

  __host__ __device__ static constexpr bool streamed(int c) {
    return (c + 1) * S / CHAIN != c * S / CHAIN;
  }
  __host__ __device__ static constexpr int stream_index(int c) { return c * S / CHAIN; }
  __host__ __device__ static constexpr int resident_index(int c) { return c - c * S / CHAIN; }
  // the step of stream index si (S > 0)
  __host__ __device__ static constexpr int streamed_step(int si) {
    return ((si + 1) * CHAIN + SS - 1) / SS - 1;
  }
  // staging units: every step's NCH units in the first M-tile, the S
  // streamed steps' in each later one
  __host__ __device__ static constexpr int units(int tiles) {
    return (CHAIN + (tiles - 1) * S) * NCH;
  }
};

// s[0..CHAIN) of one block into st (lane 0 writes): the chain's scalars
// from row 0 of a (a0) and column 0 of each w[c], K-long dots in the
// accumulator type.
template <class Op, int K, int N>
__device__ __forceinline__ void derive_scalars(const uint8_t* a0, const uint8_t* wop,
                                               typename Op::Acc* st, int lane) {
  using Acc = typename Op::Acc;
  constexpr int KB = K * Op::EB, WORDS = KB / 4, WL = (WORDS + 31) / 32, SB = KB * N;
  uint32_t aw[WL], ww[CHAIN][WL];
#pragma unroll
  for (int i = 0; i < WL; ++i) {
    const int q = lane + 32 * i;  // word q of row 0: plane q / 4, bytes 4 (q % 4) ..
    aw[i] = q < WORDS ? ldg32(a0 + 4 * q) : 0u;
#pragma unroll
    for (int c = 0; c < CHAIN; ++c)
      ww[c][i] = q < WORDS ? ldg32(wop + c * SB + (q >> 2) * N * 16 + (q & 3) * 4) : 0u;
  }
  Acc acc00 = 0, s = 0;
#pragma unroll
  for (int c = 0; c < CHAIN; ++c) {
    if (lane == 0) st[c] = s;
    Acc dot = 0;
#pragma unroll
    for (int i = 0; i < WL; ++i) dot += Op::dot(aw[i], Op::add(ww[c][i], s));
    acc00 += Op::warp_sum(dot);
    s = Op::derive(acc00);
  }
}

template <class Op, int K, int N, int MT>
__global__ void __launch_bounds__(CHAIN_THREADS, 1)
wgmma_chain_kernel(const uint8_t* __restrict__ a, const uint8_t* __restrict__ wop,
                   typename Op::Acc* __restrict__ out, int M) {
  using C = Chain<Op, K, N, MT>;
  using Acc = typename Op::Acc;
  extern __shared__ __align__(128) uint8_t smem[];
  const uint32_t slots = smem_addr(smem);
  const uint32_t full = slots + C::BARS, empty = full + 8 * C::SLOTS;
  Acc* s_tab = reinterpret_cast<Acc*>(smem + C::BARS + 8 * (C::SLOTS + C::D));  // [4][CHAIN]
  if (threadIdx.x == 0) {
    for (int d = 0; d < C::SLOTS; ++d) mbar_init(full + 8 * d, 128);  // every producer thread
    for (int d = 0; d < C::D; ++d) mbar_init(empty + 8 * d, CONSUMERS * 4);  // every consumer warp
    mbar_init_fence();
  }
  __syncthreads();  // the only block-wide barrier
  const uint8_t* ab = a + size_t(blockIdx.x) * M * C::KB;
  const int tiles = M / C::MTILE;

  if (threadIdx.x >= CONSUMERS * 128) {
    // ---- producer warpgroup: the scalars, then wc into its buffers
    regs_dec<PRODUCER_REGS>();
    const int pt = threadIdx.x - CONSUMERS * 128, lane = pt & 31;
    Acc* st = s_tab + (pt >> 5) * CHAIN;
    derive_scalars<Op, K, N>(ab, wop, st, lane);
    __syncwarp();
    // unit q -> M-tile, step and chunk
    auto unit = [&](int q, int& mt, int& c, int& ch) {
      if (q < CHAIN * C::NCH) {
        mt = 0, c = q / C::NCH, ch = q % C::NCH;
      } else {
        const int r = q - CHAIN * C::NCH;
        mt = 1 + r / (C::SS * C::NCH);
        c = C::streamed_step(r % (C::SS * C::NCH) / C::NCH), ch = r % C::NCH;
      }
    };
    const uint4* src = reinterpret_cast<const uint4*>(wop);
    uint4 buf[C::P][C::UC];
    auto load = [&](uint4 (&r)[C::UC], int q) {
      int mt, c, ch;
      unit(q, mt, c, ch);
#pragma unroll
      for (int u = 0; u < C::UC; ++u) {
        const int idx = ch * C::UC * 128 + pt + u * 128;
        if (idx < C::SB16) r[u] = __ldg(src + c * C::SB16 + idx);
      }
    };
    const int units = C::units(tiles);
#pragma unroll
    for (int p = 0; p < C::P; ++p)
      if (p < units) load(buf[p], p);
    for (int q0 = 0; q0 < units; q0 += C::P) {
#pragma unroll
      for (int p = 0; p < C::P; ++p) {
        const int q = q0 + p;
        if (q >= units) break;
        int mt, c, ch, slot;
        unit(q, mt, c, ch);
        if (C::streamed(c)) {
          const int seq = mt * C::S + C::stream_index(c);
          slot = C::R + seq % C::DD;
          if (ch == 0) mbar_wait(empty + 8 * (seq % C::DD), ((seq / C::DD) & 1) ^ 1);
        } else {
          slot = C::resident_index(c);  // staged once, in the first M-tile
        }
        const Acc s = st[c];
        uint4* dst = reinterpret_cast<uint4*>(smem + slot * C::SB);
#pragma unroll
        for (int u = 0; u < C::UC; ++u) {
          const int idx = ch * C::UC * 128 + pt + u * 128;
          if (idx < C::SB16) dst[idx] = add16<Op>(buf[p][u], s);
        }
        if (q + C::P < units) load(buf[p], q + C::P);
        if (ch == C::NCH - 1) {
          fence_async_smem();  // the generic-proxy stores, before wgmma reads them
          mbar_arrive(full + 8 * slot);
        }
      }
    }
  } else {
    // ---- consumer warpgroups: MT m64 tiles each, 16 steps an M-tile
    regs_inc<CONSUMER_REGS>();
    const int cw = threadIdx.x >> 7, wq = (threadIdx.x >> 5) & 3, lane = threadIdx.x & 31;
    const int g = lane >> 2, t = lane & 3;
    Acc acc[MT][N / 2];
    uint32_t af[MT][C::KS][4];
    auto load_a = [&](int m0) {
#pragma unroll
      for (int m = 0; m < MT; ++m) {
        const uint8_t* r0 = ab + size_t(m0 + (cw * MT + m) * 64 + wq * 16 + g) * C::KB + t * 4;
        const uint8_t* r1 = r0 + 8 * C::KB;
#pragma unroll
        for (int ks = 0; ks < C::KS; ++ks) {
          af[m][ks][0] = ldg32(r0 + ks * 32);
          af[m][ks][1] = ldg32(r1 + ks * 32);
          af[m][ks][2] = ldg32(r0 + ks * 32 + 16);
          af[m][ks][3] = ldg32(r1 + ks * 32 + 16);
        }
      }
    };
    // the slot step c of M-tile mt reads; waits for it to be filled
    auto acquire = [&](int mt, int c) {
      if (C::streamed(c)) {
        const int seq = mt * C::S + C::stream_index(c);
        mbar_wait(full + 8 * (C::R + seq % C::DD), (seq / C::DD) & 1);
        return C::R + seq % C::DD;
      }
      if (mt == 0) mbar_wait(full + 8 * C::resident_index(c), 0);
      return C::resident_index(c);
    };
    // step c's products have completed: a streamed slot goes back to the ring
    auto release = [&](int mt, int c) {
      if (C::streamed(c) && lane == 0)
        mbar_arrive(empty + 8 * ((mt * C::S + C::stream_index(c)) % C::DD));
    };
    const uint64_t b0 = desc(slots, N * 16, 128);
    Acc* ob = out + size_t(blockIdx.x) * M * N;
    load_a(0);
    for (int mt = 0; mt < tiles; ++mt) {
      const int m0 = mt * C::MTILE;
#pragma unroll
      for (int m = 0; m < MT; ++m)
#pragma unroll
        for (int i = 0; i < N / 2; ++i) acc[m][i] = 0;
      for (int c = 0; c < CHAIN; ++c) {
        const int slot = acquire(mt, c);
#pragma unroll
        for (int m = 0; m < MT; ++m) {
          fence_regs(acc[m]);
#pragma unroll
          for (int ks = 0; ks < C::KS; ++ks) fence_regs(af[m][ks]);
        }
        wg_fence();
#pragma unroll
        for (int m = 0; m < MT; ++m)
#pragma unroll
          for (int ks = 0; ks < C::KS; ++ks)
            Op::template wgmma<N>(acc[m], af[m][ks], at(b0, (slot * C::SB + ks * 32 * N) >> 4, 0));
        wg_commit();
        if (c > 0) {
          wg_wait<1>();  // the previous step's products are done
          release(mt, c - 1);
        }
      }
      wg_wait<0>();
      release(mt, CHAIN - 1);
#pragma unroll
      for (int m = 0; m < MT; ++m) {
        fence_regs(acc[m]);
#pragma unroll
        for (int ks = 0; ks < C::KS; ++ks) fence_regs(af[m][ks]);
      }
      if (mt + 1 < tiles) load_a(m0 + C::MTILE);  // in flight during the stores
#pragma unroll
      for (int m = 0; m < MT; ++m) {
        const int row = m0 + (cw * MT + m) * 64 + wq * 16 + g;
#pragma unroll
        for (int j = 0; j < N / 8; ++j)
#pragma unroll
          for (int h = 0; h < 2; ++h)
            store2(ob + size_t(row + 8 * h) * N + 8 * j + 2 * t, acc[m][4 * j + 2 * h],
                   acc[m][4 * j + 2 * h + 1]);
      }
    }
  }
}

// FFMA chain (float32 on the CUDA cores). a: [grid, M, K], w: [CHAIN, K, N],
// out: [grid, M, N]. One block per grid index walks 128-row M-tiles; a
// thread computes 8 rows x 8 columns (columns tx*4..+3 and 64+tx*4..+3)
// from the transposed A tile and wc in shared memory.
constexpr int F_MTILE = 128;
constexpr int F_AROW = F_MTILE + 4;  // padded row of the transposed A tile

template <int K, int N>
__global__ void __launch_bounds__(NTHREADS, 1)
ffma_chain_kernel(const float* __restrict__ a, const float* __restrict__ w,
                  float* __restrict__ out, int M) {
  static_assert(N == 128 && K % 4 == 0, "one thread computes 8 of 128 columns");
  extern __shared__ __align__(16) float fsm[];
  float* As = fsm;                // [K][F_AROW]
  float* Ws = fsm + K * F_AROW;   // [K][N]
  __shared__ float bcast;
  __shared__ float s_rec[CHAIN];
  const int tx = threadIdx.x & 15, ty = threadIdx.x >> 4;
  const float* ab = a + size_t(blockIdx.x) * M * K;
  float* ob = out + size_t(blockIdx.x) * M * N;

  for (int m0 = 0; m0 < M; m0 += F_MTILE) {
    for (int i = threadIdx.x; i < F_MTILE * K; i += NTHREADS) {
      const int r = i / K, k = i - r * K;
      As[k * F_AROW + r] = ab[size_t(m0 + r) * K + k];
    }
    float acc[8][8];
#pragma unroll
    for (int i = 0; i < 8; ++i)
#pragma unroll
      for (int j = 0; j < 8; ++j) acc[i][j] = 0.f;

    for (int c = 0; c < CHAIN; ++c) {
      float s = 0.f;
      if (c > 0) s = m0 == 0 ? __fmul_rn(bcast, 1e-30f) : s_rec[c];
      if (m0 == 0 && threadIdx.x == 0) s_rec[c] = s;
      const float4* wc = reinterpret_cast<const float4*>(w + size_t(c) * K * N);
      for (int i = threadIdx.x; i < K * N / 4; i += NTHREADS) {
        float4 v = __ldg(wc + i);
        v.x = __fadd_rn(v.x, s);
        v.y = __fadd_rn(v.y, s);
        v.z = __fadd_rn(v.z, s);
        v.w = __fadd_rn(v.w, s);
        reinterpret_cast<float4*>(Ws)[i] = v;
      }
      __syncthreads();
#pragma unroll 4
      for (int k = 0; k < K; ++k) {
        const float4 a0 = *reinterpret_cast<const float4*>(As + k * F_AROW + ty * 8);
        const float4 a1 = *reinterpret_cast<const float4*>(As + k * F_AROW + ty * 8 + 4);
        const float4 b0 = *reinterpret_cast<const float4*>(Ws + k * N + tx * 4);
        const float4 b1 = *reinterpret_cast<const float4*>(Ws + k * N + 64 + tx * 4);
        const float av[8] = {a0.x, a0.y, a0.z, a0.w, a1.x, a1.y, a1.z, a1.w};
        const float bv[8] = {b0.x, b0.y, b0.z, b0.w, b1.x, b1.y, b1.z, b1.w};
#pragma unroll
        for (int i = 0; i < 8; ++i)
#pragma unroll
          for (int j = 0; j < 8; ++j) acc[i][j] = fmaf(av[i], bv[j], acc[i][j]);
      }
      if (m0 == 0 && threadIdx.x == 0) bcast = acc[0][0];  // acc[0,0]
      __syncthreads();
    }

#pragma unroll
    for (int i = 0; i < 8; ++i) {
      float* orow = ob + size_t(m0 + ty * 8 + i) * N;
      *reinterpret_cast<float4*>(orow + tx * 4) =
          make_float4(acc[i][0], acc[i][1], acc[i][2], acc[i][3]);
      *reinterpret_cast<float4*>(orow + 64 + tx * 4) =
          make_float4(acc[i][4], acc[i][5], acc[i][6], acc[i][7]);
    }
    __syncthreads();  // As is rewritten by the next M-tile
  }
}

constexpr int NACC = 16;

template <class Op>
__global__ void __launch_bounds__(NTHREADS)
mma_issue_kernel(typename Op::Acc* __restrict__ out, int iters, uint32_t one) {
  using Acc = typename Op::Acc;
  const uint32_t a[4] = {one, one, one, one};
  Acc acc[NACC][4];
#pragma unroll
  for (int j = 0; j < NACC; ++j) acc[j][0] = acc[j][1] = acc[j][2] = acc[j][3] = 0;
  for (int i = 0; i < iters; ++i) {
#pragma unroll
    for (int j = 0; j < NACC; ++j) Op::mma(acc[j], a, one, one);
  }
  Acc sum = 0;
#pragma unroll
  for (int j = 0; j < NACC; ++j) sum += acc[j][0] + acc[j][1] + acc[j][2] + acc[j][3];
  out[size_t(blockIdx.x) * NTHREADS + threadIdx.x] = sum;
}

template <class Op, int K, int N, int MT>
int launch_chain(const void* a, const void* w, void* out, int grid, int M, cudaStream_t st) {
  using C = Chain<Op, K, N, MT>;
  if (M % C::MTILE) return int(cudaErrorInvalidValue);
  cudaError_t err = cudaFuncSetAttribute(wgmma_chain_kernel<Op, K, N, MT>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, C::SMEM);
  if (err != cudaSuccess) return int(err);
  wgmma_chain_kernel<Op, K, N, MT><<<grid, CHAIN_THREADS, C::SMEM, st>>>(
      static_cast<const uint8_t*>(a), static_cast<const uint8_t*>(w),
      static_cast<typename Op::Acc*>(out), M);
  return int(cudaGetLastError());
}

template <int K, int N>
int launch_ffma(const void* a, const void* w, void* out, int grid, int M, cudaStream_t st) {
  constexpr int SMEM = (K * F_AROW + K * N) * 4;
  if (M % F_MTILE) return int(cudaErrorInvalidValue);
  cudaError_t err = cudaFuncSetAttribute(ffma_chain_kernel<K, N>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, SMEM);
  if (err != cudaSuccess) return int(err);
  ffma_chain_kernel<K, N><<<grid, NTHREADS, SMEM, st>>>(
      static_cast<const float*>(a), static_cast<const float*>(w), static_cast<float*>(out), M);
  return int(cudaGetLastError());
}

}  // namespace

extern "C" {

// kind 0 = int8 -> int32, 1 = bf16 -> f32 (w given as `kernel_operand`
// writes it, [CHAIN][K bytes / 16][N][16 B]), 2 = f32 -> f32 (w as
// [CHAIN, K, N]). Returns a cudaError_t; an uninstantiated (K, N) or an M
// that is not a whole number of M-tiles gives cudaErrorInvalidValue.
int mma_probe_run(int kind, const void* a, const void* w, void* out, int grid, int M, int K,
                  int N, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (kind == 0) {
    if (K == 128 && N == 128) return launch_chain<I8, 128, 128, 2>(a, w, out, grid, M, st);
    if (K == 128 && N == 96) return launch_chain<I8, 128, 96, 2>(a, w, out, grid, M, st);
    if (K == 96 && N == 96) return launch_chain<I8, 96, 96, 2>(a, w, out, grid, M, st);
    if (K == 96 && N == 8) return launch_chain<I8, 96, 8, 4>(a, w, out, grid, M, st);
  } else if (kind == 1) {
    if (K == 128 && N == 128) return launch_chain<BF16, 128, 128, 2>(a, w, out, grid, M, st);
    if (K == 96 && N == 96) return launch_chain<BF16, 96, 96, 2>(a, w, out, grid, M, st);
  } else if (kind == 2) {
    if (K == 128 && N == 128) return launch_ffma<128, 128>(a, w, out, grid, M, st);
  }
  return int(cudaErrorInvalidValue);
}

// kind 0 = int8 (operands 0x01010101), 1 = bf16 (0x3f803f80, i.e. 1.0):
// `blocks` blocks of NTHREADS threads, out: [blocks * NTHREADS] of the
// accumulator type.
int mma_issue_run(int kind, void* out, int blocks, int iters, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (kind == 0)
    mma_issue_kernel<I8><<<blocks, NTHREADS, 0, st>>>(static_cast<int*>(out), iters, 0x01010101u);
  else if (kind == 1)
    mma_issue_kernel<BF16><<<blocks, NTHREADS, 0, st>>>(static_cast<float*>(out), iters,
                                                          0x3f803f80u);
  else
    return int(cudaErrorInvalidValue);
  return int(cudaGetLastError());
}

int mma_issue_threads() { return NTHREADS; }

int mma_issue_nacc() { return NACC; }

const char* qvrcnn_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
