"""Matrix-rate probe on one CUDA GPU: what `wgmma` and FFMA reach in a chain.

    python -m qcnn_gpu_tpu_torch.tools.mma_probe

Counterpart of `scripts/mfu_probe.py` (`build`, :36-68). Each block of the
grid runs a chain of CHAIN = 16 dependent products acc += a @ (w[c] + s)
with a: [M = 2048, K], where s comes from acc[0, 0] of the previous step
(% 3 for integers, * 1e-30 for floats), and writes its own [M, N] slot
(`csrc/mma_probe.cu`). The seven cases are those of mfu_probe.py:96-107:
int8 -> int32 and bf16 -> f32 on the tensor cores (`wgmma`, A in
registers, each step's w + s staged into a ring of shared-memory buffers
by a producer warpgroup), f32 -> f32 in FFMA on the CUDA cores (no TF32,
so "f32" means float32), at the network's pass shapes (K, N) in {128, 96,
8}.

The JAX file's warning stands for the TPU: XLA factored and hoisted that
chain and its rates came out above the chip's peak, so they fed nothing.
Here CUDA compiles what is written: the kernel issues every product of
every step on its own w + s. The s values depend only on row 0 of a and
column 0 of the w's; the kernel derives them first from K-long dots
(`chain_scalars` is that prologue's plain mirror), which takes them off
the tensor cores' path without removing a product. The operands are
integers in [-4, 4] (w without 0, so that w + s rounds back to w in the
float cases), every case is exact, and each is held bit for bit against
its plain version before it is timed.

Beside the chain, `mma_issue` measures the `mma.sync` instruction's own
ceiling: each warp of two blocks per SM issues ISSUE_ITERS rounds of NACC
independent `mma.sync` on register operands of all ones, with no memory
traffic; every thread's result is 4 * NACC * ISSUE_ITERS * k (k = 32 for
int8, 16 for bf16), which its plain version states. It is a measurement
of this card with no TPU counterpart, not a port of a TPU kernel.

Prints the card (nvidia-smi name and power limit), then per case the
exactness check at GRID = 2 and the rate at GRID = 32 (the JAX default)
and at a grid of one block per SM, in TOP/s beside the datasheet peak of
the H100 SXM (dense: 1,979 int8, 989 bf16, 67 f32 outside the tensor
cores); beside each int8 case the `wgmma` issue rate at its N with both
operands in shared memory (`tools/wgmma_rate`, 2 and 4 warpgroups); for
int8 and bf16 at K = N = 128 the time of CHAIN library products of the
same shapes with no chain between them (`torch._int_mm`,
`torch.matmul`: a yardstick, not the same function); then the issue
ceiling of int8 and bf16, and last one JSON line with every figure.
Needs a CUDA device and raises without one.
"""

from __future__ import annotations

import ctypes
import json
from typing import Optional

import numpy as np
import torch

from qcnn_gpu_tpu_torch.ops import build
from qcnn_gpu_tpu_torch.tools import (
    PEAK_BF16_FLOPS,
    PEAK_FP32_FLOPS,
    PEAK_INT8_OPS,
    events_ms,
    graph_timer,
    smi,
    wgmma_rate,
)

KERNEL = "mma_probe"
CHAIN = 16
M = 2048
GRID = 32
M_TILE = 512  # the kernels' largest M-tile; M must be a multiple
# int8 K = N = 128 at this seed: block 0's acc[0, 0] goes below 0 with a
# remainder, where % 3 must follow Python's sign
NEGATIVE_SEED = 3
# (name, operand type, K, N): scripts/mfu_probe.py:96-107
CASES = (
    ("bf16_f32", "bf16", 128, 128),
    ("int8_i32", "int8", 128, 128),
    ("f32_f32", "f32", 128, 128),
    ("int8_k128_n96", "int8", 128, 96),
    ("int8_k96_n96", "int8", 96, 96),
    ("int8_k96_n8", "int8", 96, 8),
    ("bf16_k96_n96", "bf16", 96, 96),
)
# operand type -> (torch operand dtype, accumulator dtype, kernel kind id)
TYPES = {
    "int8": (torch.int8, torch.int32, 0),
    "bf16": (torch.bfloat16, torch.float32, 1),
    "f32": (torch.float32, torch.float32, 2),
}
PEAK_TOPS = {"int8": PEAK_INT8_OPS / 1e12, "bf16": PEAK_BF16_FLOPS / 1e12,  # H100 SXM, dense
             "f32": PEAK_FP32_FLOPS / 1e12}
_ARGTYPES = [ctypes.c_int] + [ctypes.c_void_p] * 3 + [ctypes.c_int] * 4 + [ctypes.c_void_p]
_ISSUE_ARGTYPES = [ctypes.c_int, ctypes.c_void_p, ctypes.c_int, ctypes.c_int, ctypes.c_void_p]
# the issue-rate kernel: threads per block, accumulators per warp, MMA depth
ISSUE_THREADS, NACC, ISSUE_ITERS = 256, 16, 4096
ISSUE_K = {"int8": 32, "bf16": 16}


def _kind(t: torch.Tensor) -> str:
    for name, (dt, _, _) in TYPES.items():
        if t.dtype == dt:
            return name
    raise ValueError(f"no probe case for operand type {t.dtype}")


def probe_inputs(kind: str, k: int, n: int, grid: int = GRID, m: int = M, seed: int = 0,
                 *, device):
    """Seeded operands: w [CHAIN, k, n] in [-4, 4] without 0, then a
    [grid, m, k] in [-4, 4], of the case's operand type (w drawn first, so
    that w and block 0's row 0 do not depend on grid or m)."""
    rng = np.random.default_rng(seed)
    w = rng.choice(np.array([-4, -3, -2, -1, 1, 2, 3, 4]), size=(CHAIN, k, n))
    a = rng.integers(-4, 5, size=(grid, m, k))
    dt = TYPES[kind][0]
    return (torch.as_tensor(a).to(dt).to(device), torch.as_tensor(w).to(dt).to(device))


def macs(a: torch.Tensor, w: torch.Tensor) -> int:
    grid, m, k = a.shape
    return grid * m * k * w.shape[2] * CHAIN


def _derive(acc00: torch.Tensor, kind: str) -> torch.Tensor:
    if kind == "int8":
        return acc00 % 3  # Python's sign: in [0, 2]
    return acc00 * torch.tensor(1e-30, dtype=torch.float32, device=acc00.device)


def mma_probe_reference(a: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch version: [grid, m, k] x [CHAIN, k, n] -> [grid, m, n]
    in the accumulator type. Products run in float64 (exact for these
    integers); s and w + s are formed in the accumulator type, as the
    kernel forms them."""
    kind = _kind(a)
    acc_dt = TYPES[kind][1]
    grid, m, _ = a.shape
    acc = torch.zeros((grid, m, w.shape[2]), dtype=acc_dt, device=a.device)
    s = torch.zeros(grid, dtype=acc_dt, device=a.device)
    a64 = a.to(torch.float64)
    for c in range(CHAIN):
        wc = (w[c].to(acc_dt)[None] + s[:, None, None]).to(w.dtype)
        acc = acc + torch.bmm(a64, wc.to(torch.float64)).to(acc_dt)
        s = _derive(acc[:, 0, 0], kind)
    return acc


def chain_scalars(a0: torch.Tensor, w: torch.Tensor):
    """The kernel's prologue, plain: from row 0 of each block's a (a0:
    [grid, k]) and column 0 of each w[c] alone, K-long dots in the
    accumulator type. Returns s [grid, CHAIN] (the value step c adds to
    w[c]) and acc[0, 0] [grid, CHAIN] after each step."""
    kind = _kind(a0)
    acc_dt = TYPES[kind][1]
    s = torch.zeros(a0.shape[0], dtype=acc_dt, device=a0.device)
    acc00 = torch.zeros_like(s)
    used, sums = [], []
    a64 = a0.to(torch.float64)
    for c in range(CHAIN):
        used.append(s)
        wc0 = (w[c, :, 0].to(acc_dt)[None] + s[:, None]).to(w.dtype)
        acc00 = acc00 + (a64 * wc0.to(torch.float64)).sum(1).to(acc_dt)
        sums.append(acc00)
        s = _derive(acc00, kind)
    return torch.stack(used, 1), torch.stack(sums, 1)


def kernel_operand(w: torch.Tensor) -> torch.Tensor:
    """w as the kernel reads it. Tensor-core cases: [CHAIN, k bytes / 16,
    n, 16 / itemsize], each step's B in 16-byte planes of K (`wgmma`'s
    K-major core matrices: plane p holds bytes 16p .. 16p + 15 of every
    column of w[c]), so that the producer copies it as it lies; f32:
    [CHAIN, k, n] as given."""
    if w.dtype == torch.float32:
        return w
    chain, k, n = w.shape
    per = 16 // w.element_size()  # elements in 16 bytes
    return w.transpose(1, 2).reshape(chain, n, k // per, per).transpose(1, 2).contiguous()


def mma_probe(a: torch.Tensor, w: torch.Tensor, w_op: Optional[torch.Tensor] = None):
    """The chain on the card: one launch of csrc/mma_probe.cu (counted in
    `mma_probe.launches`) for CUDA tensors, the plain version for CPU
    tensors. `w_op` is `kernel_operand(w)`, when the caller has it."""
    if a.dim() != 3 or w.dim() != 3 or w.shape[0] != CHAIN or a.shape[2] != w.shape[1]:
        raise ValueError(f"expected a [grid, m, k] and w [{CHAIN}, k, n], got "
                         f"{tuple(a.shape)} and {tuple(w.shape)}")
    if a.dtype != w.dtype or a.device != w.device:
        raise ValueError("a and w must share type and device")
    if a.device.type == "cpu":
        return mma_probe_reference(a, w)
    kind = _kind(a)
    grid, m, k = a.shape
    n = w.shape[2]
    if m % M_TILE:
        raise ValueError(f"m must be a multiple of {M_TILE}, got {m}")
    w_op = kernel_operand(w) if w_op is None else w_op
    if not (a.is_contiguous() and w_op.is_contiguous()):
        raise ValueError("operands must be contiguous")
    out = torch.empty((grid, m, n), dtype=TYPES[kind][1], device=a.device)
    fn = build.function(KERNEL, "mma_probe_run", _ARGTYPES)
    with torch.cuda.device(a.device):
        err = fn(TYPES[kind][2], a.data_ptr(), w_op.data_ptr(), out.data_ptr(),
                 grid, m, k, n, build.stream_of(a))
    build.check(KERNEL, err)
    if not torch.cuda.is_current_stream_capturing():  # a captured call launches at replay
        mma_probe.launches += 1
    return out


mma_probe.launches = 0


def issue_macs(kind: str, blocks: int, iters: int = ISSUE_ITERS) -> int:
    """MACs of one mma_issue launch: m16n8 x k per MMA."""
    return blocks * (ISSUE_THREADS // 32) * NACC * iters * 16 * 8 * ISSUE_K[kind]


def mma_issue_reference(kind: str, blocks: int, iters: int = ISSUE_ITERS,
                        *, device) -> torch.Tensor:
    """Plain version of mma_issue: every thread's sum of its 4 * NACC
    accumulators, each ITERS * k."""
    return torch.full((blocks * ISSUE_THREADS,), 4 * NACC * iters * ISSUE_K[kind],
                      dtype=TYPES[kind][1], device=device)


def mma_issue(kind: str, blocks: int, iters: int = ISSUE_ITERS, device="cuda") -> torch.Tensor:
    """One launch of the issue-rate kernel (counted in `mma_issue.launches`)
    on a CUDA device; the plain version on the CPU."""
    if kind not in ISSUE_K:
        raise ValueError(f"no issue-rate kernel for {kind!r}")
    device = torch.device(device)
    if device.type == "cpu":
        return mma_issue_reference(kind, blocks, iters, device=device)
    out = torch.empty(blocks * ISSUE_THREADS, dtype=TYPES[kind][1], device=device)
    fn = build.function(KERNEL, "mma_issue_run", _ISSUE_ARGTYPES)
    with torch.cuda.device(device):
        err = fn(TYPES[kind][2], out.data_ptr(), blocks, iters, build.stream_of(out))
    build.check(KERNEL, err)
    mma_issue.launches += 1
    return out


mma_issue.launches = 0


def check_case(kind: str, k: int, n: int, grid: int = 2, seed: int = 0, device="cuda") -> int:
    """Max |kernel - plain version| of one case at `grid` blocks."""
    a, w = probe_inputs(kind, k, n, grid=grid, seed=seed, device=device)
    got = mma_probe(a, w)
    torch.cuda.synchronize()
    want = mma_probe_reference(a, w)
    return int((got.to(torch.float64) - want.to(torch.float64)).abs().max())


def time_case(kind: str, k: int, n: int, grid: int, reps: int = 10, device="cuda") -> dict:
    """ms per launch (the least of 3 CUDA-graph replays of `reps` launches)
    and TOP/s (2 x MACs) of one case at `grid` blocks. The replays'
    launches are counted in `mma_probe.launches` as they are made."""
    a, w = probe_inputs(kind, k, n, grid=grid, device=device)
    w_op = kernel_operand(w)
    mma_probe(a, w, w_op)
    # a launch can be as short as ~20 us: time the device, not the wrapper's enqueue
    timed = graph_timer(lambda: mma_probe(a, w, w_op), reps)
    replays = []
    for _ in range(3):
        replays.append(timed())
        mma_probe.launches += reps
    ms = min(replays)
    tops = 2 * macs(a, w) / (ms * 1e-3) / 1e12
    return {"grid": grid, "ms": ms, "tops": tops, "peak_share": tops / PEAK_TOPS[kind]}


def time_issue(kind: str, blocks: int, reps: int = 5, device="cuda") -> dict:
    """Exactness, ms per launch and TOP/s of the issue-rate kernel."""
    got = mma_issue(kind, blocks, device=device)
    torch.cuda.synchronize()
    if not torch.equal(got, mma_issue_reference(kind, blocks, device=device)):
        raise RuntimeError(f"issue-rate kernel {kind}: wrong sums")
    ms = events_ms(lambda: mma_issue(kind, blocks, device=device), reps)
    tops = 2 * issue_macs(kind, blocks) / (ms * 1e-3) / 1e12
    return {"blocks": blocks, "ms": ms, "tops": tops, "peak_share": tops / PEAK_TOPS[kind]}


def library_products(kind: str, k: int, n: int, grid: int, reps: int = 10,
                     device="cuda") -> dict:
    """ms and TOP/s of CHAIN library products [grid * M, k] x [k, n] on the
    case's operands (`torch._int_mm` for int8, `torch.matmul` for bf16),
    one after another with no chain between them: a yardstick of the same
    MACs, not the same function."""
    a, w = probe_inputs(kind, k, n, grid=grid, device=device)
    a2 = a.reshape(grid * M, k)
    if kind == "int8":
        bt = w.transpose(1, 2).contiguous()  # _int_mm takes B column-major

        def run():
            for c in range(CHAIN):
                torch._int_mm(a2, bt[c].t())
    else:
        def run():
            for c in range(CHAIN):
                torch.matmul(a2, w[c])
    run()
    ms = events_ms(run, reps)
    tops = 2 * macs(a, w) / (ms * 1e-3) / 1e12
    return {"grid": grid, "ms": ms, "tops": tops, "peak_share": tops / PEAK_TOPS[kind]}


def wgmma_ss(n: int) -> dict:
    """`tools/wgmma_rate`'s int8 m64n{n}k32 with both operands in shared
    memory: cycles per instruction per SM at 2 and 4 warpgroups, and the
    MACs per cycle per SM at 4 against the H100's 4,096."""
    clk = {wgs: wgmma_rate.measure(n, False, wgs) for wgs in (2, 4)}
    return {"n": n, "clk_per_wgmma": clk,
            "peak_share": 64 * n * 32 / clk[4] / wgmma_rate.SM_MACS_PER_CLK}


def main() -> int:
    if not torch.cuda.is_available():
        raise RuntimeError("this probe needs a CUDA GPU")
    card = smi()
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    print(f"gpu: {card}, {sms} SMs")
    out = {"gpu": card, "M": M, "chain": CHAIN}
    ss = {}
    for name, kind, k, n in CASES:
        err = check_case(kind, k, n)
        if err:
            raise RuntimeError(f"{name}: kernel differs from its plain version by {err}")
        rates = [time_case(kind, k, n, g) for g in (GRID, sms)]
        out[name] = {"max_abs_err": err, "rates": rates}
        print(f"{name} (K={k}, N={n}): exact; "
              + "; ".join(f"grid {r['grid']}: {r['ms']:.4f} ms, {r['tops']:.1f} TOP/s "
                          f"({100 * r['peak_share']:.1f}% of {PEAK_TOPS[kind]:.0f})"
                          for r in rates))
        if kind == "int8":
            if n not in ss:
                ss[n] = wgmma_ss(n)
            out[name]["wgmma_ss"] = ss[n]
            clk = ss[n]["clk_per_wgmma"]
            print(f"  beside it, wgmma SS m64n{n}k32 (tools/wgmma_rate): {clk[2]:.2f} clk per "
                  f"instruction per SM at 2 warpgroups, {clk[4]:.2f} at 4 "
                  f"({100 * ss[n]['peak_share']:.1f}% of 4096 MACs/clk/SM)")
        if k == n == 128 and kind in ("int8", "bf16"):
            lib = library_products(kind, k, n, sms)
            out[name]["library_products"] = lib
            print(f"  yardstick, {CHAIN} library products alone, no chain "
                  f"({'torch._int_mm' if kind == 'int8' else 'torch.matmul'} "
                  f"[{sms * M}, {k}] x [{k}, {n}]): {lib['ms']:.4f} ms, {lib['tops']:.1f} TOP/s")
    for kind in ISSUE_K:
        issue = time_issue(kind, 2 * sms)
        out[f"issue_{kind}"] = issue
        print(f"issue ceiling {kind} (mma.sync, register operands, {2 * sms} blocks x "
              f"{ISSUE_THREADS // 32} warps x {NACC} accumulators): exact; {issue['ms']:.4f} ms, "
              f"{issue['tops']:.1f} TOP/s ({100 * issue['peak_share']:.1f}% of "
              f"{PEAK_TOPS[kind]:.0f})")
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
