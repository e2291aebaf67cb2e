"""Matrix-rate probe on one CUDA GPU: what `mma.sync` and FFMA reach.

    python -m qcnn_gpu_tpu_torch.tools.mma_probe

Counterpart of `scripts/mfu_probe.py` (`build`, :36-68). Each block of the
grid runs a chain of CHAIN = 16 dependent products acc += a @ (w[c] + s)
with a: [M = 2048, K], where s comes from acc[0, 0] of the previous step
(% 3 for integers, * 1e-30 for floats), and writes its own [M, N] slot
(`csrc/mma_probe.cu`). The seven cases are those of mfu_probe.py:96-107:
int8 -> int32 and bf16 -> f32 on the tensor cores (`mma.sync`), f32 ->
f32 in FFMA on the CUDA cores (no TF32, so "f32" means float32), at the
network's pass shapes (K, N) in {128, 96, 8}.

The JAX file's warning stands for the TPU: XLA factored and hoisted that
chain and its rates came out above the chip's peak, so they fed nothing.
Here CUDA compiles what is written: the kernel issues every product, and
a block barrier carries acc[0, 0] from one step to the next, so nothing
elides the chain. The operands are integers in [-4, 4] (w without 0, so
that w + s rounds back to w in the float cases), every case is exact, and
each is held bit for bit against its plain version before it is timed.

Beside the chain, `mma_issue` measures the instruction's own ceiling:
each warp of two blocks per SM issues ISSUE_ITERS rounds of NACC
independent `mma.sync` on register operands of all ones, with no memory
traffic; every thread's result is 4 * NACC * ISSUE_ITERS * k (k = 32 for
int8, 16 for bf16), which its plain version states. It is a measurement
of this card with no TPU counterpart, not a port of a TPU kernel.

Prints the card (nvidia-smi name and power limit), then per case the
exactness check at GRID = 2 and the rate at GRID = 32 (the JAX default)
and at a grid of one block per SM, in TOP/s beside the datasheet peak of
the H100 SXM (dense: 1,979 int8, 989 bf16, 67 f32 outside the tensor
cores), then the issue ceiling of int8 and bf16, and last one JSON line
with every figure. Needs a CUDA device and raises without one.
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
    smi,
)

KERNEL = "mma_probe"
CHAIN = 16
M = 2048
GRID = 32
M_TILE = 512  # the kernel's largest M-tile; M must be a multiple
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
    """Seeded operands: a [grid, m, k] in [-4, 4], w [CHAIN, k, n] in
    [-4, 4] without 0, of the case's operand type."""
    rng = np.random.default_rng(seed)
    a = rng.integers(-4, 5, size=(grid, m, k))
    w = rng.choice(np.array([-4, -3, -2, -1, 1, 2, 3, 4]), size=(CHAIN, k, n))
    dt = TYPES[kind][0]
    return (torch.as_tensor(a).to(dt).to(device), torch.as_tensor(w).to(dt).to(device))


def macs(a: torch.Tensor, w: torch.Tensor) -> int:
    grid, m, k = a.shape
    return grid * m * k * w.shape[2] * CHAIN


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
        if kind == "int8":
            s = acc[:, 0, 0] % 3
        else:
            s = acc[:, 0, 0] * torch.tensor(1e-30, dtype=torch.float32, device=a.device)
    return acc


def kernel_operand(w: torch.Tensor) -> torch.Tensor:
    """w as the kernel reads it: [CHAIN, n, k] for the tensor-core cases,
    [CHAIN, k, n] for f32."""
    return w if w.dtype == torch.float32 else w.transpose(1, 2).contiguous()


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


def check_case(kind: str, k: int, n: int, grid: int = 2, device="cuda") -> int:
    """Max |kernel - plain version| of one case at `grid` blocks."""
    a, w = probe_inputs(kind, k, n, grid=grid, device=device)
    got = mma_probe(a, w)
    torch.cuda.synchronize()
    want = mma_probe_reference(a, w)
    return int((got.to(torch.float64) - want.to(torch.float64)).abs().max())


def time_case(kind: str, k: int, n: int, grid: int, reps: int = 10, device="cuda") -> dict:
    """ms per launch and TOP/s (2 x MACs) of one case at `grid` blocks."""
    a, w = probe_inputs(kind, k, n, grid=grid, device=device)
    w_op = kernel_operand(w)
    mma_probe(a, w, w_op)
    ms = events_ms(lambda: mma_probe(a, w, w_op), reps)
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


def main() -> int:
    if not torch.cuda.is_available():
        raise RuntimeError("this probe needs a CUDA GPU")
    card = smi()
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    print(f"gpu: {card}, {sms} SMs")
    out = {"gpu": card, "M": M, "chain": CHAIN}
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
