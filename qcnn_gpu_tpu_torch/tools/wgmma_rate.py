"""Issue rate of int8 `wgmma` on one CUDA GPU, by N and warpgroups.

    python -m qcnn_gpu_tpu_torch.tools.wgmma_rate

A measurement of the card with no TPU counterpart (`csrc/wgmma_rate.cu`):
one block per SM, 1 to 4 warpgroups each, every warpgroup issuing ITERS
rounds of CHUNKS back-to-back `m64nNk32` as generation 3 issues a
block's chunks, A read from shared memory (SS, the fused kernel's layout)
or held in registers (RS, N = 16 only). All operands are 1, so every
accumulator must end at ITERS * CHUNKS * 32; the tool raises otherwise.

Prints the card, then per case and warpgroup count the clock cycles per
`wgmma` per SM (the SM issues the instructions of all its warpgroups) and
the MACs per cycle per SM beside 4,096, the H100 SXM's dense int8 rate
per SM (1,979 TOP/s over 132 SMs at 1,830 MHz), and last one JSON line.
Needs a CUDA device and raises without one.
"""

from __future__ import annotations

import ctypes
import json

import torch

from qcnn_gpu_tpu_torch.ops import build
from qcnn_gpu_tpu_torch.tools import smi

KERNEL = "wgmma_rate"
ITERS, CHUNKS = 1000, 16
CASES = ((8, False), (16, False), (48, False), (64, False), (96, False), (128, False),
         (16, True))  # (N, A in registers)
SM_MACS_PER_CLK = 4096
_ARGTYPES = [ctypes.c_int] * 5 + [ctypes.c_void_p] * 3


def measure(n: int, rs: bool, wgs: int) -> float:
    """Cycles per `wgmma` per SM, mean over the SMs."""
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    cycles = torch.zeros(sms, dtype=torch.int64, device="cuda")
    bad = torch.zeros(1, dtype=torch.int32, device="cuda")
    fn = build.function(KERNEL, "wgmma_rate", _ARGTYPES)
    stream = torch.cuda.current_stream().cuda_stream
    for iters in (2, ITERS):  # warm-up, then the measured launch
        build.check(KERNEL, fn(n, int(rs), wgs, sms, iters, cycles.data_ptr(),
                               bad.data_ptr(), stream))
    torch.cuda.synchronize()
    if int(bad.item()):
        raise RuntimeError(f"wgmma_rate N={n} rs={rs}: {int(bad.item())} threads summed wrong")
    return float(cycles.double().mean()) / (ITERS * CHUNKS * wgs)


def main() -> int:
    if not torch.cuda.is_available():
        raise RuntimeError("this measurement needs a CUDA GPU")
    card = smi()
    print(f"gpu: {card}")
    out = {"gpu": card, "iters": ITERS, "chunks": CHUNKS, "cases": []}
    for n, rs in CASES:
        clk = [measure(n, rs, wgs) for wgs in (1, 2, 3, 4)]
        macs = [64 * n * 32 / c for c in clk]
        out["cases"].append({"n": n, "a_in_registers": rs, "clk_per_wgmma": clk})
        print(f"{'RS' if rs else 'SS'} m64n{n}k32, exact: clk per wgmma per SM at 1-4 warpgroups "
              + ", ".join(f"{c:.2f}" for c in clk) + "; MACs/clk/SM "
              + ", ".join(f"{m:.0f}" for m in macs)
              + f" ({100 * macs[-1] / SM_MACS_PER_CLK:.1f}% of {SM_MACS_PER_CLK} at 4)")
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
