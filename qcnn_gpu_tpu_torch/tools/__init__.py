"""Measurement tools for the port, run on a CUDA GPU, and what they
share: the card as nvidia-smi names it, CUDA-event timing and the int8
and float32 peaks that bounds are taken against."""

from __future__ import annotations

import subprocess

PEAK_INT8_OPS = 1979e12  # H100 SXM dense int8, data sheet
PEAK_FP32_FLOPS = 67e12  # H100 SXM float32 outside the tensor cores, data sheet


def smi(fields: str = "name,power.limit") -> str:
    """`nvidia-smi --query-gpu=<fields> --format=csv,noheader` of the first card."""
    return subprocess.run(
        ["nvidia-smi", f"--query-gpu={fields}", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip().splitlines()[0]


def events_ms(fn, reps: int) -> float:
    """Mean ms per call over `reps` calls of `fn`, CUDA events around the
    run (warm up before calling)."""
    import torch

    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(reps):
        fn()
    stop.record()
    torch.cuda.synchronize()
    return start.elapsed_time(stop) / reps
