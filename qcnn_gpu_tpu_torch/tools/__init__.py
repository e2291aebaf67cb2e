"""Measurement tools for the port, run on a CUDA GPU, and what they
share: the card as nvidia-smi names it, CUDA-event timing (of launches,
or of a CUDA graph of them) and the int8 and float32 peaks that bounds
are taken against."""

from __future__ import annotations

import subprocess

from qcnn_gpu_tpu_torch.engine.mfu import PEAK_BF16_FLOPS, PEAK_INT8_OPS  # noqa: F401 (one constant)

PEAK_FP32_FLOPS = 67e12  # H100 SXM float32 outside the tensor cores, data sheet
PEAK_BYTES = 3.35e12  # H100 SXM HBM3, bytes/s, data sheet


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


def graph_timer(fn, reps: int):
    """A callable that returns the mean device ms per call of `fn` over
    `reps` calls captured once in a CUDA graph (call `fn` once before, to
    build and warm it). Replaying the graph takes the host's per-call cost
    out of the timing: a kernel shorter than its Python wrapper's enqueue
    is then timed, not the host. `fn` must not synchronise."""
    import torch

    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(reps):
            fn()
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)

    def timed() -> float:
        torch.cuda.synchronize()
        start.record()
        graph.replay()
        stop.record()
        torch.cuda.synchronize()
        return start.elapsed_time(stop) / reps

    timed.graph = graph  # kept alive with the callable
    return timed
