"""The wide restoration CNN on one CUDA GPU: the port's counterpart of
`scripts/bench_wide.py` (BASELINE config 5).

    python -m qcnn_gpu_tpu_torch.tools.bench_wide [channels] [blocks] [h] [w]

Defaults: 256 channels, 10 body convs, 480x832. A pixel costs
9 * (C + blocks * C^2 + C) MACs: 5,902,848 at the defaults, 2.357 TMAC for
one 832x480 frame, from 5,902,848 int8 weights (the JAX script's
docstring says ~2.8 TMAC and ~5.3M weights; its own formula gives these).

First the reduced-width twin (c32 b3, one 48x64 frame) through the card
program (`models/wide.make_wide_forward`: im2col + `_int_mm`, int32
epilogues) against the port's plain version (float64-exact convolutions,
int64 epilogues) on the card; then the full-scale net on bench_wide's
batch, max(1, 60e6 / (h * w)) frames (the forward runs them in chunks),
timed with CUDA events over 8 calls after one warm-up call. Prints one
JSON line with the JAX script's keys, unrounded ("backend" names the
card); the card's name and power limit and the bound at the int8 dense
peak go on a line before it.

`route_split` splits the device time of a call of that forward by part
(im2col, GEMM, band assembly, epilogue) from a `torch.profiler` trace of
it, by the program span that launched each kernel and copy
(`qcnn_gpu_tpu_torch/spans.py`), for the smoke run and the ROADMAP's
fused implicit-GEMM item. `epilogue_ms` times a hidden layer's one-pass
bias and requant kernel (`ops/requant.bias_blu_requant_i8`) alone at a
frame's shape, beside its bound and its plain version.
"""

from __future__ import annotations

import json
import sys

import torch

from qcnn_gpu_tpu_torch import spans
from qcnn_gpu_tpu_torch.models import wide as W
from qcnn_gpu_tpu_torch.ops.requant import bias_blu_requant_i8, blu_requant_clamped_i32
from qcnn_gpu_tpu_torch.testing import synth_frames
from qcnn_gpu_tpu_torch.tools import PEAK_BYTES, PEAK_INT8_OPS, events_ms, smi

REPS = 8
# route_split's parts: the program spans whose device time each sums
PARTS = {
    "im2col": (spans.CONV_IM2COL,),
    "gemm": (spans.CONV_GEMM,),
    "assemble": (spans.CONV_ASSEMBLE,),
    "epilogue": (spans.CONV_BIAS, spans.WIDE_INPUT, spans.WIDE_REQUANT, spans.WIDE_RESIDUAL),
}


def macs_per_pixel(channels: int, blocks: int) -> int:
    return 9 * (channels + channels * channels * blocks + channels)


def batch_for(h: int, w: int) -> int:
    """bench_wide's batch rule."""
    return max(1, int(60e6 / (h * w)))


def route_split(p: W.WideParams, x_uint8: torch.Tensor, reps: int = 3):
    """ms of device time of one call of `make_wide_forward`'s card program
    on x_uint8 [N, H, W] on a CUDA device, by part: {"im2col": pad + the
    tap copy, "gemm": `_int_mm`, "assemble": the bands' accumulators
    copied into a layer's output (0 where each layer takes one band),
    "epilogue": bias, the input's centring, requant and the tail's
    residual and its add, "other": what no part's span launched}, summed
    over the layers, the mean of `reps` calls traced by `torch.profiler`
    after a warm-up. A kernel or copy counts in the part whose span
    launched it (`spans.device_seconds`), so the parts add up to the
    calls' device time."""
    run = W.make_wide_forward(p, device=x_uint8.device)
    run(x_uint8)  # warm-up
    torch.cuda.synchronize()
    acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        for _ in range(reps):
            run(x_uint8)
        torch.cuda.synchronize()
    by_span = spans.device_seconds(prof)
    out = {part: sum(by_span.pop(n, 0.0) for n in names) * 1e3 / reps
           for part, names in PARTS.items()}
    out["other"] = sum(by_span.values()) * 1e3 / reps
    return out


def epilogue_ms(h: int = 480, w: int = 832, channels: int = 256, reps: int = 20) -> dict:
    """One hidden layer's bias and requant on one frame's int32
    accumulators [1, h, w, channels] on the card (seeded values around a
    solved layer's [0, blu_q], that layer's bias and row): CUDA-event ms a
    call of the kernel and of its plain version (`blu_requant_clamped_i32`
    of u + b), in turns (kernel, plain, plain, kernel) after a warm-up,
    each the mean of `reps` calls, and the kernel's bound, its bytes (4 in
    and 1 out a value) at the card's memory rate. Raises unless both give
    the same bytes."""
    dev = torch.device("cuda")
    p = W.synth_wide_params(channels=channels, blocks=1, seed=7)
    row = W.int32_table(p)[1]
    b = torch.as_tensor(p.biases[1], device=dev)
    g = torch.Generator(device=dev).manual_seed(11)
    u = torch.randint(-row[0] // 2, 2 * row[0], (1, h, w, channels), dtype=torch.int32,
                      device=dev, generator=g)
    fns = {"kernel": lambda: bias_blu_requant_i8(u, b, *row),
           "plain": lambda: blu_requant_clamped_i32(u + b, *row)}
    if not torch.equal(fns["kernel"](), fns["plain"]()):
        raise RuntimeError("the requant epilogue kernel differs from its plain version")
    got = {"kernel": [], "plain": []}
    for name in ("kernel", "plain", "plain", "kernel"):
        got[name].append(events_ms(fns[name], reps))
    return {"ms": sum(got["kernel"]) / 2, "plain_ms": sum(got["plain"]) / 2,
            "bound_ms": u.numel() * 5 / PEAK_BYTES * 1e3, "shape": list(u.shape)}


def bench(channels: int = 256, blocks: int = 10, h: int = 480, w: int = 832,
          reps: int = REPS) -> dict:
    """The small twin's exactness, then the full-scale timing over `reps`
    calls: the JSON record (the JAX script's keys)."""
    dev = torch.device("cuda")
    p_small = W.synth_wide_params(channels=32, blocks=3, seed=5)
    xs = torch.from_numpy(synth_frames(1, 48, 64, seed=6)).to(dev)
    exact = bool(torch.equal(W.make_wide_forward(p_small, device=dev)(xs),
                             W.forward_wide(xs, p_small)))
    p = W.synth_wide_params(channels=channels, blocks=blocks, seed=7)
    run = W.make_wide_forward(p, device=dev)
    batch = batch_for(h, w)
    x = torch.from_numpy(synth_frames(batch, h, w, seed=8)).to(dev)
    run(x)  # warm-up: cuBLASLt's choices, the allocator
    ms = events_ms(lambda: run(x), reps) / batch
    macs = h * w * macs_per_pixel(channels, blocks)
    return {
        "model": f"wide c{channels} b{blocks}",
        "geometry": f"{h}x{w}",
        "batch": batch,
        "ms_per_frame": ms,
        "fps": 1000.0 / ms,
        "tmac_per_frame": macs / 1e12,
        "int8_tops": macs * 2 / (ms / 1000) / 1e12,
        "small_twin_exact_vs_oracle": exact,
        "backend": f"cuda: {torch.cuda.get_device_name(0)}",
    }


def main(channels=256, blocks=10, h=480, w=832) -> int:
    channels, blocks, h, w = int(channels), int(blocks), int(h), int(w)
    if not torch.cuda.is_available():
        raise RuntimeError("this benchmark needs a CUDA GPU")
    card = smi()
    bound = 2 * h * w * macs_per_pixel(channels, blocks) / PEAK_INT8_OPS * 1e3
    print(f"gpu: {card}; bound {bound:.4f} ms/frame at the int8 dense peak")
    rec = bench(channels, blocks, h, w)
    print(json.dumps(rec))
    return 0 if rec["small_twin_exact_vs_oracle"] else 1


if __name__ == "__main__":
    sys.exit(main(*sys.argv[1:]))
