"""Where the time of the port's main path goes, on one CUDA GPU.

    python -m qcnn_gpu_tpu_torch.tools.profile

Restores 16 seeded random 1920x1080 frames with the committed QP37 model,
batch 4, through `Engine.restore_stream` (the span that
`Engine.run_sequence` times, copies included) and prints, one item per
line:

  gpu              nvidia-smi's name, power limit and SM clock
  e2e              restore_stream ms/frame of each of 5 runs after warm-up
  split            the same batched loop with every step synchronised, in
                   ms/frame: H2D copy, kernel, D2H copy, host (numpy, Python)
  profiler table   torch.profiler over one restore_stream, then the device
                   time of the kernel and of the copies against the host window
  h2d              pageable and pinned host->device rate of one batch, GB/s
  kernel           fused-kernel ms/frame (CUDA events) at the six reference
                   geometries, 416x240 to 3840x2160, beside its bound (useful
                   MACs over the int8 peak) and its useful TOP/s
  gpu after        SM clock and power draw right after the timing loops

Needs a CUDA device and raises without one.
"""

from __future__ import annotations

import os
import time

import numpy as np
import torch

from qcnn_gpu_tpu_torch.engine.runner import Engine, read_model
from qcnn_gpu_tpu_torch.models.topology import MACS_PER_PIXEL
from qcnn_gpu_tpu_torch.ops.fused import FusedWeights, fused_forward
from qcnn_gpu_tpu_torch.tools import PEAK_INT8_OPS, events_ms, smi

_REPO = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
MODEL = os.path.join(_REPO, "assets", "golden", "model_q37.data")
QP = 37
H, W, N, BATCH, REPS, SEED = 1080, 1920, 16, 4, 5, 0
# (height, width, frames per call): the reference's six geometries
GEOMETRIES = ((240, 416, 16), (480, 832, 8), (720, 1280, 4), (1080, 1920, 4), (1600, 2560, 2),
              (2160, 3840, 1))


def _frames(n: int, h: int, w: int, seed: int) -> np.ndarray:
    return np.random.default_rng(seed).integers(0, 256, size=(n, h, w), dtype=np.uint8)


def split(frames: np.ndarray, fw: FusedWeights, batch: int, dev) -> dict:
    """restore_stream's loop with a synchronise after every step."""
    t = dict(h2d=0.0, kernel=0.0, d2h=0.0, host=0.0)
    out = np.empty_like(frames)
    for i in range(0, frames.shape[0], batch):
        t0 = time.perf_counter()
        xb = torch.from_numpy(np.ascontiguousarray(frames[i : i + batch]))
        t1 = time.perf_counter()
        xd = xb.to(dev)
        torch.cuda.synchronize()
        t2 = time.perf_counter()
        y = fused_forward(xd, fw)
        torch.cuda.synchronize()
        t3 = time.perf_counter()
        yh = y.cpu()
        t4 = time.perf_counter()
        out[i : i + yh.shape[0]] = yh.numpy()
        t5 = time.perf_counter()
        t["h2d"] += t2 - t1
        t["kernel"] += t3 - t2
        t["d2h"] += t4 - t3
        t["host"] += (t1 - t0) + (t5 - t4)
    return {k: v * 1e3 / frames.shape[0] for k, v in t.items()}


def main() -> int:
    if not torch.cuda.is_available():
        raise RuntimeError("this profile needs a CUDA GPU")
    dev = torch.device("cuda")
    print(f"gpu: {smi('name,power.limit,clocks.sm')}")

    params = read_model(MODEL)
    eng = Engine(device=dev, impl="kernel", batch_frames=BATCH)
    eng.set_model(QP, params)
    frames = _frames(N, H, W, SEED)
    eng.warmup(QP, H, W, N)

    e2e = []
    for _ in range(REPS):
        t0 = time.perf_counter()
        eng.restore_stream(frames, QP)
        e2e.append((time.perf_counter() - t0) * 1e3 / N)
    print(f"e2e restore_stream {N}x{H}x{W} batch {BATCH} ms/frame "
          f"({REPS} runs): {[round(v, 4) for v in e2e]}")

    fw = FusedWeights.from_engine(params, dev)
    passes = [split(frames, fw, BATCH, dev) for _ in range(3)]
    mean = {k: sum(p[k] for p in passes) / len(passes) for k in passes[0]}
    print("split ms/frame (synchronised, 3 passes): "
          + ", ".join(f"{k} {v:.4f}" for k, v in mean.items()))

    acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        t0 = time.perf_counter()
        eng.restore_stream(frames, QP)
        torch.cuda.synchronize()
        window_us = (time.perf_counter() - t0) * 1e6
    rows = prof.key_averages()
    print(rows.table(sort_by="self_device_time_total", row_limit=12))

    def device_us(match):
        return sum(e.self_device_time_total for e in rows if match in e.key)

    kern = device_us("qvrcnn_fused_kernel")
    h2d, d2h = device_us("Memcpy HtoD"), device_us("Memcpy DtoH")
    print(f"profiler {N} frames: host window {window_us:.1f} us; device kernel "
          f"{kern:.1f} us ({100 * kern / window_us:.1f}%), H2D {h2d:.1f} us, "
          f"D2H {d2h:.1f} us; kernel + copies {100 * (kern + h2d + d2h) / window_us:.1f}% "
          "of the window")

    host = torch.from_numpy(frames[:BATCH].copy())
    pinned = host.pin_memory()
    dst = torch.empty(host.shape, dtype=host.dtype, device=dev)
    for name, src in (("pageable", host), ("pinned", pinned)):
        dst.copy_(src, non_blocking=True)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(20):
            dst.copy_(src, non_blocking=True)
        torch.cuda.synchronize()
        gbs = 20 * host.numel() / (time.perf_counter() - t0) / 1e9
        print(f"h2d {name}: {gbs:.2f} GB/s ({host.numel()} B per copy)")

    for gh, gw, gn in GEOMETRIES:
        xd = torch.from_numpy(_frames(gn, gh, gw, SEED + 1)).to(dev)
        for _ in range(3):
            fused_forward(xd, fw)
        ms = events_ms(lambda: fused_forward(xd, fw), 20) / gn
        ops = 2 * MACS_PER_PIXEL * gh * gw
        print(f"kernel {gn}x{gh}x{gw}: {ms:.4f} ms/frame, bound {ops / PEAK_INT8_OPS * 1e3:.4f}, "
              f"useful {ops / ms / 1e9:.1f} TOP/s")
    print(f"gpu after: {smi('clocks.sm,power.draw')}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
