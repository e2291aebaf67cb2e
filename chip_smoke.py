#!/usr/bin/env python3
"""Smoke run of the PyTorch port (qcnn_gpu_tpu_torch) on one NVIDIA GPU.

    python3 chip_smoke.py

Run from the root of a checkout on a machine with a CUDA GPU, `nvcc` and
a CUDA build of PyTorch. It imports torch, numpy and the port only. It
builds the fused-network kernel from qcnn_gpu_tpu_torch/csrc, holds it
bit for bit against its plain PyTorch version, holds the plain version
against the port's literal 6-conv reference graph (which the CPU tests
hold bit-equal to the numpy oracle), drives the main path
(`qcnn_gpu_tpu_torch.cli run` on 16 synthetic 1920x1080 frames with the
committed QP37 model) and times kernel and plain version at 1080p. No
phase catches an error: any failure exits non-zero. Without a GPU, or
without the rest of the repository, it exits non-zero and prints no
result.

Output, one item per line: the GPU's name and power limit (nvidia-smi),
the build time, every comparison, the main path's PSNR and time, the
timings; then a JSON line {"kernels": [...]} and, last, the JSON line
{"ok": true, "device": {...}}.
"""

from __future__ import annotations

import dataclasses
import json
import math
import os
import subprocess
import sys
import tempfile
import time

HERE = os.path.dirname(os.path.abspath(__file__))
GOLDEN = os.path.join(HERE, "assets", "golden")
KERNEL_SOURCE = "qcnn_gpu_tpu_torch/csrc/qvrcnn_fused.cu"
REPLACES = "qcnn_gpu_tpu/ops/pallas_pipeline3.py:319"  # _kernel3_body
H, W = 1080, 1920


def fail(msg: str) -> None:
    print(f"FAIL: {msg}", file=sys.stderr)
    sys.exit(1)


def frames(n: int, h: int, w: int, seed: int):
    """Seeded video-like uint8 frames [n, h, w]: smooth gradients + noise."""
    import numpy as np

    rng = np.random.default_rng(seed)
    yy, xx = np.mgrid[0:h, 0:w]
    base = (128 + 60 * np.sin(yy / 37.0) + 50 * np.cos(xx / 53.0))[None]
    return np.clip(base + rng.normal(0, 12, size=(n, h, w)), 0, 255).astype(np.uint8)


def shuffled(p, seed: int):
    """A seeded synthetic model: each layer's weights permuted over taps x
    input channels within every output channel. Per-channel L1 norms, and
    so every exactness and int32 bound, stay those of the model `p`."""
    import numpy as np

    rng = np.random.default_rng(seed)
    ws = tuple(
        rng.permuted(w.reshape(-1, w.shape[-1]), axis=0).reshape(w.shape) for w in p.weights
    )
    return dataclasses.replace(p, weights=ws)


def write_yuv420(path: str, y) -> None:
    """uint8 luma [n, h, w] -> YUV 4:2:0 file with constant chroma."""
    import numpy as np

    n, h, w = y.shape
    planes = np.full((n, h * w * 3 // 2), 128, np.uint8)
    planes[:, : h * w] = y.reshape(n, -1)
    planes.tofile(path)


def read_y420(path: str, n: int, h: int, w: int):
    import numpy as np

    raw = np.fromfile(path, np.uint8)
    if raw.size != n * h * w * 3 // 2:
        fail(f"{path}: {raw.size} bytes, expected {n} frames of {h}x{w} YUV 4:2:0")
    return raw.reshape(n, -1)[:, : h * w].reshape(n, h, w)


def cuda_time_ms(fn, reps: int) -> float:
    """Mean ms per call over `reps` calls, CUDA events around the run."""
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


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is False: this smoke run needs a CUDA GPU")
    sys.path.insert(0, HERE)
    import numpy as np

    from qcnn_gpu_tpu_torch import cli
    from qcnn_gpu_tpu_torch.engine.runner import read_model
    from qcnn_gpu_tpu_torch.models.qvrcnn import make_forward
    from qcnn_gpu_tpu_torch.ops import build
    from qcnn_gpu_tpu_torch.ops.fused import (
        KERNEL,
        FusedWeights,
        fused_forward,
        fused_forward_reference,
    )

    # ---- phase 1: the card, and the kernel build from the repo's sources
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip().splitlines()[0]
    card = f"[{smi}]"
    print(f"gpu: {smi}")
    print(f"torch {torch.__version__} cuda {torch.version.cuda}, {torch.cuda.get_device_name(0)}")
    t0 = time.perf_counter()
    build.library(KERNEL)
    info = build.build_info[KERNEL]
    print(f"nvcc build of {KERNEL_SOURCE}: {info['seconds']:.2f} s "
          f"(load incl. {time.perf_counter() - t0:.2f} s)")
    for line in info["log"].splitlines():
        if "registers" in line or "spill" in line:
            print("  ptxas:", line.strip())
    dev = torch.device("cuda")

    # ---- phase 2: kernel == plain version, bit for bit, on the card
    p37 = read_model(os.path.join(GOLDEN, "model_q37.data"))
    models = {
        "golden-QP22": read_model(os.path.join(GOLDEN, "model_q22.data")),
        "golden-QP37": p37,
        "golden-QP22-int4-pc": read_model(os.path.join(GOLDEN, "model_q22_int4.data"), "pc"),
        "shuffled-QP37-seed0": shuffled(p37, seed=0),
    }
    cases = []
    for geo in ((1, 37, 53), (2, 13, 245), (3, 240, 416), (2, H, W)):
        for name in models:
            cases.append((name, geo, "synth", ()))
    for name in ("golden-QP37", "golden-QP22-int4-pc"):
        cases += [(name, (2, 240, 416), "zeros", ()), (name, (2, 240, 416), "255", ())]
        cases.append((name, (2, 240, 416), "synth", (7, 229, 3, 401)))
    fws = {name: FusedWeights.from_engine(p, dev) for name, p in models.items()}
    max_err = 0
    for name, geo, kind, bounds in cases:
        if kind == "synth":
            x = frames(*geo, seed=sum(geo))
        else:
            x = np.full(geo, 0 if kind == "zeros" else 255, np.uint8)
        xd = torch.from_numpy(x).to(dev)
        got = fused_forward(xd, fws[name], *bounds)
        torch.cuda.synchronize()
        want = fused_forward_reference(xd, fws[name], *bounds)
        if got.shape != xd.shape or got.dtype != torch.uint8:
            fail(f"kernel output {got.dtype} {tuple(got.shape)} for input {tuple(xd.shape)}")
        err = int((got.to(torch.int16) - want.to(torch.int16)).abs().max())
        max_err = max(max_err, err)
        print(f"kernel vs plain {name} {geo} {kind} bounds={bounds or 'frame'}: "
              f"max_abs_err={err}")
        if err != 0:
            fail(f"kernel differs from its plain version: {name} {geo} {kind} {bounds}")

    # ---- phase 3: plain version on the card == literal reference graph
    # (6 convs, 2 concats, literal BLU; on the CPU, where the tests hold it
    # bit-equal to the numpy oracle)
    for name in ("golden-QP37", "golden-QP22-int4-pc"):
        x = frames(1, 240, 416, seed=11)
        plain = fused_forward_reference(torch.from_numpy(x).to(dev), fws[name]).cpu()
        literal = make_forward(models[name], device="cpu", merged=False)(torch.from_numpy(x))
        if not torch.equal(plain, literal):
            fail(f"plain version on CUDA differs from the literal reference graph: {name}")
        print(f"plain (CUDA) vs literal reference graph (CPU) {name} (1, 240, 416): equal")

    # ---- phase 4: the main path, as a user runs it
    n_frames = 16
    ori = frames(n_frames, H, W, seed=0)
    noise = np.random.default_rng(1).integers(-6, 7, size=ori.shape)
    anchor = np.clip(ori.astype(np.int16) + noise, 0, 255).astype(np.uint8)
    with tempfile.TemporaryDirectory() as tmp:
        paths = {k: os.path.join(tmp, f"{k}.yuv") for k in ("ori", "anchor", "recon")}
        write_yuv420(paths["ori"], ori)
        write_yuv420(paths["anchor"], anchor)
        fused_forward.launches = 0
        rc = cli.main([
            "run", "--ori", paths["ori"], "--anchor", paths["anchor"],
            "--height", str(H), "--width", str(W), "--frames", str(n_frames),
            "--model", os.path.join(GOLDEN, "model_q37.data"), "--qp", "37",
            "--device", "cuda", "--impl", "auto",
            "--out-dir", tmp, "--recon", paths["recon"],
        ])
        launches = fused_forward.launches
        if rc != 0:
            fail(f"cli run exited {rc}")
        if launches <= 0:
            fail("the main path launched the fused kernel no time")
        recon = read_y420(paths["recon"], n_frames, H, W)
        with open(os.path.join(tmp, "runs.jsonl")) as fp:
            run = json.loads(fp.readline())
    want = np.concatenate([
        fused_forward_reference(torch.from_numpy(anchor[i:i + 4]).to(dev), fws["golden-QP37"])
        .cpu().numpy()
        for i in range(0, n_frames, 4)
    ])
    if not (recon == want).all():
        fail("main-path reconstruction differs from the plain version")
    if not (math.isfinite(run["psnr_before"]) and math.isfinite(run["psnr_after"])):
        fail(f"main-path PSNR not finite: {run['psnr_before']}, {run['psnr_after']}")
    ms_frame = run["time_us"] / 1e3 / n_frames
    print(f"main path: cli run QP37 {n_frames}x{H}x{W} on cuda: fused kernel launches={launches}, "
          f"recon == plain version; PSNR before {run['psnr_before']:.4f} dB, after "
          f"{run['psnr_after']:.4f} dB; {run['time_us']} us incl. H2D/D2H = "
          f"{ms_frame:.3f} ms/frame ({n_frames / (run['time_us'] / 1e6):.1f} fps) {card}")

    # ---- phase 5: kernel and plain ms/frame at 1080p
    fw37 = fws["golden-QP37"]
    times = {}
    for b in (1, 4, 8):
        xd = torch.from_numpy(frames(b, H, W, seed=b)).to(dev)
        for _ in range(3):
            fused_forward(xd, fw37)
        fused_forward_reference(xd, fw37)
        k_ms = cuda_time_ms(lambda: fused_forward(xd, fw37), 20)
        p_ms = cuda_time_ms(lambda: fused_forward_reference(xd, fw37), 2)
        times[b] = (k_ms, p_ms)
        print(f"1080p batch {b}: kernel {k_ms / b:.4f} ms/frame, plain {p_ms / b:.4f} ms/frame "
              f"({k_ms:.4f} / {p_ms:.4f} ms per call) {card}")

    k_ms, p_ms = times[4]  # the main path's batch (Engine batch_frames=4)
    print(json.dumps({"kernels": [{
        "name": KERNEL, "route": "cuda", "source": KERNEL_SOURCE, "replaces": REPLACES,
        "launches": launches, "max_abs_err": max_err, "ms": k_ms, "plain_ms": p_ms,
    }]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
