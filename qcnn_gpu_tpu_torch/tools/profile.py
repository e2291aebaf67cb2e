"""Where the time of the port's main path goes, on one CUDA GPU.

    python -m qcnn_gpu_tpu_torch.tools.profile

Restores 16 seeded random 1920x1080 frames with the committed QP37 model,
batch 4, through the pipelined `Engine.restore_stream` (the span that
`Engine.run_sequence` times, copies included) and prints, one item per
line:

  gpu              nvidia-smi's name, power limit and SM clock
  e2e              restore_stream ms/frame of each of 5 runs, in rounds:
                   after the warm-up, at torch's default intra-op threads
                   and at 1 in turns, after 2 s of idle card, after 0.5 s
                   of kernel launches
  host copy        one batch's host-to-host copy by numpy and by torch,
                   alone and on two threads at once (min, median, max)
  serial baseline  the loop without the pipeline (pageable copies, every
                   step synchronised), in ms/frame: H2D copy, kernel, D2H
                   copy, host (numpy, Python)
  trace raw        torch.profiler over one pipelined restore_stream: the
                   host window, the kernel's busy share of it, the device
                   time of the copies, and the time in which a copy and the
                   kernel overlap (from the device events' start and end);
                   then the host ms per batch of each program span
                   (`stream.*` on the producer and the fetcher,
                   `engine.output`): the stream's per-batch host timeline
  duplex host      three untraced duplex streams of a static-camera
                   sequence (`static_camera`): the window against the
                   producer's and the fetcher's host seconds and their parts
  trace duplex     the duplex stream traced: the device time of the
                   duplex's own torch operations per packed step
  h2d              pageable and pinned host->device rate of one batch, GB/s
  kernel           fused-kernel ms/frame (CUDA events) at the six reference
                   geometries, 416x240 to 3840x2160, beside its bound (useful
                   MACs over the int8 peak) and its useful TOP/s
  gpu after        SM clock and power draw right after the timing loops

`trace_stream`, `static_camera` and `duplex_host_split` are shared with
chip_smoke.py. Needs a CUDA device and raises without one.
"""

from __future__ import annotations

import os
import time

import numpy as np
import torch

from qcnn_gpu_tpu_torch.engine.runner import Engine, read_model
from qcnn_gpu_tpu_torch.models.topology import MACS_PER_PIXEL
from qcnn_gpu_tpu_torch.ops.fused import FusedWeights, fused_forward
from qcnn_gpu_tpu_torch.spans import host_seconds, length, overlap, read_profiler, union
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


def static_camera(n: int, h: int, w: int, seed: int):
    """A static-camera sequence -> (frames, anchors), uint8 [n, h, w]:
    frame t is one seeded background plus one fixed seeded noise field
    (the same every frame) with a seeded 128x128 textured square (a 9x9
    random grid in [30, 225] upsampled bilinearly, plus fine noise: an
    object, not white noise) pasted at x = 64 + 16 t, y = h // 2 - 64;
    the anchors add a second fixed +-6 noise field. Surveillance and
    conferencing video look like this."""
    rng = np.random.default_rng(seed)
    yy, xx = np.mgrid[0:h, 0:w]
    bg = 128 + 50 * np.sin(yy / 41.0) + 40 * np.cos(xx / 67.0) + rng.normal(0, 8, (h, w))
    grid = rng.integers(30, 226, (9, 9)).astype(np.float64)
    u = np.linspace(0, 8, 128)
    i = np.minimum(u.astype(int), 7)
    f = u - i
    rows = grid[i] * (1 - f)[:, None] + grid[i + 1] * f[:, None]
    square = rows[:, i] * (1 - f)[None] + rows[:, i + 1] * f[None] + rng.normal(0, 4, (128, 128))
    square = np.clip(square, 0, 255)
    frames = np.broadcast_to(np.clip(bg, 0, 255).astype(np.uint8), (n, h, w)).copy()
    y0 = h // 2 - 64
    for t in range(n):
        x0 = 64 + 16 * t
        frames[t, y0:y0 + 128, x0:x0 + 128] = square[:, : max(0, min(128, w - x0))]
    anchors = np.clip(frames.astype(np.int16) + rng.integers(-6, 7, (h, w)), 0, 255)
    return frames, anchors.astype(np.uint8)


def trace_stream(eng: Engine, frames: np.ndarray, qp: int, transport: str) -> dict:
    """torch.profiler over one restore_stream (warm it first), every thread
    followed (the fetcher starts inside the window). Device time in us,
    from the raw kineto events' start and end: the port's kernels
    ("qvrcnn_*"), host->device and device->host copies, every other device
    operation ("other": torch's own kernels and memsets), the time in which
    a copy and a port kernel run at once, and the host window; "spans":
    each program span's (count, host ms per batch)."""
    torch.cuda.synchronize()
    acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    every_thread = torch._C._profiler._ExperimentalConfig(profile_all_threads=True)
    with torch.profiler.profile(activities=acts, experimental_config=every_thread) as prof:
        t0 = time.perf_counter()
        eng.restore_stream(frames, qp, transport=transport)
        torch.cuda.synchronize()
        window_us = (time.perf_counter() - t0) * 1e6
    prog, _, device = read_profiler(prof)
    kinds = {"kernel": [], "h2d": [], "d2h": [], "other": []}
    for name, _, s, e in device:
        kind = ("kernel" if "qvrcnn_" in name else "h2d" if "Memcpy HtoD" in name
                else "d2h" if "Memcpy DtoH" in name else "other")
        kinds[kind].append((s * 1e6, e * 1e6))
    merged = {k: union(v) for k, v in kinds.items()}
    batches = -(-frames.shape[0] // eng.batch_frames)
    copies = union(kinds["h2d"] + kinds["d2h"])
    return {
        "window_us": window_us,
        "kernel_us": length(merged["kernel"]),
        "kernel_launches": len(kinds["kernel"]),
        "kernel_share": length(merged["kernel"]) / window_us,
        "h2d_us": length(merged["h2d"]),
        "d2h_us": length(merged["d2h"]),
        "other_us": length(merged["other"]),
        "other_ops": len(kinds["other"]),
        "overlap_us": overlap(merged["kernel"], copies),
        "served": eng.last_stream.get("served"),
        "packed_steps": eng.last_stream.get("packed_steps", 0),
        "dense_fetches": eng.last_stream.get("dense_fetches", 0),
        "spans": {name: (n, 1e3 * t / batches)
                  for name, (n, t) in sorted(host_seconds(prog).items())},
    }


def duplex_host_split(stream: dict, window_s: float) -> str:
    """The host seconds of one duplex `restore_stream` (its `last_stream`,
    summed from DuplexTransport.stats) against its wall-clock window, in
    ms: the producer's sends and their parts, the fetcher's receives and
    theirs, and what is left of the window on each thread (waiting on the
    queue, or the ragged tail)."""
    ms = {k: 1e3 * v for k, v in stream.items() if k[:2] == "t_"}
    win = 1e3 * window_s
    send, recv = ms.get("t_send", 0.0), ms.get("t_receive", 0.0)
    parts_s = ms.get("t_pack", 0.0) + ms.get("t_predict", 0.0) + ms.get("t_dispatch", 0.0)
    parts_r = ms.get("t_fetch", 0.0) + ms.get("t_decode", 0.0)
    return (f"window {win:.3f} ms; producer: send {send:.3f} ms (pack {ms.get('t_pack', 0):.3f}, "
            f"predict {ms.get('t_predict', 0):.3f}, upload+dispatch {ms.get('t_dispatch', 0):.3f}, "
            f"other {send - parts_s:.3f}: snapshots, refs, full steps), not sending "
            f"{win - send:.3f}; fetcher: receive {recv:.3f} ms (fetch wait "
            f"{ms.get('t_fetch', 0):.3f}, decode {ms.get('t_decode', 0):.3f}, other "
            f"{recv - parts_r:.3f}: full steps, the sink's copy), not receiving {win - recv:.3f}")


def host_copies(nbytes: int, reps: int = 20) -> dict:
    """ms per copy of `nbytes` between two host arrays, by np.copyto and by
    torch's copy_ (which splits a large copy over torch's intra-op
    threads), alone and on two threads at once, as the pipeline's producer
    and fetcher copy: -> {method: (min, median, max)}."""
    import threading

    src = [np.random.default_rng(i).integers(0, 256, nbytes, dtype=np.uint8) for i in range(2)]
    dst = [np.empty(nbytes, np.uint8) for _ in range(2)]
    methods = {
        "numpy": lambda d, a: np.copyto(d, a),
        "torch": lambda d, a: torch.from_numpy(d).copy_(torch.from_numpy(a)),
    }
    out = {}
    for name, copy in methods.items():
        for threads in (1, 2):
            times = [[] for _ in range(threads)]

            def loop(i):
                for _ in range(reps):
                    t0 = time.perf_counter()
                    copy(dst[i], src[i])
                    times[i].append((time.perf_counter() - t0) * 1e3)

            ths = [threading.Thread(target=loop, args=(i,)) for i in range(threads)]
            for th in ths:
                th.start()
            for th in ths:
                th.join()
            flat = sorted(t for ts in times for t in ts)
            out[f"{name} x{threads}"] = (flat[0], flat[len(flat) // 2], flat[-1])
    return out


def serial_baseline(frames: np.ndarray, fw: FusedWeights, batch: int, dev) -> dict:
    """The loop before the pipeline: pageable copies, a synchronise after
    every step; ms/frame of each step."""
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


def _print_trace(label: str, tr: dict, n: int) -> None:
    print(f"trace {label} ({n} frames, served {tr['served']}): host window "
          f"{tr['window_us']:.1f} us; kernel {tr['kernel_us']:.1f} us in "
          f"{tr['kernel_launches']} launches ({100 * tr['kernel_share']:.1f}% busy); H2D "
          f"{tr['h2d_us']:.1f} us, D2H {tr['d2h_us']:.1f} us; copy/kernel overlap "
          f"{tr['overlap_us']:.1f} us; other device ops {tr['other_us']:.1f} us in "
          f"{tr['other_ops']} ({tr['packed_steps']} packed steps, {tr['dense_fetches']} dense "
          "fetches)")
    print(f"trace {label} host ms per batch by span: "
          + ", ".join(f"{name} {ms:.4f} ({n})" for name, (n, ms) in tr["spans"].items()))


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

    default_threads = torch.get_num_threads()
    print(f"host: {os.cpu_count()} CPUs, torch intra-op threads {default_threads}")
    fw = FusedWeights.from_engine(params, dev)
    xb = torch.from_numpy(frames[:BATCH].copy()).to(dev)

    def busy():  # 0.5 s of back-to-back kernel launches
        t_end = time.perf_counter() + 0.5
        while time.perf_counter() < t_end:
            for _ in range(20):
                fused_forward(xb, fw)
            torch.cuda.synchronize()

    # rounds of REPS runs: right after the warm-up, at torch's default
    # intra-op threads and at 1 (torch's host copies on one thread each)
    # in turns, then after 2 s of idle card and after 0.5 s of kernels
    rounds = [("after warm-up", default_threads, None), ("", 1, None),
              ("", default_threads, None), ("", 1, None),
              ("after 2 s idle", default_threads, lambda: time.sleep(2.0)),
              ("after 0.5 s of kernels", default_threads, busy)]
    for rnd, (label, threads, before) in enumerate(rounds):
        torch.set_num_threads(threads)
        if before is not None:
            before()
        e2e = []
        for _ in range(REPS):
            t0 = time.perf_counter()
            eng.restore_stream(frames, QP)
            e2e.append((time.perf_counter() - t0) * 1e3 / N)
        print(f"e2e restore_stream {N}x{H}x{W} batch {BATCH} ms/frame, round {rnd}"
              f"{', ' + label if label else ''}, torch threads {threads} ({REPS} runs): "
              f"{[round(v, 4) for v in e2e]}")
    torch.set_num_threads(default_threads)
    for name, (lo, med, hi) in host_copies(BATCH * H * W).items():
        print(f"host copy {BATCH * H * W} B, {name}: ms per copy min {lo:.4f} median "
              f"{med:.4f} max {hi:.4f}")

    passes = [serial_baseline(frames, fw, BATCH, dev) for _ in range(3)]
    mean = {k: sum(p[k] for p in passes) / len(passes) for k in passes[0]}
    print("serial baseline ms/frame (pageable, synchronised, 3 passes): "
          + ", ".join(f"{k} {v:.4f}" for k, v in mean.items()))

    _print_trace("raw", trace_stream(eng, frames, QP, "raw"), N)
    _, static = static_camera(N, H, W, SEED)
    eng.warmup(QP, H, W, N, transport="duplex")
    eng.restore_stream(static, QP, transport="duplex")  # the carries meet this content
    for _ in range(3):
        t0 = time.perf_counter()
        eng.restore_stream(static, QP, transport="duplex")
        print(f"duplex host split {N}x{H}x{W}: "
              f"{duplex_host_split(eng.last_stream, time.perf_counter() - t0)}")
    _print_trace("duplex", trace_stream(eng, static, QP, "duplex"), N)

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
