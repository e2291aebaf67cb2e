"""The headline measurement of the PyTorch port: restoration frames/s on
one CUDA GPU.

    python -m qcnn_gpu_tpu_torch.bench [--device cuda]
    python -m qcnn_gpu_tpu_torch.cli bench [--device cuda]

Counterpart of the JAX package's root `bench.py`, which its `cli bench`
runs (qcnn_gpu_tpu/cli.py:349-353), with the same knobs, environment
names, defaults and JSON keys (bench.py:57-66, :455):

  BENCH_H, BENCH_W      1080, 1920
  BENCH_BATCH           16 frames a call
  BENCH_ITERS           16 timed calls
  BENCH_IMPL            auto: one of the port's `--impl` names
                        (engine/runner.IMPLS; `auto` is generation 3 at
                        the tuned table's tile for a table inside the
                        saturation window, as `Engine` chooses)
  BENCH_DEPTH           3 batches in flight in the pipelined loop
  BENCH_HOST_WINDOWS    6 windows a transport (budget-capped)
  BENCH_HOST_BUDGET_S   180 s for one geometry's windows
  BENCH_GEOS            "all": at 1920x1080, 832x480, 1280x720, 2560x1600
                        and 3840x2160 besides 416x240

On synthetic QP37 weights (`testing.synth_engine_params`) and seeded
frames it measures:

  * `value`: frames/s of BENCH_ITERS calls of the program on a
    device-resident batch, the host clock around them and one synchronize
    after the last (the JAX definition, so that the figures compare);
  * `host_section`: the pipelined loop with transfers (engine/stream.py)
    over a pool of batches: a +1 program (the link's ceiling), the raw
    wire, the packed D2H and the duplex wire, each window set's best and
    median;
  * `batch1_section`: device ms/frame at batch 1 and the single-frame
    stream;
  * at 1920x1080, 416x240 (and with BENCH_GEOS=all four more
    geometries), each with its own program and rows suffixed `_{w}x{h}`;
  * `mfu`: `engine/mfu.mfu_report` of the headline.

The exactness gate. `exact_vs_xla_on_hw` keeps the JAX key, which there
compares the Pallas output with the XLA graph on the TPU. Here it says
that the program's output on the whole batch equals the plain reference
net's (`models/qvrcnn.make_forward`, the XLA graph's counterpart:
float64-exact convolutions) on the same device, compared there, before
anything is timed. Nothing demotes, unlike the JAX script (bench.py:152-193,
:484, :502): the chosen program is built or raises; an output that
differs from its reference (the main batch, the batch-1 build, each
other geometry, the packed and duplex wires' warm-up steps) raises
`InexactError` before that program is timed, and `main` exits 1. Two
outcomes are recorded instead, as properties of the content: the packed
D2H's capacity overflow (`packed_exact: "error: OverflowError"`), and a
duplex warm-up whose first two steps are not full then packed
(`fps_duplex_transport: null`).

The pool: the JAX script's static-camera sequence (`video_like_pool`:
the composite canvas, a closed-track patch, JPEG at quality 32 through
the installed PIL) where matplotlib and PIL import, else its noise pool
(bench.py:235-245); `pool` says which. The card's machine has no
matplotlib, so its runs read "noise".

The JSON line, printed last on stdout, has the JAX script's keys, with
`backend` the device type ("cuda"), `link_note` the card's name and power
limit (nvidia-smi), and two more in `detail`: `tile`, the program's tile,
and `pool`. Progress goes to stderr.
"""

from __future__ import annotations

import argparse
import dataclasses
import functools
import json
import os
import sys
import time
from typing import Callable, Optional, Tuple

import numpy as np
import torch

from qcnn_gpu_tpu_torch.data.golden import composite_canvas, jpeg_roundtrip
from qcnn_gpu_tpu_torch.engine.mfu import mfu_report
from qcnn_gpu_tpu_torch.engine.packed import (
    duplex_roundtrip_bytes,
    make_duplex_restore,
    make_packed_restore,
    measure_stream_fps_duplex,
    measure_stream_fps_packed,
    packed_roundtrip_bytes,
)
from qcnn_gpu_tpu_torch.engine.runner import build_program, generation
from qcnn_gpu_tpu_torch.engine.stream import Staging, measure_stream_fps
from qcnn_gpu_tpu_torch.models.qvrcnn import make_forward
from qcnn_gpu_tpu_torch.ops.fused import TILE_H, TILE_W
from qcnn_gpu_tpu_torch.ops.tuning import tuned_kwargs
from qcnn_gpu_tpu_torch.testing import synth_engine_params, synth_frames
from qcnn_gpu_tpu_torch.tools import smi

BASELINE_FPS = 23.6  # the reference's best at 1080p (BASELINE.md)
# (h, w, the reference's best fps there, batch): bench.py:455-463
EXTRA_GEOS = [(240, 416, 83.3, 16)]
ALL_GEOS = [(480, 832, 84.0, 16), (720, 1280, 49.3, 16), (1600, 2560, 13.8, 8),
            (2160, 3840, 6.4, 4)]
# the plain reference net runs at most this many pixels a call: its
# float64 activations of 16 frames of 1080p would not fit the card
REF_PIXELS = 4 * 1080 * 1920

_T0 = time.perf_counter()


def _mark(msg: str) -> None:
    """Progress on stderr: a silent bench cannot be told from a hung one."""
    print(f"[bench +{time.perf_counter() - _T0:7.1f}s] {msg}", file=sys.stderr, flush=True)


class InexactError(RuntimeError):
    """A program's output differs from its reference: nothing of it is timed."""


@dataclasses.dataclass(frozen=True)
class Settings:
    """The JAX script's knobs (bench.py:57-66, :455), from the environment."""

    h: int = 1080
    w: int = 1920
    batch: int = 16
    iters: int = 16
    impl: str = "auto"
    depth: int = 3
    host_windows: int = 6
    host_budget_s: float = 180.0
    geos: str = ""

    @classmethod
    def from_env(cls, env=os.environ) -> "Settings":
        d = cls()
        return cls(
            h=int(env.get("BENCH_H", d.h)), w=int(env.get("BENCH_W", d.w)),
            batch=int(env.get("BENCH_BATCH", d.batch)),
            iters=int(env.get("BENCH_ITERS", d.iters)),
            impl=env.get("BENCH_IMPL", d.impl), depth=int(env.get("BENCH_DEPTH", d.depth)),
            host_windows=int(env.get("BENCH_HOST_WINDOWS", d.host_windows)),
            host_budget_s=float(env.get("BENCH_HOST_BUDGET_S", d.host_budget_s)),
            geos=env.get("BENCH_GEOS", d.geos),
        )


# ---- the data ---------------------------------------------------------------

def make_pure_transfer_run() -> Callable:
    """The minimal device round trip (bench.py:69-81): +1 on the device,
    streamed through the same loop as the program, measures the link's
    sustained ceiling over the same bytes at the same moment."""
    return lambda x: x + 1


def video_like_pool(h: int, w: int, batch: int, n_batches: int) -> list:
    """bench.py:84-112: a static camera over the mirror-tiled composite
    canvas, one foreground patch (~2.8% of the frame) on a closed track
    (frame 0 continues the last, so cycling the pool is a continuous
    stream), every frame JPEG-coded at quality 32. Needs matplotlib's
    sample data and PIL (ImportError without them)."""
    base = composite_canvas()  # [720, 1152]
    canvas = np.tile(base, (h // 720 + 2, w // 1152 + 2))
    bg = canvas[:h, :w].copy()
    n = batch * n_batches
    t = np.arange(n) / n
    ph, pw = max(h // 6, 16), max(w // 6, 16)
    patch = canvas[h:h + ph, :pw]
    y = np.round((0.5 - 0.5 * np.cos(2 * np.pi * t)) * (h - ph)).astype(int)
    x = np.round((0.5 + 0.5 * np.sin(2 * np.pi * t)) * (w - pw)).astype(int)
    frames = np.empty((n, h, w), np.uint8)
    for i in range(n):
        f = bg.copy()
        f[y[i]:y[i] + ph, x[i]:x[i] + pw] = patch
        frames[i] = f
    frames = jpeg_roundtrip(frames, 32)
    return [frames[i * batch:(i + 1) * batch] for i in range(n_batches)]


def noise_pool(base: np.ndarray, n_batches: int) -> list:
    """bench.py:235-245: the base batch plus seeded noise in [-3, 3], one
    draw a batch (mutually uncorrelated frames: the duplex's worst case)."""
    rng = np.random.default_rng(7)
    return [
        np.clip(base.astype(np.int16) + rng.integers(-3, 4, base.shape, np.int16),
                0, 255).astype(np.uint8)
        for _ in range(n_batches)
    ]


def frame_pool(base: np.ndarray, n_batches: int) -> Tuple[list, str]:
    """(pool, "video") where matplotlib and PIL import, else (noise pool,
    "noise"), as the JAX script falls back (silently there)."""
    b, h, w = base.shape
    try:
        return video_like_pool(h, w, b, n_batches), "video"
    except ImportError:
        return noise_pool(base, n_batches), "noise"


# ---- the gate and the clocks ------------------------------------------------

def plain_restore(ref: Callable, x: torch.Tensor) -> torch.Tensor:
    """The plain reference net's output on the uint8 batch x, in calls of
    whole frames, at most REF_PIXELS pixels each."""
    n = max(1, REF_PIXELS // (x.shape[1] * x.shape[2]))
    return torch.cat([ref(x[i:i + n]) for i in range(0, x.shape[0], n)])


def build(p, name: str, device, geo, batch: int) -> Callable:
    """`engine/runner.build_program`, with the reference net called in
    `plain_restore`'s chunks (a whole batch of it may not fit the card)."""
    run = build_program(p, name, device, geo, batch)
    return functools.partial(plain_restore, run) if name == "reference" else run


def check_equal(what: str, got: torch.Tensor, want: torch.Tensor) -> None:
    """InexactError unless the uint8 outputs (on one device) are equal."""
    if got.shape != want.shape or not torch.equal(got, want):
        bad = int((got != want).sum()) if got.shape == want.shape else f"shape {got.shape}"
        raise InexactError(f"{what}: output differs from its reference ({bad} pixels); "
                           "nothing of it is timed")


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def device_fps(run: Callable, x: torch.Tensor, iters: int) -> float:
    """Frames/s of `iters` calls on the device-resident batch x: the host
    clock around them, one synchronize after the last (bench.py:194-208)."""
    _sync(x.device)
    t0 = time.perf_counter()
    for _ in range(iters):
        run(x)
    _sync(x.device)
    return x.shape[0] * iters / (time.perf_counter() - t0)


def tile_of(name: str, run: Callable) -> Optional[Tuple[int, int]]:
    """The program's tile: generation 3's from the table, 24x40 for
    generations 1 and 2, None for the reference net."""
    if name == "kernel3":
        return run.tile
    return None if name == "reference" else (TILE_H, TILE_W)


# ---- the sections -----------------------------------------------------------

def host_section(run: Callable, base: np.ndarray, baseline_fps: float, n_windows: int,
                 budget_s: float, dev_fps: float, s: Settings, device) -> dict:
    """Transfer-inclusive fps (bench.py:218-386): the raw, packed-D2H and
    duplex wires next to the link's own ceiling, all through the same
    pipelined loop over the same pool of batches in the same phase."""
    device = torch.device(device)
    batch = base.shape[0]
    fb = base.nbytes / batch
    bump = make_pure_transfer_run()
    # one tiny window sizes the measurement, so a slow link cannot blow the budget
    _mark("link phase probe")
    quick = measure_stream_fps(bump, [base[:2]], depth=s.depth, device=device)
    slow_link = quick * 2 * fb / 1e6 < 60.0  # < 60 MB/s sustained both ways
    pool, kind = frame_pool(base, 3 if slow_link else 8)
    _mark(f"{kind} pool of {len(pool)} batches (slow_link={slow_link})")
    d: dict = {"pool": kind}
    t0 = time.perf_counter()

    def windows_of(fn, key, deadline=None, n=None):
        ws = []
        end = deadline if deadline is not None else t0 + budget_s
        for _ in range(n if n is not None else (2 if slow_link else n_windows)):
            ws.append(round(fn(), 2))
            _mark(f"{key} window -> {ws[-1]}")
            if time.perf_counter() > end:
                break
        d[key] = ws
        # the best matches the baseline's best-of-510; the median is the
        # steady state on a link whose rate spreads
        d[key.replace("windows_", "fps_") + "_median"] = round(float(np.median(ws)), 2)
        return max(ws)

    # (a) the link's ceiling (the +1 warmed at the pool's shape first)
    bump(torch.from_numpy(pool[0]).to(device))
    fps_link = windows_of(lambda: measure_stream_fps(bump, pool, s.depth, device=device),
                          "windows_link_pure")
    # (b) the raw wire, the loop the reference times
    measure_stream_fps(run, pool[:1], s.depth, device=device)  # untimed warm-up
    fps_full = windows_of(lambda: measure_stream_fps(run, pool, s.depth, device=device),
                          "windows_full")
    # (c) the packed D2H: ~0.5 B/px down, the host decode in the window
    fps_packed = None
    packed, decode = make_packed_restore(run)
    try:
        x0 = torch.from_numpy(pool[0]).to(device)
        check_equal("packed D2H", torch.from_numpy(decode(pool[0], packed(x0))),
                    run(x0).cpu())
        packed_exact = True
        fps_packed = windows_of(
            lambda: measure_stream_fps_packed(packed, decode, pool, s.depth, device=device),
            "windows_packed")
    except OverflowError as e:  # more exceptions than the capacity: the content's
        packed_exact = f"error: {type(e).__name__}"
    # (d) the duplex: temporal deltas up, predicted residual deltas down.
    # Two warm-up passes over the pool, every step checked: the second
    # covers the pairings the cycling windows see (pool[0] after pool[-1])
    fps_duplex = None
    transport = make_duplex_restore(run, device, Staging(device, s.depth + 2))
    kinds = []
    _mark("duplex warm-up (2 pool passes)")
    for x in pool + pool:
        item = transport.send(x)
        kinds.append(item[0])
        rec = transport.receive(x, item)
        check_equal(f"duplex warm-up step {len(kinds)} ({item[0]})", torch.from_numpy(rec),
                    run(torch.from_numpy(x).to(device)).cpu())
    duplex_exact = True
    if kinds[:2] == ["full", "packed"]:
        # the transport carries its chain across windows; the duplex has
        # its own allowance, the warm-up having spent the shared one
        fps_duplex = windows_of(
            lambda: measure_stream_fps_duplex(transport, pool, s.depth), "windows_duplex",
            deadline=time.perf_counter() + budget_s / 2, n=n_windows)
    fps_host = max(fps_full, fps_packed or 0.0, fps_duplex or 0.0)
    fps_host_median = max(d.get("fps_full_median", 0.0), d.get("fps_packed_median", 0.0),
                          d.get("fps_duplex_median", 0.0))
    h2d_b, d2h_b = packed_roundtrip_bytes(base.shape)
    dup_h2d, dup_d2h = duplex_roundtrip_bytes(base.shape)
    # a link-bound claim needs the raw wire at the link's own ceiling
    link_bound = bool(fps_link < baseline_fps and fps_full >= 0.8 * min(fps_link, dev_fps))
    st = transport.stats
    d.update(
        fps_incl_host_transfers=fps_host,
        fps_incl_host_transfers_vs_baseline=round(fps_host / baseline_fps, 2),
        fps_incl_host_transfers_median=round(fps_host_median, 2),
        fps_incl_host_transfers_median_vs_baseline=round(fps_host_median / baseline_fps, 2),
        fps_full_transport=fps_full,
        fps_packed_transport=fps_packed,
        packed_exact=packed_exact,
        fps_duplex_transport=fps_duplex,
        duplex_exact=duplex_exact,
        duplex_bytes_per_frame=round((dup_h2d + dup_d2h) / batch),
        duplex_exc_frac=round(float(np.mean(st["exc_frac"])), 5) if fps_duplex else None,
        duplex_h2d_bytes_per_frame_measured=(
            round(float(np.median(st["h2d_bytes"])) / batch) if fps_duplex else None),
        duplex_d2h_bytes_per_frame_measured=(
            round(float(np.median(st["d2h_bytes"])) / batch) if fps_duplex else None),
        fps_link_pure=fps_link,
        sustained_link_mbps=round(fps_link * 2 * fb / 1e6, 1),
        required_link_mbps_for_baseline=round(baseline_fps * 2 * fb / 1e6, 1),
        packed_bytes_per_frame=round((h2d_b + d2h_b) / batch),
        full_bytes_per_frame=round(2 * fb),
        link_bound=link_bound,
        baseline_fps=baseline_fps,
    )
    return d


def batch1_section(p, name: str, run: Callable, base: np.ndarray, baseline_fps: float,
                   s: Settings, device) -> dict:
    """Single-frame rows (bench.py:388-440): device ms/frame at batch 1 and
    the single-frame pipelined stream over the raw wire. Where the table
    gives generation 3 another tile at batch 1, that program serves them,
    once it equals the batch program on one frame (else InexactError)."""
    device = torch.device(device)
    bh, bw = base.shape[1:]
    x1 = torch.from_numpy(base[:1]).to(device)
    if name == "kernel3" and tuned_kwargs(h=bh, w=bw, batch=1) != tuned_kwargs(h=bh, w=bw):
        _mark("batch-1 program")
        cand = build(p, name, device, (bh, bw), 1)
        check_equal(f"batch-1 program at {cand.tile}", cand(x1), run(x1))
        run = cand
    run(x1)
    n1 = 16
    d = {"ms_per_frame_device_batch1": round(1000 / device_fps(run, x1, n1), 3)}
    singles = [base[i:i + 1] for i in range(base.shape[0])]
    measure_stream_fps(run, singles[:2], s.depth, device=device)  # warm the loop
    fps1 = measure_stream_fps(run, singles, s.depth, device=device)
    d["fps_incl_host_transfers_batch1"] = round(fps1, 2)
    d["fps_incl_host_transfers_batch1_vs_baseline"] = round(fps1 / baseline_fps, 2)
    _mark(f"batch 1: {d['ms_per_frame_device_batch1']} ms device, "
          f"{d['fps_incl_host_transfers_batch1']} fps incl. transfers")
    return d


def measure(device="cuda", s: Optional[Settings] = None) -> dict:
    """The bench's JSON object (module docstring) for the settings `s`
    (default: from the environment) on `device`."""
    s = s or Settings.from_env()
    device = torch.device(device)
    if device.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError("no CUDA device: --device cpu runs the kernels' plain versions")
        card, kind = smi(), torch.cuda.get_device_name(device)
    else:
        card = kind = device.type
    p = synth_engine_params(37)
    ref = make_forward(p, device=device)
    name = generation(p, s.impl)
    _mark(f"building {name} for {s.batch}x{s.h}x{s.w} on {device}")
    run = build(p, name, device, (s.h, s.w), s.batch)
    tile = tile_of(name, run)
    frames = synth_frames(s.batch, s.h, s.w, seed=1)
    xd = torch.from_numpy(frames).to(device)
    _mark("exactness gate against the plain reference net")
    check_equal(f"{name} {s.batch}x{s.h}x{s.w}", run(xd), plain_restore(ref, xd))

    _mark("timing device throughput")
    fps_dev = device_fps(run, xd, s.iters)
    host = host_section(run, frames, BASELINE_FPS, s.host_windows, s.host_budget_s,
                        fps_dev, s, device)
    host.update(batch1_section(p, name, run, frames, BASELINE_FPS, s, device))

    dgeo = {}
    if (s.h, s.w) == (1080, 1920):  # not on an overridden (smoke) geometry
        for gh, gw, base_fps, gb in EXTRA_GEOS + (ALL_GEOS if s.geos == "all" else []):
            sfx = f"_{gw}x{gh}"
            _mark(f"geometry {gw}x{gh}")
            rung = run if name != "kernel3" else build(p, name, device, (gh, gw), gb)
            fg = synth_frames(gb, gh, gw, seed=3)
            xg = torch.from_numpy(fg).to(device)
            check_equal(f"{name} {gb}x{gh}x{gw}", rung(xg), plain_restore(ref, xg))
            dev_ms = 1000 / device_fps(rung, xg, 8)
            hg = host_section(rung, fg, base_fps, 4, s.host_budget_s / 2, 1000 / dev_ms, s,
                              device)
            hg["ms_per_frame_device"] = round(dev_ms, 3)
            hg.update(batch1_section(p, name, rung, fg, base_fps, s, device))
            dgeo.update({k + sfx: v for k, v in hg.items()})

    ms_dev = 1000 / fps_dev
    return {
        "metric": "1080p YUV frames/sec/chip (INT8 QVRCNN forward_blu, sustained device "
                  "throughput)",
        "value": round(fps_dev, 2),
        "unit": "frames/s",
        "vs_baseline": round(fps_dev / BASELINE_FPS, 2),
        "detail": {
            "impl": name,
            "exact_vs_xla_on_hw": True,  # check_equal raised otherwise
            "batch": s.batch,
            "iters": s.iters,
            "ms_per_frame_device": round(ms_dev, 3),
            "mfu": mfu_report(s.h * s.w, ms_dev, kind, tile or (TILE_H, TILE_W)),
            "stream_depth": s.depth,
            "tile": f"{tile[0]}x{tile[1]}" if tile else None,
            **host,
            **dgeo,
            "link_note": (f"{card}; fps_link_pure is the link's own sustained ceiling measured "
                          "by the same pipelined loop over the same bytes"),
            "backend": device.type,
            "baseline_note": "reference best-of-510 1080p e2e 42.4ms (Debug build, log.txt)",
        },
    }


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="qcnn_gpu_tpu_torch.bench", description=__doc__,
                                 formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--device", default="cuda", help="torch device, e.g. cuda, cuda:1, cpu")
    args = ap.parse_args(argv)
    try:
        result = measure(args.device)
    except InexactError as e:
        print(f"error: {e}", file=sys.stderr)
        return 1
    print(json.dumps(result))
    return 0


if __name__ == "__main__":
    sys.exit(main())
