#!/usr/bin/env python3
"""Smoke run of the PyTorch port (qcnn_gpu_tpu_torch) on one NVIDIA GPU.

    python3 chip_smoke.py

Run from the root of a checkout on a machine with a CUDA GPU, `nvcc` and
a CUDA build of PyTorch. It imports torch, numpy and the port only. It
builds the kernels from the four sources in qcnn_gpu_tpu_torch/csrc (one
nvcc each, all at once) and then:

  1-5  the kernels' `ptxas` reports (registers, spills; none allowed in
       the three network kernels) and shared memory; the fused kernel
       (generation 3: split branch GEMMs on `wgmma`, weights resident in
       shared memory, a persistent grid of 24x40 tiles) bit for bit
       against its plain version (phase 2's
       cases: four models, 37x53 to 1080p, batch 8 at 1080p, frame bounds,
       and a tile count that is not a multiple of the grid), the plain
       version against the port's literal 6-conv reference graph (which
       the CPU tests hold bit-equal to the numpy oracle), the main path
       (`qcnn_gpu_tpu_torch.cli run` on 16 synthetic 1920x1080 frames with
       the committed QP37 model) and kernel and plain version timed at
       1080p;
  6    the frame-pair (generation 2) and literal-requant
       (generation 1) kernels, both on generation 3's design, bit for bit
       against their plain versions on phase 2's cases, odd batches
       included;
  7    the literal kernel on two tables of the QP37 model outside the
       solver's saturation window (C2_2's bound one step up; S1's raised by
       half, whose activations pass 127 on random frames), against its plain
       version and the literal 6-conv graph; the folded-epilogue weights
       must refuse both;
  8    `cli run --impl kernel2` on phase 4's frames: the pair kernel's path,
       reconstruction equal to phase 4's;
  9    the matrix-rate probe's seven chain cases bit for bit against their
       plain version at grid 2, then its tool (`tools/mma_probe`) end to
       end, which also prints the `mma.sync` issue ceiling (a measurement
       with no TPU counterpart, so not in the kernels line);
  10   `tools/bench_kernels` (its literal launches on a line of their
       own), then v3, v2 and v1 timed at 1080p batch 4 in turns (v3 v2 v1
       v1 v2 v3), beside their plain versions;
  11   the streaming engine (engine/stream.py, engine/packed.py):
       phase 4's pipelined raw stream again under
       `torch.cuda.set_sync_debug_mode("error")` (no host sync in the
       producer), equal to phase 4, and traced with torch.profiler (the
       time a copy overlaps the kernel must be above 0); a static-camera
       sequence (16 frames of 1920x1080, a 128x128 textured square moving
       16 px a frame) through `cli run --transport raw` and `--transport duplex`:
       equal reconstructions, `+duplex` served, fewer wire bytes than raw's
       2 B/px, at least one packed step, then the duplex stream under the
       sync check and traced (the device time of its own torch operations
       per packed step, and its host seconds: send and receive, and their
       pack, predict, dispatch, fetch wait and decode); and `cli run
       --transport auto` on phase 4's frames, equal to phase 4, its
       decision from 3 link and 3 device samples;
  12   generation 1 as an engine program: phase 7's two tables outside the
       saturation window through `cli run --impl kernel1` and `--impl
       auto` on phase 4's frames (auto must serve `kernel1`; the literal
       kernel launched, the fused kernel not; recon equal to the literal
       plain version on the card), and `--impl kernel` on them exits 1
       with the window message;
  13   the dynamic path: a dynamic model from the QP37 model's weights
       with seeded steps; `cli calibrate-dynamic` (the dynamic mode with
       its b_adj dump, and the hybrid mode on the QP37 model) on 4 frames
       of 416x240 and `cli validate` (report and feature dump) on the
       first, once on the card and once on the CPU: equal text and equal
       file bytes; then `cli calibrate-dynamic` on 4 of phase 4's
       1920x1080 anchors on the card, and each forward's ms/frame there;
  14   the training path at full width, through the CLI: the training
       demo's data (12 clean 256x256 frames, DCT q=28 anchors, a held-out
       pair from seed 99); `cli train` on the card, 300 steps of 64
       patches of 64x64 at lr 1e-3 (the loss must fall), the train step's
       ms against its float32 bound, and its first 3 steps on the card
       and on the CPU (within the CPU tests' tolerance); `cli calibrate
       --sample` on both devices (bounds within rtol 1e-4, the tables'
       equality printed, one table's model file byte-equal across the
       devices, the presets' files byte-equal); `cli finetune` (100
       steps) and `cli eval-float`; the calibrated and the fine-tuned
       models through `cli run --impl auto` on the held-out anchors (the
       served kernel launched, recon equal to its plain version on the
       card, INT8 PSNR against the anchors'); tiled float prediction
       against the whole frame (pixels that differ, printed); and the
       demo's byte target (ckpt-1500 and quant_table.data quantize to
       assets/demo/model_q.data).

The committed 1080p and class-A golden PSNRs need matplotlib's sample
data, which the smoke does not assume: `tests/test_torch_golden.py`
checks them (slow-marked, on the CPU).

Every path (phases 4, 8, 9, 10, each of 11's, 12's and 14's) runs with the
launch counts set to 0 just before it and read just after; a kernel of
the path that was not launched fails the run. No phase catches an error: any
failure exits non-zero. Without a GPU, or without the rest of the
repository, it exits non-zero and prints no result.

Output, one item per line: the GPU's name and power limit (nvidia-smi),
the build times, every comparison, the paths' PSNR and times, the
timings; then a JSON line {"kernels": [...]} and, last, the JSON line
{"ok": true, "device": {...}}.
"""

from __future__ import annotations

import contextlib
import dataclasses
import io
import json
import math
import os
import re
import sys
import tempfile
import time

HERE = os.path.dirname(os.path.abspath(__file__))
GOLDEN = os.path.join(HERE, "assets", "golden")
CSRC = "qcnn_gpu_tpu_torch/csrc"
# kernel -> (source, the TPU kernel it replaces)
KERNELS = {
    "qvrcnn_fused": (f"{CSRC}/qvrcnn_fused.cu", "qcnn_gpu_tpu/ops/pallas_pipeline3.py:319"),
    "qvrcnn_pair": (f"{CSRC}/qvrcnn_pair.cu", "qcnn_gpu_tpu/ops/pallas_pipeline2.py:165"),
    "qvrcnn_literal": (f"{CSRC}/qvrcnn_literal.cu", "qcnn_gpu_tpu/ops/pallas_pipeline.py:179"),
    "mma_probe": (f"{CSRC}/mma_probe.cu", "scripts/mfu_probe.py:36"),
}
H, W = 1080, 1920
PEAK_BYTES = 3.35e12  # H100 SXM HBM3


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


@contextlib.contextmanager
def no_host_sync():
    """Any CUDA call that synchronises with the host raises inside."""
    import torch

    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        yield
    finally:
        torch.cuda.set_sync_debug_mode(0)


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is False: this smoke run needs a CUDA GPU")
    sys.path.insert(0, HERE)
    import numpy as np

    from concurrent.futures import ThreadPoolExecutor

    from qcnn_gpu_tpu_torch import cli
    from qcnn_gpu_tpu_torch.engine.runner import Engine, read_model
    from qcnn_gpu_tpu_torch.models.qvrcnn import _normalized_table, make_forward
    from qcnn_gpu_tpu_torch.models.topology import MACS_PER_PIXEL
    from qcnn_gpu_tpu_torch.ops import build
    from qcnn_gpu_tpu_torch.ops.fused import (
        KERNEL,
        TILE_H,
        TILE_W,
        FusedWeights,
        fused_forward,
        fused_forward_reference,
    )
    from qcnn_gpu_tpu_torch.data.model_files import write_dynamic_hwcn, write_static_qfp_vect_c
    from qcnn_gpu_tpu_torch.models.engine_params import DynamicParams
    from qcnn_gpu_tpu_torch.models.qvrcnn_dynamic import make_dynamic_forward, make_hybrid_forward
    from qcnn_gpu_tpu_torch.ops.literal import (
        LiteralWeights,
        literal_forward,
        literal_forward_reference,
        literal_residual,
        literal_residual_reference,
    )
    from qcnn_gpu_tpu_torch.ops.pair import pair_forward, pair_forward_reference
    from qcnn_gpu_tpu_torch.tools import PEAK_INT8_OPS, bench_kernels, events_ms, mma_probe, smi
    from qcnn_gpu_tpu_torch.tools.profile import duplex_host_split, static_camera, trace_stream

    wrappers = {
        "qvrcnn_fused": fused_forward, "qvrcnn_pair": pair_forward,
        "qvrcnn_literal": literal_residual, "mma_probe": mma_probe.mma_probe,
    }

    def zero_counts():
        for fn in wrappers.values():
            fn.launches = 0

    def counts():
        return {name: fn.launches for name, fn in wrappers.items()}

    # ---- phase 1: the card, and the kernels' build from the repo's sources
    card = f"[{smi()}]"
    print(f"gpu: {card[1:-1]}")
    print(f"torch {torch.__version__} cuda {torch.version.cuda}, {torch.cuda.get_device_name(0)}")
    t0 = time.perf_counter()
    libraries = sorted({source.rsplit("/", 1)[1][:-3] for source, _ in KERNELS.values()})
    with ThreadPoolExecutor(len(libraries)) as pool:  # one nvcc per source, all at once
        list(pool.map(build.library, libraries))
    print(f"nvcc builds, in parallel: {time.perf_counter() - t0:.2f} s in all")
    for name in libraries:
        source = f"{CSRC}/{name}.cu"
        info = build.build_info[name]
        print(f"  {source}: {info['seconds']:.2f} s")
        for line in info["log"].splitlines():
            entry = re.search(r"Compiling entry function '(\w+)'", line)
            if entry:
                print("    ptxas: entry", entry.group(1))
            elif "registers" in line or "spill" in line:
                print("    ptxas:", line.strip())
    for name in ("qvrcnn_fused", "qvrcnn_pair", "qvrcnn_literal"):
        spills = re.findall(r"(\d+) bytes spill (?:stores|loads)", build.build_info[name]["log"])
        if not spills or any(int(n) for n in spills):
            fail(f"ptxas reports spills (or no report) for {name}: {spills}")
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    smem = build.library(KERNEL).qvrcnn_smem_bytes()
    print(f"{KERNEL}: 0 bytes spilled, {smem} bytes of dynamic shared memory per block, "
          f"{TILE_H}x{TILE_W} tiles, grid = min(tiles, {sms} SMs) blocks of 512 threads")
    for name in ("qvrcnn_pair", "qvrcnn_literal"):
        print(f"{name}: 0 bytes spilled, {build.library(name).qvrcnn_smem_bytes()} bytes of "
              f"dynamic shared memory, {TILE_H}x{TILE_W} tiles")
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
    # generation 3 alone: a batch of 8 at 1080p, and a frame of 2 x (sms // 2
    # + 1) tiles, a tile count that is no multiple of the grid (min(tiles, sms))
    odd = (1, TILE_H + 13, TILE_W * (sms // 2) + 13)
    tiles = -(-odd[1] // TILE_H) * -(-odd[2] // TILE_W)
    if tiles <= sms or tiles % sms == 0:
        fail(f"{odd}: {tiles} tiles on {sms} blocks is not the case this should test")
    print(f"{odd}: {tiles} tiles on a grid of {sms} blocks")
    max_err = 0
    for name, geo, kind, bounds in cases + [
        ("golden-QP37", (8, H, W), "synth", ()), ("golden-QP22-int4-pc", odd, "synth", ()),
    ]:
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
    tmp_dir = tempfile.TemporaryDirectory()
    tmp = tmp_dir.name
    yuv = {k: os.path.join(tmp, f"{k}.yuv") for k in ("ori", "anchor")}
    write_yuv420(yuv["ori"], ori)
    write_yuv420(yuv["anchor"], anchor)

    def cli_run(impl: str, transport: str = "raw", files=yuv,
                model=os.path.join(GOLDEN, "model_q37.data")):
        """`cli run` on the 16 frames; -> (launch counts, recon, record)."""
        out = os.path.join(tmp, f"{impl}-{transport}-{os.path.basename(files['anchor'])}-"
                                f"{os.path.basename(model)}")
        recon_path = os.path.join(out, "recon.yuv")
        zero_counts()
        rc = cli.main([
            "run", "--ori", files["ori"], "--anchor", files["anchor"],
            "--height", str(H), "--width", str(W), "--frames", str(n_frames),
            "--model", model, "--qp", "37",
            "--device", "cuda", "--impl", impl, "--transport", transport,
            "--out-dir", out, "--recon", recon_path,
        ])
        launched = counts()
        if rc != 0:
            fail(f"cli run --impl {impl} --transport {transport} exited {rc}")
        with open(os.path.join(out, "runs.jsonl")) as fp:
            rec = json.loads(fp.readline())
        if not (math.isfinite(rec["psnr_before"]) and math.isfinite(rec["psnr_after"])):
            fail(f"cli run --impl {impl}: PSNR not finite: {rec['psnr_before']}, "
                 f"{rec['psnr_after']}")
        return launched, read_y420(recon_path, n_frames, H, W), rec

    launched, recon, run = cli_run("auto")
    launches = {"qvrcnn_fused": launched["qvrcnn_fused"]}
    if launches["qvrcnn_fused"] <= 0:
        fail("the main path launched the fused kernel no time")
    want = np.concatenate([
        fused_forward_reference(torch.from_numpy(anchor[i:i + 4]).to(dev), fws["golden-QP37"])
        .cpu().numpy()
        for i in range(0, n_frames, 4)
    ])
    if not (recon == want).all():
        fail("main-path reconstruction differs from the plain version")
    ms_frame = run["time_us"] / 1e3 / n_frames
    print(f"main path: cli run QP37 {n_frames}x{H}x{W} on cuda: fused kernel launches="
          f"{launches['qvrcnn_fused']}, recon == plain version; PSNR before "
          f"{run['psnr_before']:.4f} dB, after {run['psnr_after']:.4f} dB; {run['time_us']} us "
          f"incl. H2D/D2H = {ms_frame:.3f} ms/frame "
          f"({n_frames / (run['time_us'] / 1e6):.1f} fps, impl={run['impl']}, transport "
          f"{run['transport']['served']}, pipelined) {card}")

    # ---- phase 5: kernel and plain ms/frame at 1080p
    fw37 = fws["golden-QP37"]
    times = {}
    for b in (1, 4, 8):
        xd = torch.from_numpy(frames(b, H, W, seed=b)).to(dev)
        for _ in range(3):
            fused_forward(xd, fw37)
        fused_forward_reference(xd, fw37)
        k_ms = events_ms(lambda: fused_forward(xd, fw37), 20)
        p_ms = events_ms(lambda: fused_forward_reference(xd, fw37), 2)
        times[b] = (k_ms, p_ms)
        print(f"1080p batch {b}: kernel {k_ms / b:.4f} ms/frame, plain {p_ms / b:.4f} ms/frame "
              f"({k_ms:.4f} / {p_ms:.4f} ms per call) {card}")

    # ---- phase 6: pair and literal kernels == their plain versions on
    # phase 2's cases (frame bounds are the one-frame kernel's alone; the
    # batches 1 and 3 give the pair kernel a lone last frame)
    lws = {name: LiteralWeights.from_engine(p, dev) for name, p in models.items()}
    max_errs = {"qvrcnn_fused": max_err, "qvrcnn_pair": 0, "qvrcnn_literal": 0}
    for name, geo, kind, bounds in cases:
        if bounds:
            continue
        if kind == "synth":
            x = frames(*geo, seed=sum(geo))
        else:
            x = np.full(geo, 0 if kind == "zeros" else 255, np.uint8)
        xd = torch.from_numpy(x).to(dev)
        runs = [("qvrcnn_pair", pair_forward, pair_forward_reference, fws),
                ("qvrcnn_literal", literal_residual, literal_residual_reference, lws)]
        for kname, kernel, plain, wts in runs:
            got = kernel(xd, wts[name])
            torch.cuda.synchronize()
            want = plain(xd, wts[name])
            if got.shape != want.shape or got.dtype != want.dtype:
                fail(f"{kname} output {got.dtype} {tuple(got.shape)}, expected {want.dtype}")
            err = int((got.to(torch.int32) - want.to(torch.int32)).abs().max())
            max_errs[kname] = max(max_errs[kname], err)
            print(f"{kname} vs plain {name} {geo} {kind}: max_abs_err={err}")
            if err != 0:
                fail(f"{kname} differs from its plain version: {name} {geo} {kind}")

    # ---- phase 7: tables outside the saturation window: the literal
    # kernel is exact there, the folded-epilogue weights refuse them. C2_2's
    # bound one output step up (smooth frames), and S1's bound raised by
    # half (uniform random frames: kept values past 127, which only its
    # uint8 activations and `.u8.s8` products hold)
    mul, shift = _normalized_table(p37)
    blu = list(p37.blu_q)
    blu[2] = int(blu[2]) + (1 << int(shift[2])) // int(mul[2]) + 1  # C2_2 one step up
    p_out = dataclasses.replace(p37, blu_q=blu)
    blu = list(p37.blu_q)
    blu[0] = 3 * int(blu[0]) // 2
    p_half = dataclasses.replace(p37, blu_q=blu)
    for label, table, kind in (("C2_2 bound one step up", p_out, "smooth"),
                               ("S1 bound raised by half", p_half, "random")):
        try:
            FusedWeights.from_engine(table, dev)
        except ValueError as e:
            print(f"FusedWeights refuses the table with the {label}: {e}")
        else:
            fail(f"FusedWeights accepted a table outside the saturation window ({label})")
        lw_out = LiteralWeights.from_engine(table, dev)
        for geo in ((2, 240, 416), (1, H, W)):
            if kind == "smooth":
                x = frames(*geo, seed=5)
            else:
                x = np.random.default_rng(5).integers(0, 256, geo, dtype=np.uint8)
            xd = torch.from_numpy(x).to(dev)
            got = literal_residual(xd, lw_out)
            torch.cuda.synchronize()
            err = int((got.to(torch.int32) - literal_residual_reference(xd, lw_out)
                       .to(torch.int32)).abs().max())
            max_errs["qvrcnn_literal"] = max(max_errs["qvrcnn_literal"], err)
            print(f"qvrcnn_literal vs plain, {label}, {kind} frames {geo}: max_abs_err={err}")
            if err != 0:
                fail(f"literal kernel differs from its plain version ({label})")
        x = frames(1, 240, 416, seed=12)
        restored = literal_forward(torch.from_numpy(x).to(dev), lw_out).cpu()
        graph = make_forward(table, device="cpu", merged=False)(torch.from_numpy(x))
        if not torch.equal(restored, graph):
            fail(f"literal kernel differs from the literal reference graph ({label})")
        print(f"literal kernel (CUDA) vs literal reference graph (CPU), {label} "
              "(1, 240, 416): equal")

    # ---- phase 8: the frame-pair kernel's path, cli run --impl kernel2
    launched, recon2, run2 = cli_run("kernel2")
    launches["qvrcnn_pair"] = launched["qvrcnn_pair"]
    if launches["qvrcnn_pair"] <= 0:
        fail("cli run --impl kernel2 launched the pair kernel no time")
    if not (recon2 == recon).all():
        fail("cli run --impl kernel2 reconstructs other frames than --impl auto")
    print(f"cli run --impl kernel2: pair kernel launches={launches['qvrcnn_pair']}, recon == "
          f"phase 4's; impl={run2['impl']}; {run2['time_us'] / 1e3 / n_frames:.3f} ms/frame incl. "
          f"H2D/D2H {card}")

    # ---- phase 9: the matrix-rate probe, exact at grid 2, then its tool
    for pname, kind, k, n in mma_probe.CASES:
        err = mma_probe.check_case(kind, k, n)
        max_errs["mma_probe"] = max(max_errs.get("mma_probe", 0), err)
        print(f"mma_probe {pname} (K={k}, N={n}) vs plain, grid 2: max_abs_err={err}")
        if err != 0:
            fail(f"mma_probe {pname} differs from its plain version")
    zero_counts()
    mma_probe.main()
    launches["mma_probe"] = counts()["mma_probe"]
    if launches["mma_probe"] <= 0:
        fail("tools/mma_probe launched the probe kernel no time")

    # ---- phase 10: tools/bench_kernels, then v3, v2 and v1 timed
    # at 1080p batch 4 (the main path's batch) beside their plain versions
    zero_counts()
    bench_kernels.main([])
    n_bench = counts()["qvrcnn_literal"]
    if n_bench <= 0:
        fail("tools/bench_kernels launched the literal kernel no time")
    print(f"tools/bench_kernels: literal kernel launches={n_bench}")
    b = 4
    xd = torch.from_numpy(frames(b, H, W, seed=b)).to(dev)
    lw37 = lws["golden-QP37"]
    px = b * H * W
    # v3, v2 and v1 in turns: v3 v2 v1 v1 v2 v3
    runs = {"v3": lambda: fused_forward(xd, fw37), "v2": lambda: pair_forward(xd, fw37),
            "v1": lambda: literal_residual(xd, lw37)}
    turns = {k: [] for k in runs}
    for k in runs:
        runs[k]()
    for k in list(runs) + list(runs)[::-1]:
        turns[k].append(events_ms(runs[k], 20))
    mean = {k: sum(v) / len(v) for k, v in turns.items()}
    for k, v in turns.items():
        print(f"{k} at 1080p batch {b}, in turns: {mean[k] / b:.4f} ms/frame "
              f"({' / '.join(f'{t / b:.4f}' for t in v)}), {mean[k] / mean['v3']:.4f} of v3 {card}")
    pair_forward_reference(xd, fw37)
    literal_residual_reference(xd, lw37)
    measured = {
        "qvrcnn_fused": (mean["v3"], times[b][1]),
        "qvrcnn_pair": (mean["v2"],
                        events_ms(lambda: pair_forward_reference(xd, fw37), 2)),
        "qvrcnn_literal": (mean["v1"], events_ms(lambda: literal_residual_reference(xd, lw37), 2)),
    }
    for kname, (k_ms, p_ms) in measured.items():
        print(f"{kname} 1080p batch {b}: kernel {k_ms / b:.4f} ms/frame, plain "
              f"{p_ms / b:.4f} ms/frame {card}")
    a, w = mma_probe.probe_inputs("int8", 128, 128, grid=sms, device=dev)
    w_op = mma_probe.kernel_operand(w)
    mma_probe.mma_probe(a, w, w_op)
    mma_probe.mma_probe_reference(a, w)
    measured["mma_probe"] = (events_ms(lambda: mma_probe.mma_probe(a, w, w_op), 10),
                             events_ms(lambda: mma_probe.mma_probe_reference(a, w), 2))
    print(f"mma_probe int8_i32 grid {sms}: kernel {measured['mma_probe'][0]:.4f} ms, plain "
          f"{measured['mma_probe'][1]:.4f} ms {card}")

    # ---- phase 11: the streaming engine. (a) phase 4's raw stream under
    # the host-sync check, then traced: a copy must overlap the kernel
    model = os.path.join(GOLDEN, "model_q37.data")
    eng = Engine(device="cuda")
    eng.load_model(37, model)
    eng.warmup(37, H, W, n_frames, transport="duplex")  # raw shapes, rings, duplex
    zero_counts()
    with no_host_sync():
        got = eng.restore_stream(anchor, 37, transport="raw")
    n_raw = counts()["qvrcnn_fused"]
    if n_raw <= 0 or not (got == recon).all():
        fail(f"pipelined raw stream: {n_raw} fused launches, recon equal to phase 4: "
             f"{bool((got == recon).all())}")
    tr = trace_stream(eng, anchor, 37, "raw")
    print(f"raw stream {n_frames}x{H}x{W} under set_sync_debug_mode('error'): no host sync, "
          f"recon == phase 4, fused launches={n_raw}; traced: window {tr['window_us']:.1f} us "
          f"({tr['window_us'] / 1e3 / n_frames:.4f} ms/frame), kernel {tr['kernel_us']:.1f} us "
          f"({100 * tr['kernel_share']:.1f}% busy), H2D {tr['h2d_us']:.1f} us, D2H "
          f"{tr['d2h_us']:.1f} us, memcpy/kernel overlap {tr['overlap_us']:.1f} us {card}")
    if tr["kernel_launches"] <= 0 or tr["overlap_us"] <= 0:
        fail(f"no memcpy/kernel overlap in the traced raw stream: {tr}")

    # (b) a static camera through cli run --transport raw and duplex
    ori_s, anchor_s = static_camera(n_frames, H, W, seed=3)
    static = {k: os.path.join(tmp, f"static_{k}.yuv") for k in ("ori", "anchor")}
    write_yuv420(static["ori"], ori_s)
    write_yuv420(static["anchor"], anchor_s)
    launched_sr, recon_sr, run_sr = cli_run("auto", "raw", static)
    launched_sd, recon_sd, run_sd = cli_run("auto", "duplex", static)
    wire = run_sd["transport"]
    raw_bytes = n_frames * H * W
    print(f"static camera {n_frames}x{H}x{W}: cli run --transport raw {run_sr['time_us'] / 1e3 / n_frames:.4f} "
          f"ms/frame (fused launches={launched_sr['qvrcnn_fused']}), --transport duplex "
          f"{run_sd['time_us'] / 1e3 / n_frames:.4f} ms/frame (fused launches="
          f"{launched_sd['qvrcnn_fused']}), impl={run_sd['impl']}; duplex wire h2d "
          f"{wire.get('h2d_bytes')} B, d2h {wire.get('d2h_bytes')} B against raw {raw_bytes} B "
          f"each way ({wire.get('full_steps')} full, {wire.get('packed_steps')} packed steps, "
          f"{wire.get('dense_fetches')} dense fetches) {card}")
    if launched_sd["qvrcnn_fused"] <= 0 or not (recon_sd == recon_sr).all():
        fail("cli run --transport duplex: no fused launch, or recon differs from --transport raw")
    if not run_sd["impl"].endswith("+duplex") or wire.get("packed_steps", 0) < 1:
        fail(f"cli run --transport duplex served {run_sd['impl']} with {wire}")
    if not (wire["h2d_bytes"] < raw_bytes and wire["d2h_bytes"] < raw_bytes):
        fail(f"the duplex wire moved no fewer bytes than raw: {wire}")
    print(f"duplex host split, cli run: {duplex_host_split(wire, run_sd['time_us'] / 1e6)} {card}")
    eng.restore_stream(anchor_s, 37, transport="duplex")  # the transport meets this content
    zero_counts()
    t0 = time.perf_counter()
    with no_host_sync():
        got = eng.restore_stream(anchor_s, 37, transport="duplex")
    window = time.perf_counter() - t0
    n_duplex = counts()["qvrcnn_fused"]
    steps = eng.last_stream["packed_steps"]
    if n_duplex <= 0 or steps < 1 or not (got == recon_sr).all():
        fail(f"duplex stream: {n_duplex} launches, {steps} packed steps, recon equal to raw: "
             f"{bool((got == recon_sr).all())}")
    print(f"duplex host split, under the sync check: "
          f"{duplex_host_split(eng.last_stream, window)} {card}")
    tr = trace_stream(eng, anchor_s, 37, "duplex")
    print(f"duplex stream under set_sync_debug_mode('error'): no host sync, recon == raw, "
          f"{steps} packed steps, {eng.last_stream['dense_fetches']} dense fetches; traced: window {tr['window_us']:.1f} us, kernel "
          f"{tr['kernel_us']:.1f} us, duplex device ops {tr['other_us']:.1f} us in "
          f"{tr['other_ops']} ({tr['other_us'] / max(tr['packed_steps'], 1):.1f} us per packed "
          f"step of 4 frames), H2D {tr['h2d_us']:.1f} us, D2H {tr['d2h_us']:.1f} us {card}")

    # (c) cli run --transport auto on phase 4's frames
    launched_a, recon_a, run_a = cli_run("auto", "auto")
    dec = run_a["transport"].get("auto", {})
    print(f"cli run --transport auto: chose {dec.get('transport')} (served "
          f"{run_a['transport']['served']}); link {dec.get('link_mbps', 0):.1f} MB/s = "
          f"{dec.get('link_fps', 0):.1f} fps from {dec.get('link_seconds')} s, device "
          f"{dec.get('device_fps', 0):.1f} fps from {dec.get('device_seconds')} s; "
          f"{run_a['time_us'] / 1e3 / n_frames:.4f} ms/frame, fused launches="
          f"{launched_a['qvrcnn_fused']} {card}")
    if len(dec.get("link_seconds", ())) < 3 or len(dec.get("device_seconds", ())) < 3:
        fail(f"transport auto decided from fewer than 3 + 3 samples: {dec}")
    if launched_a["qvrcnn_fused"] <= 0 or not (recon_a == recon).all():
        fail("cli run --transport auto: no fused launch, or recon differs from raw")

    # ---- phase 12: generation 1 as an engine program. Phase 7's tables
    # outside the saturation window through cli run --impl kernel1 and
    # --impl auto (which must pick generation 1), equal to the plain
    # version on the card; --impl kernel refuses them. The kernels line
    # reads the literal launches of the first table's --impl auto run
    for label, table in (("C2_2 bound one step up", p_out), ("S1 bound raised by half", p_half)):
        model = os.path.join(tmp, f"model_{label.split()[0]}_moved.data")
        write_static_qfp_vect_c(model, table)
        lw_t = LiteralWeights.from_engine(table, dev)
        want = np.concatenate([
            literal_forward_reference(torch.from_numpy(anchor[i:i + 4]).to(dev), lw_t).cpu().numpy()
            for i in range(0, n_frames, 4)
        ])
        for impl in ("kernel1", "auto"):
            launched, recon1, run1 = cli_run(impl, model=model)
            if run1["impl"] != "kernel1" or launched["qvrcnn_literal"] <= 0 \
                    or launched["qvrcnn_fused"] != 0 or not (recon1 == want).all():
                fail(f"cli run --impl {impl}, {label}: impl {run1['impl']}, launches {launched}, "
                     f"recon equal to the plain version: {bool((recon1 == want).all())}")
            if impl == "auto":
                launches.setdefault("qvrcnn_literal", launched["qvrcnn_literal"])
            print(f"cli run --impl {impl}, table with the {label}: impl={run1['impl']}, literal "
                  f"kernel launches={launched['qvrcnn_literal']}, fused 0, recon == plain "
                  f"version; {run1['time_us'] / 1e3 / n_frames:.4f} ms/frame incl. H2D/D2H {card}")
        err = io.StringIO()
        with contextlib.redirect_stderr(err):
            rc = cli.main(["run", "--ori", yuv["ori"], "--anchor", yuv["anchor"], "--height",
                           str(H), "--width", str(W), "--frames", str(n_frames), "--model", model,
                           "--qp", "37", "--device", "cuda", "--impl", "kernel",
                           "--out-dir", os.path.join(tmp, "refused")])
        if rc != 1 or "saturation window" not in err.getvalue():
            fail(f"cli run --impl kernel on the table with the {label}: exit {rc}, "
                 f"{err.getvalue()!r}")
        print(f"cli run --impl kernel, {label}: exit 1, {err.getvalue().strip()[:100]}...")

    # ---- phase 13: the dynamic path. A dynamic model from the QP37 model's
    # weights with seeded steps; cli calibrate-dynamic (both modes, with the
    # b_adj dump) and cli validate on 4 frames of 416x240, on the card and
    # on the CPU: the files and the text must be equal. Then cli
    # calibrate-dynamic on 4 of phase 4's 1920x1080 anchors on the card, and
    # each forward's ms/frame there
    dyn = DynamicParams([int(v) for v in np.random.default_rng(13).integers(2, 30, 6)],
                        list(p37.weights), list(p37.biases))
    dyn_model = os.path.join(tmp, "model_q37_dynamic.data")
    write_dynamic_hwcn(dyn_model, dyn)
    n_cal = 4
    small = os.path.join(tmp, "calibrate_416x240.yuv")
    write_yuv420(small, frames(n_cal, 240, 416, seed=13))

    def calibrate(device, d, anchor_yuv, h, w):
        """cli calibrate-dynamic in both modes into `d`; -> {mode: (text, s)}."""
        os.makedirs(d)
        got = {}
        for mode, model in (("dynamic", dyn_model), ("hybrid", os.path.join(GOLDEN, "model_q37.data"))):
            extra = ["--b-adj-out", os.path.join(d, "b_adj.data")] if mode == "dynamic" else []
            out = io.StringIO()
            t0 = time.perf_counter()
            with contextlib.redirect_stdout(out):
                rc = cli.main(["calibrate-dynamic", "--mode", mode, "--model", model, "--anchor",
                               anchor_yuv, "--height", str(h), "--width", str(w), "--frames",
                               str(n_cal), "--out", os.path.join(d, f"max_u_{mode}.data"),
                               "--device", device, *extra])
            if rc != 0:
                fail(f"cli calibrate-dynamic --mode {mode} --device {device} exited {rc}")
            got[mode] = (out.getvalue().replace(d, "{dir}"), time.perf_counter() - t0)
        return got

    files, texts, secs = {}, {}, {}
    for device in ("cuda", "cpu"):
        d = os.path.join(tmp, f"calibrate-{device}")
        for mode, (text, sec) in calibrate(device, d, small, 240, 416).items():
            texts[device, mode], secs[device, mode] = text, sec
        out = io.StringIO()
        with contextlib.redirect_stdout(out):
            rc = cli.main(["validate", "--model", os.path.join(GOLDEN, "model_q37.data"),
                           "--anchor", small, "--height", "240", "--width", "416",
                           "--dump-features", os.path.join(d, "features.bin"), "--device", device])
        if rc != 0:
            fail(f"cli validate --device {device} exited {rc}")
        texts[device, "validate"] = out.getvalue().replace(d, "{dir}")
        for name in sorted(os.listdir(d)):
            with open(os.path.join(d, name), "rb") as fp:
                files[device, name] = fp.read()
    for key in ("dynamic", "hybrid", "validate"):
        if texts["cuda", key] != texts["cpu", key]:
            fail(f"cli {key}: the text on cuda differs from the CPU's")
    for (device, name), data in files.items():
        if device == "cuda" and (not data or files.get(("cpu", name)) != data):
            fail(f"{name}: the card's bytes differ from the CPU's (or are empty)")
    print(f"dynamic path: cli calibrate-dynamic (dynamic, hybrid) on {n_cal} frames of "
          f"416x240 and cli validate on the first: text and files ({', '.join(f'{n} {len(b)} B' for (dv, n), b in sorted(files.items()) if dv == 'cuda')}) "
          f"equal on cuda and cpu; {texts['cuda', 'dynamic'].strip()}")
    for mode in ("dynamic", "hybrid"):
        print(f"cli calibrate-dynamic --mode {mode} on {n_cal} frames of 416x240: "
              f"{1e3 * secs['cuda', mode] / n_cal:.1f} ms/frame on cuda, "
              f"{1e3 * secs['cpu', mode] / n_cal:.1f} on cpu (whole command) {card}")
    for mode, (text, sec) in calibrate("cuda", os.path.join(tmp, "calibrate-1080p"),
                                       yuv["anchor"], H, W).items():
        print(f"cli calibrate-dynamic --mode {mode} on {n_cal} frames of {H}x{W} on cuda: "
              f"{1e3 * sec / n_cal:.1f} ms/frame (whole command); {text.strip()} {card}")
    xd = torch.from_numpy(anchor[:1]).to(dev)
    for mode, run in (("dynamic", make_dynamic_forward(dyn, device=dev)),
                      ("hybrid", make_hybrid_forward(p37, device=dev))):
        run(xd)
        t0 = time.perf_counter()
        for _ in range(5):
            run(xd)  # reads its telemetry back: one sync per call
        print(f"{mode} forward on cuda, one {H}x{W} frame: "
              f"{1e3 * (time.perf_counter() - t0) / 5:.3f} ms/frame {card}")

    # ---- phase 14: the training path at full width on the card
    training_path(cli, tmp, card, zero_counts, counts, anchor)
    tmp_dir.cleanup()

    # least time for the same work: operations over the int8 peak, bytes
    # (each input read once, each output written once) over HBM's rate
    net_ops = 2 * MACS_PER_PIXEL * px
    bounds_in = {
        "qvrcnn_fused": (net_ops, 2 * px), "qvrcnn_pair": (net_ops, 2 * px),
        "qvrcnn_literal": (net_ops, 3 * px),
        "mma_probe": (2 * mma_probe.macs(a, w), a.numel() + w.numel() + 4 * a.shape[0]
                      * a.shape[1] * w.shape[2]),
    }
    rows = []
    for kname, (source, replaces) in KERNELS.items():
        ops, nbytes = bounds_in[kname]
        ops_ms, bytes_ms = ops / PEAK_INT8_OPS * 1e3, nbytes / PEAK_BYTES * 1e3
        k_ms, p_ms = measured[kname]
        rows.append({
            "name": kname, "route": "cuda", "source": source, "replaces": replaces,
            "launches": launches[kname], "max_abs_err": max_errs[kname], "ms": k_ms,
            "plain_ms": p_ms, "bound_ms": max(ops_ms, bytes_ms),
            "bound_by": "operations" if ops_ms >= bytes_ms else "bytes", "library_ms": None,
        })
    print(json.dumps({"kernels": rows}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}))
    return 0


def training_path(cli, tmp: str, card: str, zero_counts, counts, anchor_1080p) -> None:
    """Phase 14: the training path at full width on the card, through the
    port's CLI: the demo's data, `train` (and its first steps on the CPU
    too), `calibrate` on both devices, `finetune`, `eval-float`, the
    trained model served by `cli run --impl auto`, and the demo's byte
    target."""
    import numpy as np
    import torch

    from qcnn_gpu_tpu_torch.data import yuv as Y
    from qcnn_gpu_tpu_torch.data.datasets import PatchDataset
    from qcnn_gpu_tpu_torch.data.model_files import write_static_qfp_vect_c
    from qcnn_gpu_tpu_torch.engine.calibrate import quantize_model
    from qcnn_gpu_tpu_torch.engine.runner import read_model
    from qcnn_gpu_tpu_torch.models import float_model as FM
    from qcnn_gpu_tpu_torch.models.topology import MACS_PER_PIXEL, QVRCNN_LAYERS
    from qcnn_gpu_tpu_torch.ops.fused import FusedWeights, fused_forward_reference
    from qcnn_gpu_tpu_torch.ops.literal import LiteralWeights, literal_forward_reference
    from qcnn_gpu_tpu_torch.quant.params import QuantTable
    from qcnn_gpu_tpu_torch.testing import dct_compress, make_clean_frames
    from qcnn_gpu_tpu_torch.tools import PEAK_FP32_FLOPS
    from qcnn_gpu_tpu_torch.train.checkpoint import load_checkpoint
    from qcnn_gpu_tpu_torch.train.trainer import TrainConfig, Trainer

    t_phase = time.perf_counter()
    d = os.path.join(tmp, "training")
    os.makedirs(d)
    dev = torch.device("cuda")

    def run_cli(*argv):
        """cli.main(argv) with its stdout kept; -> (stdout, seconds)."""
        out = io.StringIO()
        t0 = time.perf_counter()
        with contextlib.redirect_stdout(out):
            rc = cli.main([str(a) for a in argv])
        if rc != 0:
            fail(f"cli {' '.join(str(a) for a in argv)} exited {rc}")
        return out.getvalue(), time.perf_counter() - t0

    # (1) the demo's data (scripts/train_demo.py): 12 clean frames and their
    # DCT q=28 anchors, and a held-out pair from seed 99, as YUV files
    t0 = time.perf_counter()
    side, lr, batch = 256, 1e-3, 64
    clean = make_clean_frames(12, side, side)
    anchor = dct_compress(clean, q=28.0)
    clean_ev = make_clean_frames(4, side, side, seed=99)
    anchor_ev = dct_compress(clean_ev, q=28.0)
    files = {}
    for name, y in (("ori", clean), ("anchor", anchor), ("ori_ev", clean_ev), ("anchor_ev", anchor_ev)):
        files[name] = os.path.join(d, f"{name}.yuv")
        Y.write_y_as_420(files[name], y)
    print(f"training data: 12 clean {side}x{side} frames and DCT q=28 anchors (PSNR "
          f"{Y.psnr(anchor, clean):.4f} dB), held-out 4 (anchor PSNR "
          f"{Y.psnr(anchor_ev, clean_ev):.4f} dB); {time.perf_counter() - t0:.2f} s on the host")
    geo = ["--height", side, "--width", side]
    train_args = ["train", "--ori", files["ori"], "--anchor", files["anchor"], *geo, "--frames", 12,
                  "--batch-size", batch, "--lr", lr]

    # (2) cli train on the card at the reference's batch (64 patches of
    # 64x64), lr 1e-3: the loss falls; ms/step against the float32 bound
    steps = 300
    ckpt = os.path.join(d, "ckpt")
    out, secs = run_cli(*train_args, "--steps", steps, "--ckpt", ckpt, "--device", "cuda")
    logged = [float(v) for v in re.findall(r"^step \d+: loss (\S+)", out, re.M)]
    if len(logged) != steps // 10:
        fail(f"cli train logged {len(logged)} losses in {steps} steps")
    first, last = sum(logged[:20]) / 20, sum(logged[-20:]) / 20
    if not last < first:
        fail(f"cli train: the loss did not fall: first 20 logged {first:.4f}, last 20 {last:.4f}")
    px = batch * 64 * 64
    c1_macs = QVRCNN_LAYERS[0].ksize ** 2 * QVRCNN_LAYERS[0].in_ch * QVRCNN_LAYERS[0].out_ch
    # forward, then the weight gradients (the same products) and the input
    # gradients of every layer but C1
    step_flops = 2 * (3 * MACS_PER_PIXEL - c1_macs) * px
    bound_ms = step_flops / PEAK_FP32_FLOPS * 1e3
    print(f"cli train --device cuda, {steps} steps of {batch}x64x64: mean loss of the first 20 "
          f"logged steps {first:.4f}, of the last 20 {last:.4f}; whole command {secs:.2f} s = "
          f"{1e3 * secs / steps:.3f} ms/step {card}")
    ds = PatchDataset([(clean, anchor)], patch=64, seed=0)
    batches = list(ds.batches(batch, 60))
    tr = Trainer(TrainConfig(lr=lr, log_every=0), device=dev)
    tr.fit_batches(batches[:10])  # warm-up (cuDNN's choices, the allocator)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    tr.fit_batches(batches[10:])
    torch.cuda.synchronize()
    ms_step = 1e3 * (time.perf_counter() - t0) / 50
    print(f"train step on cuda, {batch}x64x64 (host clock over 50 steps, H2D of each batch "
          f"included): {ms_step:.4f} ms/step; bound {bound_ms:.4f} ms ({step_flops:.4g} FLOP over "
          f"{PEAK_FP32_FLOPS:.3g} FLOP/s float32) {card}")

    # (3) the first 3 steps on cuda and on the CPU from the same seed and
    # batches: the CPU tests' tolerance
    first3 = {}
    for device in ("cuda", "cpu"):
        c = os.path.join(d, f"first3-{device}")
        out, secs3 = run_cli(*train_args, "--steps", 3, "--ckpt", c, "--device", device)
        first3[device] = (float(re.search(r"last loss (\S+)", out).group(1)),
                          load_checkpoint(c)[0], secs3)
    (lc, pc, sc), (lh, ph, sh) = first3["cuda"], first3["cpu"]
    diffs = np.concatenate([np.abs(pc[k] - ph[k]).ravel() for k in FM.PARAM_NAMES])
    if abs(lc - lh) > 1e-4 * abs(lh) or diffs.max() > 2 * lr * 3 or np.median(diffs) > 1e-6:
        fail(f"first 3 steps: loss {lc} on cuda, {lh} on cpu; params max |diff| {diffs.max():.3g}, "
             f"median {np.median(diffs):.3g}")
    print(f"cli train --steps 3 on cuda and cpu: last loss {lc:.6f} / {lh:.6f} (rel "
          f"{abs(lc - lh) / abs(lh):.2e}), params max |diff| {diffs.max():.3g}, median "
          f"{np.median(diffs):.3g}; {sc:.2f} s / {sh:.2f} s (whole commands) {card}")

    # (4) cli calibrate --sample on both devices: bounds within rtol 1e-4;
    # the tables equal or not (the solve jumps for small bound changes); the
    # presets' table and model byte-equal; one table's model file equal
    # whichever device the params went through
    got = {}
    for device in ("cuda", "cpu"):
        paths = [os.path.join(d, f"{device}-{kind}.data") for kind in ("table", "model")]
        out, secs_c = run_cli("calibrate", "--ckpt", ckpt, "--sample", files["anchor"], *geo,
                              "--frames", 4, "--table-out", paths[0], "--model-out", paths[1],
                              "--device", device)
        bounds = [float(v) for v in out.splitlines()[0].removeprefix("blu bounds: ").split(", ")]
        preset = [os.path.join(d, f"{device}-preset-{kind}.data") for kind in ("table", "model")]
        run_cli("calibrate", "--ckpt", ckpt, "--qp", 37, "--table-out", preset[0], "--model-out",
                preset[1], "--device", device)
        got[device] = (bounds, [open(f, "rb").read() for f in paths + preset], secs_c, paths)
    rel = max(abs(a - b) / abs(b) for a, b in zip(got["cuda"][0], got["cpu"][0]) if b)
    same_table = got["cuda"][1][0] == got["cpu"][1][0]
    if rel > 1e-4 or got["cuda"][1][2:] != got["cpu"][1][2:] or (
            same_table and got["cuda"][1][1] != got["cpu"][1][1]):
        fail(f"cli calibrate: bounds rel diff {rel:.3g}; preset files equal "
             f"{got['cuda'][1][2:] == got['cpu'][1][2:]}")
    table_path, model_cal = got["cuda"][3]
    table = QuantTable.load_pickle(table_path)
    params = load_checkpoint(ckpt)[0]
    one_table = {}
    for device in ("cuda", "cpu"):
        buf = io.BytesIO()
        write_static_qfp_vect_c(buf, quantize_model(FM.FloatVRCNN(params, device=device).to_jax(),
                                                    table))
        one_table[device] = buf.getvalue()
    if one_table["cuda"] != one_table["cpu"] or one_table["cuda"] != got["cuda"][1][1]:
        fail("the model file from the card's table differs across the devices")
    print(f"cli calibrate --sample (4 anchors): bounds on cuda {[round(b, 6) for b in got['cuda'][0]]}, "
          f"max rel diff to the CPU's {rel:.2e}; tables equal: {same_table}; model files from the "
          f"card's table byte-equal on both devices; presets' table and model byte-equal; "
          f"{got['cuda'][2]:.2f} s on cuda, {got['cpu'][2]:.2f} s on cpu (whole commands) {card}")

    # (5) cli finetune (100 steps on the card's table's grid) and eval-float
    model_ft = os.path.join(d, "model_q_ft.data")
    out, secs_f = run_cli("finetune", "--ckpt", ckpt, "--table", table_path, "--ori", files["ori"],
                          "--anchor", files["anchor"], *geo, "--frames", 12, "--steps", 100,
                          "--batch-size", batch, "--model-out", model_ft, "--device", "cuda")
    print(f"cli finetune --device cuda, 100 steps of {batch}x64x64: {secs_f:.2f} s = "
          f"{10 * secs_f:.3f} ms/step (whole command); {out.strip()} {card}")
    for c in (ckpt, ckpt + "_qfp"):
        out, secs_e = run_cli("eval-float", "--ckpt", c, "--ori", files["ori_ev"], "--anchor",
                              files["anchor_ev"], *geo, "--frames", 4, "--out-dir", d,
                              "--device", "cuda")
        print(f"cli eval-float --device cuda {os.path.basename(c)} on the held-out 4: "
              f"{out.strip()}; {secs_e:.2f} s {card}")

    # (6) the trained models served: cli run --impl auto on the held-out
    # anchors, launch counts zeroed before and read after, recon == the
    # served kernel's plain version on the card
    x = torch.from_numpy(anchor_ev).to(dev)
    for label, model in (("calibrated", model_cal), ("fine-tuned", model_ft)):
        out_dir = os.path.join(d, f"run-{label}")
        recon_path = os.path.join(out_dir, "recon.yuv")
        zero_counts()
        rc = cli.main(["run", "--ori", files["ori_ev"], "--anchor", files["anchor_ev"],
                       *[str(a) for a in geo], "--frames", "4", "--model", model, "--qp", "37",
                       "--device", "cuda", "--impl", "auto", "--out-dir", out_dir,
                       "--recon", recon_path])
        launched = counts()
        if rc != 0:
            fail(f"cli run --impl auto on the {label} model exited {rc}")
        with open(os.path.join(out_dir, "runs.jsonl")) as fp:
            rec = json.loads(fp.readline())
        served = rec["impl"].split("+")[0]
        p = read_model(model)
        if served == "kernel3":
            kname, want = "qvrcnn_fused", fused_forward_reference(x, FusedWeights.from_engine(p, dev))
        elif served == "kernel1":
            kname, want = "qvrcnn_literal", literal_forward_reference(x, LiteralWeights.from_engine(p, dev))
        else:
            fail(f"cli run --impl auto served {rec['impl']!r}")
        recon = read_y420(recon_path, 4, side, side)
        if launched[kname] <= 0 or not (recon == want.cpu().numpy()).all():
            fail(f"cli run --impl auto, {label} model: {kname} launches {launched[kname]}, recon "
                 f"equal to the plain version: {bool((recon == want.cpu().numpy()).all())}")
        print(f"cli run --impl auto, {label} model, 4 held-out {side}x{side} frames: served "
              f"{served}, {kname} launches={launched[kname]}, recon == plain version on the card; "
              f"INT8 PSNR {rec['psnr_after']:.4f} dB against anchor {rec['psnr_before']:.4f} dB "
              f"({rec['psnr_after'] - rec['psnr_before']:+.4f}) {card}")

    # (7) tiled float prediction against the whole frame on the card (cuDNN
    # may pick another algorithm per tile shape): the pixels that differ
    tp = FM.params_from_jax(params, dev)
    for frames_in, tile in ((anchor_ev, 96), (anchor_1080p[:1], 768)):
        whole = FM.predict_uint8(tp, frames_in).cpu().numpy()
        tiled = FM.predict_uint8_tiled(tp, frames_in, tile=tile)
        print(f"predict_uint8_tiled on cuda, {frames_in.shape} in {tile}x{tile} tiles: "
              f"{int((whole != tiled).sum())} of {whole.size} pixels differ from the whole frame")

    # (8) the demo's byte target on this machine
    demo = os.path.join(HERE, "assets", "demo")
    buf = io.BytesIO()
    write_static_qfp_vect_c(buf, quantize_model(load_checkpoint(os.path.join(demo, "ckpt"))[0],
                                                QuantTable.load_pickle(os.path.join(demo, "quant_table.data"))))
    with open(os.path.join(demo, "model_q.data"), "rb") as fp:
        if buf.getvalue() != fp.read():
            fail("quantize_model(ckpt-1500, quant_table.data) differs from assets/demo/model_q.data")
    print(f"demo byte target: quantize_model(ckpt-1500, quant_table.data) as vect_c == "
          f"assets/demo/model_q.data ({len(buf.getvalue())} B)")
    print(f"phase 14: {time.perf_counter() - t_phase:.1f} s")


if __name__ == "__main__":
    sys.exit(main())
