#!/usr/bin/env python3
"""Smoke run of the PyTorch port (qcnn_gpu_tpu_torch) on one NVIDIA GPU.

    python3 chip_smoke.py

Run from the root of a checkout on a machine with a CUDA GPU, `nvcc` and
a CUDA build of PyTorch. It imports torch, numpy and the port only. It
builds the kernels from the four sources in qcnn_gpu_tpu_torch/csrc (one
nvcc each, all at once) and then:

  1-5  the kernels' `ptxas` reports (registers, spills; none allowed in
       the three network kernels, every tile instance of generation 3
       built) and shared memory; the fused kernel
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
       (generation 1) kernels, both instances of generation 3's design,
       bit for bit against their plain versions on phase 2's cases, odd
       batches included (the frame-bounds cases: generation 1 alone);
  7    the literal kernel on two tables of the QP37 model outside the
       solver's saturation window (C2_2's bound one step up; S1's raised by
       half, whose activations pass 127 on random frames), against its plain
       version, over whole frames and under frame bounds (a row band and a
       2-D rectangle, as a mesh's blocks pass them), and the literal 6-conv
       graph; the folded-epilogue weights must refuse both;
  8    `cli run --impl kernel2` on phase 4's frames: the pair kernel's path,
       reconstruction equal to phase 4's;
  9    the matrix-rate probe (its int8 and bf16 chains on `wgmma`, A in
       registers, a ring of w + s buffers filled by a producer warpgroup;
       `ptxas` must report 0 spills in each chain instance): the seven
       chain cases bit for bit against their plain version at grid 2, int8
       and bf16 at K = N = 128 and the negative-sum seed at one block per
       SM, then its tool (`tools/mma_probe`) end to end, which also prints
       the `wgmma` issue rate at each int8 case's N (`tools/wgmma_rate`),
       the library products' yardstick and the `mma.sync` issue ceiling
       (measurements with no TPU counterpart, so not in the kernels line);
  10   `tools/bench_kernels` (its literal launches on a line of their
       own), then v3 at the table's tile for 1080p batch 4 (v3t, the
       instance phase 4 launched, which the kernels line's row 1 times),
       v3 at 24x40, v2 and v1 timed at 1080p batch 4 in turns (v3t v3 v2
       v1 v1 v2 v3 v3t), beside their plain versions; then each tile
       instance of v3 (all three are instances of the split template,
       csrc/qvrcnn_split.cuh): this build's `ptxas` registers and spills
       and its ms/frame in CUDA-graph replays (the kernels line's
       `instances`), printed beside a record (PARENT_FUSED, not measured
       by this script) of the parent commit's build as
       `tools/compare_builds` timed the two in turns in one call;
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
       assets/demo/model_q.data);
  15   the mesh path, on virtual meshes over cuda:0 (every shard a launch
       of generation 3, or of generation 1 for a table outside the window,
       with its frame bounds): (a) `make_sharded_forward`
       at 1x4, 2x2, 1x8, 1x2x2, 2x2x2 and 4x1 on phase 4's anchors (batch 4, 8
       at 2x2x2), equal to phase 4, each block's kernel output equal to
       its plain version with the same bounds, dp*sp*sw launches a call;
       phase 2's 240p cases of every kind at 1x2x2; (b) `cli run --mesh
       1x4` on phase 4's frames and `--mesh 1x2x2 --transport duplex` on
       phase 11's static camera (recon equal, `runs.jsonl` mesh and impl,
       launches = (warm-up calls + batches) x shards); (c) `cli run
       --config` with a 2x2 mesh; (d) `DistributedRunner` in 2 processes
       on gloo, 4 frames each: both return the global 8, and its psnr is
       the host PSNR to the last bit; (e) `auto` under a mesh serves
       phase 7's table outside the saturation window with generation 1
       under each block's frame bounds at 1x2, 2x2 and 1x2x2 (one literal
       launch a block a call), equal to the unsharded literal kernel and
       the reference net, timed in turns against it at 1080p batch 4;
       `--impl kernel2` under a mesh raises; the sharded reference net
       serves the table at 1x2; (f) the unsharded kernel against 1x4, 2x2 and 1x2x2
       at 1080p batch 4 in turns (u 1x4 2x2 1x2x2 1x2x2 2x2 1x4 u), with
       the tile overhead each mesh implies, then u 4x1 4x1 u (four
       launches of a frame each, no tile overhead: the launches' cost). Each of
       phase 15's paths prints its own launches; the kernels line's
       fused launches stay phase 4's run, and its literal row carries
       (e)'s launches and ms/frame by mesh (`mesh`);
  16   the wide CNN family and tensor parallelism on cuda:0, at full width
       (256 channels, 10 body convs, 832x480), through library GEMMs (the
       JAX package runs XLA convolutions there, no Pallas kernel): (a)
       `make_wide_forward` (im2col + `torch._int_mm`, int32 epilogues) on
       2 seeded frames and the c32 b3 twin, bit-equal to the plain version
       on the card; (b) `tools/bench_wide` at its defaults (ms/frame and
       int8 TOP/s against the 2.382 ms/frame bound) and a 2-frame call's
       device time by part (im2col, GEMM, band assembly, epilogue, other:
       by launching span); (c) `make_wide_forward_fp8`
       (`torch._scaled_mm`) against its plain version (max |diff| <= 1)
       and the float model (JAX's bounds: PSNR > 40 dB, max |diff| <= 8),
       its weight bytes and ms/frame; (d) `make_tp_wide_forward` at tp
       2, 4, 8 bit-equal to (a), and `make_tp_int8_forward` (QP37) at tp
       1, 2, 4, 8 on phase 4's
       anchors bit-equal to phase 4's generation-3 recon, each timed in
       turns against tp 1 (QVRCNN's also against generation 3); a JSON
       line {"library_routes": [...]} sums the routes up;
  17   (dp, sp)-sharded training on virtual meshes over cuda:0, on phase
       14's data (64 patches of 64x64): `make_grad_fn` at 2x1, 1x2, 2x2
       and 1x4 against 1x1 (loss rel 1e-5, every gradient within 1e-5 of
       its max |g|), ms/step per mesh in turns, 20 Adam steps of
       `Trainer(mesh=2x2)` (the loss falls), `quant_finetune` on a 1x2
       mesh (the weights on the grid);
  18   the tuned table (ops/tuning.py, qcnn_gpu_tpu_torch/tuned_h100.json)
       and generation 3's tile instances (ops/fused.TILES): (a) every
       instance, and generation 2's one (24x40), bit for bit against its
       plain version on phase 2's cases (frame bounds: generation 3 alone)
       and on frames smaller than any tile, ragged in both axes, where the
       card's plain version is first held equal to the CPU's; (b) at the six reference
       geometries, batch 1 and 4, the table's program (`build_tuned`)
       against generation 3 at 24x40: equal recon, ms/frame of each in
       turns (base tuned tuned base, CUDA-graph replays: device time, not
       the host's enqueue), the tile served; (c) `cli run
       --config` (batch_frames 1) on 8 frames of 416x240: the table's
       instance launched, no other tile;
  19   meshes whose axes span processes, host tiling and the native Y
       reader: (a) `DistributedRunner` in 2 gloo processes on cuda:0 over
       global meshes (`make_global_mesh`) 1x2, 1x4, 1x2x2 and 1x1x2, the
       QP37 model at 1920x1080 batch 4 on phase 4's anchors, each rank
       passing its slice: both ranks return the global batch equal to
       phase 4's recon, generation 3 launched once per position a rank
       owns, the halo bytes each rank sends and receives, ms per call in
       turns against the same mesh in one process; then phase 7's table
       outside the window at global 1x2: generation 1, once a rank, both
       ranks equal to the unsharded literal kernel; (b) the TP forwards
       across the 2 ranks: `make_tp_int8_forward` (QP37, tp 2, 832x480)
       equal to generation 3, `make_tp_wide_forward` (c256 b10, tp 2, one
       frame) equal to phase 16's one-process result; (c) `restore_tiled`
       over `Engine.restore` (540x960 tiles, 4 windows a call) at
       3840x2160 through generation 3 and the reference net: tiled equal
       to whole, generation 3's launches checked (8 tiled, 1 whole, 0
       under the reference net), peak device memory and ms/frame of each;
       (d) the native reader and writer (`native/yuvio.cpp`) against NumPy
       on phase 4's 16 frames: equal, both times, and `run_sequence`'s
       wall time from files to files with each;
  20   (dp, sp) training over meshes whose axes span processes: 2 gloo
       processes on cuda:0, global meshes 2x1, 1x2, 1x4 and 2x2 on phase
       17's data, every rank passing the whole batch: (a) `make_grad_fn`
       against the one-process 1x1 step (loss rel 1e-5, every gradient
       within 1e-5 of its max |g|), the ranks bit-equal, the bytes across
       ranks exact (halo 98,304 a rank at 1x2 and 1x4, 0 at 2x1 and 2x2;
       all-reduce 218,696); (b) ms per step across the processes against
       the same mesh in one, in turns; (c) 20 Adam steps of
       `Trainer(mesh=global 1x2)`: the loss falls, the ranks' params
       bit-equal and close to a one-process 1x2 Trainer's, the checkpoint
       written by rank 0 alone; (d) `quant_finetune` on that mesh (the
       weights on the grid, equal on both ranks), its model written by rank
       0 and served by `DistributedRunner` over the global 1x2 mesh on
       phase 4's anchors: generation 3 launched once a rank, bit-equal to a
       one-process `Engine.restore` of the file.
  21   generation 3's diagnostic instances (`fused_forward(stages=,
       _debug=)`, a library of their own built per tile at first use): none
       built or launched by phases 1-20; (a) the library at 24x32 and 32x32
       (the table's tiles) built in parallel, its build seconds, 4 entries
       and 0 spills in its `ptxas` report; every variant (truncated after
       S1, S2, S3, and `zero_a1`) bit for bit against its plain version on
       phase 2's cases (frame bounds included) and on each halo-extended
       block of a 1x2x2 mesh at 1080p under its bounds; (b)
       `tools/stage_marginals` at 1920x1080 batch 4 (the main path's shape
       and tile) and at 416x240 batch 1 (24x32), with the counts set to 0
       before and read after: every variant of the tile launched, the
       per-stage split and its JSON line.
  22   the port's headline measurement: `cli bench` at its defaults (16
       frames of 1920x1080, generation 3 at the table's tile; the host
       windows cut to 2 in a 20 s budget), its JSON line, the program
       exact against the plain reference net on the card before any timing
       (`exact_vs_xla_on_hw`), generation 3 launched at the table's tiles
       for 1080p and 416x240 and no other instance; then
       `tools/bench_layer --layer C2_2` (its library GEMMs launched, exact
       against the plain convolution) and `tools/bench_matrix` (generations
       3 and 2 at the six reference geometries and the 1080p batch curve,
       the reference net's row at 416x240, each exact before timed).
  23   the golden generators (`tools/make_golden*`) on seeded content that
       needs no matplotlib or PIL: (a) `make_golden.golden_for_qp` at full
       width, 12 + 4 frames of 416x240 DCT-degraded as QP37, 200 + 100
       steps and 50 fine-tune steps of batch 32 (each kind of step timed
       first), its records written and read back, the served kernel
       (generation 3, or 1 for a table outside the window) equal to its
       plain version on the card and `after` equal to its output's PSNR;
       (b) `make_golden_eval.eval_goldens` with the four committed models
       on 2 of phase 4's 1080p anchors, whole and in 540x960 windows
       (bit-equal, generation 3 at the table's tiles), and on 2 frames of
       416x240 on cuda and on cpu (the same digits); (c) `cli bench`'s
       raw and +1 windows at its 1080p pool on `measure_stream_fps`,
       printed beside the medians before the windows' setup left the clock.

The clips the committed goldens were measured on need matplotlib's
sample data, which the smoke does not assume: `tests/test_torch_golden.py`
checks the committed golden PSNRs and `tests/test_torch_make_golden.py`
the generators' files (slow-marked, on the CPU).

Every path (phases 4, 8, 9, 10, each of 11's, 12's, 14's, 15's, 18's and 19's, 20 (d), 21 (b) and each of 22's and 23's) runs with
the launch counts set to 0 just before it and read just after; a kernel of
the path that was not launched fails the run. Phase 16's paths count
their library GEMMs the same way (`conv_int8.launches`,
`conv_fp8.launches`); they launch none of the four kernels. No phase catches an error: any
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
import socket
import subprocess
import sys
import tempfile
import textwrap
import time

HERE = os.path.dirname(os.path.abspath(__file__))
GOLDEN = os.path.join(HERE, "assets", "golden")
# `cli bench`'s 1080p raw-wire and +1 medians (frames/s) while each window
# still timed its setup (a new pinned ring, a result array of every frame
# first touched inside it); NVIDIA H100 80GB HBM3, 700.00 W; PERF.md
PRE_REPAIR_FPS = {"raw": 1311.30, "+1": 1449.49}
# generation 3 per tile at 1080p batch 4 before it became an instance of
# csrc/qvrcnn_split.cuh (the parent commit's build) and after, in turns in
# one call: `python -m qcnn_gpu_tpu_torch.tools.compare_builds
# <parent's csrc>` (medians of 14 CUDA-graph replays each); PERF.md
PARENT_FUSED_CARD = "NVIDIA H100 80GB HBM3, 700.00 W"
PARENT_FUSED = {
    (24, 40): {"registers": 107, "ms_frame": 0.5256, "this_ms_frame": 0.5270},
    (24, 32): {"registers": 106, "ms_frame": 0.5419, "this_ms_frame": 0.5413},
    (32, 32): {"registers": 106, "ms_frame": 0.5124, "this_ms_frame": 0.5119},
}
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
    from qcnn_gpu_tpu_torch.ops import build, tuning
    from qcnn_gpu_tpu_torch.ops.fused import (
        KERNEL,
        SPLIT_BYTES,
        TILE_H,
        TILE_W,
        TILES,
        FusedWeights,
        fused_forward,
        fused_forward_reference,
        layout,
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
    from qcnn_gpu_tpu_torch.tools import (
        PEAK_INT8_OPS, bench_kernels, events_ms, graph_timer, mma_probe, smi,
    )
    from qcnn_gpu_tpu_torch.tools.profile import duplex_host_split, static_camera, trace_stream

    wrappers = {
        "qvrcnn_fused": fused_forward, "qvrcnn_pair": pair_forward,
        "qvrcnn_literal": literal_residual, "mma_probe": mma_probe.mma_probe,
    }

    def zero_counts():
        for fn in wrappers.values():
            fn.launches = 0
            if hasattr(fn, "tile_launches"):  # generation 3: launches by tile
                fn.tile_launches = dict.fromkeys(fn.tile_launches, 0)

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
            elif "registers" in line or "spill" in line or "warning" in line:
                print("    ptxas:", line.strip())
    for name in ("qvrcnn_fused", "qvrcnn_pair", "qvrcnn_literal"):
        log = build.build_info[name]["log"]
        spills = re.findall(r"(\d+) bytes spill (?:stores|loads)", log)
        if not spills or any(int(n) for n in spills):
            fail(f"ptxas reports spills (or no report) for {name}: {spills}")
        entries = len(re.findall(r"Compiling entry function", log))
        if entries != (len(TILES) if name == KERNEL else 1):
            fail(f"{name}: ptxas compiled {entries} kernels, expected "
                 f"{'one per tile of ' + str(TILES) if name == KERNEL else 'one'}")
    # the probe's tensor-core chains (6 instances): 0 spills, registers printed
    chains = [part for part in re.split(r"Compiling entry function", build.build_info[
        "mma_probe"]["log"]) if "wgmma_chain_kernel" in part.split("\n", 1)[0]]
    for part in chains:
        spills = re.findall(r"(\d+) bytes spill (?:stores|loads)", part)
        regs = re.search(r"Used (\d+) registers", part)
        if not spills or any(int(n) for n in spills) or not regs:
            fail(f"ptxas reports spills (or no report) for a probe chain: {part[:300]}")
    if len(chains) != 6:
        fail(f"mma_probe: ptxas compiled {len(chains)} chain instances, expected 6")
    print(f"mma_probe: 0 bytes spilled in its {len(chains)} wgmma chain instances")
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    smem = {t: build.library(KERNEL).qvrcnn_smem_bytes(*t) for t in TILES}
    want = {t: SPLIT_BYTES + 160 * 16 + layout(*t).bytes for t in TILES}
    if smem != want:
        fail(f"{KERNEL}: dynamic shared memory by tile {smem}, ops/fused.layout says {want}")
    print(f"{KERNEL}: 0 bytes spilled in its {len(TILES)} tile instances; dynamic shared memory "
          f"per block: {', '.join(f'{th}x{tw} {b} B' for (th, tw), b in smem.items())}; "
          f"grid = min(tiles, {sms} SMs) blocks of 512 threads")
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
                model=os.path.join(GOLDEN, "model_q37.data"), extra=(), out=None):
        """`cli run` on the 16 frames, with `extra` flags last (they win);
        -> (launch counts, recon, record)."""
        out = out or os.path.join(tmp, "-".join([
            impl, transport, os.path.basename(files["anchor"]), os.path.basename(model),
            *(a.strip("-").replace("/", "_") for a in extra)]))
        recon_path = os.path.join(out, "recon.yuv")
        zero_counts()
        rc = cli.main([
            "run", "--ori", files["ori"], "--anchor", files["anchor"],
            "--height", str(H), "--width", str(W), "--frames", str(n_frames),
            "--model", model, "--qp", "37",
            "--device", "cuda", "--impl", impl, "--transport", transport,
            "--out-dir", out, "--recon", recon_path, *extra,
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
    main_tiles = {f"{th}x{tw}": n for (th, tw), n in fused_forward.tile_launches.items() if n}
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
    # phase 2's cases (frame bounds: the literal kernel's too, the pair
    # kernel takes none; the batches 1 and 3 give the pair kernel a lone
    # last frame)
    lws = {name: LiteralWeights.from_engine(p, dev) for name, p in models.items()}
    max_errs = {"qvrcnn_fused": max_err, "qvrcnn_pair": 0, "qvrcnn_literal": 0}
    for name, geo, kind, bounds in cases:
        if kind == "synth":
            x = frames(*geo, seed=sum(geo))
        else:
            x = np.full(geo, 0 if kind == "zeros" else 255, np.uint8)
        xd = torch.from_numpy(x).to(dev)
        runs = [("qvrcnn_literal", literal_residual, literal_residual_reference, lws)]
        if not bounds:
            runs.insert(0, ("qvrcnn_pair", pair_forward, pair_forward_reference, fws))
        for kname, kernel, plain, wts in runs:
            got = kernel(xd, wts[name], *bounds)
            torch.cuda.synchronize()
            want = plain(xd, wts[name], *bounds)
            if got.shape != want.shape or got.dtype != want.dtype:
                fail(f"{kname} output {got.dtype} {tuple(got.shape)}, expected {want.dtype}")
            err = int((got.to(torch.int32) - want.to(torch.int32)).abs().max())
            max_errs[kname] = max(max_errs[kname], err)
            print(f"{kname} vs plain {name} {geo} {kind} bounds={bounds or 'frame'}: "
                  f"max_abs_err={err}")
            if err != 0:
                fail(f"{kname} differs from its plain version: {name} {geo} {kind} {bounds}")

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
        # whole frames, and under frame bounds as a mesh's blocks pass them:
        # a row band and a 2-D rectangle
        for geo, with_bounds in (((2, 240, 416), ((), (7, 235), (3, 231, 11, 412))),
                                 ((1, H, W), ((), (3, H - 9, 11, W - 4)))):
            if kind == "smooth":
                x = frames(*geo, seed=5)
            else:
                x = np.random.default_rng(5).integers(0, 256, geo, dtype=np.uint8)
            xd = torch.from_numpy(x).to(dev)
            for bounds in with_bounds:
                got = literal_residual(xd, lw_out, *bounds)
                torch.cuda.synchronize()
                err = int((got.to(torch.int32) - literal_residual_reference(xd, lw_out, *bounds)
                           .to(torch.int32)).abs().max())
                max_errs["qvrcnn_literal"] = max(max_errs["qvrcnn_literal"], err)
                print(f"qvrcnn_literal vs plain, {label}, {kind} frames {geo} bounds="
                      f"{bounds or 'frame'}: max_abs_err={err}")
                if err != 0:
                    fail(f"literal kernel differs from its plain version ({label}, {bounds})")
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
    for kind, seed in (("int8", 0), ("bf16", 0), ("int8", mma_probe.NEGATIVE_SEED)):
        err = mma_probe.check_case(kind, 128, 128, grid=sms, seed=seed)
        max_errs["mma_probe"] = max(max_errs["mma_probe"], err)
        print(f"mma_probe {kind} (K=128, N=128, seed {seed}) vs plain, grid {sms}: "
              f"max_abs_err={err}")
        if err != 0:
            fail(f"mma_probe {kind} seed {seed} differs from its plain version at grid {sms}")
    zero_counts()
    mma_probe.main()
    launches["mma_probe"] = counts()["mma_probe"]
    if launches["mma_probe"] <= 0:
        fail("tools/mma_probe launched the probe kernel no time")

    # ---- phase 10: tools/bench_kernels, then v3 (at the table's tile for
    # the main path's shape, and at 24x40), v2 and v1 timed at 1080p batch 4
    # (the main path's batch) beside their plain versions
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
    # the instance the main path runs at this shape (phase 4 launched it
    # alone), then v3 at 24x40, v2 and v1, in turns: v3t v3 v2 v1 v1 v2 v3 v3t
    tuned = tuning.build_tuned(models["golden-QP37"], dev, H, W, b)
    main_tile = f"{tuned.tile[0]}x{tuned.tile[1]}"
    if set(main_tiles) != {main_tile}:
        fail(f"phase 4 launched the fused kernel at {main_tiles}, the table says {main_tile}")
    runs = {"v3t": lambda: tuned(xd), "v3": lambda: fused_forward(xd, fw37),
            "v2": lambda: pair_forward(xd, fw37), "v1": lambda: literal_residual(xd, lw37)}
    turns = {k: [] for k in runs}
    for k in runs:
        runs[k]()
    for k in list(runs) + list(runs)[::-1]:
        turns[k].append(events_ms(runs[k], 20))
    mean = {k: sum(v) / len(v) for k, v in turns.items()}
    for k, v in turns.items():
        label = f"v3 at {main_tile} (the main path's)" if k == "v3t" else k
        print(f"{label} at 1080p batch {b}, in turns: {mean[k] / b:.4f} ms/frame "
              f"({' / '.join(f'{t / b:.4f}' for t in v)}), {mean[k] / mean['v3']:.4f} of v3 {card}")
    pair_forward_reference(xd, fw37)
    literal_residual_reference(xd, lw37)
    measured = {
        "qvrcnn_fused": (mean["v3t"], times[b][1]),
        "qvrcnn_pair": (mean["v2"],
                        events_ms(lambda: pair_forward_reference(xd, fw37), 2)),
        "qvrcnn_literal": (mean["v1"], events_ms(lambda: literal_residual_reference(xd, lw37), 2)),
    }
    for kname, (k_ms, p_ms) in measured.items():
        print(f"{kname} 1080p batch {b}: kernel {k_ms / b:.4f} ms/frame, plain "
              f"{p_ms / b:.4f} ms/frame {card}")
    # generation 3's instances of the split template: this build's ptxas
    # registers and spills and its ms/frame at each tile (CUDA-graph
    # replays), printed beside PARENT_FUSED, a record of the parent
    # commit's build (generation 3's own copy of the design) that
    # tools/compare_builds timed in turns in one call
    instances = {}
    ptxas = build.ptxas_instances(build.build_info[KERNEL]["log"])
    for tile in TILES:
        run_t = lambda tile=tile: fused_forward(xd, fw37, tile=tile)  # noqa: E731
        run_t()
        timer = graph_timer(run_t, 10)
        ms = sorted(timer() for _ in range(5))[2] / b
        label, parent = f"{tile[0]}x{tile[1]}", PARENT_FUSED[tile]
        instances[label] = {**ptxas[tile], "ms_frame": ms}
        print(f"generation 3 {label}, 1080p batch {b}: this build {ptxas[tile]['registers']} "
              f"registers, {ptxas[tile]['spill_stores']}/{ptxas[tile]['spill_loads']} bytes "
              f"spilled, {ms:.4f} ms/frame (CUDA-graph replays, median of 5) {card}; "
              f"recorded, not measured here (tools/compare_builds, PERF.md section 6): the "
              f"parent's build {parent['registers']} registers, 0 spilled, in turns with this "
              f"source in one call parent {parent['ms_frame']:.4f}, this "
              f"{parent['this_ms_frame']:.4f} ms/frame ({PARENT_FUSED_CARD})")
    a, w = mma_probe.probe_inputs("int8", 128, 128, grid=sms, device=dev)
    w_op = mma_probe.kernel_operand(w)
    mma_probe.mma_probe(a, w, w_op)
    mma_probe.mma_probe_reference(a, w)
    # a 0.12 ms launch is near its wrapper's enqueue: device time from graph replays
    probe_timer = graph_timer(lambda: mma_probe.mma_probe(a, w, w_op), 10)
    measured["mma_probe"] = (min(probe_timer() for _ in range(3)),
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

    # ---- phase 15: the mesh path (virtual meshes over cuda:0)
    literal_mesh = mesh_path(cli_run, tmp, card, zero_counts, counts, models, fws, max_errs,
                             {"ori": ori, "anchor": anchor, "recon": recon, "static": static,
                              "recon_static": recon_sr, "outside": p_out})
    tmp_dir.cleanup()

    # ---- phase 16: the wide family and tensor parallelism (library GEMMs)
    wide_one = wide_path(card, anchor, recon, p37)

    # ---- phase 17: (dp, sp)-sharded training (virtual meshes over cuda:0)
    sharded_training(card)

    # ---- phase 18: the tuned table and generation 3's tile instances
    tiles_18 = tuned_path(cli, card, zero_counts, wrappers, models, fws, cases, max_errs)

    # ---- phase 19: meshes across processes, host tiling, the native reader
    span_path(card, anchor, recon, p37, p_out, wide_one)

    # ---- phase 20: (dp, sp) training across processes, its model served
    span_training(card, anchor)

    # ---- phase 21: generation 3 truncated at each stage, and its split
    stage_instances = stage_split(card, models, fws, cases, anchor)

    # ---- phase 22: cli bench, tools/bench_layer and tools/bench_matrix
    bench_tiles = bench_path(cli, card, zero_counts, counts)

    # ---- phase 23: the golden generators on the card, and the stream's windows
    golden_launches = golden_path(card, zero_counts, counts, ori[:2], anchor[:2])

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
    # row 1's tiles: the instances launched on the main path (phase 4) and
    # on phase 18 (c)'s cli run, and phase 10's ms per launch of the main
    # path's instance (row 1's "ms") beside 24x40's
    rows[0]["tiles"] = {"phase 4": main_tiles, "phase 18 (c)": tiles_18,
                        "ms": {main_tile: mean["v3t"], "24x40": mean["v3"]}}
    # phase 10's instances of the split template: registers, spills, ms/frame
    rows[0]["instances"] = instances
    # phase 15 (e): generation 1 under meshes, literal launches a call and
    # ms/frame at 1080p batch 4 beside unsharded
    rows[2]["mesh"] = literal_mesh
    # phase 21's diagnostic instances: max_abs_err and launches per tile
    rows[0]["stage_instances"] = stage_instances
    # phase 22's `cli bench` run: its launches by tile
    rows[0]["bench"] = bench_tiles
    # phase 23 (a)'s trained model served (generation 3, or 1 for a table
    # outside the saturation window) and (b)'s committed models
    for row in rows:
        if row["name"] in golden_launches:
            row["golden"] = golden_launches[row["name"]]
    print(json.dumps({"kernels": rows}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}))
    return 0


# phase 15 (d): one rank of DistributedRunner on a 4x2 global mesh, 2x2 a
# rank over cuda:0; argv: repo, rank, world, port, work dir
MESH_WORKER = textwrap.dedent("""
    import json, sys
    sys.path.insert(0, sys.argv[1])
    import numpy as np
    import torch
    from qcnn_gpu_tpu_torch.engine.runner import read_model
    from qcnn_gpu_tpu_torch.ops.fused import fused_forward
    from qcnn_gpu_tpu_torch.parallel.distributed import DistributedRunner, initialize
    from qcnn_gpu_tpu_torch.parallel.mesh import make_global_mesh

    here, rank, world, port, d = sys.argv[1], int(sys.argv[2]), int(sys.argv[3]), sys.argv[4], sys.argv[5]
    initialize(f"tcp://127.0.0.1:{port}", world, rank)
    dev = torch.device("cuda", 0)
    runner = DistributedRunner(read_model(f"{here}/assets/golden/model_q37.data"),
                               make_global_mesh(2 * world, 2, [dev] * 4), impl="auto")
    local = np.array_split(np.load(f"{d}/anchor.npy"), world)[rank]
    fused_forward.launches = 0
    got = runner.restore(local)
    launches = fused_forward.launches
    np.save(f"{d}/rank{rank}.npy", got)
    psnr = runner.psnr(np.array_split(got, world)[rank],
                       np.array_split(np.load(f"{d}/ori.npy"), world)[rank])
    with open(f"{d}/rank{rank}.json", "w") as fp:
        json.dump({"psnr": psnr.hex(), "launches": launches, "impl": runner.run.impl,
                   "frames": int(local.shape[0])}, fp)
    torch.distributed.destroy_process_group()
""")


def tiles_per_frame(dims, h: int, w: int, halo: int = 6) -> int:
    """Generation 3's 24x40 tiles for one frame cut over a (dp, sp, sw)
    mesh (dims None: unsharded): every block is extended by the halo on
    both sides of each split axis (a frame edge gets filler rows or
    columns, also tiled)."""
    if dims is None:
        return -(-h // 24) * -(-w // 40)
    _, sp, sw = dims
    rows = h // sp + (2 * halo if sp > 1 else 0)
    cols = w // sw + (2 * halo if sw > 1 else 0)
    return sp * sw * -(-rows // 24) * -(-cols // 40)


def mesh_path(cli_run, tmp: str, card: str, zero_counts, counts, models, fws, max_errs,
              data) -> dict:
    """Phase 15: the mesh path on virtual meshes over cuda:0 (every shard a
    launch of generation 3 with its frame bounds). (a) make_sharded_forward
    at 1x4, 2x2, 1x8, 1x2x2, 2x2x2 and 4x1 on phase 4's anchors, each block's
    kernel output against its plain version, and phase 2's 240p cases at
    1x2x2; (b) cli run --mesh 1x4, and --mesh 1x2x2 --transport duplex on
    phase 11's static camera; (c) cli run --config (2x2); (d)
    DistributedRunner in 2 processes on gloo; (e) auto under a mesh on
    phase 7's table outside the saturation window: generation 1 at 1x2,
    2x2 and 1x2x2, equal to the unsharded literal kernel and the reference
    net, timed in turns against it at 1080p batch 4; kernel2 refused; and
    the reference net at 1x2; (f) the unsharded kernel against 1x4, 2x2
    and 1x2x2 in turns, then against 4x1 (four launches, no tile
    overhead). Each path's launches are counted around it, printed and
    checked on its own line. Returns (e)'s literal launches and ms/frame
    by mesh, and the unsharded ms/frame."""
    import numpy as np
    import torch

    from qcnn_gpu_tpu_torch.data import yuv as Y
    from qcnn_gpu_tpu_torch.models.qvrcnn import make_forward
    from qcnn_gpu_tpu_torch.ops.fused import fused_forward, fused_forward_reference
    from qcnn_gpu_tpu_torch.ops.literal import LiteralWeights, literal_forward
    from qcnn_gpu_tpu_torch.parallel.mesh import make_mesh
    from qcnn_gpu_tpu_torch.parallel.spatial import (
        extended_blocks,
        make_sharded_forward,
        split_blocks,
    )
    from qcnn_gpu_tpu_torch.tools import events_ms

    t_phase = time.perf_counter()
    dev = torch.device("cuda", 0)
    p37, fw37 = models["golden-QP37"], fws["golden-QP37"]
    anchor, recon = data["anchor"], data["recon"]
    n_frames = anchor.shape[0]
    meshes = {"1x4": (1, 4, 1), "2x2": (2, 2, 1), "1x8": (1, 8, 1), "1x2x2": (1, 2, 2),
              "2x2x2": (2, 2, 2), "4x1": (4, 1, 1)}

    def mesh_of(dims):
        return make_mesh(dims[0], dims[1], devices=[dev] * 8, sw=dims[2])

    def err(a, b) -> int:
        a, b = (torch.as_tensor(v).to(dev, torch.int16) for v in (a, b))
        return int((a - b).abs().max())

    def block_errs(xd, mesh, fw) -> int:
        """Each halo-extended block: the kernel against its plain version
        with the same frame bounds (comparison launches, not counted)."""
        xe, bounds = extended_blocks(split_blocks(xd, mesh), 6, 128)
        worst = 0
        for idx in np.ndindex(xe.shape):
            got = fused_forward(xe[idx], fw, *bounds[idx])
            torch.cuda.synchronize()
            worst = max(worst, err(got, fused_forward_reference(xe[idx], fw, *bounds[idx])))
        return worst

    # (a) make_sharded_forward(impl="auto") on phase 4's anchors
    for label, dims in meshes.items():
        b = 8 if label == "2x2x2" else 4
        mesh = mesh_of(dims)
        run = make_sharded_forward(p37, mesh, impl="auto")
        xd = torch.from_numpy(anchor[:b]).to(dev)
        zero_counts()
        got = run(xd)
        torch.cuda.synchronize()
        n = counts()["qvrcnn_fused"]
        shards = dims[0] * dims[1] * dims[2]
        e_whole, e_plain = err(got, recon[:b]), block_errs(xd, mesh, fw37)
        max_errs["qvrcnn_fused"] = max(max_errs["qvrcnn_fused"], e_plain)
        t = tiles_per_frame(dims, H, W)
        print(f"make_sharded_forward {label} ({run.impl}), {b}x{H}x{W}: fused launches={n} "
              f"(dp*sp*sw = {shards}); vs phase 4's unsharded max_abs_err={e_whole}; each "
              f"block vs its plain version max_abs_err={e_plain}; {t} tiles a frame "
              f"({100 * (t / tiles_per_frame(None, H, W) - 1):+.1f}% on the unsharded "
              f"{tiles_per_frame(None, H, W)})")
        if n != shards or e_whole or e_plain or run.impl != "kernel3":
            fail(f"sharded generation 3 at {label}: {n} launches, errors {e_whole}/{e_plain}")
    geo = (2, 240, 416)
    mesh = mesh_of(meshes["1x2x2"])
    for name in ("golden-QP37", "golden-QP22-int4-pc"):
        run = make_sharded_forward(models[name], mesh, impl="auto")
        for kind in ("synth", "zeros", "255"):
            x = frames(*geo, seed=sum(geo)) if kind == "synth" else np.full(
                geo, 0 if kind == "zeros" else 255, np.uint8)
            xd = torch.from_numpy(x).to(dev)
            e_whole = err(run(xd), fused_forward(xd, fws[name]))
            e_plain = block_errs(xd, mesh, fws[name])
            max_errs["qvrcnn_fused"] = max(max_errs["qvrcnn_fused"], e_plain)
            print(f"make_sharded_forward 1x2x2 {name} {geo} {kind}: vs the unsharded kernel "
                  f"max_abs_err={e_whole}, each block vs its plain version max_abs_err={e_plain}")
            if e_whole or e_plain:
                fail(f"sharded generation 3 at 1x2x2 differs: {name} {geo} {kind}")

    # (b) cli run --mesh: launches = (warm-up calls + batches) x shards, the
    # warm-up streaming depth + 2 = 5 batches of zeros (and, for the duplex,
    # as many warm batches), the stream 16 / 4 batches
    calls_raw = 5 + n_frames // 4
    runs_b = (
        ("1x4", "raw", None, recon, calls_raw * 4),
        ("1x2x2", "duplex", data["static"], data["recon_static"], (calls_raw + 5) * 4),
    )
    for label, transport, files, want, expect in runs_b:
        kw = {"files": files} if files else {}
        launched, got, rec = cli_run("auto", transport, extra=("--device", "cuda:0", "--mesh", label),
                                     **kw)
        n = launched["qvrcnn_fused"]
        impl = "kernel3" + ("+duplex" if transport == "duplex" else "")
        print(f"cli run --mesh {label} --transport {transport}: impl={rec['impl']}, mesh="
              f"{rec['mesh']}, fused launches={n} (expected {expect}), recon == "
              f"{'phase 11' if files else 'phase 4'}: {bool((got == want).all())}; "
              f"{rec['time_us'] / 1e3 / n_frames:.4f} ms/frame incl. H2D/D2H {card}")
        if n != expect or rec["mesh"] != label or rec["impl"] != impl or not (got == want).all():
            fail(f"cli run --mesh {label} --transport {transport}: {rec['impl']} {rec['mesh']}, "
                 f"{n} launches (expected {expect})")

    # (c) cli run --config: a JSON file's mesh (2x2) replaces the flags
    out = os.path.join(tmp, "config-run")
    cfg = os.path.join(tmp, "engine.json")
    with open(cfg, "w") as fp:
        json.dump({"engine": {"mesh_dp": 2, "mesh_sp": 2, "out_dir": out}}, fp)
    launched, got, rec = cli_run("auto", extra=("--device", "cuda:0", "--config", cfg), out=out)
    n_c = launched["qvrcnn_fused"]
    print(f"cli run --config (mesh_dp 2, mesh_sp 2): impl={rec['impl']}, mesh={rec['mesh']}, "
          f"fused launches={n_c} (expected {calls_raw * 4}), recon == phase 4: "
          f"{bool((got == recon).all())} {card}")
    if n_c != calls_raw * 4 or rec["mesh"] != "2x2" or not (got == recon).all():
        fail(f"cli run --config: {rec['mesh']}, {n_c} launches")

    # (d) DistributedRunner across 2 processes (gloo), 4 frames each on a
    # 4x2 global mesh (2x2 a process, virtual over cuda:0): both return the
    # global batch of 8
    d = os.path.join(tmp, "distributed")
    os.makedirs(d)
    np.save(os.path.join(d, "anchor.npy"), anchor[:8])
    np.save(os.path.join(d, "ori.npy"), data["ori"][:8])
    script = os.path.join(d, "worker.py")
    with open(script, "w") as fp:
        fp.write(MESH_WORKER)
    with socket.socket() as sock:
        sock.bind(("127.0.0.1", 0))
        port = str(sock.getsockname()[1])
    t0 = time.perf_counter()
    procs = [subprocess.Popen([sys.executable, script, HERE, str(r), "2", port, d],
                              stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
             for r in range(2)]
    try:
        logs = [pr.communicate(timeout=300)[0] for pr in procs]
    finally:
        for pr in procs:
            if pr.poll() is None:
                pr.kill()
                pr.wait()
    if any(pr.returncode for pr in procs):
        fail(f"DistributedRunner workers exited {[pr.returncode for pr in procs]}: {logs}")
    host_psnr = Y.psnr(recon[:8], data["ori"][:8])
    for r in range(2):
        got = np.load(os.path.join(d, f"rank{r}.npy"))
        with open(os.path.join(d, f"rank{r}.json")) as fp:
            rec = json.load(fp)
        psnr = float.fromhex(rec["psnr"])
        print(f"DistributedRunner rank {r} of 2 (gloo, 4x2 global mesh, 2x2 a rank over "
              f"cuda:0, {rec['frames']} frames): "
              f"returned {got.shape}, == phase 4's unsharded: {bool((got == recon[:8]).all())}; "
              f"fused launches={rec['launches']}; psnr {psnr!r} == host {host_psnr!r}: "
              f"{psnr == host_psnr}")
        if got.shape != (8, H, W) or not (got == recon[:8]).all() or psnr != host_psnr \
                or rec["launches"] != 4 or rec["impl"] != "kernel3":
            fail(f"DistributedRunner rank {r}: {rec}")
    print(f"DistributedRunner, 2 processes: {time.perf_counter() - t0:.1f} s in all")

    # (e) a table outside the saturation window under a mesh: auto serves
    # it with generation 1 under each block's frame bounds, one literal
    # launch a block a call, bit-equal to the unsharded literal kernel and
    # to the reference net; then at 1080p batch 4, equal and timed in
    # turns against the unsharded literal kernel. --impl kernel2 under a
    # mesh still raises; the sharded reference net serves the table too
    p_out = data["outside"]
    lw_out = LiteralWeights.from_engine(p_out, dev)
    xd = torch.from_numpy(frames(*geo, seed=15)).to(dev)
    want = literal_forward(xd, lw_out)
    e_ref = err(want, make_forward(p_out, device=dev)(xd))
    literal_meshes = {"1x2": (1, 2, 1), "2x2": (2, 2, 1), "1x2x2": (1, 2, 2)}
    x1080 = torch.from_numpy(anchor[:4]).to(dev)
    want1080 = literal_forward(x1080, lw_out)
    runs = {"u": lambda: literal_forward(x1080, lw_out)}
    literal_mesh = {}
    for label, dims in literal_meshes.items():
        run = make_sharded_forward(p_out, mesh_of(dims), impl="auto")
        zero_counts()
        got = run(xd)
        torch.cuda.synchronize()
        n, n_fused = counts()["qvrcnn_literal"], counts()["qvrcnn_fused"]
        blocks = dims[0] * dims[1] * dims[2]
        e_whole, e_1080 = err(got, want), err(run(x1080), want1080)
        literal_mesh[label] = {"launches": n}
        print(f"make_sharded_forward auto {label} {geo}, table outside the window: impl="
              f"{run.impl}, literal launches={n} (blocks {blocks}), fused {n_fused}; vs the "
              f"unsharded literal kernel max_abs_err={e_whole} ({e_1080} at 4x{H}x{W}); the "
              f"unsharded literal kernel vs the reference net max_abs_err={e_ref}")
        if run.impl != "kernel1" or n != blocks or n_fused or e_whole or e_1080 or e_ref:
            fail(f"generation 1 under mesh {label}: impl {run.impl}, {n} literal launches, "
                 f"{n_fused} fused, errors {e_whole}/{e_1080}/{e_ref}")
        runs[label] = lambda run=run: run(x1080)
    turns = {k: [] for k in runs}
    for k in list(runs) + list(runs)[::-1]:
        turns[k].append(events_ms(runs[k], 5))
    mean = {k: sum(v) / len(v) for k, v in turns.items()}
    for k, v in turns.items():
        if k != "u":
            literal_mesh[k]["ms_frame"] = mean[k] / 4
        print(f"generation 1, 1080p batch 4, {'unsharded' if k == 'u' else 'mesh ' + k}, in "
              f"turns: {mean[k] / 4:.4f} ms/frame ({' / '.join(f'{x / 4:.4f}' for x in v)}), "
              f"{mean[k] / mean['u']:.4f} of unsharded {card}")
    literal_mesh["unsharded_ms_frame"] = mean["u"] / 4
    try:
        make_sharded_forward(p37, mesh_of((1, 2, 1)), impl="kernel2")
    except ValueError as e:
        if "--impl reference" not in str(e):
            fail(f"--impl kernel2 under a mesh: {e}")
        print(f"make_sharded_forward kernel2, 1x2: ValueError {str(e)[:90]}...")
    else:
        fail("--impl kernel2 under a mesh did not raise")
    e_ref = err(make_sharded_forward(p_out, mesh_of((1, 2, 1)), impl="reference")(xd),
                make_forward(p_out, device=dev)(xd))
    print(f"make_sharded_forward reference 1x2 {geo}, table outside the window, vs the "
          f"unsharded reference net: max_abs_err={e_ref}")
    if e_ref:
        fail("the sharded reference net differs from the unsharded one")

    # (f) the unsharded kernel against 1x4, 2x2 and 1x2x2 at 1080p batch 4,
    # CUDA events, 10 calls a turn, in turns u 1x4 2x2 1x2x2 1x2x2 2x2 1x4 u
    xd = torch.from_numpy(frames(4, H, W, seed=4)).to(dev)
    runs = {"u": lambda: fused_forward(xd, fw37)}
    for label in ("1x4", "2x2", "1x2x2"):
        run = make_sharded_forward(p37, mesh_of(meshes[label]), impl="auto")
        runs[label] = lambda run=run: run(xd)
    for fn in runs.values():
        fn()
    turns = {k: [] for k in runs}
    for k in list(runs) + list(runs)[::-1]:
        turns[k].append(events_ms(runs[k], 10))
    # then u 4x1 4x1 u: four launches of one frame each and no tile
    # overhead (an unsplit axis gets no halo), the launches' own cost
    run = make_sharded_forward(p37, mesh_of(meshes["4x1"]), impl="auto")
    runs["4x1"] = lambda: run(xd)
    runs["4x1"]()
    turns["4x1"] = []
    for k in ("u", "4x1", "4x1", "u"):
        turns[k].append(events_ms(runs[k], 10))
    mean = {k: sum(v) / len(v) for k, v in turns.items()}
    for k, v in turns.items():
        t = tiles_per_frame(meshes.get(k), H, W) / tiles_per_frame(None, H, W) - 1
        print(f"1080p batch 4, {'unsharded' if k == 'u' else 'mesh ' + k}, in turns: "
              f"{mean[k] / 4:.4f} ms/frame ({' / '.join(f'{x / 4:.4f}' for x in v)}), "
              f"{mean[k] / mean['u']:.4f} of unsharded; tile overhead {100 * t:+.1f}% {card}")
    print(f"phase 15: {time.perf_counter() - t_phase:.1f} s")
    return literal_mesh


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


def in_turns(fns: dict, order, reps: int) -> dict:
    """CUDA-event ms per call of each fns[name], timed in the given order
    (names repeat: turns) after one warm-up call each, averaged over a
    name's turns."""
    from qcnn_gpu_tpu_torch.tools import events_ms

    for fn in fns.values():
        fn()
    got = {}
    for name in order:
        got.setdefault(name, []).append(events_ms(fns[name], reps))
    return {name: sum(v) / len(v) for name, v in got.items()}


def wide_path(card: str, anchor_1080p, recon_1080p, p37) -> None:
    """Phase 16: the wide CNN family and tensor parallelism on cuda:0, at
    full width (c256 b10, 832x480). (a) make_wide_forward (im2col +
    `_int_mm`) on 2 seeded frames and the small twin, bit-equal to the
    plain version on the card, with the hidden layers' requant epilogue
    kernel launched once a hidden layer and chunk; (b) tools/bench_wide at
    its defaults, a 2-frame call's device time by part (im2col, GEMM, band
    assembly, epilogue, other), and the epilogue kernel alone on one
    frame's accumulators against its bound and its plain version; (c) the FP8 forward
    (`_scaled_mm`) against its plain version (max |diff| <= 1, as
    tests/test_torch_wide_cuda.py holds it) and the float model (JAX's
    bounds: PSNR > 40 dB, max |diff| <= 8); (d) the TP forwards on virtual
    meshes: the wide net at tp 2, 4, 8 bit-equal to (a), QVRCNN (the QP37
    model) at tp 2, 4, 8 on phase 4's anchors bit-equal to phase 4's
    generation-3 recon, each timed in turns against tp 1 (and QVRCNN
    against generation 3). Each path's GEMM count is zeroed before it and
    read after; one JSON line {"library_routes": [...]} sums them up.
    Returns (a)'s restored first frame."""
    import numpy as np
    import torch

    from qcnn_gpu_tpu_torch.data.yuv import psnr
    from qcnn_gpu_tpu_torch.models import wide as WD
    from qcnn_gpu_tpu_torch.ops.fused import FusedWeights, fused_forward
    from qcnn_gpu_tpu_torch.ops import build
    from qcnn_gpu_tpu_torch.ops.int8_conv import conv_fp8, conv_int8
    from qcnn_gpu_tpu_torch.ops.requant import KERNEL as EPILOGUE, bias_blu_requant_i8
    from qcnn_gpu_tpu_torch.parallel.mesh import make_mesh
    from qcnn_gpu_tpu_torch.parallel.tensor import make_tp_int8_forward, make_tp_wide_forward
    from qcnn_gpu_tpu_torch.tools import PEAK_INT8_OPS, bench_wide, events_ms

    t_phase = time.perf_counter()
    dev = torch.device("cuda", 0)
    c, blocks, h, w = 256, 10, 480, 832
    macs = h * w * bench_wide.macs_per_pixel(c, blocks)
    bound = 2 * macs / PEAK_INT8_OPS * 1e3  # ms per frame, int8 (and fp8) dense peak

    def max_err(a, b):
        return int((a.to(torch.int16) - b.to(torch.int16)).abs().max())

    # (a) the INT8 net on 2 frames, and the small twin, == the plain version
    p = WD.synth_wide_params(c, blocks, seed=7)
    x2 = torch.from_numpy(frames(2, h, w, seed=16)).to(dev)
    run = WD.make_wide_forward(p, device=dev)
    conv_int8.launches = bias_blu_requant_i8.launches = 0
    got = run(x2)
    torch.cuda.synchronize()
    n_int, n_epi = conv_int8.launches, bias_blu_requant_i8.launches
    chunks = -(-len(x2) // WD.frames_per_chunk(h, w, c))
    want_epi = (len(p.weights) - 1) * chunks
    t0 = time.perf_counter()
    want = WD.forward_wide(x2, p)
    torch.cuda.synchronize()
    plain_s = time.perf_counter() - t0
    p_small = WD.synth_wide_params(32, 3, seed=5)
    xs = torch.from_numpy(frames(1, 48, 64, seed=6)).to(dev)
    err_small = max_err(WD.make_wide_forward(p_small, device=dev)(xs), WD.forward_wide(xs, p_small))
    err = max_err(got, want)
    if err or err_small or n_int <= 0 or got.shape != x2.shape or n_epi != want_epi:
        fail(f"wide INT8: max_abs_err {err} (c{c} b{blocks} 2x{h}x{w}), {err_small} (c32 b3), "
             f"{n_int} _int_mm launches, {n_epi} requant epilogue launches (want {want_epi})")
    print(f"wide c{c} b{blocks} INT8, 2x{h}x{w} on cuda (impl {run.impl}): _int_mm launches={n_int}, "
          f"requant epilogue launches={n_epi} ({len(p.weights) - 1} hidden layers x {chunks} "
          f"chunk(s)); max_abs_err=0 against the plain version on the card (float64 convs, "
          f"{plain_s:.2f} s); small twin c32 b3 1x48x64 max_abs_err=0; {macs / 1e12:.6f} TMAC a "
          f"frame {card}")
    log = build.build_info[EPILOGUE]["log"]  # "already built: ..." where a run before built it
    spills = re.findall(r"(\d+) bytes spill (?:stores|loads)", log)
    if any(int(n) for n in spills):
        fail(f"ptxas reports spills for {EPILOGUE}: {spills}")
    regs = re.findall(r"Compiling entry function '(\w+)'.*?Used (\d+) registers", log, re.S)
    print(f"{EPILOGUE}: " + ("; ".join(f"{name} {n} registers" for name, n in regs)
                             or log.strip()) + ", 0 bytes spilled")

    # (b) tools/bench_wide at its defaults (2 timed calls of its 150 frames,
    # not 8: the smoke's time), and one frame's split
    conv_int8.launches = 0
    rec = bench_wide.bench(reps=2)
    n_bench = conv_int8.launches
    if not rec["small_twin_exact_vs_oracle"] or n_bench <= 0:
        fail(f"tools/bench_wide: {rec}, {n_bench} _int_mm launches")
    print(json.dumps(rec))
    split = bench_wide.route_split(p, x2)  # make_wide_forward's own call, by launching span
    total = sum(split.values())
    print(f"tools/bench_wide c{c} b{blocks} {h}x{w} batch {rec['batch']} (2 calls after a warm-up): "
          f"{rec['ms_per_frame']:.4f} "
          f"ms/frame, {rec['int8_tops']:.2f} int8 TOP/s; bound {bound:.4f} ms/frame "
          f"({rec['ms_per_frame'] / bound:.3f}x), {n_bench} _int_mm launches; a call of 2 frames "
          "by part (device ms): "
          + ", ".join(f"{k} {v:.4f} ms ({100 * v / total:.1f}%)" for k, v in split.items())
          + f", {total:.4f} ms in all; epilogue {split['epilogue'] / len(x2):.4f} ms/frame {card}")
    epi = bench_wide.epilogue_ms(h, w, c)
    print(f"requant epilogue kernel ({EPILOGUE}.cu) alone on one frame's accumulators "
          f"{'x'.join(map(str, epi['shape']))}: {epi['ms']:.4f} ms a layer, bound "
          f"{epi['bound_ms']:.4f} ms ({epi['ms'] / epi['bound_ms']:.3f}x; 5 bytes a value at 3.35 "
          f"TB/s), plain version {epi['plain_ms']:.4f} ms ({epi['plain_ms'] / epi['ms']:.2f}x the "
          f"kernel), CUDA events in turns {card}")

    # (c) the FP8 net: synth_wide_params' float weights
    ws, bs = WD.synth_float_wide(c, blocks, seed=7)
    run8 = WD.make_wide_forward_fp8(ws, bs, device=dev)
    plain8 = WD.make_wide_forward_fp8(ws, bs, device=dev, route="plain")
    conv_fp8.launches = 0
    r8 = run8(x2)
    torch.cuda.synchronize()
    n8 = conv_fp8.launches
    rp = plain8(x2)
    xn = (x2[..., None].to(torch.float32) - 128.0) / 255.0
    with torch.no_grad():
        res_f = WD.float_forward([torch.from_numpy(v).to(dev) for v in ws],
                                 [torch.from_numpy(v).to(dev) for v in bs], xn)
    rec_f = torch.clamp(x2.to(torch.float32) + torch.round(res_f[..., 0] * 255.0), 0, 255).to(torch.uint8)
    r8n, rpn, rfn = (t.cpu().numpy() for t in (r8, rp, rec_f))
    psnr_plain, psnr_float = psnr(r8n, rpn), psnr(r8n, rfn)
    err_plain, err_float = max_err(r8, rp), max_err(r8, rec_f)
    n_params = sum(v.size for v in ws)
    if err_plain > 1 or not (psnr_float > 40.0 and err_float <= 8) or n8 <= 0 \
            or run8.weight_bytes != n_params:
        fail(f"wide FP8: max |diff| {err_plain} against its plain version (bound 1), PSNR "
             f"{psnr_float} dB / max |diff| {err_float} against the float model, "
             f"{n8} _scaled_mm launches, weight_bytes {run8.weight_bytes}")
    t8 = in_turns({"int8": lambda: run(x2), "fp8": lambda: run8(x2), "fp8-plain": lambda: plain8(x2)},
                  ("int8", "fp8", "fp8-plain", "fp8-plain", "fp8", "int8"), 3)
    print(f"wide c{c} b{blocks} FP8, 2x{h}x{w} on cuda: _scaled_mm launches={n8}; against its plain "
          f"version PSNR {psnr_plain:.4f} dB, max |diff| {err_plain} (bound 1); against the float model PSNR "
          f"{psnr_float:.4f} dB, max |diff| {err_float} (bounds > 40, <= 8); weight_bytes "
          f"{run8.weight_bytes} (1 B/param); ms/frame in turns: FP8 {t8['fp8'] / 2:.4f}, its plain "
          f"version {t8['fp8-plain'] / 2:.4f}, INT8 {t8['int8'] / 2:.4f} (batch 2) {card}")

    # (d) tensor parallelism on virtual meshes over cuda:0
    x1 = x2[:1]
    tp_wide = {1: make_tp_wide_forward(p, make_mesh(1, 1, devices=[dev]))}
    for tp in (2, 4, 8):
        tp_wide[tp] = make_tp_wide_forward(p, make_mesh(1, tp, devices=[dev] * tp))
        conv_int8.launches = 0
        out = tp_wide[tp](x1)
        torch.cuda.synchronize()
        n_tp = conv_int8.launches
        if max_err(out, got[:1]) or n_tp <= 0:
            fail(f"TP wide tp={tp}: max_abs_err {max_err(out, got[:1])}, {n_tp} launches")
        print(f"make_tp_wide_forward tp={tp} ({tp_wide[tp].impl}), 1x{h}x{w}: max_abs_err=0 against "
              f"(a); _int_mm launches={n_tp}")
    tw = in_turns({tp: (lambda r=r: r(x1)) for tp, r in tp_wide.items()},
                  (1, 2, 4, 8, 8, 4, 2, 1), 2)
    print(f"TP wide ms/frame in turns (1x{h}x{w}): "
          + ", ".join(f"tp {tp} {ms:.4f} ({ms / tw[1]:.3f}x)" for tp, ms in tw.items()) + f" {card}")
    xa = torch.from_numpy(anchor_1080p[:4]).to(dev)
    want_q = torch.from_numpy(recon_1080p[:4]).to(dev)
    fw = FusedWeights.from_engine(p37, dev)
    tp_q = {}
    for tp in (1, 2, 4, 8):
        tp_q[tp] = make_tp_int8_forward(p37, make_mesh(1, tp, devices=[dev] * tp))
        conv_int8.launches = 0
        out = tp_q[tp](xa)
        torch.cuda.synchronize()
        n_tp = conv_int8.launches
        if max_err(out, want_q) or n_tp <= 0:
            fail(f"TP QVRCNN tp={tp}: max_abs_err {max_err(out, want_q)} against phase 4, {n_tp} launches")
        print(f"make_tp_int8_forward tp={tp} ({tp_q[tp].impl}), QP37 4x1080x1920: max_abs_err=0 "
              f"against phase 4's generation-3 recon; _int_mm launches={n_tp}")
    tq = in_turns({"g3": lambda: fused_forward(xa, fw),
                   **{tp: (lambda r=r: r(xa)) for tp, r in tp_q.items()}},
                  ("g3", 1, 2, 4, 8, 8, 4, 2, 1, "g3"), 2)
    print("TP QVRCNN ms/frame in turns (4x1080x1920): "
          + ", ".join(f"{'generation 3' if k == 'g3' else f'tp {k}'} {ms / 4:.4f} "
                      f"({ms / tq[1]:.3f}x tp 1)" for k, ms in tq.items()) + f" {card}")
    print(json.dumps({"library_routes": [
        {"name": "wide_int8", "route": "torch._int_mm", "source": "qcnn_gpu_tpu_torch/ops/int8_conv.py",
         "counterpart": "qcnn_gpu_tpu/models/wide.py:246 (XLA int8 conv)",
         "launches_per_call_2_frames": n_int, "ms_per_frame": rec["ms_per_frame"],
         "bound_ms_per_frame": bound, "split_ms_one_frame": split},
        {"name": "wide_requant_epilogue", "route": "cuda",
         "source": f"qcnn_gpu_tpu_torch/csrc/{EPILOGUE}.cu",
         "counterpart": "none: XLA elementwise ops after qcnn_gpu_tpu/models/wide.py:246's convs",
         "launches_per_call_2_frames": n_epi, "ms_per_layer_one_frame": epi["ms"],
         "bound_ms": epi["bound_ms"], "plain_ms": epi["plain_ms"],
         "split_epilogue_ms_per_frame": split["epilogue"] / len(x2)},
        {"name": "wide_fp8", "route": "torch._scaled_mm", "source": "qcnn_gpu_tpu_torch/ops/int8_conv.py",
         "counterpart": "qcnn_gpu_tpu/models/wide.py:299 (XLA bf16 conv)",
         "launches_per_call_2_frames": n8, "ms_per_frame": t8["fp8"] / 2, "bound_ms_per_frame": bound},
        {"name": "tp_wide_int8", "route": "torch._int_mm", "source": "qcnn_gpu_tpu_torch/parallel/tensor.py",
         "counterpart": "qcnn_gpu_tpu/parallel/tensor.py:144", "ms_per_frame": tw},
        {"name": "tp_qvrcnn_int8", "route": "torch._int_mm", "source": "qcnn_gpu_tpu_torch/parallel/tensor.py",
         "counterpart": "qcnn_gpu_tpu/parallel/tensor.py:73",
         "ms_per_frame": {str(k): v / 4 for k, v in tq.items()}},
    ]}))
    print(f"phase 16: {time.perf_counter() - t_phase:.1f} s")
    return got[:1].cpu().numpy()  # (a)'s first frame: phase 19 (b)'s reference


def sharded_training(card: str) -> None:
    """Phase 17: (dp, sp)-sharded training on virtual meshes over cuda:0,
    on phase 14's demo data (64 patches of 64x64): make_grad_fn at 2x1,
    1x2, 2x2 and 1x4 against 1x1 (loss rel 1e-5, every gradient within
    1e-5 of its max |g|: the float model's tolerance in
    tests/test_torch_float_model.py); ms/step per mesh in turns;
    20 Adam steps of Trainer(mesh=2x2) (the loss falls); quant_finetune
    on a 1x2 mesh (the weights on the grid)."""
    import numpy as np
    import torch

    from qcnn_gpu_tpu_torch.data.datasets import PatchDataset
    from qcnn_gpu_tpu_torch.models import float_model as FM
    from qcnn_gpu_tpu_torch.parallel.mesh import make_mesh
    from qcnn_gpu_tpu_torch.quant.solver import BLU_INIT, stepw_from_weights
    from qcnn_gpu_tpu_torch.testing import dct_compress, make_clean_frames
    from qcnn_gpu_tpu_torch.train.finetune import quant_finetune
    from qcnn_gpu_tpu_torch.train.trainer import TrainConfig, Trainer, make_grad_fn, make_train_step

    t_phase = time.perf_counter()
    dev = torch.device("cuda", 0)
    clean = make_clean_frames(12, 256, 256)
    ds = PatchDataset([(clean, dct_compress(clean, q=28.0))], patch=64, seed=0)
    batches = list(ds.batches(64, 30))
    meshes = [(1, 1), (2, 1), (1, 2), (2, 2), (1, 4)]

    def mesh(dp, sp):
        return make_mesh(dp, sp, devices=[dev] * (dp * sp))

    params = FM.params_from_jax(FM.init_params(0), dev)
    x, y = batches[0]
    ref_loss, ref = make_grad_fn(mesh(1, 1))(params, x, y)
    for dp, sp in meshes[1:]:
        loss, grads = make_grad_fn(mesh(dp, sp))(params, x, y)
        rel = abs(float(loss) / float(ref_loss) - 1)
        worst = max(float((grads[k] - ref[k]).abs().max() / ref[k].abs().max()) for k in ref)
        if rel > 1e-5 or worst > 1e-5:
            fail(f"make_grad_fn {dp}x{sp}: loss rel diff {rel:.3g}, worst gradient {worst:.3g} of max |g|")
        print(f"make_grad_fn {dp}x{sp} on cuda, 64x64x64: loss rel diff to 1x1 {rel:.3g}, worst "
              f"gradient diff {worst:.3g} of its max |g| (tolerance 1e-5)")

    steps = {}
    for dp, sp in meshes:
        step, make_opt = make_train_step(mesh(dp, sp), lr=1e-4)
        model = FM.FloatVRCNN(FM.init_params(0), device=dev)
        opt = make_opt(model)
        for xb, yb in batches[:2]:  # warm-up: cuDNN's choices, the allocator
            step(model, opt, xb, yb)
        steps[(dp, sp)] = (step, model, opt)

    def timed(key):
        step, model, opt = steps[key]
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for xb, yb in batches[2:7]:
            step(model, opt, xb, yb)
        torch.cuda.synchronize()
        return 1e3 * (time.perf_counter() - t0) / 5

    ms = {}
    for key in meshes + meshes[::-1]:
        ms.setdefault(key, []).append(timed(key))
    ms = {k: sum(v) / len(v) for k, v in ms.items()}
    print("train step ms in turns (64x64x64, host clock over 5 steps, H2D included): "
          + ", ".join(f"{dp}x{sp} {v:.4f} ({v / ms[(1, 1)]:.3f}x)" for (dp, sp), v in ms.items())
          + f" {card}")

    tr = Trainer(TrainConfig(lr=1e-4, log_every=0), mesh=mesh(2, 2))
    losses = [float(tr.step_fn(tr.model, tr.opt, xb, yb)) for xb, yb in batches[:20]]
    first, last = sum(losses[:5]) / 5, sum(losses[-5:]) / 5
    if not last < first:
        fail(f"Trainer(mesh=2x2): the loss did not fall: first 5 steps {first:.4f}, last 5 {last:.4f}")
    trained = tr.params
    stepw = stepw_from_weights(FM.params_to_lists(trained)[0])
    out = quant_finetune(trained, stepw, batches[20:30], mesh=mesh(1, 2), blu_ub=BLU_INIT[37],
                         log_every=0)
    off = max(float(np.abs(out[f"w_{n}"] / s - np.round(out[f"w_{n}"] / s)).max())
              for n, s in zip(("C1", "C2_1", "C2_2", "C3_1", "C3_2", "C4"), stepw))
    if off > 1e-3:
        fail(f"quant_finetune(mesh=1x2): weights {off} of a step off the grid")
    print(f"Trainer(mesh=2x2) 20 Adam steps (lr 1e-4): mean loss of the first 5 {first:.4f}, of the "
          f"last 5 {last:.4f}; quant_finetune(mesh=1x2) 10 steps: weights on the grid (max {off:.2g} "
          f"of a step off) {card}")
    print(f"phase 17: {time.perf_counter() - t_phase:.1f} s")


def tuned_path(cli, card: str, zero_counts, wrappers, models, fws, cases, max_errs) -> dict:
    """Phase 18: the tuned table (ops/tuning.py) and generation 3's tile
    instances. (a) Every instance, and generation 2's one (24x40), bit for
    bit against its plain version on phase 2's cases (frame bounds:
    generation 3 alone) and on frames smaller than any tile, ragged in
    both axes, where the card's plain version is first held equal to the
    CPU's. (b) At the six reference geometries, batch 1 and 4: the
    table's program against generation 3 at 24x40, equal recon and
    ms/frame in turns. (c) `cli run --config` (batch_frames 1) on 8 frames
    of 416x240: the table's instance launched and no other kernel or
    tile. Returns (c)'s fused launches by tile."""
    import numpy as np
    import torch

    from qcnn_gpu_tpu_torch.ops import tuning
    from qcnn_gpu_tpu_torch.ops.fused import (
        TILES,
        FusedWeights,
        fused_forward,
        fused_forward_reference,
    )
    from qcnn_gpu_tpu_torch.ops.pair import pair_forward
    from qcnn_gpu_tpu_torch.tools import events_ms, graph_timer
    from qcnn_gpu_tpu_torch.tools.sweep_kernel import GEOMETRIES

    t_phase = time.perf_counter()
    dev = torch.device("cuda")

    # (a) every instance against its plain version; on the frames smaller
    # than a tile, the card's plain version (cuDNN float64 convolutions)
    # against the CPU's first, a second witness for the kernels' reference
    small = [(name, geo, "synth", ()) for name in models for geo in ((1, 13, 27), (2, 19, 31))]
    for name, geo, _, _ in small:
        x = torch.from_numpy(frames(*geo, seed=sum(geo)))
        cpu = fused_forward_reference(x, FusedWeights.from_engine(models[name], "cpu"))
        if not torch.equal(fused_forward_reference(x.to(dev), fws[name]).cpu(), cpu):
            fail(f"the plain version on the card differs from the CPU's: {name} {geo}")
    print(f"the plain version on the card == the CPU's on the {len(small)} frames smaller than "
          "a tile")
    worst = {("qvrcnn_fused", t): 0 for t in TILES}
    worst["qvrcnn_pair", (24, 40)] = 0
    for name, geo, kind, bounds in cases + small:
        if kind == "synth":
            x = frames(*geo, seed=sum(geo))
        else:
            x = np.full(geo, 0 if kind == "zeros" else 255, np.uint8)
        xd = torch.from_numpy(x).to(dev)
        want = fused_forward_reference(xd, fws[name], *bounds)
        for kname, tile in worst:
            if kname == "qvrcnn_pair":
                if bounds:
                    continue
                got = pair_forward(xd, fws[name])
            else:
                got = fused_forward(xd, fws[name], *bounds, tile=tile)
            torch.cuda.synchronize()
            err = int((got.to(torch.int16) - want.to(torch.int16)).abs().max())
            worst[kname, tile] = max(worst[kname, tile], err)
            if err != 0:
                fail(f"{kname} {tile[0]}x{tile[1]} differs from its plain version: "
                     f"{name} {geo} {kind} {bounds}")
    for (kname, (th, tw)), err in worst.items():
        max_errs[kname] = max(max_errs[kname], err)
        print(f"{kname} {th}x{tw} vs plain, phase 2's {len(cases)} cases (bounds: "
              f"generation 3 only) and {len(small)} frames smaller than a tile: max_abs_err={err}")

    # (b) the table's program against 24x40, in turns
    fw = fws["golden-QP37"]
    p37 = models["golden-QP37"]
    for h, w in GEOMETRIES:
        for b in (1, 4):
            run = tuning.build_tuned(p37, dev, h, w, b)
            x = torch.from_numpy(frames(b, h, w, seed=h + b)).to(dev)
            got, want = run(x), fused_forward(x, fw)
            torch.cuda.synchronize()
            if not torch.equal(got, want):
                fail(f"the table's program at {w}x{h} batch {b} differs from 24x40")
            reps = max(5, math.ceil(20.0 / max(events_ms(lambda: fused_forward(x, fw), 3), 1e-3)))
            timers = {"24x40": graph_timer(lambda: fused_forward(x, fw), reps),
                      "tuned": graph_timer(lambda: run(x), reps)}
            ms = {k: 0.0 for k in timers}
            for k in ("24x40", "tuned", "tuned", "24x40"):
                ms[k] += timers[k]() / 2
            del timers
            th, tw = run.tile
            print(f"tuned {w}x{h} batch {b}: generation 3 at {th}x{tw}, recon == 24x40; "
                  f"{ms['tuned'] / b:.4f} ms/frame against 24x40's {ms['24x40'] / b:.4f} "
                  f"({ms['tuned'] / ms['24x40']:.4f}x) in turns, CUDA graphs of {reps} launches "
                  f"{card}")

    # (c) cli run at 416x240, batch 1: the table's instance
    h, w, n = 240, 416, 8
    want = tuning.tuned_kwargs(h, w, 1)
    served = f"{want.get('th', 24)}x{want.get('tw', 40)}"
    with tempfile.TemporaryDirectory() as d:
        ori = frames(n, h, w, seed=18)
        anchor = np.clip(ori.astype(np.int16) + np.random.default_rng(18).integers(
            -6, 7, size=ori.shape), 0, 255).astype(np.uint8)
        files = {k: os.path.join(d, f"{k}.yuv") for k in ("ori", "anchor")}
        write_yuv420(files["ori"], ori)
        write_yuv420(files["anchor"], anchor)
        with open(os.path.join(d, "engine.json"), "w") as fp:
            json.dump({"engine": {"impl": "auto", "batch_frames": 1, "out_dir": d}}, fp)
        zero_counts()
        rc = cli.main(["run", "--ori", files["ori"], "--anchor", files["anchor"], "--height",
                       str(h), "--width", str(w), "--frames", str(n), "--model",
                       os.path.join(GOLDEN, "model_q37.data"), "--qp", "37", "--device", "cuda",
                       "--config", os.path.join(d, "engine.json"),
                       "--recon", os.path.join(d, "recon.yuv")])
        launched = {f"{th}x{tw}": c for (th, tw), c in fused_forward.tile_launches.items() if c}
        others = {k: fn.launches for k, fn in wrappers.items()
                  if k != "qvrcnn_fused" and fn.launches}
        if rc != 0:
            fail(f"cli run --config (batch_frames 1) at {w}x{h} exited {rc}")
        with open(os.path.join(d, "runs.jsonl")) as fp:
            rec = json.loads(fp.readline())
        recon = read_y420(os.path.join(d, "recon.yuv"), n, h, w)
    if set(launched) != {served} or others:
        fail(f"cli run at {w}x{h} batch 1: fused launches by tile {launched}, other kernels "
             f"{others}; the table says {served}")
    plain = fused_forward_reference(torch.from_numpy(anchor).to(dev), fw).cpu().numpy()
    if not (recon == plain).all():
        fail(f"cli run at {w}x{h} batch 1: recon differs from the plain version")
    print(f"cli run --config (batch_frames 1), {n}x{w}x{h}: impl={rec['impl']}, the table's "
          f"generation 3 at {served} launched {launched[served]} times, no other tile or "
          f"kernel; recon == plain version; {rec['time_us'] / 1e3 / n:.4f} ms/frame incl. "
          f"H2D/D2H {card}")
    print(f"phase 18: {time.perf_counter() - t_phase:.1f} s")
    return launched


# phase 19 (a), (b): one rank of DistributedRunner and the TP forwards over
# global meshes whose axes span the 2 ranks, every position on cuda:0;
# argv: repo, rank, port, work dir
SPAN_WORKER = textwrap.dedent("""
    import dataclasses, json, sys, time
    sys.path.insert(0, sys.argv[1])
    import numpy as np
    import torch
    import torch.distributed as dist
    from qcnn_gpu_tpu_torch.engine.runner import read_model
    from qcnn_gpu_tpu_torch.models.qvrcnn import _normalized_table
    from qcnn_gpu_tpu_torch.models.wide import synth_wide_params
    from qcnn_gpu_tpu_torch.ops.fused import fused_forward
    from qcnn_gpu_tpu_torch.ops.int8_conv import conv_int8
    from qcnn_gpu_tpu_torch.ops.literal import literal_residual
    from qcnn_gpu_tpu_torch.parallel.distributed import DistributedRunner, initialize
    from qcnn_gpu_tpu_torch.parallel.mesh import make_global_mesh, make_mesh
    from qcnn_gpu_tpu_torch.parallel.spatial import make_sharded_forward
    from qcnn_gpu_tpu_torch.parallel.tensor import make_tp_int8_forward, make_tp_wide_forward

    here, rank, port, d = sys.argv[1], int(sys.argv[2]), sys.argv[3], sys.argv[4]
    initialize(f"tcp://127.0.0.1:{port}", 2, rank)
    dev = torch.device("cuda", 0)
    p37 = read_model(f"{here}/assets/golden/model_q37.data")
    anchor, recon = np.load(f"{d}/anchor.npy"), np.load(f"{d}/recon.npy")
    rec = {"meshes": {}}

    def clock(fn):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        return out, 1e3 * (time.perf_counter() - t0)

    for label in ("1x2", "1x4", "1x2x2", "1x1x2"):
        dims = [int(v) for v in label.split("x")] + [1]
        dp, sp, sw = dims[:3]
        mesh = make_global_mesh(dp, sp, [dev] * (dp * sp * sw // 2), sw=sw)
        runner = DistributedRunner(p37, mesh, impl="auto")
        x = anchor[mesh.local_slice(rank, anchor.shape)]
        runner.restore(x)  # warm-up
        fused_forward.launches = 0
        runner.run.halo_bytes.update(sent=0, received=0)
        got = runner.restore(x)
        launches, halo = fused_forward.launches, dict(runner.run.halo_bytes)
        one = make_sharded_forward(p37, make_mesh(dp, sp, devices=[dev] * (dp * sp * sw), sw=sw))
        if rank == 0:
            one(torch.from_numpy(anchor).to(dev))
        turns = {"x": [], "one": [], "forward": []}
        for turn in ("x", "one", "one", "x"):
            dist.barrier()  # one process at a time on the card
            for _ in range(3):
                if turn == "x":
                    turns["x"].append(clock(lambda: runner.restore(x))[1])
                    xd = torch.from_numpy(x).to(dev)
                    turns["forward"].append(clock(lambda: runner.run(xd))[1])
                    dist.barrier()
                elif rank == 0:
                    turns["one"].append(clock(
                        lambda: one(torch.from_numpy(anchor).to(dev)).cpu().numpy())[1])
            dist.barrier()
        rec["meshes"][label] = {
            "equal": bool((got == recon).all()), "shape": list(got.shape),
            "local": list(x.shape), "positions": int((mesh.ranks == rank).sum()),
            "launches": launches, "halo": halo, "impl": runner.run.impl,
            "ranks": mesh.ranks.tolist(), "ms": turns,
        }

    # (a) generation 1 across the 2 ranks: a table outside the saturation
    # window (C2_2's bound one output step up, phase 7's) at global 1x2
    mul, shift = _normalized_table(p37)
    blu = list(p37.blu_q)
    blu[2] = int(blu[2]) + (1 << int(shift[2])) // int(mul[2]) + 1
    mesh = make_global_mesh(1, 2, [dev])
    runner = DistributedRunner(dataclasses.replace(p37, blu_q=blu), mesh, impl="auto")
    x = anchor[mesh.local_slice(rank, anchor.shape)]
    literal_residual.launches = 0
    got = runner.restore(x)
    rec["outside"] = {"equal": bool((got == np.load(f"{d}/recon_out.npy")).all()),
                      "shape": list(got.shape), "impl": runner.run.impl,
                      "launches": literal_residual.launches,
                      "positions": int((mesh.ranks == rank).sum())}

    # (b) TP across the 2 ranks: QVRCNN at tp 2, the wide net c256 b10 at tp 2
    mesh = make_global_mesh(1, 2, [dev])
    xt = torch.from_numpy(np.load(f"{d}/tp_x.npy")).to(dev)
    run = make_tp_int8_forward(p37, mesh)
    run(xt)
    conv_int8.launches = 0
    out, ms = clock(lambda: run(xt).cpu().numpy())
    rec["tp_int8"] = {"equal": bool((out == np.load(f"{d}/tp_want.npy")).all()),
                      "launches": conv_int8.launches, "ms": ms, "impl": run.impl}
    xw = torch.from_numpy(np.load(f"{d}/wide_x.npy")).to(dev)
    wide = make_tp_wide_forward(synth_wide_params(256, 10, seed=7), mesh)
    conv_int8.launches = 0
    out, ms = clock(lambda: wide(xw).cpu().numpy())
    rec["tp_wide"] = {"equal": bool((out == np.load(f"{d}/wide_want.npy")).all()),
                      "launches": conv_int8.launches, "ms": ms, "impl": wide.impl}
    with open(f"{d}/rank{rank}.json", "w") as fp:
        json.dump(rec, fp)
    dist.destroy_process_group()
""")


def span_path(card: str, anchor_1080p, recon_1080p, p37, p_out, wide_one) -> None:
    """Phase 19: (a) DistributedRunner in 2 gloo processes on cuda:0 over
    global meshes 1x2, 1x4, 1x2x2 and 1x1x2 (sp, sw across the ranks),
    QP37 at 1920x1080 batch 4, each rank passing its slice of phase 4's
    anchors: both ranks return the global batch equal to phase 4's recon,
    generation 3 launched once per position a rank owns, the halo bytes
    each rank sends and receives, and the ms per call (host clock) in
    turns against the same mesh in one process; then phase 7's table
    outside the saturation window at global 1x2: generation 1 (`auto`),
    launched once a rank, both ranks equal to the unsharded literal
    kernel; (b) the TP forwards
    across the 2 ranks: QVRCNN at tp 2 on 2 frames of 832x480 against
    generation 3, the wide net c256 b10 at tp 2 on phase 16's first frame
    against phase 16's one-process result; (c) `restore_tiled` over
    `Engine.restore` (540x960 tiles, 4 windows a call) at 3840x2160
    through generation 3 (2 frames) and the reference net (1): tiled equal
    to whole, the launches counted, each one's peak device memory and
    ms/frame; (d) the native Y reader (and writer) against NumPy on phase
    4's 16 frames of 1080p: equal, both times in turns, alone and in
    run_sequence's wall time from files to files."""
    import numpy as np
    import torch

    from qcnn_gpu_tpu_torch.data import yuv as Y
    from qcnn_gpu_tpu_torch.engine.runner import Engine
    from qcnn_gpu_tpu_torch.engine.tiled import restore_tiled
    from qcnn_gpu_tpu_torch.ops.fused import FusedWeights, fused_forward
    from qcnn_gpu_tpu_torch.ops.literal import LiteralWeights, literal_forward

    t_phase = time.perf_counter()
    dev = torch.device("cuda", 0)
    with tempfile.TemporaryDirectory() as d:
        # (a), (b): the two ranks
        np.save(os.path.join(d, "anchor.npy"), anchor_1080p[:4])
        np.save(os.path.join(d, "recon.npy"), recon_1080p[:4])
        np.save(os.path.join(d, "recon_out.npy"), literal_forward(
            torch.from_numpy(anchor_1080p[:4]).to(dev), LiteralWeights.from_engine(p_out, dev))
            .cpu().numpy())
        tp_x = frames(2, 480, 832, seed=19)
        np.save(os.path.join(d, "tp_x.npy"), tp_x)
        np.save(os.path.join(d, "tp_want.npy"), fused_forward(
            torch.from_numpy(tp_x).to(dev), FusedWeights.from_engine(p37, dev)).cpu().numpy())
        np.save(os.path.join(d, "wide_x.npy"), frames(2, 480, 832, seed=16)[:1])
        np.save(os.path.join(d, "wide_want.npy"), wide_one)
        script = os.path.join(d, "worker.py")
        with open(script, "w") as fp:
            fp.write(SPAN_WORKER)
        with socket.socket() as sock:
            sock.bind(("127.0.0.1", 0))
            port = str(sock.getsockname()[1])
        t0 = time.perf_counter()
        procs = [subprocess.Popen([sys.executable, script, HERE, str(r), port, d],
                                  stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
                 for r in range(2)]
        try:
            logs = [pr.communicate(timeout=600)[0] for pr in procs]
        finally:
            for pr in procs:
                if pr.poll() is None:
                    pr.kill()
                    pr.wait()
        if any(pr.returncode for pr in procs):
            fail(f"phase 19 workers exited {[pr.returncode for pr in procs]}: {logs}")
        recs = []
        for r in range(2):
            with open(os.path.join(d, f"rank{r}.json")) as fp:
                recs.append(json.load(fp))
    print(f"phase 19 (a)-(b): 2 processes, {time.perf_counter() - t0:.1f} s in all")
    for label in recs[0]["meshes"]:
        for r, rec in enumerate(recs):
            m = rec["meshes"][label]
            ms = {k: sum(v) / len(v) for k, v in m["ms"].items() if v}
            print(f"DistributedRunner {label} across 2 ranks (ranks by position {m['ranks']}), "
                  f"rank {r}: local slice {m['local']}, returned {m['shape']}, == phase 4's "
                  f"recon: {m['equal']}; fused launches={m['launches']} ({m['positions']} "
                  f"positions x 1 call); halo bytes sent {m['halo']['sent']}, received "
                  f"{m['halo']['received']}; ms per call in turns (host clock, x one one x, "
                  f"3 calls a turn): across processes {ms['x']:.3f} (its sharded forward alone "
                  f"{ms['forward']:.3f}, the rest the shapes' and the frames' all-gathers)"
                  + (f", the same mesh in one process {ms['one']:.3f} "
                     f"({ms['x'] / ms['one']:.3f}x)" if "one" in ms else "") + f" {card}")
            if not m["equal"] or m["shape"] != [4, H, W] or m["launches"] != m["positions"] \
                    or m["impl"] != "kernel3" or m["halo"]["sent"] <= 0:
                fail(f"DistributedRunner {label} rank {r}: {m}")
    for r, rec in enumerate(recs):
        m = rec["outside"]
        print(f"DistributedRunner 1x2 across 2 ranks, phase 7's table outside the window, rank "
              f"{r}: impl={m['impl']}, returned {m['shape']}, == the unsharded literal kernel: "
              f"{m['equal']}; literal launches={m['launches']} ({m['positions']} positions x 1 "
              f"call)")
        if not m["equal"] or m["impl"] != "kernel1" or m["launches"] != m["positions"] \
                or m["shape"] != [4, H, W]:
            fail(f"DistributedRunner with generation 1 across ranks, rank {r}: {m}")
    for key, what in (("tp_int8", "make_tp_int8_forward QP37 tp 2, 2x480x832, vs generation 3"),
                      ("tp_wide", "make_tp_wide_forward c256 b10 tp 2, 1x480x832, vs phase 16 (a)")):
        for r, rec in enumerate(recs):
            t = rec[key]
            print(f"{what} across 2 ranks, rank {r} ({t['impl']}): equal {t['equal']}; "
                  f"_int_mm launches={t['launches']}; {t['ms']:.3f} ms for the call "
                  f"(host clock, one call after {'a warm-up' if key == 'tp_int8' else 'none'}) "
                  f"{card}")
            if not t["equal"] or t["launches"] <= 0:
                fail(f"{what} across ranks, rank {r}: {t}")

    # (c) restore_tiled (540x960 tiles, 4 windows a call) over
    # Engine.restore at 3840x2160 against whole frames
    x2160 = frames(2, 2160, 3840, seed=20)
    outs = {}
    for impl, n in (("kernel3", 2), ("reference", 1)):
        eng = Engine(device=dev, impl=impl, batch_frames=4)
        eng.set_model(37, p37)
        runs = {"whole": lambda: eng.restore(x2160[:n], 37),
                "tiled": lambda: restore_tiled(lambda w: eng.restore(w, 37), x2160[:n],
                                               540, 960, chunk=4)}
        # generation 3: one launch a call of up to 4 frames or windows (16
        # windows a frame); the reference net launches none
        want = ({"whole": -(-n // 4), "tiled": -(-16 * n // 4)} if impl == "kernel3"
                else {"whole": 0, "tiled": 0})
        for how, run in runs.items():
            run()  # warm-up: build, weights, allocator
            torch.cuda.synchronize()
            torch.cuda.empty_cache()
            base = torch.cuda.memory_allocated()
            torch.cuda.reset_peak_memory_stats()
            fused_forward.launches = 0
            t0 = time.perf_counter()
            outs[impl, how] = run()
            torch.cuda.synchronize()
            ms = 1e3 * (time.perf_counter() - t0) / n
            peak = torch.cuda.max_memory_allocated() - base
            launches = fused_forward.launches
            print(f"Engine(impl={impl}).restore {how} {n}x2160x3840: {ms:.3f} ms/frame (host "
                  f"clock, copies included), peak device memory above the {base} B held "
                  f"before: {peak} B ({peak / 2**20:.1f} MiB); fused launches={launches} "
                  f"(expected {want[how]}) {card}")
            if launches != want[how]:
                fail(f"Engine(impl={impl}).restore {how} at 2160p: {launches} fused launches, "
                     f"expected {want[how]}")
        equal = bool((outs[impl, "whole"] == outs[impl, "tiled"]).all())
        print(f"Engine(impl={impl}) 2160p: tiled at 540x960 == whole: {equal}")
        if not equal:
            fail(f"restore_tiled over Engine(impl={impl}) differs from the whole frame at 2160p")
    if not (outs["kernel3", "whole"][:1] == outs["reference", "whole"]).all():
        fail("generation 3 and the reference net differ at 2160p")

    # (d) the native Y reader and writer against NumPy, 16 frames of 1080p:
    # alone, and in the metric they move, run_sequence's wall time from
    # files to files (cli run's work: two reads, warm-up, stream, PSNR,
    # write)
    with tempfile.TemporaryDirectory() as d:
        files = {k: os.path.join(d, f"{k}.yuv") for k in ("native", "numpy")}
        Y.write_y_as_420(files["native"], anchor_1080p)
        Y.write_y_as_420_numpy(files["numpy"], anchor_1080p)
        with open(files["native"], "rb") as a, open(files["numpy"], "rb") as b:
            same_bytes = a.read() == b.read()
        reads = {"native": lambda: Y.read_y(files["native"], H, W, len(anchor_1080p)),
                 "numpy": lambda: Y.read_y_numpy(files["native"], H, W, len(anchor_1080p))}
        ms = {k: [] for k in reads}
        got = {}
        for k in ("native", "numpy", "numpy", "native"):
            t0 = time.perf_counter()
            got[k] = reads[k]()
            ms[k].append(1e3 * (time.perf_counter() - t0))
        equal = all((v == anchor_1080p).all() for v in got.values())
        print(f"read_y 16x{H}x{W} (page cache): native {sum(ms['native']) / 2:.3f} ms, NumPy "
              f"{sum(ms['numpy']) / 2:.3f} ms (host clock, in turns n np np n: "
              f"{ms['native'][0]:.3f} {ms['numpy'][0]:.3f} {ms['numpy'][1]:.3f} "
              f"{ms['native'][1]:.3f}); equal to the frames: {equal}; native writer's bytes == "
              f"NumPy's: {same_bytes}")
        if not (equal and same_bytes):
            fail("the native Y reader or writer differs from NumPy")
        # the writer alone, in turns n np np n
        wms = {"native": [], "numpy": []}
        for k in ("native", "numpy", "numpy", "native"):
            write = Y.write_y_as_420 if k == "native" else Y.write_y_as_420_numpy
            t0 = time.perf_counter()
            write(files[k], anchor_1080p)
            wms[k].append(1e3 * (time.perf_counter() - t0))
        print(f"write_y_as_420 16x{H}x{W}: native {' '.join(f'{x:.3f}' for x in wms['native'])} "
              f"ms, NumPy {' '.join(f'{x:.3f}' for x in wms['numpy'])} ms (host clock, in "
              f"turns n np np n)")
        # run_sequence with each IO: a warm-up, then 10 pairs, the side that
        # runs first alternating; medians, quartiles and pairs won
        eng = Engine(device=dev, impl="auto", batch_frames=4, out_dir=d)
        eng.set_model(37, p37)
        io = {"native": (Y.read_y, Y.write_y_as_420),
              "numpy": (Y.read_y_numpy, Y.write_y_as_420_numpy)}
        wall = {k: [] for k in io}
        stream = {k: [] for k in io}
        recons = {k: os.path.join(d, f"recon_{k}.yuv") for k in io}

        def one(k: str) -> float:
            Y.read_y, Y.write_y_as_420 = io[k]
            t0 = time.perf_counter()
            rec = eng.run_sequence("e2e", files["native"], files["native"], H, W, 37,
                                   frames=len(anchor_1080p), recon_path=recons[k])
            ms = 1e3 * (time.perf_counter() - t0)
            stream[k].append(rec.time_us / 1e3)
            return ms

        try:
            one("native")  # warm-up
            stream["native"].clear()
            for i in range(10):
                for k in (("native", "numpy") if i % 2 == 0 else ("numpy", "native")):
                    wall[k].append(one(k))
        finally:
            Y.read_y, Y.write_y_as_420 = io["native"]
        with open(recons["native"], "rb") as a, open(recons["numpy"], "rb") as b:
            same_recon = a.read() == b.read()
        q = {k: np.percentile(v, [25, 50, 75]) for k, v in wall.items()}
        won = sum(n < p for n, p in zip(wall["native"], wall["numpy"]))
        print(f"run_sequence 16x{H}x{W} files to files (two reads, warm-up, stream, PSNR, "
              f"write), wall ms, 10 pairs after a warm-up, first side alternating: native "
              f"{' '.join(f'{x:.3f}' for x in wall['native'])}; NumPy IO "
              f"{' '.join(f'{x:.3f}' for x in wall['numpy'])}; median native {q['native'][1]:.3f} "
              f"(quartiles {q['native'][0]:.3f}-{q['native'][2]:.3f}), NumPy {q['numpy'][1]:.3f} "
              f"({q['numpy'][0]:.3f}-{q['numpy'][2]:.3f}); native faster in {won} of 10 pairs; "
              f"its timed stream (time_us) median native {np.median(stream['native']):.3f}, "
              f"NumPy {np.median(stream['numpy']):.3f}; recon files equal: {same_recon} {card}")
        if not same_recon:
            fail("run_sequence's recon differs between the native and the NumPy IO")
    print(f"phase 19: {time.perf_counter() - t_phase:.1f} s")


# phase 20: one rank of (dp, sp) training over global meshes whose axes
# span the 2 ranks, every position on cuda:0; argv: repo, rank, port, work dir
SPAN_TRAIN_WORKER = textwrap.dedent("""
    import json, sys, time
    sys.path.insert(0, sys.argv[1])
    import numpy as np
    import torch
    import torch.distributed as dist
    from qcnn_gpu_tpu_torch.data.model_files import write_static_qfp_vect_c
    from qcnn_gpu_tpu_torch.engine.calibrate import quantize_model, solve_table
    from qcnn_gpu_tpu_torch.engine.runner import read_model
    from qcnn_gpu_tpu_torch.models import float_model as FM
    from qcnn_gpu_tpu_torch.ops.fused import fused_forward
    from qcnn_gpu_tpu_torch.parallel.distributed import DistributedRunner, initialize
    from qcnn_gpu_tpu_torch.parallel.mesh import make_global_mesh, make_mesh
    from qcnn_gpu_tpu_torch.quant.solver import BLU_INIT
    from qcnn_gpu_tpu_torch.train import trainer as T
    from qcnn_gpu_tpu_torch.train.finetune import quant_finetune
    from qcnn_gpu_tpu_torch.train.trainer import TrainConfig, Trainer, make_grad_fn, make_train_step

    here, rank, port, d = sys.argv[1], int(sys.argv[2]), sys.argv[3], sys.argv[4]
    meshes = json.loads(sys.argv[5])
    initialize(f"tcp://127.0.0.1:{port}", 2, rank)
    dev = torch.device("cuda", 0)
    data = np.load(f"{d}/batches.npz")
    batches = list(zip(data["x"], data["y"]))
    rec = {"meshes": {}}

    def ms_per_step(run):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for xb, yb in batches[2:7]:
            run(xb, yb)
        torch.cuda.synchronize()
        return 1e3 * (time.perf_counter() - t0) / 5

    params = FM.params_from_jax(FM.init_params(0), dev)
    for label, (dp, sp, local) in meshes.items():
        # (a) the gradients of the first batch, every rank passing all of it
        mesh = make_global_mesh(dp, sp, [dev] * local)
        fn = make_grad_fn(mesh)
        loss, grads = fn(params, *batches[0])
        np.savez(f"{d}/grads-{label}-rank{rank}.npz", loss=loss.cpu().numpy(),
                 **{k: v.cpu().numpy() for k, v in grads.items()})
        # (b) a step across the processes ("x", both ranks) against the same
        # mesh in one process ("one", rank 0 alone), in turns
        on = {"x": mesh}
        if rank == 0:
            on["one"] = make_mesh(dp, sp, devices=[dev] * (dp * sp))
        runs = {}
        for name, m in on.items():
            step, make_opt = make_train_step(m, lr=1e-4)
            model = FM.FloatVRCNN(FM.init_params(0), device=dev)
            opt = make_opt(model)
            for xb, yb in batches[:2]:  # warm-up: cuDNN's choices, the allocator
                step(model, opt, xb, yb)
            runs[name] = (lambda xb, yb, step=step, model=model, opt=opt:
                          step(model, opt, xb, yb))
        ms = {"x": [], "one": []}
        for turn in ("x", "one", "one", "x"):
            dist.barrier()  # one process at a time on the card, unless both step
            if turn in runs:
                ms[turn].append(ms_per_step(runs[turn]))
            dist.barrier()
        # where a step across the processes goes, 5 more steps: the host
        # seconds spent waiting for the card before each exchange, in the
        # halo exchange and in the all-reduce (each after that wait)
        split = {"device wait": 0.0, "halo": 0.0, "all-reduce": 0.0}

        def timed(fn, key):
            def wrapper(*args, **kwargs):
                t0 = time.perf_counter()
                torch.cuda.synchronize()
                t1 = time.perf_counter()
                out = fn(*args, **kwargs)
                split["device wait"] += t1 - t0
                split[key] += time.perf_counter() - t1
                return out
            return wrapper

        plain = T.halo_exchange_rows, T._allreduce
        T.halo_exchange_rows, T._allreduce = timed(plain[0], "halo"), timed(plain[1], "all-reduce")
        dist.barrier()
        split["step"] = ms_per_step(runs["x"]) / 1e3 * 5
        T.halo_exchange_rows, T._allreduce = plain
        rec["meshes"][label] = {"cross": fn.cross_bytes, "ranks": mesh.ranks.tolist(),
                                "ms": ms, "split": {k: 1e3 * v / 5 for k, v in split.items()}}

    # (c) 20 Adam steps of Trainer on the global 1x2 mesh
    mesh = make_global_mesh(1, 2, [dev])
    tr = Trainer(TrainConfig(lr=1e-4, log_every=0), mesh=mesh)
    rec["losses"] = [float(tr.step_fn(tr.model, tr.opt, xb, yb)) for xb, yb in batches[:20]]
    tr.save_checkpoint(f"{d}/ckpt-rank{rank}")
    trained = tr.params
    np.savez(f"{d}/trainer-rank{rank}.npz", **trained)
    # (d) quant_finetune on the same mesh, 10 steps, under the QP37 presets'
    # table; rank 0 writes the model, which both serve over the mesh
    table = solve_table(trained, qp=37)
    out = quant_finetune(trained, table.stepw, batches[20:30], mesh=mesh, blu_ub=BLU_INIT[37],
                         log_every=0)
    np.savez(f"{d}/finetune-rank{rank}.npz", **out)
    rec["stepw"] = [float(s) for s in table.stepw]
    if rank == 0:
        write_static_qfp_vect_c(f"{d}/model_ft.data", quantize_model(out, table))
    dist.barrier()
    runner = DistributedRunner(read_model(f"{d}/model_ft.data"), mesh, impl="auto")
    anchor = np.load(f"{d}/anchor.npy")
    x = anchor[mesh.local_slice(rank, anchor.shape)]
    fused_forward.launches = 0
    got = runner.restore(x)
    rec["served"] = {"launches": fused_forward.launches, "impl": runner.run.impl,
                     "local": list(x.shape), "positions": int((mesh.ranks == rank).sum())}
    np.save(f"{d}/served-rank{rank}.npy", got)
    with open(f"{d}/rank{rank}.json", "w") as fp:
        json.dump(rec, fp)
    dist.destroy_process_group()
""")


def span_training(card: str, anchor_1080p) -> None:
    """Phase 20: (dp, sp) training in 2 gloo processes on cuda:0 over
    global meshes 2x1, 1x2 (1 local device a rank), 1x4 and 2x2 (2), on
    phase 17's data, every rank passing the whole batch: (a) make_grad_fn
    against the one-process 1x1 step on the card (loss rel 1e-5, every
    gradient within 1e-5 of its max |g|), the ranks bit-equal, the bytes
    across ranks exact (halo 6 x 64 x 64 x 4 B = 98,304 a rank at 1x2 and
    1x4, 0 at 2x1 and 2x2; the all-reduce's 54,674 float32 = 218,696 B);
    (b) ms per step across the processes against the same mesh in one,
    in turns (host clock, 5 steps after 2 warm-up steps); (c) 20 Adam
    steps of Trainer on the global 1x2 mesh: the loss falls, both ranks'
    params bit-equal, close to a one-process 1x2 Trainer's (max |diff| at
    most 2 x lr x 5, median at most 1e-6), the checkpoint written by rank
    0 alone; (d) quant_finetune on that mesh, 10 steps: weights on the
    grid and equal on both ranks; rank 0 writes the vect_c model, which
    DistributedRunner serves over the global 1x2 mesh on phase 4's
    anchors (1080p batch 4), generation 3 launched once a rank, bit-equal
    on both ranks to a one-process Engine.restore of the same file."""
    import numpy as np
    import torch

    from qcnn_gpu_tpu_torch.data.datasets import PatchDataset
    from qcnn_gpu_tpu_torch.engine.runner import Engine, read_model
    from qcnn_gpu_tpu_torch.models import float_model as FM
    from qcnn_gpu_tpu_torch.parallel.mesh import make_mesh
    from qcnn_gpu_tpu_torch.testing import dct_compress, make_clean_frames
    from qcnn_gpu_tpu_torch.train.trainer import TrainConfig, Trainer, make_grad_fn

    t_phase = time.perf_counter()
    dev = torch.device("cuda", 0)
    clean = make_clean_frames(12, 256, 256)
    ds = PatchDataset([(clean, dct_compress(clean, q=28.0))], patch=64, seed=0)
    batches = list(ds.batches(64, 30))
    # label -> (dp, sp, local devices a rank), and the halo bytes a rank
    # sends (= receives): 6 rows x 64 columns x 64 patches x 4 B where an
    # sp boundary lies between the ranks
    meshes = {"2x1": (2, 1, 1), "1x2": (1, 2, 1), "1x4": (1, 4, 2), "2x2": (2, 2, 2)}
    halo = {"2x1": 0, "1x2": 6 * 64 * 64 * 4, "1x4": 6 * 64 * 64 * 4, "2x2": 0}
    n_sums = sum(v.size for v in FM.init_params(0).values()) + 1  # every weight, bias, the loss
    with tempfile.TemporaryDirectory() as d:
        np.savez(os.path.join(d, "batches.npz"), x=np.stack([x for x, _ in batches]),
                 y=np.stack([y for _, y in batches]))
        np.save(os.path.join(d, "anchor.npy"), anchor_1080p[:4])
        script = os.path.join(d, "worker.py")
        with open(script, "w") as fp:
            fp.write(SPAN_TRAIN_WORKER)
        with socket.socket() as sock:
            sock.bind(("127.0.0.1", 0))
            port = str(sock.getsockname()[1])
        t0 = time.perf_counter()
        procs = [subprocess.Popen([sys.executable, script, HERE, str(r), port, d,
                                   json.dumps(meshes)],
                                  stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
                 for r in range(2)]
        try:
            logs = [pr.communicate(timeout=600)[0] for pr in procs]
        finally:
            for pr in procs:
                if pr.poll() is None:
                    pr.kill()
                    pr.wait()
        if any(pr.returncode for pr in procs):
            fail(f"phase 20 workers exited {[pr.returncode for pr in procs]}: {logs}")
        print(f"phase 20: 2 processes, {time.perf_counter() - t0:.1f} s in all")
        recs = []
        for r in range(2):
            with open(os.path.join(d, f"rank{r}.json")) as fp:
                recs.append(json.load(fp))

        def load(name):
            with np.load(os.path.join(d, name)) as f:
                return {k: f[k] for k in f.files}

        # (a), (b)
        ref_loss, ref = make_grad_fn(make_mesh(1, 1, devices=[dev]))(
            FM.params_from_jax(FM.init_params(0), dev), *batches[0])
        ref_loss, ref = float(ref_loss), {k: v.cpu().numpy() for k, v in ref.items()}
        for label in meshes:
            got = [load(f"grads-{label}-rank{r}.npz") for r in range(2)]
            equal = all(np.array_equal(got[0][k], got[1][k]) for k in got[0])
            rel = abs(float(got[0]["loss"]) / ref_loss - 1)
            worst = max(float(np.abs(got[0][k] - ref[k]).max() / np.abs(ref[k]).max()) for k in ref)
            cross = [recs[r]["meshes"][label]["cross"] for r in range(2)]
            want = {"halo_sent": halo[label], "halo_received": halo[label],
                    "allreduce": 4 * n_sums}
            m = recs[0]["meshes"][label]
            ms = {k: sum(v) / len(v) for k, v in m["ms"].items()}
            ms_1 = sum(recs[1]["meshes"][label]["ms"]["x"]) / 2
            print(f"make_grad_fn {label} across 2 ranks (ranks by position {m['ranks']}), "
                  f"64x64x64 on cuda: loss rel diff to the 1x1 step {rel:.3g}, worst gradient "
                  f"diff {worst:.3g} of its max |g| (tolerance 1e-5), ranks bit-equal: {equal}; "
                  f"bytes across a call, rank 0 {cross[0]}, rank 1 {cross[1]}; a train step "
                  f"(host clock, x one one x, 5 steps a turn after 2 warm-up): across processes "
                  f"{ms['x']:.4f} ms (rank 1 {ms_1:.4f}), the same mesh in one process "
                  f"{ms['one']:.4f} ({ms['x'] / ms['one']:.3f}x) {card}")
            for r in range(2):
                part = recs[r]["meshes"][label]["split"]
                rest = part["step"] - part["device wait"] - part["halo"] - part["all-reduce"]
                print(f"  {label} rank {r}, 5 more steps across processes: {part['step']:.4f} ms a "
                      f"step, of it waiting for the card before an exchange "
                      f"{part['device wait']:.4f}, the halo exchange {part['halo']:.4f}, the "
                      f"all-reduce {part['all-reduce']:.4f}, the rest (enqueueing, the "
                      f"optimizer) {rest:.4f} (host clock)")
            if rel > 1e-5 or worst > 1e-5 or not equal or cross != [want, want]:
                fail(f"make_grad_fn {label} across 2 ranks: loss rel {rel}, worst {worst}, "
                     f"ranks equal {equal}, bytes {cross}, expected {want}")

        # (c)
        losses = recs[0]["losses"]
        first, last = sum(losses[:5]) / 5, sum(losses[-5:]) / 5
        trained = [load(f"trainer-rank{r}.npz") for r in range(2)]
        same = recs[1]["losses"] == losses and all(
            np.array_equal(trained[0][k], trained[1][k]) for k in FM.PARAM_NAMES)
        one = Trainer(TrainConfig(lr=1e-4, log_every=0), mesh=make_mesh(1, 2, devices=[dev] * 2))
        for xb, yb in batches[:20]:
            one.step_fn(one.model, one.opt, xb, yb)
        diffs = np.concatenate([np.abs(trained[0][k] - one.params[k]).ravel()
                                for k in FM.PARAM_NAMES])
        ckpts = [os.path.exists(os.path.join(d, f"ckpt-rank{r}", "latest")) for r in range(2)]
        print(f"Trainer(mesh=global 1x2) across 2 ranks, 20 Adam steps (lr 1e-4): mean loss of "
              f"the first 5 {first:.4f}, of the last 5 {last:.4f}; ranks' losses and params "
              f"bit-equal: {same}; against a one-process 1x2 Trainer max |diff| "
              f"{diffs.max():.3g}, median {np.median(diffs):.3g} (bounds 2 x lr x 5 = 1e-3, "
              f"1e-6); checkpoint written by rank 0, 1: {ckpts} {card}")
        if not (last < first and same and diffs.max() <= 2 * 1e-4 * 5
                and np.median(diffs) <= 1e-6 and ckpts == [True, False]):
            fail("Trainer(mesh=global 1x2) across 2 ranks: the loss did not fall, the ranks "
                 "differ, the params left the one-process run's bounds or the checkpoint was "
                 "not written by rank 0 alone")

        # (d)
        tuned = [load(f"finetune-rank{r}.npz") for r in range(2)]
        stepw = recs[0]["stepw"]
        names = [f"w_{n}" for n in ("C1", "C2_1", "C2_2", "C3_1", "C3_2", "C4")]
        off = max(float(np.abs(tuned[0][n] / s - np.round(tuned[0][n] / s)).max())
                  for n, s in zip(names, stepw))
        same = all(np.array_equal(tuned[0][k], tuned[1][k]) for k in tuned[0])
        eng = Engine(device=dev, impl="auto", batch_frames=4)
        eng.set_model(37, read_model(os.path.join(d, "model_ft.data")))
        want = eng.restore(anchor_1080p[:4], 37)
        served = [np.load(os.path.join(d, f"served-rank{r}.npy")) for r in range(2)]
        equal = [bool((s == want).all()) for s in served]
        sv = [recs[r]["served"] for r in range(2)]
        print(f"quant_finetune(mesh=global 1x2) across 2 ranks, 10 steps: weights on the grid "
              f"(max {off:.2g} of a step off), equal on both ranks: {same}; the model written "
              f"by rank 0, served by DistributedRunner over the global 1x2 mesh on "
              f"4x{H}x{W} ({sv[0]['impl']}; local slices {sv[0]['local']}, {sv[1]['local']}; "
              f"fused launches {sv[0]['launches']}, {sv[1]['launches']} for "
              f"{sv[0]['positions']}, {sv[1]['positions']} positions): == a one-process "
              f"Engine.restore ({eng.program_name(37)}) of the file: {equal} {card}")
        if off > 1e-3 or not same or equal != [True, True] or any(
                s["impl"] != "kernel3" or s["launches"] != s["positions"] for s in sv):
            fail(f"quant_finetune(mesh=global 1x2) and its model across 2 ranks: off {off}, "
                 f"equal {same}, served {sv}, == one process {equal}")
    print(f"phase 20: {time.perf_counter() - t_phase:.1f} s")


def stage_split(card: str, models, fws, cases, anchor_1080p) -> dict:
    """Phase 21: generation 3's diagnostic instances (ops/fused.STAGE_VARIANTS,
    csrc/qvrcnn_fused.cu built with the tile's defines). Nothing of phases
    1-20 built or launched them. (a) The library at the table's tiles,
    24x32 and 32x32, built in parallel (build seconds; 4 entries, 0 spills);
    every variant bit for bit against its plain version on phase 2's cases
    and on each halo-extended block of a 1x2x2 mesh at 1080p under its
    frame bounds (comparison launches). (b) tools/stage_marginals at
    1920x1080 batch 4 and 416x240 batch 1, the counts zeroed before and
    read after: every variant of the tool's tile launched. Returns, per
    tile, the worst max_abs_err of each variant and (b)'s launches."""
    import numpy as np
    import torch

    from concurrent.futures import ThreadPoolExecutor

    from qcnn_gpu_tpu_torch.ops import build, tuning
    from qcnn_gpu_tpu_torch.ops.fused import (
        KERNEL,
        STAGE_VARIANTS,
        fused_forward,
        fused_forward_reference,
        stage_defines,
    )
    from qcnn_gpu_tpu_torch.parallel.mesh import make_mesh
    from qcnn_gpu_tpu_torch.parallel.spatial import extended_blocks, split_blocks
    from qcnn_gpu_tpu_torch.tools import stage_marginals

    t_phase = time.perf_counter()
    dev = torch.device("cuda", 0)
    diag = [k for k in build.build_info if k.startswith(KERNEL + "[")]
    if diag or any(fused_forward.stage_launches.values()):
        fail(f"phases 1-20 reached the diagnostic library: built {diag}, launched "
             f"{ {k: n for k, n in fused_forward.stage_launches.items() if n} }")
    print("phases 1-20 built no diagnostic library and launched no diagnostic instance")

    # (a) the library at the table's tiles, then every variant == plain
    tiles = ((24, 32), (32, 32))
    t0 = time.perf_counter()
    with ThreadPoolExecutor(len(tiles)) as pool:  # one nvcc per tile, both at once
        list(pool.map(lambda t: build.library(KERNEL, stage_defines(t)), tiles))
    print(f"diagnostic libraries at {', '.join(f'{th}x{tw}' for th, tw in tiles)}, in parallel: "
          f"{time.perf_counter() - t0:.2f} s in all")
    for t in tiles:
        key = build.key(KERNEL, stage_defines(t))
        log = build.build_info[key]["log"]
        print(f"  {key}: {build.build_info[key]['seconds']:.2f} s")
        for line in log.splitlines():
            entry = re.search(r"Compiling entry function '(\w+)'", line)
            if entry:
                print("    ptxas: entry", entry.group(1))
            elif "registers" in line or "spill" in line:
                print("    ptxas:", line.strip())
        spills = re.findall(r"(\d+) bytes spill (?:stores|loads)", log)
        entries = len(re.findall(r"Compiling entry function", log))
        if not spills or any(int(n) for n in spills) or entries != len(STAGE_VARIANTS):
            fail(f"{key}: ptxas compiled {entries} kernels (expected {len(STAGE_VARIANTS)}), "
                 f"spills {spills}")
        print(f"  {key}: {entries} entries, 0 bytes spilled")

    def variant(s, d):
        return f"stages={s}" + (f" {d}" if d else "")

    worst = {t: {variant(s, d): 0 for s, d in STAGE_VARIANTS} for t in tiles}

    def check(x, fw, bounds, what):
        for s, d in STAGE_VARIANTS:
            want = fused_forward_reference(x, fw, *bounds, stages=s, _debug=d)
            for t in tiles:
                got = fused_forward(x, fw, *bounds, tile=t, stages=s, _debug=d)
                torch.cuda.synchronize()
                if got.shape != x.shape or got.dtype != torch.uint8:
                    fail(f"{variant(s, d)} at {t}: output {got.dtype} {tuple(got.shape)}")
                err = int((got.to(torch.int16) - want.to(torch.int16)).abs().max())
                worst[t][variant(s, d)] = max(worst[t][variant(s, d)], err)
                if err != 0:
                    fail(f"generation 3 {variant(s, d)} at {t[0]}x{t[1]} differs from its plain "
                         f"version: {what} bounds={bounds or 'frame'} (max_abs_err {err})")

    for name, geo, kind, bounds in cases:
        if kind == "synth":
            x = frames(*geo, seed=sum(geo))
        else:
            x = np.full(geo, 0 if kind == "zeros" else 255, np.uint8)
        check(torch.from_numpy(x).to(dev), fws[name], bounds, f"{name} {geo} {kind}")
    mesh = make_mesh(1, 2, devices=[dev] * 4, sw=2)
    xe, bounds = extended_blocks(split_blocks(torch.from_numpy(anchor_1080p[:1]).to(dev), mesh),
                                 6, 128)
    for idx in np.ndindex(xe.shape):
        check(xe[idx], fws["golden-QP37"], bounds[idx],
              f"1x2x2 block {idx} {tuple(xe[idx].shape)}")
    for t in tiles:
        print(f"generation 3 at {t[0]}x{t[1]}, each variant vs plain on phase 2's {len(cases)} "
              f"cases and the {xe.size} blocks of a 1x2x2 mesh at 1080p under their bounds: "
              + ", ".join(f"{k} max_abs_err={v}" for k, v in worst[t].items()))

    # (b) the split, through the tool, at the main path's shape and at 240p
    out = {f"{th}x{tw}": {"max_abs_err": worst[th, tw], "launches": {}} for th, tw in tiles}
    for h, w, b in ((1080, 1920, 4), (240, 416, 1)):
        want = tuning.tuned_kwargs(h=h, w=w)
        tile = (want.get("th", 24), want.get("tw", 40))
        fused_forward.launches = 0
        fused_forward.stage_launches = dict.fromkeys(fused_forward.stage_launches, 0)
        res = stage_marginals.main([str(h), str(w), str(b)])
        launched = {variant(s, d): fused_forward.stage_launches[(*tile, s, d)]
                    for s, d in STAGE_VARIANTS}
        launched["stages=4"] = fused_forward.launches
        if res["tile"] != f"{tile[0]}x{tile[1]}" or not all(launched.values()):
            fail(f"tools/stage_marginals {w}x{h} batch {b}: tile {res['tile']} (the table: "
                 f"{tile}), launches {launched}")
        if any(res["max_abs_err"].values()):
            fail(f"tools/stage_marginals {w}x{h} batch {b}: {res['max_abs_err']}")
        print(f"tools/stage_marginals {w}x{h} batch {b} at {res['tile']}: launches {launched}; "
              f"marginals S1..S4 {', '.join(f'{v:.4f}' for v in res['marginal_ms'].values())} "
              f"ms/frame, sum {sum(res['marginal_ms'].values()):.4f} = stages=4's "
              f"{res['ms_per_frame']['4']['mean']:.4f} {card}")
        out.setdefault(res["tile"], {"launches": {}})["launches"][f"{w}x{h} b{b}"] = launched
    print(f"phase 21: {time.perf_counter() - t_phase:.1f} s")
    return out



def bench_path(cli, card: str, zero_counts, counts) -> dict:
    """Phase 22: `cli bench` at its defaults (1080p, batch 16) with
    BENCH_HOST_WINDOWS=2 and BENCH_HOST_BUDGET_S=20 (any other BENCH_*
    variable removed), the counts set to 0 before and read after:
    generation 3 launched at the table's tiles for 1080p batch 16 and
    416x240 and at no other, the JSON line parsed, `exact_vs_xla_on_hw`
    true. Then `tools/bench_layer --layer C2_2` (its GEMMs counted) and
    `tools/bench_matrix` with BENCH_IMPLS=kernel3,kernel2 (generation 3 at
    the table's tiles and the pair kernel launched) and the reference net's
    row at 416x240. Returns `cli bench`'s launches by tile."""
    from qcnn_gpu_tpu_torch.ops import tuning
    from qcnn_gpu_tpu_torch.ops.fused import fused_forward
    from qcnn_gpu_tpu_torch.ops.int8_conv import conv_int8
    from qcnn_gpu_tpu_torch.testing import synth_engine_params
    from qcnn_gpu_tpu_torch.tools import bench_layer, bench_matrix

    import torch

    t_phase = time.perf_counter()
    dev = torch.device("cuda", 0)

    def table_tile(h, w, b):
        kw = tuning.tuned_kwargs(h=h, w=w, batch=b)
        return f"{kw.get('th', 24)}x{kw.get('tw', 40)}"

    def launched_tiles():
        return {f"{th}x{tw}": n for (th, tw), n in fused_forward.tile_launches.items() if n}

    saved = dict(os.environ)
    for k in [k for k in os.environ if k.startswith("BENCH_")]:
        del os.environ[k]
    os.environ.update(BENCH_HOST_WINDOWS="2", BENCH_HOST_BUDGET_S="20")
    try:
        # (a) cli bench
        zero_counts()
        buf = io.StringIO()
        t0 = time.perf_counter()
        with contextlib.redirect_stdout(buf):
            rc = cli.main(["bench", "--device", "cuda"])
        seconds = time.perf_counter() - t0
        launched, tiles = counts(), launched_tiles()
        out = buf.getvalue()
        print(out, end="")
        if rc != 0:
            fail(f"cli bench exited {rc}")
        res = json.loads(out.splitlines()[-1])
        d = res["detail"]
        want = {table_tile(1080, 1920, 16), table_tile(240, 416, 16)}
        if d["exact_vs_xla_on_hw"] is not True or d["impl"] != "kernel3" \
                or d["tile"] != table_tile(1080, 1920, 16):
            fail(f"cli bench: exact {d['exact_vs_xla_on_hw']}, impl {d['impl']}, tile {d['tile']}")
        if set(tiles) != want or launched["qvrcnn_fused"] <= 0:
            fail(f"cli bench launched generation 3 at {tiles}, the table's tiles are {want}")
        print(f"cli bench: {seconds:.1f} s; launches {launched}, generation 3 by tile {tiles}; "
              f"exact_vs_xla_on_hw {d['exact_vs_xla_on_hw']}; {res['value']} frames/s "
              f"({d['ms_per_frame_device']} ms/frame device, batch {d['batch']}, tile "
              f"{d['tile']}); with transfers, {d['pool']} pool: raw best/median "
              f"{d['fps_full_transport']}/{d['fps_full_median']}, packed "
              f"{d['fps_packed_transport']} ({d['packed_exact']}), duplex "
              f"{d['fps_duplex_transport']}, link {d['fps_link_pure']} fps; batch 1 "
              f"{d['ms_per_frame_device_batch1']} ms device, "
              f"{d['fps_incl_host_transfers_batch1']} fps; 416x240 "
              f"{d['ms_per_frame_device_416x240']} ms/frame device {card}")

        # (b) tools/bench_layer
        conv_int8.launches = 0
        layer = bench_layer.main(["--layer", "C2_2"])
        if conv_int8.launches <= 0:
            fail("tools/bench_layer launched no GEMM")
        print(f"tools/bench_layer C2_2: GEMM launches={conv_int8.launches}, "
              f"{layer['us_per_frame']:.3f} us/frame against a {layer['bound_us_per_frame']:.3f} "
              f"us bound ({layer['bound_by']}) {card}")

        # (c) tools/bench_matrix: generations 3 and 2, then the reference's row
        os.environ["BENCH_IMPLS"] = "kernel3,kernel2"
        zero_counts()
        with tempfile.TemporaryDirectory() as tmp:
            rep = bench_matrix.main([os.path.join(tmp, "bench_matrix.json")])
        launched_m, tiles_m = counts(), launched_tiles()
        want_m = {table_tile(h, w, 8) for h, w, _ in bench_matrix.GEOMETRIES} | {
            table_tile(1080, 1920, b) for b in bench_matrix.CURVE_BATCHES}
        rows, n_geos = rep["device_ms_per_frame"], len(bench_matrix.GEOMETRIES)
        if (set(tiles_m) != want_m or launched_m["qvrcnn_pair"] <= 0
                or [len(rows[k]) for k in ("kernel3", "kernel2")] != [n_geos, n_geos]
                or len(rep["batch_scaling_1080p"]) != len(bench_matrix.CURVE_BATCHES)):
            fail(f"tools/bench_matrix: launches {launched_m}, generation 3 by tile {tiles_m} "
                 f"(the table's: {want_m}), rows {[len(v) for v in rows.values()]}")
        print(f"tools/bench_matrix: launches {launched_m}, generation 3 by tile {tiles_m} {card}")
        ref_rows = bench_matrix.rows_for(synth_engine_params(37), "reference", dev,
                                         bench_matrix.GEOMETRIES[:1], {})
        print(f"tools/bench_matrix reference: {json.dumps(ref_rows)} {card}")
    finally:
        os.environ.clear()
        os.environ.update(saved)
    print(f"phase 22: {time.perf_counter() - t_phase:.1f} s")
    return tiles


def golden_path(card: str, zero_counts, counts, ori_1080p, anchor_1080p) -> dict:
    """Phase 23: the golden generators' functions on content that needs no
    matplotlib or PIL (`testing.make_clean_frames`, DCT-degraded at q=28 as
    phase 14's), and the stream's timed windows. (a) `make_golden.golden_for_qp`
    at full width on the card: 12 training and 4 held-out frames of
    416x240 as QP37, 200 + 100 steps, 50 fine-tune steps, batch 32 (the
    script's 4000 + 2000 and 800, cut for the smoke), with each kind of
    step's ms on the host clock first; its records written and read back
    equal; the served kernel launched, its output equal to its plain
    version on the card and `after` equal to that output's PSNR. (b)
    `make_golden_eval.eval_goldens` with the four committed models on 2 of
    phase 4's 1920x1080 anchors, whole and in 540x960 windows (bit-equal,
    generation 3 at the table's tiles), and on 2 of (a)'s 416x240 frames on
    cuda and on cpu (equal to every digit). (c) `cli bench`'s raw and +1
    windows at its pool (8 batches of 16 frames of 1920x1080) on
    `engine/stream.measure_stream_fps`, printed beside `PRE_REPAIR_FPS` (a
    record, not a bound). Returns (a)'s and (b)'s launches by kernel."""
    import numpy as np
    import torch

    from qcnn_gpu_tpu_torch.data import yuv as Y
    from qcnn_gpu_tpu_torch.data.datasets import PatchDataset
    from qcnn_gpu_tpu_torch.data.model_files import read_static_qfp_vect_c
    from qcnn_gpu_tpu_torch.engine.calibrate import solve_table
    from qcnn_gpu_tpu_torch.engine.runner import Engine, generation, read_model
    from qcnn_gpu_tpu_torch.ops import tuning
    from qcnn_gpu_tpu_torch.ops.fused import FusedWeights, fused_forward, fused_forward_reference
    from qcnn_gpu_tpu_torch.ops.literal import LiteralWeights, literal_forward_reference
    from qcnn_gpu_tpu_torch.testing import dct_compress, make_clean_frames
    from qcnn_gpu_tpu_torch import bench
    from qcnn_gpu_tpu_torch.engine.stream import measure_stream_fps
    from qcnn_gpu_tpu_torch.testing import synth_engine_params, synth_frames
    from qcnn_gpu_tpu_torch.tools import make_golden, make_golden_eval
    from qcnn_gpu_tpu_torch.train.finetune import quant_finetune
    from qcnn_gpu_tpu_torch.train.trainer import TrainConfig, Trainer

    t_phase = time.perf_counter()
    dev = torch.device("cuda", 0)
    qp, lr, batch = 37, 1e-3, 32
    clean = make_clean_frames(16, 240, 416, seed=qp)
    anchor = dct_compress(clean, q=28.0)
    tr_c, tr_a, ev_c, ev_a = clean[:12], anchor[:12], clean[12:], anchor[12:]
    out: dict = {}

    # (a) the step times, then golden_for_qp with the counts zeroed (its
    # training launches none of the four kernels; its serve does)
    ds = PatchDataset([(tr_c, tr_a)], patch=64, seed=qp)
    steps = list(ds.batches(batch, 21))
    tr = Trainer(TrainConfig(lr=lr, batch_size=batch, log_every=0, seed=qp), device=dev)
    table = solve_table(tr.params, qp=qp)
    ms = {}
    for kind in ("train", "fine-tune"):
        def run(bs):
            if kind == "train":
                tr.fit_batches(bs)
            else:
                quant_finetune(tr.params, table.stepw, bs, device=dev, blu_ub=table.blu_adj,
                               lr=lr * 0.1, log_every=0)
        run(steps[:1])
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        run(steps[1:])
        torch.cuda.synchronize()
        ms[kind] = 1e3 * (time.perf_counter() - t0) / (len(steps) - 1)
    print(f"train step and fine-tune step on cuda, {batch}x64x64 (host clock over "
          f"{len(steps) - 1} steps after one warm-up, H2D of each batch included): "
          f"{ms['train']:.4f} / {ms['fine-tune']:.4f} ms/step {card}")
    zero_counts()
    t0 = time.perf_counter()
    ep, psnrs = make_golden.golden_for_qp(
        tr_c, tr_a, ev_c, ev_a, qp, steps=200, decay_steps=100, finetune_steps=50, lr=lr,
        batch=batch, wbits=8, per_channel=False, device="cuda")
    secs = time.perf_counter() - t0
    launched = counts()
    served = generation(ep, "auto")
    kname = {"kernel3": "qvrcnn_fused", "kernel1": "qvrcnn_literal"}[served]
    if launched[kname] <= 0 or sum(launched.values()) != launched[kname]:
        fail(f"golden_for_qp served {served}: launches {launched}")
    out[kname] = launched[kname]
    with tempfile.TemporaryDirectory() as d:
        make_golden.write_records(d, {qp: (ep, psnrs)}, "", 8, False)
        back = read_static_qfp_vect_c(os.path.join(d, f"model_q{qp}.data"))
        with open(os.path.join(d, "psnr_golden.json")) as fp:
            row = json.load(fp)["goldens"][str(qp)]
    same = all(np.array_equal(np.asarray(a), np.asarray(b)) for f in
               ("weights", "biases", "blu_q", "mul", "shift")
               for a, b in zip(getattr(back, f), getattr(ep, f)))
    if not same or row != {k: round(v, 6) for k, v in psnrs.items()}:
        fail(f"golden_for_qp's records: model read back equal {same}, JSON row {row}")
    engine = Engine(device=dev)
    engine.set_model(qp, back)
    rec = engine.restore(ev_a, qp)
    x = torch.from_numpy(ev_a).to(dev)
    if served == "kernel3":
        want = fused_forward_reference(x, FusedWeights.from_engine(back, dev)).cpu().numpy()
    else:
        want = literal_forward_reference(x, LiteralWeights.from_engine(back, dev)).cpu().numpy()
    if not (rec == want).all() or Y.psnr(want, ev_c) != psnrs["after"]:
        fail(f"golden_for_qp: served output equal to its plain version "
             f"{bool((rec == want).all())}, after {psnrs['after']!r} against the plain "
             f"output's {Y.psnr(want, ev_c)!r}")
    print(f"make_golden.golden_for_qp on cuda, QP{qp} on 12 + 4 seeded 416x240 frames (DCT "
          f"q=28), 200 + 100 steps, 50 fine-tune steps, batch {batch}: {secs:.2f} s; served "
          f"{served}, launches {launched}, output == plain version on the card, model file "
          f"read back equal; PSNR before {psnrs['before']:.6f} after {psnrs['after']:.6f} "
          f"({psnrs['after'] - psnrs['before']:+.6f}) {card}")

    # (b) eval_goldens with the committed models: 1080p whole and tiled,
    # then 416x240 on cuda and on cpu
    qps = [22, 27, 32, 37]
    names = {q: generation(read_model(os.path.join(GOLDEN, f"model_q{q}.data")), "auto")
             for q in qps}
    if set(names.values()) != {"kernel3"}:
        fail(f"the committed models' programs: {names}")
    anchors = {q: anchor_1080p for q in qps}
    got = {}
    for label, tile, shape in (("whole", None, (1080, 1920, 2)), ("540x960", (540, 960),
                                                                   (552, 972, 4))):
        zero_counts()
        t0 = time.perf_counter()
        got[label] = make_golden_eval.eval_goldens(ori_1080p, anchors, GOLDEN, device="cuda",
                                                   tile=tile)
        secs = time.perf_counter() - t0
        kw = tuning.tuned_kwargs(h=shape[0], w=shape[1], batch=shape[2])
        want_tile = (kw.get("th", 24), kw.get("tw", 40))
        tiles = {t: n for t, n in fused_forward.tile_launches.items() if n}
        if set(tiles) != {want_tile} or counts()["qvrcnn_fused"] != tiles[want_tile]:
            fail(f"eval_goldens {label}: generation 3 by tile {tiles}, the table's {want_tile}")
        out["qvrcnn_fused"] = out.get("qvrcnn_fused", 0) + tiles[want_tile]
        print(f"make_golden_eval.eval_goldens on cuda, the 4 committed models, 2 of phase 4's "
              f"1920x1080 anchors, {label}: {secs:.2f} s, generation 3 launches {tiles}; "
              + ", ".join(f"QP{q} {g['before']:.6f} -> {g['after']:.6f}"
                          for q, g in got[label].items()) + f" {card}")
    engine = Engine(device=dev)
    engine.load_model(37, os.path.join(GOLDEN, "model_q37.data"))
    whole = make_golden_eval.restorer(engine, 37)(anchor_1080p)
    if got["whole"] != got["540x960"] or not (
            make_golden_eval.restorer(engine, 37, (540, 960))(anchor_1080p) == whole).all():
        fail("eval_goldens at 1080p: 540x960 windows differ from the whole frame")
    small = {q: ev_a[:2] for q in qps}
    by_dev = {}
    for device in ("cuda", "cpu"):
        zero_counts()
        t0 = time.perf_counter()
        by_dev[device] = make_golden_eval.eval_goldens(ev_c[:2], small, GOLDEN, device=device)
        by_dev[device + " s"] = time.perf_counter() - t0
        by_dev[device + " launches"] = counts()["qvrcnn_fused"]
    if by_dev["cuda"] != by_dev["cpu"] or by_dev["cuda launches"] != len(qps) \
            or by_dev["cpu launches"]:
        fail(f"eval_goldens at 416x240: cuda {by_dev['cuda']} against cpu {by_dev['cpu']}; "
             f"generation 3 launches {by_dev['cuda launches']} / {by_dev['cpu launches']}")
    out["qvrcnn_fused"] += by_dev["cuda launches"]
    print(f"make_golden_eval.eval_goldens, 2 seeded 416x240 frames: equal on cuda and cpu to "
          f"every digit ({by_dev['cuda s']:.2f} s / {by_dev['cpu s']:.2f} s; generation 3 "
          f"launches {by_dev['cuda launches']} / {by_dev['cpu launches']}); "
          + ", ".join(f"QP{q} {g['after']!r}" for q, g in by_dev["cuda"].items()) + f" {card}")

    # (c) `cli bench`'s raw and +1 windows on the repaired definition
    p37 = synth_engine_params(37)
    geo, bs = (1080, 1920), 16
    programs = {"raw": bench.build(p37, generation(p37, "auto"), dev, geo, bs),
                "+1": bench.make_pure_transfer_run()}
    pool, kind = bench.frame_pool(synth_frames(bs, *geo, seed=1), 8)
    zero_counts()
    fps = {}
    for name, run in programs.items():
        measure_stream_fps(run, pool[:1], 3, device=dev)  # untimed warm-up
        fps[name] = [measure_stream_fps(run, pool, 3, device=dev) for _ in range(3)]
    n_raw = counts()["qvrcnn_fused"]
    if n_raw <= 0:
        fail("cli bench's raw window launched no generation 3")
    print(f"cli bench's windows on measure_stream_fps, {kind} pool of 8x{bs}x1920x1080, 3 "
          f"windows each, frames/s median (windows): "
          + ", ".join(f"{n} {np.median(w):.2f} ({', '.join(f'{v:.2f}' for v in w)})"
                      for n, w in fps.items())
          + "; before the repair: " + ", ".join(f"{n} {v:.2f}" for n, v in PRE_REPAIR_FPS.items())
          + f" (PERF.md); fused launches={n_raw} {card}")
    print(f"phase 23: {time.perf_counter() - t_phase:.1f} s")
    return out


if __name__ == "__main__":
    sys.exit(main())
