"""Generation 3 built from two source trees, timed in turns on the card.

    python -m qcnn_gpu_tpu_torch.tools.compare_builds OTHER_CSRC [H W BATCH]

OTHER_CSRC is another checkout's `qcnn_gpu_tpu_torch/csrc`, for example a
parent commit unpacked with `git archive` into a git-ignored directory.
Both trees' `qvrcnn_fused.cu` are built with this package's nvcc flags
(`ops/build.library(..., csrc=)`), and both must export
`qvrcnn_fused_forward` with the signature `ops/fused.py` calls. Printed:

- each tree's `ptxas` registers and spills for every tile instance of
  `ops/fused.TILES` (`ops/build.ptxas_instances`);
- every instance of both trees held equal to the plain version on 2
  frames of 80x140, whole and under frame bounds, and the two trees
  equal to each other at the timed shape (a difference raises);
- every instance of both at H x W (default 1080 x 1920) in batches of
  BATCH (default 4), the seeded QP37 model (`testing.synth_engine_params`),
  each captured once in a CUDA graph of launches (device time, not the
  host's enqueue) and replayed in turns, other this this other, for
  ROUNDS rounds: ms/frame medians and range, this / other;
- one JSON line {"compare_builds": {...}} with the card's name and power
  limit.

It runs on a CUDA GPU only; without one it raises.
"""

from __future__ import annotations

import ctypes
import json
import os
import statistics
import sys

import torch

from qcnn_gpu_tpu_torch.ops import build
from qcnn_gpu_tpu_torch.ops.fused import (
    _ARGTYPES,
    KERNEL,
    TILES,
    FusedWeights,
    fused_forward_reference,
    frame_bounds,
)
from qcnn_gpu_tpu_torch.testing import synth_engine_params, synth_frames
from qcnn_gpu_tpu_torch.tools import graph_timer, smi

ROUNDS = 7
ORDER = ("other", "this", "this", "other")
CHECK = (2, 80, 140)  # the exactness frames
CHECK_BOUNDS = ((), (5, 70, 3, 131))
GRAPH_MS = 20.0  # device time of one graph replay


def _entry(lib: ctypes.CDLL):
    fn = lib.qvrcnn_fused_forward
    fn.argtypes = list(_ARGTYPES)
    fn.restype = ctypes.c_int
    lib.qvrcnn_error_string.argtypes = [ctypes.c_int]
    lib.qvrcnn_error_string.restype = ctypes.c_char_p
    return fn


def _launcher(lib, x: torch.Tensor, fw: FusedWeights, tile, bounds=()):
    """A call that launches `lib`'s `tile` instance on x into one output
    buffer (allocated once, so that a CUDA graph can capture the call)."""
    fn = _entry(lib)
    out = torch.empty_like(x)
    b, h, w = x.shape
    args = (b, h, w, *frame_bounds(h, w, *(bounds or (0, None, 0, None))),
            fw.b4, fw.mul4, fw.shift4, *tile)

    def run() -> torch.Tensor:
        err = fn(x.data_ptr(), out.data_ptr(), fw.split.data_ptr(), fw.vec.data_ptr(), *args,
                 build.stream_of(x))
        if err:
            raise RuntimeError(f"{tile}: CUDA error {err} "
                               f"({lib.qvrcnn_error_string(err).decode()})")
        return out

    return run


def main(argv=None) -> int:
    argv = sys.argv[1:] if argv is None else list(argv)
    if not argv or len(argv) not in (1, 4):
        raise SystemExit("usage: python -m qcnn_gpu_tpu_torch.tools.compare_builds OTHER_CSRC "
                         "[H W BATCH]")
    other_csrc = os.path.abspath(argv[0])
    h, w, batch = (int(v) for v in argv[1:]) if len(argv) == 4 else (1080, 1920, 4)
    if not torch.cuda.is_available():
        raise RuntimeError("tools/compare_builds needs a CUDA GPU")
    card = smi()
    dev = torch.device("cuda")
    libs = {"other": build.library(KERNEL, csrc=other_csrc), "this": build.library(KERNEL)}
    logs = {"other": build.build_info[f"{KERNEL}@{other_csrc}"]["log"],
            "this": build.build_info[KERNEL]["log"]}
    ptxas = {k: build.ptxas_instances(log) for k, log in logs.items()}
    for k in libs:
        for tile in TILES:
            r = ptxas[k].get(tile)
            if r is None:
                raise RuntimeError(f"{k}: no ptxas report for the {tile} instance: {logs[k][:300]}")
            print(f"{k} ({other_csrc if k == 'other' else build.CSRC}) {tile[0]}x{tile[1]}: "
                  f"{r['registers']} registers, {r['spill_stores']} bytes spill stores, "
                  f"{r['spill_loads']} bytes spill loads")

    fw = FusedWeights.from_engine(synth_engine_params(37), dev)
    xc = torch.from_numpy(synth_frames(*CHECK, seed=1)).to(dev)
    for tile in TILES:
        for bounds in CHECK_BOUNDS:
            want = fused_forward_reference(xc, fw, *bounds)
            for k, lib in libs.items():
                got = _launcher(lib, xc, fw, tile, bounds)()
                torch.cuda.synchronize()
                if not torch.equal(got, want):
                    raise RuntimeError(f"{k} {tile} differs from the plain version at {CHECK} "
                                       f"bounds {bounds or 'frame'}")
    print(f"every instance of both trees == plain version at {CHECK}, whole and under bounds "
          f"{CHECK_BOUNDS[1]}")

    x = torch.from_numpy(synth_frames(batch, h, w, seed=batch)).to(dev)
    result = {"card": card, "shape": [batch, h, w], "other": other_csrc, "order": "".join(
        k[0] for k in ORDER), "rounds": ROUNDS, "tiles": {}}
    for tile in TILES:
        runs = {k: _launcher(lib, x, fw, tile) for k, lib in libs.items()}
        outs = {k: run().clone() for k, run in runs.items()}
        torch.cuda.synchronize()
        if not torch.equal(outs["this"], outs["other"]):
            raise RuntimeError(f"{tile}: the two trees differ at {tuple(x.shape)}")
        one = graph_timer(runs["this"], 1)()
        reps = max(1, round(GRAPH_MS / one))
        timers = {k: graph_timer(run, reps) for k, run in runs.items()}
        samples = {k: [] for k in runs}
        for _ in range(ROUNDS):
            for k in ORDER:
                samples[k].append(timers[k]() / batch)
        med = {k: statistics.median(v) for k, v in samples.items()}
        ratio = med["this"] / med["other"]
        label = f"{tile[0]}x{tile[1]}"
        result["tiles"][label] = {
            "ratio": ratio, "reps": reps,
            **{k: {"ms_frame": med[k], "samples": samples[k], **ptxas[k][tile]} for k in runs}}
        print(f"{label} at {batch}x{h}x{w}, CUDA-graph replays of {reps} launches, in turns "
              f"({' '.join(ORDER)}) x {ROUNDS}: this {med['this']:.4f} ms/frame "
              f"({min(samples['this']):.4f}-{max(samples['this']):.4f}), other "
              f"{med['other']:.4f} ({min(samples['other']):.4f}-{max(samples['other']):.4f}); "
              f"this / other {ratio:.4f} [{card}]")
    print(json.dumps({"compare_builds": result}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
