"""Split generation 3's time on the card by stage: the kernel truncated
after each stage, timed in turns, and the differences.

    python -m qcnn_gpu_tpu_torch.tools.stage_marginals [H W BATCH]

Counterpart of `scripts/stage_marginals.py`, the JAX package's own
utilization method: build the kernel truncated at each stage and
difference the timings. Frames of H x W (default 1080 x 1920) in batches
of BATCH (default 8), the seeded QP37 model (`testing.synth_engine_params`),
generation 3 at the tuned table's tile for the geometry
(`ops/tuning.tuned_kwargs(h=, w=)`). It runs on a CUDA GPU only; without
one it raises.

The variants (`ops/fused.fused_forward(stages=, _debug=)`): `1`, `2`,
`3`, the kernel truncated after S1, S2, S3 (each writes x + channel 0 of
its last stage in place of S4's pass); `4`, the main path's kernel; `z`,
`zero_a1`, the whole network on a window never read from global memory.
Each is first held equal to its plain version on the card at 2x80x140,
and any difference raises. Then each is captured in a CUDA graph of
launches (device time, not the host's enqueue) and replayed in turns,
1 2 3 4 z z 4 3 2 1, for several rounds. Printed: ms/frame of each with
its spread; the marginals S1 (stage 1 alone, with the window load and
its expansion), S2-S1, S3-S2, S4-S3, which sum to the whole kernel's
time; the `zero_a1` saving at stages 4; beside each stage its issued
and useful MACs per pixel from the pass model
(`engine/mfu.pass_model_summary`) and the issued TOP/s its marginal
implies. Then one JSON line {"stage_marginals": {...}} with the card's
name and power limit.
"""

from __future__ import annotations

import argparse
import json
import math
from typing import Dict, List, Optional

import torch

from qcnn_gpu_tpu_torch.engine.mfu import pass_model_summary
from qcnn_gpu_tpu_torch.ops import build, tuning
from qcnn_gpu_tpu_torch.ops.fused import (
    KERNEL,
    TILE_H,
    TILE_W,
    FusedWeights,
    fused_forward,
    fused_forward_reference,
    stage_defines,
)
from qcnn_gpu_tpu_torch.testing import synth_engine_params, synth_frames
from qcnn_gpu_tpu_torch.tools import events_ms, graph_timer, smi

# name -> (stages, _debug)
VARIANTS = {"1": (1, ""), "2": (2, ""), "3": (3, ""), "4": (4, ""), "z": (4, "zero_a1")}
ORDER = "1234zz4321"
ROUNDS = 3
CHECK = (2, 80, 140)  # the exactness frames, as the JAX script's
GRAPH_MS = 20.0  # device time of one graph replay


def _parse(argv: Optional[List[str]]):
    ap = argparse.ArgumentParser(prog="python -m qcnn_gpu_tpu_torch.tools.stage_marginals",
                                 description=__doc__.split("\n\n")[0])
    ap.add_argument("h", nargs="?", type=int, default=1080)
    ap.add_argument("w", nargs="?", type=int, default=1920)
    ap.add_argument("batch", nargs="?", type=int, default=8)
    return ap.parse_args(argv)


def main(argv: Optional[List[str]] = None) -> Dict:
    """Check, time and print the split (module docstring); returns the
    JSON line's object."""
    args = _parse(argv)
    if not torch.cuda.is_available():
        raise RuntimeError("stage_marginals needs a CUDA GPU: the truncated builds of "
                           "generation 3 have no CPU mode")
    h, w, batch = args.h, args.w, args.batch
    dev = torch.device("cuda")
    card = smi()
    kw = tuning.tuned_kwargs(h=h, w=w)
    tile = (kw.get("th", TILE_H), kw.get("tw", TILE_W))
    label = f"{tile[0]}x{tile[1]}"
    fw = FusedWeights.from_engine(synth_engine_params(37), dev)

    def run(x, name):
        stages, debug = VARIANTS[name]
        return fused_forward(x, fw, tile=tile, stages=stages, _debug=debug)

    # exactness first: every variant against its plain version on the card
    xs = torch.from_numpy(synth_frames(*CHECK, seed=3)).to(dev)
    exact = {}
    for name, (stages, debug) in VARIANTS.items():
        got = run(xs, name)
        torch.cuda.synchronize()
        want = fused_forward_reference(xs, fw, stages=stages, _debug=debug)
        exact[name] = int((got.to(torch.int16) - want.to(torch.int16)).abs().max())
        if exact[name] != 0:
            raise RuntimeError(f"generation 3 at {label}, variant {name} (stages={stages}, "
                               f"_debug={debug!r}): max_abs_err {exact[name]} against its plain "
                               f"version at {CHECK}")
    key = build.key(KERNEL, stage_defines(tile))
    print(f"stage variants at {label} == their plain versions at {CHECK}: max_abs_err "
          f"{max(exact.values())} (the full kernel: exact against the oracle's definition); "
          f"diagnostic library {key}: {build.build_info[key]['seconds']:.2f} s to build")

    # time: CUDA graphs of `reps` launches each, replayed in turns
    x = torch.from_numpy(synth_frames(batch, h, w, seed=1)).to(dev)
    for name in VARIANTS:
        run(x, name)
    reps = max(5, math.ceil(GRAPH_MS / max(events_ms(lambda: run(x, "4"), 3), 1e-3)))
    timers = {name: graph_timer(lambda name=name: run(x, name), reps) for name in VARIANTS}
    samples = {name: [] for name in VARIANTS}
    for _ in range(ROUNDS):
        for name in ORDER:
            samples[name].append(timers[name]() / batch)
    del timers
    mean = {k: sum(v) / len(v) for k, v in samples.items()}
    ms = {k: {"mean": mean[k], "min": min(v), "max": max(v)} for k, v in samples.items()}
    marginal = {"S1": mean["1"], "S2": mean["2"] - mean["1"], "S3": mean["3"] - mean["2"],
                "S4": mean["4"] - mean["3"]}
    pm = pass_model_summary(tile)
    issued_all = pm["issued_macs_per_px"]
    stages = {}
    for s, m in marginal.items():
        issued = pm["stages"][s]["issued_macs_per_px"]
        stages[s] = {
            "marginal_ms": m,
            "time_share": m / mean["4"],
            "issued_macs_per_px": issued,
            "useful_macs_per_px": pm["stages"][s]["useful_macs_per_px"],
            "issued_share": issued / issued_all,
            "issued_tops": 2 * issued * h * w / (m * 1e-3) / 1e12 if m > 0 else None,
        }
    names = {"1": "stages=1", "2": "stages=2", "3": "stages=3", "4": "stages=4 (full)",
             "z": "zero_a1 (stages=4)"}
    head = f"{w}x{h} batch {batch}, generation 3 at {label}"
    for k, v in ms.items():
        print(f"{head}: {names[k]}: {v['mean']:.4f} ms/frame (min {v['min']:.4f}, max "
              f"{v['max']:.4f}; {len(samples[k])} graph replays of {reps} launches in turns) "
              f"[{card}]")
    for s, v in stages.items():
        tops = "n/a" if v["issued_tops"] is None else f"{v['issued_tops']:.1f}"
        extra = " (with the window load and its expansion)" if s == "S1" else ""
        print(f"{head}: {s} marginal{extra} {v['marginal_ms']:.4f} ms/frame, "
              f"{100 * v['time_share']:.1f}% of the kernel; issued {v['issued_macs_per_px']} "
              f"MACs/px ({100 * v['issued_share']:.1f}% of the issued), useful "
              f"{v['useful_macs_per_px']}; issued {tops} TOP/s [{card}]")
    saving = mean["4"] - mean["z"]
    print(f"{head}: zero_a1 saves {saving:.4f} ms/frame of {mean['4']:.4f} "
          f"({100 * saving / mean['4']:.1f}%) [{card}]")
    out = {
        "geometry": f"{w}x{h}", "batch": batch, "tile": label, "card": card,
        "reps": reps, "rounds": ROUNDS, "order": ORDER, "max_abs_err": exact,
        "ms_per_frame": ms, "marginal_ms": marginal, "stages": stages,
        "zero_a1_saving_ms": saving, "issued_macs_per_px": issued_all,
    }
    print(json.dumps({"stage_marginals": out}))
    return out


if __name__ == "__main__":
    main()
