"""Device ms/frame at the reference's six geometries for each of the
port's programs, and generation 3's batch curve at 1080p: the port's
counterpart of `scripts/bench_matrix.py`.

    python -m qcnn_gpu_tpu_torch.tools.bench_matrix [out.json] [--device cuda]

BENCH_IMPLS (a comma list; default all three) picks the rows:
`kernel3` (generation 3 at the tuned table's tile for each geometry,
`ops/tuning.build_tuned`), `kernel2` (the frame-pair kernel,
`ops/pair.pair_forward`, at its one 24x40 tile) and `reference` (the
plain reference net, float64-exact convolutions, on the device, in calls
of at most `bench.REF_PIXELS` pixels). Each
geometry runs the script's batch, max(2, min(8, 2^21 // (h*w // 512)))
rounded up to even (8 at all six), of `synth_frames(batch, h, w, seed=1)`;
the curve runs batches 1, 2, 4, 8 and 16 of `synth_frames(16, 1080, 1920,
seed=2)`, one program per tile the table gives a batch. The script times
8 calls (16 at batch 1) with the host clock and one synchronize; so does
this.

Two departures from the script, on purpose. Every (program, geometry)
and every point of the curve is first checked equal to the plain
reference net on its batch, and a difference raises before it is timed
(the script times whatever ran). And nothing falls back: the script
measures a host-tiled run where a whole-frame XLA compile fails on a TPU
toolchain (:79-104), and records any error as a row; here a failure
raises.

The report goes to `out.json`, by default under `chiprun_out/` (never
the committed `bench_matrix.json` of the TPU runs), after each program
and at the end; it names the card and its power limit.
"""

from __future__ import annotations

import argparse
import json
import os

import torch

from qcnn_gpu_tpu_torch.bench import build, check_equal, device_fps, plain_restore, tile_of
from qcnn_gpu_tpu_torch.models.qvrcnn import make_forward
from qcnn_gpu_tpu_torch.ops.tuning import load_table, tuned_kwargs
from qcnn_gpu_tpu_torch.testing import synth_engine_params, synth_frames
from qcnn_gpu_tpu_torch.tools import smi

# (H, W, the reference's best ms there, from its log.txt)
GEOMETRIES = [
    (240, 416, 12.0),
    (480, 832, 11.9),
    (720, 1280, 20.3),
    (1080, 1920, 42.4),
    (1600, 2560, 72.7),
    (2160, 3840, 155.7),
]
IMPLS = ("kernel3", "kernel2", "reference")
CURVE_GEOMETRY = (1080, 1920)
CURVE_BATCHES = (1, 2, 4, 8, 16)
DEFAULT_OUT = os.path.join("chiprun_out", "bench_matrix.json")


def batch_for(h: int, w: int) -> int:
    """The script's batch rule (bench_matrix.py:50-51)."""
    batch = max(2, min(8, (1 << 21) // (h * w // 512)))
    return batch + batch % 2


def _tile(name: str, run):
    tile = tile_of(name, run)
    return f"{tile[0]}x{tile[1]}" if tile else None


def rows_for(p, name: str, device, geometries, gold: dict) -> dict:
    """The rows of program `name` at each (h, w, reference ms) of
    `geometries`, each checked equal to the plain reference net first;
    `gold` caches the reference's outputs by geometry across programs."""
    rows = {}
    for h, w, ref_ms in geometries:
        batch = batch_for(h, w)
        run = build(p, name, device, (h, w), batch)
        x = torch.from_numpy(synth_frames(batch, h, w, seed=1)).to(device)
        if (h, w) not in gold:
            gold[h, w] = plain_restore(make_forward(p, device=device), x)
        check_equal(f"{name} {batch}x{h}x{w}", run(x), gold[h, w])  # and warms it
        ms = 1000 / device_fps(run, x, 8)
        rows[f"{w}x{h}"] = {
            "ms_per_frame": round(ms, 3),
            "fps": round(1000 / ms, 1),
            "ref_best_ms": ref_ms,
            "speedup_vs_ref": round(ref_ms / ms, 2),
            "batch": batch,
            "tile": _tile(name, run),
        }
        print(f"{name} {w}x{h}: {ms:.3f} ms/frame ({1000 / ms:.0f} fps, {ref_ms / ms:.1f}x ref, "
              f"batch {batch}, tile {rows[f'{w}x{h}']['tile']}), exact", flush=True)
    return rows


def batch_curve(p, device) -> dict:
    """Generation 3's ms/frame at CURVE_GEOMETRY for each of CURVE_BATCHES,
    one program per tile the table gives, each point checked equal to the
    plain reference net on its frames first (bench_matrix.py:117-126)."""
    h, w = CURVE_GEOMETRY
    x_all = torch.from_numpy(synth_frames(max(CURVE_BATCHES), h, w, seed=2)).to(device)
    want = plain_restore(make_forward(p, device=device), x_all)
    runs, curve = {}, {}
    for b in CURVE_BATCHES:
        kw = tuple(sorted(tuned_kwargs(h=h, w=w, batch=b).items()))
        if kw not in runs:
            runs[kw] = build(p, "kernel3", device, (h, w), b)
        run, x = runs[kw], x_all[:b]
        check_equal(f"kernel3 {b}x{h}x{w}", run(x), want[:b])
        ms = 1000 / device_fps(run, x, 8 if b > 1 else 16)
        curve[b] = {"ms_per_frame": round(ms, 3), "fps": round(1000 / ms, 1),
                    "tile": _tile("kernel3", run)}
        print(f"batch {b} @{w}x{h}: {ms:.3f} ms/frame (tile {curve[b]['tile']}), exact",
              flush=True)
    return curve


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(prog="qcnn_gpu_tpu_torch.tools.bench_matrix")
    ap.add_argument("out", nargs="?", default=DEFAULT_OUT)
    ap.add_argument("--device", default="cuda", help="torch device, e.g. cuda, cpu")
    args = ap.parse_args(argv)
    device = torch.device(args.device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise SystemExit("bench_matrix times a CUDA GPU: no CUDA device (--device cpu runs "
                         "the kernels' plain versions)")
    only = os.environ.get("BENCH_IMPLS")  # e.g. "kernel2" or "reference,kernel2"
    unknown = set(only.split(",")) - set(IMPLS) if only else set()
    if unknown:
        raise SystemExit(f"BENCH_IMPLS: unknown {sorted(unknown)}; the programs are {IMPLS}")
    impls = [n for n in IMPLS if not only or n in only.split(",")]
    p = synth_engine_params(37)
    report = {
        "backend": device.type,
        "card": smi() if device.type == "cuda" else device.type,
        "kernel_config": load_table(),  # the table that ships
        "device_ms_per_frame": {},
    }

    def write():
        os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
        with open(args.out, "w") as fp:
            json.dump(report, fp, indent=1)

    gold: dict = {}
    for name in impls:
        report["device_ms_per_frame"][name] = rows_for(p, name, device, GEOMETRIES, gold)
        write()  # incremental: a cut run keeps what it measured
    gold.clear()
    report["batch_scaling_1080p"] = batch_curve(p, device)
    write()
    print(f"-> {args.out} [{report['card']}]")
    return report


if __name__ == "__main__":
    main()
