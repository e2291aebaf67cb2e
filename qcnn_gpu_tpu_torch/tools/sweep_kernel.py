"""Sweep generation 3 over its compiled tiles on one CUDA GPU, and fill
the tuned table.

    python -m qcnn_gpu_tpu_torch.tools.sweep_kernel [--out JSONL] [--table JSON]
        [--repeats 7] [--timeout 600] [--no-write]

Counterpart of `scripts/sweep_kernel.py`. A config is generation 3 at
one of its compiled tiles (`ops/fused.TILES`). Each runs in its own
subprocess with a timeout (a fault or a hang costs one config, not the
sweep), over the six reference geometries (416x240 ... 3840x2160) at
batch 1 and 4, with the committed QP37 model. In the subprocess the
config is first held bit-equal to the plain version on a small frame
ragged in both axes (2x37x53, the CPU's plain version, which the card's
must equal too), then, per geometry, on one frame of that geometry (the
card's plain version). A config that is not exact there is recorded,
with its max |diff|, and not timed.
Each cell is then warmed up (~0.5 s of both programs) and timed in
turns with generation 3 at 24x40, the table's default (base, config,
config, base, ...; `--repeats` pairs): CUDA events around the replay of
a CUDA graph of enough launches for ~100 ms, so that a 416x240 frame's
~35 us kernel is timed and not its wrapper's enqueue on the host
(`tools.graph_timer`). Each cell is appended to the JSONL as one row:
every repeat's ms/frame of both, each pair's ratio (config / 24x40, so
a drift of the card's clock that both sides of a pair see cancels), the
median ratio and the config's spread (max - min of its ratios),
`engine/mfu.mfu_report`'s useful TOP/s and share of the int8 peak, the
issued and useful MACs per pixel, and the card's name and power limit. A re-run resumes: only cells without a
measured row run. The command exits 1 when a config failed, timed out
or was not bit-equal to the plain version.

Then, unless `--no-write`, the table is rewritten atomically
(`ops/tuning.write_tuned`) from the rows of this card: every swept geometry is a class
(so that the nearest-class rule never hands one geometry's tile to
another), and its entry carries a tile only where that tile read faster
than 24x40 in every one of its paired repeats (the largest of its ratios
below 1: one repeat that reads even faster cannot block a winner, and
one that reads slower keeps 24x40), batch 4 in the entry and batch 1 in
its `batch1` block; of such tiles the lowest median ratio wins. Only
rows of the tiles compiled now count (the committed JSONL also holds
rows of generation 2 and of a 20x40 tile from an earlier sweep).
"""

from __future__ import annotations

import argparse
import json
import math
import os
import statistics
import subprocess
import sys
import tempfile

_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
_REPO = os.path.dirname(_PKG)
MODEL = os.path.join(_REPO, "assets", "golden", "model_q37.data")
JSONL = os.path.join(_PKG, "sweep_h100.jsonl")
GEOMETRIES = ((240, 416), (480, 832), (720, 1280), (1080, 1920), (1600, 2560), (2160, 3840))
BATCHES = (1, 4)
TIMED_MS = 100.0  # each timing spans at least this much kernel time
WARM_MS = 500.0  # kernel time of both programs before a cell's first timing
DEFAULT = (24, 40)  # the table's default tile


def configs():
    from qcnn_gpu_tpu_torch.ops.fused import TILES

    return list(TILES)


def _frames(n: int, h: int, w: int, seed: int):
    """Seeded video-like uint8 frames: smooth gradients + noise."""
    import numpy as np

    rng = np.random.default_rng(seed)
    yy, xx = np.mgrid[0:h, 0:w]
    base = (128 + 60 * np.sin(yy / 37.0) + 50 * np.cos(xx / 53.0))[None]
    return np.clip(base + rng.normal(0, 12, size=(n, h, w)), 0, 255).astype(np.uint8)


def child(th: int, tw: int, cells, repeats: int, model: str) -> None:
    """Check and time generation 3 at th x tw at `cells` [(h, w, batch)],
    one RESULT line per cell on stdout."""
    import torch

    from qcnn_gpu_tpu_torch.engine.mfu import mfu_report
    from qcnn_gpu_tpu_torch.engine.runner import read_model
    from qcnn_gpu_tpu_torch.ops.fused import FusedWeights, fused_forward, fused_forward_reference
    from qcnn_gpu_tpu_torch.tools import events_ms, graph_timer, smi

    if not torch.cuda.is_available():
        raise RuntimeError("the sweep needs a CUDA GPU")
    dev = torch.device("cuda")
    card = smi()
    params = read_model(model)
    fw = FusedWeights.from_engine(params, dev)

    def run(x):
        return fused_forward(x, fw, tile=(th, tw))

    def base(x):
        return fused_forward(x, fw)

    def err(x, want) -> int:
        got = run(x)
        torch.cuda.synchronize()
        return int((got.to(torch.int16) - want.to(torch.int16)).abs().max())

    # the small frame against the plain version on the CPU, and the plain
    # version on the card against it (the frames of each geometry are held
    # against the card's plain version: the CPU's would take minutes)
    small = torch.from_numpy(_frames(2, 37, 53, seed=1))
    want = fused_forward_reference(small, FusedWeights.from_engine(params, "cpu"))
    checks = {"max_abs_err_small": err(small.to(dev), want.to(dev)),
              "plain_on_card_equals_cpu": torch.equal(
                  fused_forward_reference(small.to(dev), fw).cpu(), want)}
    for h, w in sorted({(h, w) for h, w, _ in cells}):
        x1 = torch.from_numpy(_frames(1, h, w, seed=2)).to(dev)
        checks["max_abs_err_geometry"] = err(x1, fused_forward_reference(x1, fw))
        ok = (checks["max_abs_err_small"] == 0 and checks["max_abs_err_geometry"] == 0
              and checks["plain_on_card_equals_cpu"])
        for b in sorted(b for hh, ww, b in cells if (hh, ww) == (h, w)):
            row = {"kernel": 3, "th": th, "tw": tw, "h": h, "w": w, "batch": b,
                   "exact": ok, **checks, "card": card}
            if ok:
                x = torch.from_numpy(_frames(b, h, w, seed=3)).to(dev)
                run(x)
                base(x)
                one = max(events_ms(lambda: run(x), 3), 1e-3)
                n = max(3, math.ceil(TIMED_MS / one))
                events_ms(lambda: (base(x), run(x)), math.ceil(WARM_MS / (2 * one)))
                timers = {"base": graph_timer(lambda: base(x), n),
                          "run": graph_timer(lambda: run(x), n)}
                t_run, t_base = [], []
                for r in range(repeats):  # in turns: base first on even repeats
                    pair = [(t_base, "base"), (t_run, "run")]
                    for times, name in (pair if r % 2 == 0 else pair[::-1]):
                        times.append(timers[name]() / b)
                del timers  # the graphs' memory
                ms, ms_base = statistics.median(t_run), statistics.median(t_base)
                ratios = [a / b for a, b in zip(t_run, t_base)]
                report = mfu_report(h * w, ms, card.split(",")[0], (th, tw))
                row.update({
                    "ms_per_frame": ms, "base_ms_per_frame": ms_base,
                    "ratio": statistics.median(ratios), "spread": max(ratios) - min(ratios),
                    "ratios": ratios, "repeats_ms": t_run, "base_repeats_ms": t_base,
                    "launches_per_repeat": n,
                    "useful_tops": report["sustained_useful_tops"],
                    "mfu_vs_int8_peak": report["mfu_vs_int8_peak"],
                    "issued_macs_per_px": report["issued_macs_per_px"],
                    "useful_macs_per_px": report["useful_macs_per_px"],
                })
            else:
                row["error"] = "not bit-equal to the plain version: not timed"
            print("RESULT " + json.dumps(row), flush=True)


def wins(row) -> bool:
    """A measured, exact row that read faster than 24x40 in every paired
    repeat."""
    return bool(row.get("exact")) and "ratios" in row and max(row["ratios"]) < 1


def winner(rows):
    """The cell's winning (th, tw) among `rows`, or None: of the rows of a
    compiled tile that win, the lowest median ratio."""
    tiles = set(configs())
    won = [r for r in rows if r.get("kernel", 3) == 3 and (r["th"], r["tw"]) in tiles and wins(r)]
    if not won:
        return None
    best = min(won, key=lambda r: r["ratio"])
    return best["th"], best["tw"]


def table_from(rows) -> dict:
    """per_geometry entries from the rows: every geometry swept, a tile
    only where one won (batch 4 in the entry, batch 1 in `batch1`)."""
    per = {}
    for h, w in sorted({(r["h"], r["w"]) for r in rows}, key=lambda g: g[0] * g[1]):
        pick = {b: winner([r for r in rows if (r["h"], r["w"], r["batch"]) == (h, w, b)])
                for b in BATCHES}
        entry = {} if pick[4] is None else dict(zip(("th", "tw"), pick[4]))
        one = pick[1] or (DEFAULT if entry else None)
        if one is not None and one != pick[4]:
            entry["batch1"] = dict(zip(("th", "tw"), one))
        per[f"{h}x{w}"] = entry
    return per


def _read(path: str):
    if not os.path.exists(path):
        return []
    with open(path) as fp:
        return [json.loads(line) for line in fp if line.strip()]


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--out", default=JSONL, help="the resumable JSONL of rows")
    ap.add_argument("--table", default=None, help="the table to rewrite (default: the shipped "
                    "qcnn_gpu_tpu_torch/tuned_h100.json)")
    ap.add_argument("--model", default=MODEL)
    ap.add_argument("--repeats", type=int, default=7)
    ap.add_argument("--timeout", type=float, default=600.0, help="seconds per config")
    ap.add_argument("--no-write", action="store_true", help="leave the table as it is")
    ap.add_argument("--child", nargs=2, type=int, metavar=("TH", "TW"),
                    help=argparse.SUPPRESS)
    ap.add_argument("--cells", default="", help=argparse.SUPPRESS)
    args = ap.parse_args(argv)
    if args.repeats < 5:
        ap.error("--repeats must be at least 5")
    if args.child:
        cells = [tuple(int(v) for v in c.split(",")) for c in args.cells.split(";") if c]
        child(*args.child, cells, args.repeats, args.model)
        return 0

    done = {(r["th"], r["tw"], r["h"], r["w"], r["batch"])
            for r in _read(args.out) if "ms_per_frame" in r and r.get("kernel", 3) == 3}
    failed = 0
    for th, tw in configs():
        cells = [(h, w, b) for h, w in GEOMETRIES for b in BATCHES
                 if (th, tw, h, w, b) not in done]
        if not cells:
            continue
        cmd = [sys.executable, "-m", "qcnn_gpu_tpu_torch.tools.sweep_kernel",
               "--child", str(th), str(tw), "--repeats", str(args.repeats),
               "--model", args.model, "--cells", ";".join(",".join(map(str, c)) for c in cells)]
        rows, error = [], None
        try:
            cp = subprocess.run(cmd, cwd=_REPO, capture_output=True, text=True,
                                timeout=args.timeout)
            rows = [json.loads(line[7:]) for line in cp.stdout.splitlines()
                    if line.startswith("RESULT ")]
            if cp.returncode != 0:
                error = " | ".join(cp.stderr.strip().splitlines()[-3:])[:400]
        except subprocess.TimeoutExpired as e:
            rows = [json.loads(line[7:]) for line in (e.stdout or b"").decode().splitlines()
                    if line.startswith("RESULT ")]
            error = f"timeout {args.timeout:g} s"
        got = {(r["h"], r["w"], r["batch"]) for r in rows}
        if error or any(r.get("exact") is False for r in rows):
            failed += 1
        if error:  # the cells the subprocess did not reach, retried on resume
            rows += [{"kernel": 3, "th": th, "tw": tw, "h": h, "w": w, "batch": b,
                      "error": error} for h, w, b in cells if (h, w, b) not in got]
        with open(args.out, "a") as fp:
            for r in rows:
                fp.write(json.dumps(r) + "\n")
        for r in rows:
            print(json.dumps({k: v for k, v in r.items() if not k.endswith("repeats_ms")}),
                  flush=True)

    measured = [r for r in _read(args.out) if "ms_per_frame" in r or r.get("exact") is False]
    cards = {r["card"] for r in measured}
    if len(cards) > 1:
        raise RuntimeError(f"{args.out} holds rows of more than one card: {sorted(cards)}")
    per = table_from(measured)
    print("table: " + json.dumps(per))
    if not args.no_write and per:
        from qcnn_gpu_tpu_torch.ops.tuning import TUNED_PATH, write_tuned

        table = args.table or TUNED_PATH
        with tempfile.TemporaryDirectory(dir=os.path.dirname(os.path.abspath(table))) as d:
            tmp = os.path.join(d, "tuned.json")
            for geo, entry in per.items():
                write_tuned(entry, tmp, geometry=geo, batch1=entry.get("batch1"))
            os.replace(tmp, table)
        print(f"tuned -> {table}")
    if failed:
        print(f"{failed} of {len(configs())} configs failed, timed out or were not bit-equal to "
              "the plain version", file=sys.stderr)
    return 1 if failed else 0


if __name__ == "__main__":
    raise SystemExit(main())
