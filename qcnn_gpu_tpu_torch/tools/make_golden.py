"""Train the per-QP golden models and record their PSNRs: the port's
counterpart of `scripts/make_golden.py`.

    python -m qcnn_gpu_tpu_torch.tools.make_golden [--device cuda] [--qps 37 ...]
        [--steps 4000] [--decay-steps 2000] [--finetune-steps 800] [--lr 1e-3]
        [--batch 32] [--wbits 8|4] [--per-channel | --no-per-channel]
        [--out-dir assets/golden]

For each QP: train the float VRCNN on the 416x240 hopper pan against its
JPEG anchors, then lr/5 from its params, calibrate the BLU bounds on 4
anchors, solve the fixed-point table, fine-tune on the table's grid at
lr/10, quantize, and serve the held-out anchors through the engine
(`golden_for_qp`, the script's loop body, :99-144). `write_records` writes
what the script writes into `--out-dir`: `model_q{qp}{suffix}.data`
(static-qfp NCHW_VECT_C, or per-channel `pc` with --per-channel),
`psnr_static_hopper_{qp}{suffix}.data` (two little-endian doubles) and
`psnr_golden{suffix}.json`, merged into an existing file so that a --qps
run extends the set (:147-168). `suffix` is `_int4` for --wbits 4.

`main` builds the clip, which needs matplotlib's sample data and PIL
(ImportError naming the one missing); `golden_for_qp` and `write_records`
take arrays, so a machine without either runs them on content of its own.
Every step runs on `--device` (default cuda; a CUDA device without CUDA
raises).

Departures from the script, on purpose:
  * the training anchors go through the installed PIL's encoder
    (`data/golden.jpeg_roundtrip`), as the script's do (:102); the
    evaluation anchors are the committed `hopper_eval` bytes, decoded
    (`data/golden.jpeg_anchor`), where the script re-encodes them (:103):
    the port never re-encodes a committed anchor. A model trained under
    another PIL version may differ;
  * `after` is the PSNR of the quantized model served by
    `Engine(impl="auto")` (the kernel on the card, its plain version on
    the CPU), where the script runs the numpy oracle (:133). The integer
    path is exact, so the number is the same;
  * the model, the .data file and the JSON are written after each QP, so
    a run cut short keeps the QPs it finished (the JSON ends the same).
"""

from __future__ import annotations

import argparse
import json
import os
import struct
from typing import Dict, Tuple

import numpy as np

from qcnn_gpu_tpu_torch.data import yuv
from qcnn_gpu_tpu_torch.data.datasets import PatchDataset
from qcnn_gpu_tpu_torch.data.golden import (
    N_EVAL,
    QP_QUALITY,
    golden_clip,
    jpeg_anchor,
    jpeg_roundtrip,
)
from qcnn_gpu_tpu_torch.data.model_files import write_static_qfp_pc, write_static_qfp_vect_c
from qcnn_gpu_tpu_torch.engine.calibrate import calibrate_blu_bounds, quantize_model, solve_table
from qcnn_gpu_tpu_torch.engine.runner import Engine
from qcnn_gpu_tpu_torch.models.engine_params import EngineParams
from qcnn_gpu_tpu_torch.parallel.mesh import mesh_on
from qcnn_gpu_tpu_torch.train.finetune import quant_finetune
from qcnn_gpu_tpu_torch.train.trainer import TrainConfig, Trainer

LOG_EVERY = 400


def golden_for_qp(clean_tr: np.ndarray, anchor_tr: np.ndarray, clean_ev: np.ndarray,
                  anchor_ev: np.ndarray, qp: int, *, steps: int, decay_steps: int,
                  finetune_steps: int, lr: float, batch: int, wbits: int, per_channel: bool,
                  device) -> Tuple[EngineParams, Dict[str, float]]:
    """One QP's model from uint8 frame stacks [N, H, W]: train on (clean_tr,
    anchor_tr) patches of 64x64 (seed qp), `decay_steps` more at lr/5,
    calibrate on anchor_tr[:4], solve the table, fine-tune on its grid at
    lr/10, quantize; then serve anchor_ev. Returns the model and its
    unrounded PSNRs against clean_ev, {"before": anchor, "after": served}.
    The model trains on a 1x1 mesh of `device` ("cuda" is the first
    visible card), as the script's on `make_mesh(1, 1)`."""
    mesh = mesh_on(device, 1, 1)
    ds = PatchDataset([(clean_tr, anchor_tr)], patch=64, seed=qp)
    tr = Trainer(TrainConfig(lr=lr, batch_size=batch, log_every=LOG_EVERY, seed=qp), mesh)
    tr.fit_batches(ds.batches(batch, steps))
    if decay_steps:
        tr = Trainer(TrainConfig(lr=lr / 5, batch_size=batch, log_every=LOG_EVERY, seed=qp),
                     tr.mesh, params=tr.params)
        tr.fit_batches(ds.batches(batch, decay_steps))
    blu = calibrate_blu_bounds(tr.params, anchor_tr[:4], device=mesh.first)
    table = solve_table(tr.params, blu_bounds=blu, wbits=wbits, per_channel=per_channel)
    ft = quant_finetune(tr.params, table.stepw, ds.batches(batch, finetune_steps), mesh=tr.mesh,
                        blu_ub=table.blu_adj, lr=lr * 0.1, log_every=LOG_EVERY, wbits=wbits)
    ep = quantize_model(ft, table, wbits=wbits)
    engine = Engine(device=mesh.first, impl="auto")
    engine.set_model(qp, ep)
    rec = engine.restore(anchor_ev, qp)
    return ep, {"before": yuv.psnr(anchor_ev, clean_ev), "after": yuv.psnr(rec, clean_ev)}


def write_records(out_dir: str, goldens: Dict[int, Tuple[EngineParams, Dict[str, float]]],
                  suffix: str, wbits: int, per_channel: bool) -> str:
    """Write each QP's model and its PSNR pair, then merge the rounded
    PSNRs into `psnr_golden{suffix}.json` (the QPs already there keep
    their place, new ones are appended), in the script's bytes. Returns
    the JSON's path."""
    os.makedirs(out_dir, exist_ok=True)
    writer = write_static_qfp_pc if per_channel else write_static_qfp_vect_c
    rows = {}
    for qp, (ep, psnrs) in goldens.items():
        writer(os.path.join(out_dir, f"model_q{qp}{suffix}.data"), ep)
        with open(os.path.join(out_dir, f"psnr_static_hopper_{qp}{suffix}.data"), "wb") as fp:
            fp.write(struct.pack("<2d", psnrs["before"], psnrs["after"]))
        rows[str(qp)] = {"before": round(psnrs["before"], 6), "after": round(psnrs["after"], 6)}
        if wbits != 8:  # the INT4 set may mix solvers per QP
            rows[str(qp)]["per_channel"] = bool(per_channel)
    out_json = os.path.join(out_dir, f"psnr_golden{suffix}.json")
    merged = {}
    if os.path.exists(out_json):
        with open(out_json) as fp:
            merged = json.load(fp).get("goldens", {})
    merged.update(rows)
    with open(out_json, "w") as fp:
        json.dump({"clip": "grace_hopper pan 416x240", "frames_eval": N_EVAL,
                   "qp_quality": QP_QUALITY, "wbits": wbits, "goldens": merged}, fp, indent=1)
    return out_json


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(prog="qcnn_gpu_tpu_torch.tools.make_golden",
                                 description=__doc__.splitlines()[0])
    ap.add_argument("--steps", type=int, default=4000)
    ap.add_argument("--decay-steps", type=int, default=2000, help="extra steps at lr/5")
    ap.add_argument("--finetune-steps", type=int, default=800)
    ap.add_argument("--lr", type=float, default=1e-3)
    ap.add_argument("--batch", type=int, default=32)
    ap.add_argument("--out-dir", default="assets/golden")
    ap.add_argument("--wbits", type=int, default=8, choices=(4, 8),
                    help="weight grid: 8, the reference's INT8 path; 4, the INT4 variant "
                         "(artifacts get an _int4 suffix)")
    ap.add_argument("--qps", type=int, nargs="*", default=None,
                    help="subset of QPs (default: all four)")
    ap.add_argument("--per-channel", dest="per_channel", action="store_true", default=None,
                    help="per-output-channel stepw + (mul, shift); the default for --wbits 4")
    ap.add_argument("--no-per-channel", dest="per_channel", action="store_false")
    ap.add_argument("--device", default="cuda", help="torch device, e.g. cuda, cpu")
    args = ap.parse_args(argv)
    if args.per_channel is None:
        args.per_channel = args.wbits == 4
    suffix = "" if args.wbits == 8 else f"_int{args.wbits}"

    clean_tr, clean_ev = golden_clip()
    goldens = {}
    qps = args.qps or list(QP_QUALITY)
    for qp, quality in QP_QUALITY.items():
        if qp not in qps:
            continue
        anchor_tr = jpeg_roundtrip(clean_tr, quality)
        anchor_ev = jpeg_anchor(clean_ev, quality, "hopper_eval")
        print(f"QP{qp} (jpeg q{quality}): anchor {yuv.psnr(anchor_ev, clean_ev):.3f} dB; "
              "training...", flush=True)
        ep, psnrs = golden_for_qp(
            clean_tr, anchor_tr, clean_ev, anchor_ev, qp, steps=args.steps,
            decay_steps=args.decay_steps, finetune_steps=args.finetune_steps, lr=args.lr,
            batch=args.batch, wbits=args.wbits, per_channel=args.per_channel,
            device=args.device)
        write_records(args.out_dir, {qp: (ep, psnrs)}, suffix, args.wbits, args.per_channel)
        before, after = psnrs["before"], psnrs["after"]
        goldens[qp] = {"before": round(before, 6), "after": round(after, 6)}
        if args.wbits != 8:
            goldens[qp]["per_channel"] = bool(args.per_channel)
        print(f"QP{qp}: {before:.3f} -> {after:.3f} dB ({after - before:+.3f})", flush=True)
    print(json.dumps(goldens))
    return goldens


if __name__ == "__main__":
    main()
