"""Command-line interface of the PyTorch port.

    python -m qcnn_gpu_tpu_torch.cli run --ori ori.yuv --anchor anchor.yuv \
        --height 1080 --width 1920 --frames 16 --model model_q37.data \
        --qp 37 --device cuda --transport raw
    python -m qcnn_gpu_tpu_torch.cli run ... --mesh 1x2x2 --device cuda:0
    python -m qcnn_gpu_tpu_torch.cli run ... --config engine.json
    python -m qcnn_gpu_tpu_torch.cli sweep --data-root /data \
        --model-pattern models/model_q%d.data --qps 22,27,32,37
    python -m qcnn_gpu_tpu_torch.cli convert --infile m.hwcn --informat hwcn \
        --outfile m.vectc --outformat vect_c
    python -m qcnn_gpu_tpu_torch.cli validate --model model_q37.data \
        --dump-features feats.bin
    python -m qcnn_gpu_tpu_torch.cli calibrate-dynamic --model dyn.data \
        --anchor anchor.yuv --height 1080 --width 1920 --frames 4 \
        --out max_u_C1.data --b-adj-out b_adj.data
    python -m qcnn_gpu_tpu_torch.cli train --ori o.yuv --anchor a.yuv \
        --height 256 --width 256 --frames 12 --lr 1e-3 --steps 300 --ckpt ckpt
    python -m qcnn_gpu_tpu_torch.cli calibrate --ckpt ckpt --sample a.yuv \
        --height 256 --width 256 --frames 4 --table-out table.data \
        --model-out model_q.data
    python -m qcnn_gpu_tpu_torch.cli finetune --ckpt ckpt --table table.data \
        --ori o.yuv --anchor a.yuv --height 256 --width 256 --frames 12 \
        --steps 100 --model-out model_q_ft.data
    python -m qcnn_gpu_tpu_torch.cli eval-float --ckpt ckpt --ori o.yuv \
        --anchor a.yuv --height 256 --width 256 --frames 4
    BENCH_GEOS=all python -m qcnn_gpu_tpu_torch.cli bench --device cuda

Counterpart of `qcnn_gpu_tpu/cli.py` `run` (cmd_run, cli.py:27-65: load
one static model, restore one sequence, print PSNR before/after and the
time, append the metric logs, optionally write the reconstruction; with
`--mesh DPxSP[xSW]` on a mesh, with `--config` from a JSON Config whose
engine settings replace the flags), `sweep` (cmd_sweep, cli.py:68-82: the
JCT-VC manifest or a JSON manifest over a list of QPs, one model per QP),
`convert` (cmd_convert, cli.py:85-129: a model file into another format
of its family, static, dynamic or float; across families it exits 2),
`validate` (cmd_validate,
cli.py:277-294: the viewmem report of the literal net on the first frame
of an anchor or of synthetic frames, and optionally the feature dump) and
`calibrate-dynamic` (cmd_calibrate_dynamic, cli.py:297-346: the dynamic
path's per-frame max_u telemetry appended to `--out` as int32, and with
`--b-adj-out` its adjusted biases; `--mode hybrid` runs the reference's
hybrid forward on a static model instead), `train` (cmd_train,
cli.py:132-160: float training from a YUV pair, checkpoint to --ckpt),
`calibrate` (cmd_calibrate, cli.py:163-202: a checkpoint's table, from
3-sigma BLU bounds on --sample frames or the QP's presets, and its model
file), `finetune` (cmd_finetune, cli.py:205-244: the shadow-weight
fine-tune on a table's grid, checkpoint to <ckpt>_qfp, optionally the
vect_c model) and `eval-float` (cmd_eval_float, cli.py:247-274: the float
model's PSNR on a sequence, appended to psnr.data / psnr_ori.data) and
`bench` (cmd_bench, cli.py:349-353: the headline measurement, here the
port's `bench.py` module, its knobs BENCH_* in the environment, its JSON
line last), with the same flags, text and files, plus `--device`.

`--impl` picks the program: kernel = generation 3 (the counterpart of the
JAX `pallas`), kernel1 / kernel2 / kernel3 = the literal-requant /
frame-pair / one-frame kernel, reference = the float64-exact reference
net, auto = generation 3 inside the table's saturation window, else
generation 1. On `--device cpu` a kernel runs as its plain version.
`--mesh` shards the batch (parallel/spatial.py): "--device cuda" spreads
the mesh over the visible CUDA devices, one device ("--device cuda:0",
"cpu") carries every shard, a virtual mesh; under a mesh `auto` is
generation 3 or raises, and kernel1 / kernel2 raise.
`--transport` picks the wire of the pipelined stream (cli.py:388, :408):
raw (2 B/px each way), duplex (block-sparse temporal deltas up, predicted
residual-delta blocks down; for static-camera content), or auto (measure
the link against the device rate, best of 3 samples each, and pick).

Departures from the JAX CLI:
  * `validate` and `calibrate-dynamic --mode hybrid` read a static model
    with `runner.read_model` in each of the three formats, where the JAX
    CLI reads a `pc` file with the hwcn reader;
  * `calibrate --per-channel` (or `--model-format pc`) raises ValueError
    when given `--table-out`, or when not given `--model-out`: a
    per-channel table has no pickle form and lands in the pc model file.
    The JAX CLI skips --table-out and may print success having written
    nothing;
  * `calibrate --sample` prints the BLU bounds it measured, and `train`
    its last step's loss (the table and the checkpoint cannot show them).
`finetune` saves `<ckpt>_qfp` with a fresh optimizer state (count 0,
zero moments), as the JAX CLI does (cli.py:238).
"""

from __future__ import annotations

import argparse
import os
import struct
import sys

from qcnn_gpu_tpu_torch import bench
from qcnn_gpu_tpu_torch.config import Config
from qcnn_gpu_tpu_torch.data import model_files, yuv
from qcnn_gpu_tpu_torch.data.datasets import PatchDataset, PrefetchLoader
from qcnn_gpu_tpu_torch.data.manifest import JCTVC_SEQUENCES, load_manifest
from qcnn_gpu_tpu_torch.engine import validate as V
from qcnn_gpu_tpu_torch.engine.calibrate import (
    calibrate_blu_bounds,
    calibrate_dynamic,
    quantize_model,
    save_b_adj,
    solve_table,
)
from qcnn_gpu_tpu_torch.engine.runner import IMPLS, TRANSPORTS, Engine, read_model
from qcnn_gpu_tpu_torch.models import float_model as FM
from qcnn_gpu_tpu_torch.models.qvrcnn_dynamic import make_hybrid_forward
from qcnn_gpu_tpu_torch.parallel.mesh import mesh_on, parse_mesh
from qcnn_gpu_tpu_torch.quant.params import QuantTable
from qcnn_gpu_tpu_torch.quant.solver import BLU_INIT
from qcnn_gpu_tpu_torch.testing import synth_frames
from qcnn_gpu_tpu_torch.train.checkpoint import AdamState, load_checkpoint, save_checkpoint
from qcnn_gpu_tpu_torch.train.finetune import quant_finetune
from qcnn_gpu_tpu_torch.train.trainer import TrainConfig, Trainer

MODEL_FORMATS = ["vect_c", "hwcn", "pc"]


def cmd_run(args) -> int:
    if args.config:
        eng = Config.load(args.config).make_engine(device=args.device)
    else:
        mesh = mesh_on(args.device, *parse_mesh(args.mesh)) if args.mesh else None
        eng = Engine(device=args.device, impl=args.impl, out_dir=args.out_dir, mesh=mesh)
    eng.load_model(args.qp, args.model, fmt=args.model_format)
    rec = eng.run_sequence(
        name=args.anchor,
        ori_path=args.ori,
        anchor_path=args.anchor,
        height=args.height,
        width=args.width,
        qp=args.qp,
        frames=args.frames,
        recon_path=args.recon,
        transport=args.transport,
    )
    print(
        f"before net: PSNR={rec.psnr_before:.3f}\n"
        f"after quantized net: PSNR={rec.psnr_after:.3f}\n"
        f"time: {rec.time_us}us ({rec.fps:.1f} fps, impl={rec.impl}, "
        f"transport={rec.transport['served']}{', mesh=' + rec.mesh if rec.mesh else ''})"
    )
    return 0


def cmd_sweep(args) -> int:
    specs = load_manifest(args.manifest) if args.manifest else JCTVC_SEQUENCES
    qps = [int(q) for q in args.qps.split(",")]
    eng = Engine(device=args.device, impl=args.impl, out_dir=args.out_dir)
    for qp in qps:
        eng.load_model(qp, args.model_pattern % qp, fmt=args.model_format)
    for r in eng.run_manifest(specs, args.data_root, qps=qps, transport=args.transport):
        print(f"{r.sequence} QP{r.qp}: {r.psnr_before:.3f} -> {r.psnr_after:.3f} dB, "
              f"{r.fps:.1f} fps")
    return 0


CONVERT_FORMATS = {
    # family -> {format: (reader, writer)} of data/model_files.py; a file
    # converts within its family only (qvrcnn.cu:398-585): static qfp,
    # dynamic and float each have an HWCN (training side) and an engine
    # layout. pc -> a scalar format only where every row is single-valued.
    "static": {
        "hwcn": ("read_static_qfp_hwcn", "write_static_qfp_hwcn"),
        "vect_c": ("read_static_qfp_vect_c", "write_static_qfp_vect_c"),
        "pc": ("read_static_qfp_pc", "write_static_qfp_pc"),
    },
    "dynamic": {
        "dyn_hwcn": ("read_dynamic_hwcn", "write_dynamic_hwcn"),
        "dyn_vect_c": ("read_dynamic_vect_c", "write_dynamic_vect_c"),
    },
    "float": {
        "float_hwcn": ("read_float_hwcn", "write_float_hwcn"),
        "float_nchw": ("read_float_nchw", "write_float_nchw"),
    },
}
_ALL_FORMATS = [f for fam in CONVERT_FORMATS.values() for f in fam]


def cmd_convert(args) -> int:
    """A model file into another format of its family, with the JAX
    command's bytes and text; across families, exit 2."""
    fam_in = next(f for f, d in CONVERT_FORMATS.items() if args.informat in d)
    fam_out = next(f for f, d in CONVERT_FORMATS.items() if args.outformat in d)
    if fam_in != fam_out:
        print(
            f"error: cannot convert {args.informat} ({fam_in} family) to "
            f"{args.outformat} ({fam_out} family); pick formats from one family"
        )
        return 2
    reader = getattr(model_files, CONVERT_FORMATS[fam_in][args.informat][0])
    writer = getattr(model_files, CONVERT_FORMATS[fam_out][args.outformat][1])
    params = reader(args.infile)
    if fam_in == "float":  # float readers return (weights, biases)
        writer(args.outfile, *params)
    else:
        writer(args.outfile, params)
    print(f"converted {args.infile} ({args.informat}) -> {args.outfile} ({args.outformat})")
    return 0


def cmd_validate(args) -> int:
    """The viewmem report (and the feature dump) of the literal net on the
    first frame of the anchor, or of one synthetic 96x64 frame."""
    p = read_model(args.model, args.model_format)
    if args.anchor:
        frames = yuv.read_y(args.anchor, args.height, args.width, args.frames)
    else:
        frames = synth_frames(1, 64, 96, seed=0)
    print(V.viewmem_report(p, frames[:1], device=args.device))
    if args.dump_features:
        V.dump_features(p, frames[:1], args.dump_features, device=args.device)
        print(f"feature maps -> {args.dump_features}")
    return 0


def cmd_calibrate_dynamic(args) -> int:
    """The dynamic path's max_u telemetry per frame (the save_steps flow,
    qvrcnn.cu:70-81, 163), appended to --out as int32; --b-adj-out appends
    each frame's adjusted biases (save_b_adj, qvrcnn.cu:288-304; dynamic
    mode only). --mode hybrid runs the hybrid forward on a static model."""
    frames = yuv.read_y(args.anchor, args.height, args.width, args.frames)
    if args.mode == "hybrid":
        run = make_hybrid_forward(read_model(args.model, args.model_format), device=args.device)
        max_c1 = 0
        for i in range(frames.shape[0]):
            _, max_u = run(frames[i:i + 1])
            max_c1 = max(max_c1, max_u)
            with open(args.out, "ab") as fp:
                fp.write(struct.pack("<i", max_u))  # max_u_C1.data format
        print("hybrid max_u_C1:", max_c1, "->", args.out)
        return 0
    maxima, telemetry = calibrate_dynamic(
        model_files.read_dynamic_hwcn(args.model), frames, device=args.device
    )
    for tel in telemetry:
        with open(args.out, "ab") as fp:
            fp.write(struct.pack("<i", tel["max_u"][0]))  # max_u_C1.data format
        if args.b_adj_out:
            save_b_adj(args.b_adj_out, tel["b_adj"])
    print("per-group max_u:", maxima, "->", args.out)
    return 0


def cmd_train(args) -> int:
    """Float training on --device from a YUV pair; the checkpoint goes to
    --ckpt (resumed from it with --resume)."""
    cfg = TrainConfig(lr=args.lr, batch_size=args.batch_size, epochs=args.epochs, seed=args.seed)
    ds = PatchDataset.from_yuv([(args.ori, args.anchor, args.height, args.width)],
                               frames=args.frames, patch=cfg.patch, seed=cfg.seed)
    tr = Trainer(cfg, device=args.device, blu_ub=BLU_INIT[args.qp] if args.blu else None)
    if args.resume:
        tr.load_checkpoint(args.ckpt)
    steps = args.steps or (ds.pieces // cfg.batch_size) * cfg.epochs
    loss = tr.fit_batches(PrefetchLoader(ds.batches(cfg.batch_size, steps)),
                          image_dir=args.image_dir)
    tr.save_checkpoint(args.ckpt)
    print(f"trained {steps} steps -> {args.ckpt}" + ("" if loss is None else f"; last loss {loss:.6f}"))
    return 0


def cmd_calibrate(args) -> int:
    """A checkpoint's fixed-point table (3-sigma BLU bounds of the float
    model on --sample frames on --device, else the QP's presets) to
    --table-out, and its model file to --model-out."""
    per_channel = args.per_channel or args.model_format == "pc"
    if per_channel and (args.table_out is not None or not args.model_out):
        raise ValueError(
            "calibrate --per-channel: a per-channel table has no pickle form and lands in "
            "the pc model file; give --model-out and no --table-out")
    params, _, _ = load_checkpoint(args.ckpt)
    blu = None
    if args.sample:
        sample = yuv.read_y(args.sample, args.height, args.width, args.frames)
        blu = calibrate_blu_bounds(params, sample, device=args.device)
        print("blu bounds: " + ", ".join(repr(b) for b in blu))
    table = solve_table(params, blu_bounds=blu, qp=args.qp, wbits=args.wbits,
                        per_channel=per_channel)
    msgs = []
    if not per_channel:
        table_out = args.table_out or "quant_table.data"
        table.save_pickle(table_out)
        msgs.append(f"table -> {table_out}")
    if args.model_out:
        ep = quantize_model(params, table, wbits=args.wbits)
        writer = {"pc": model_files.write_static_qfp_pc,
                  "vect_c": model_files.write_static_qfp_vect_c,
                  "hwcn": model_files.write_static_qfp_hwcn}
        writer["pc" if per_channel else args.model_format](args.model_out, ep)
        msgs.append(f"model -> {args.model_out}")
    print(", ".join(msgs))
    return 0


def cmd_finetune(args) -> int:
    """Shadow-weight quantization-aware fine-tune (model.py:170-233) on
    --device: a float checkpoint and its table -> the grid checkpoint
    <ckpt>_qfp, and optionally the vect_c model file."""
    params, _, step0 = load_checkpoint(args.ckpt)
    table = QuantTable.load_pickle(args.table)
    ds = PatchDataset.from_yuv([(args.ori, args.anchor, args.height, args.width)],
                               frames=args.frames, seed=0)
    steps = args.steps or ds.pieces // args.batch_size
    out = quant_finetune(params, table.stepw, PrefetchLoader(ds.batches(args.batch_size, steps)),
                         device=args.device, blu_ub=BLU_INIT[args.qp], lr=args.lr)
    save_checkpoint(args.ckpt + "_qfp", out, AdamState.zeros(out), step0 + steps)
    if args.model_out:
        model_files.write_static_qfp_vect_c(args.model_out, quantize_model(out, table))
    print(f"finetuned {steps} steps -> {args.ckpt}_qfp"
          + (f", model -> {args.model_out}" if args.model_out else ""))
    return 0


def cmd_eval_float(args) -> int:
    """The float model's restoration of a sequence on --device (the test()
    analog, model.py:257-297): PSNR before/after, appended as doubles to
    psnr.data and psnr_ori.data in --out-dir."""
    params, _, _ = load_checkpoint(args.ckpt)
    ori = yuv.read_y(args.ori, args.height, args.width, args.frames)
    anchor = yuv.read_y(args.anchor, args.height, args.width, args.frames)
    blu_ub = BLU_INIT[args.qp] if args.blu else None
    pred = FM.predict_uint8(FM.params_from_jax(params, args.device), anchor, blu_ub).cpu().numpy()
    p_before, p_after = yuv.psnr(anchor, ori), yuv.psnr(pred, ori)
    model_files.append_psnr_record(os.path.join(args.out_dir, "psnr.data"), p_after)
    model_files.append_psnr_record(os.path.join(args.out_dir, "psnr_ori.data"), p_before)
    print(f"PSNR: before net {p_before:.3f}\tafter net {p_after:.3f}")
    return 0


def cmd_bench(args) -> int:
    """The headline measurement (the port's bench.py, not the JAX root
    script): exits 1, having timed nothing, when a program's output
    differs from the plain reference net."""
    return bench.main(["--device", args.device])


def _add_geometry(p) -> None:
    p.add_argument("--height", type=int, required=True)
    p.add_argument("--width", type=int, required=True)
    p.add_argument("--frames", type=int, default=1)


def _add_device_flag(p) -> None:
    p.add_argument("--device", default="cuda", help="torch device, e.g. cuda, cuda:1, cpu")


def _add_engine_flags(p) -> None:
    p.add_argument("--model-format", default="vect_c", choices=MODEL_FORMATS)
    p.add_argument("--impl", default="auto", choices=list(IMPLS))
    _add_device_flag(p)
    p.add_argument("--transport", default="raw", choices=list(TRANSPORTS))
    p.add_argument("--out-dir", default=".")


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(prog="qcnn_gpu_tpu_torch", description=__doc__)
    sub = ap.add_subparsers(dest="cmd", required=True)

    p = sub.add_parser("run", help="restore one sequence (testqvrcnn analog)")
    p.add_argument("--ori", required=True)
    p.add_argument("--anchor", required=True)
    _add_geometry(p)
    p.add_argument("--model", required=True)
    p.add_argument("--qp", type=int, required=True)
    p.add_argument("--recon", default=None)
    p.add_argument("--config", default=None, help="JSON Config file (its engine settings "
                   "replace --impl, --mesh and --out-dir)")
    p.add_argument("--mesh", default="",
                   help="DPxSP[xSW], e.g. 2x4 or 1x2x4 (sw = frame-column spatial axis, "
                        "2-D halo sharding)")
    _add_engine_flags(p)
    p.set_defaults(fn=cmd_run)

    p = sub.add_parser("sweep", help="run the JCT-VC manifest (run_all analog)")
    p.add_argument("--data-root", required=True)
    p.add_argument("--model-pattern", required=True, help="e.g. models/q%%d.data")
    p.add_argument("--qps", default="22,27,32,37")
    p.add_argument("--manifest", default=None, help="JSON manifest (default: JCT-VC set)")
    _add_engine_flags(p)
    p.set_defaults(fn=cmd_sweep)

    p = sub.add_parser("convert", help="model file format conversion")
    p.add_argument("--infile", required=True)
    p.add_argument("--informat", required=True, choices=_ALL_FORMATS)
    p.add_argument("--outfile", required=True)
    p.add_argument("--outformat", required=True, choices=_ALL_FORMATS)
    p.set_defaults(fn=cmd_convert)

    p = sub.add_parser("validate", help="cross-impl validation report (viewmem analog)")
    p.add_argument("--model", required=True)
    p.add_argument("--model-format", default="vect_c", choices=MODEL_FORMATS)
    p.add_argument("--anchor", default=None)
    p.add_argument("--height", type=int, default=0)
    p.add_argument("--width", type=int, default=0)
    p.add_argument("--frames", type=int, default=1)
    p.add_argument("--dump-features", default=None)
    _add_device_flag(p)
    p.set_defaults(fn=cmd_validate)

    p = sub.add_parser(
        "calibrate-dynamic", help="dynamic-path max_u telemetry (save_steps analog)"
    )
    p.add_argument("--model", required=True,
                   help="dynamic-format model file (static qfp for --mode hybrid)")
    p.add_argument("--model-format", default="vect_c", choices=MODEL_FORMATS,
                   help="static-qfp container for --mode hybrid")
    p.add_argument("--anchor", required=True)
    _add_geometry(p)
    p.add_argument("--out", default="max_u_C1.data")
    p.add_argument("--mode", choices=["dynamic", "hybrid"], default="dynamic")
    p.add_argument("--b-adj-out", default=None, help="append save_b_adj telemetry here")
    _add_device_flag(p)
    p.set_defaults(fn=cmd_calibrate_dynamic)

    p = sub.add_parser("train", help="float training")
    p.add_argument("--ori", required=True)
    p.add_argument("--anchor", required=True)
    _add_geometry(p)
    p.add_argument("--qp", type=int, default=37)
    p.add_argument("--blu", action="store_true")
    p.add_argument("--lr", type=float, default=1e-4)
    p.add_argument("--batch-size", type=int, default=64)
    p.add_argument("--epochs", type=int, default=1)
    p.add_argument("--steps", type=int, default=0)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--ckpt", default="checkpoint")
    p.add_argument("--resume", action="store_true")
    p.add_argument("--image-dir", default=None,
                   help="dump input|output|target triplet PNGs at log steps "
                        "(tf.summary.image analog, model.py:61-69)")
    _add_device_flag(p)
    p.set_defaults(fn=cmd_train)

    p = sub.add_parser("calibrate", help="solve quant table from a checkpoint")
    p.add_argument("--ckpt", required=True)
    p.add_argument("--qp", type=int, default=37)
    p.add_argument("--sample", default=None, help="YUV file for 3-sigma BLU stats")
    p.add_argument("--height", type=int, default=0)
    p.add_argument("--width", type=int, default=0)
    p.add_argument("--frames", type=int, default=1)
    p.add_argument("--table-out", default=None,
                   help="quant table pickle (default quant_table.data; refused "
                        "with --per-channel)")
    p.add_argument("--model-out", default=None)
    p.add_argument("--model-format", default="vect_c", choices=MODEL_FORMATS)
    p.add_argument("--wbits", type=int, default=8, choices=[4, 8],
                   help="weight grid: 8 (reference) or 4 (INT4 stretch)")
    p.add_argument("--per-channel", action="store_true",
                   help="per-output-channel stepw + (mul, shift) (INT4 quality "
                        "closure); the table lands in the 'pc' model file "
                        "(--model-out, required)")
    _add_device_flag(p)
    p.set_defaults(fn=cmd_calibrate)

    p = sub.add_parser("finetune", help="shadow-weight quant-aware fine-tune")
    p.add_argument("--ckpt", required=True)
    p.add_argument("--table", required=True, help="quant_params pickle")
    p.add_argument("--ori", required=True)
    p.add_argument("--anchor", required=True)
    _add_geometry(p)
    p.add_argument("--qp", type=int, default=37)
    p.add_argument("--lr", type=float, default=1e-4)
    p.add_argument("--batch-size", type=int, default=64)
    p.add_argument("--steps", type=int, default=0)
    p.add_argument("--model-out", default=None)
    _add_device_flag(p)
    p.set_defaults(fn=cmd_finetune)

    p = sub.add_parser("eval-float", help="float-model sequence eval (test() analog)")
    p.add_argument("--ckpt", required=True)
    p.add_argument("--ori", required=True)
    p.add_argument("--anchor", required=True)
    _add_geometry(p)
    p.add_argument("--qp", type=int, default=37)
    p.add_argument("--blu", action="store_true")
    p.add_argument("--out-dir", default=".")
    _add_device_flag(p)
    p.set_defaults(fn=cmd_eval_float)

    p = sub.add_parser("bench", help="headline benchmark (knobs: BENCH_* in the environment)")
    _add_device_flag(p)
    p.set_defaults(fn=cmd_bench)
    return ap


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)
    try:
        return args.fn(args)
    except (FileNotFoundError, EOFError, ValueError, KeyError) as e:
        print(f"error: {e}", file=sys.stderr)
        return 1


if __name__ == "__main__":
    sys.exit(main())
