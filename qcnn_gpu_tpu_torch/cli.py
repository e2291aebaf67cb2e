"""Command-line interface of the PyTorch port.

    python -m qcnn_gpu_tpu_torch.cli run --ori ori.yuv --anchor anchor.yuv \
        --height 1080 --width 1920 --frames 16 --model model_q37.data \
        --qp 37 --device cuda --transport raw
    python -m qcnn_gpu_tpu_torch.cli sweep --data-root /data \
        --model-pattern models/model_q%d.data --qps 22,27,32,37
    python -m qcnn_gpu_tpu_torch.cli validate --model model_q37.data \
        --dump-features feats.bin
    python -m qcnn_gpu_tpu_torch.cli calibrate-dynamic --model dyn.data \
        --anchor anchor.yuv --height 1080 --width 1920 --frames 4 \
        --out max_u_C1.data --b-adj-out b_adj.data

Counterpart of `qcnn_gpu_tpu/cli.py` `run` (cmd_run, cli.py:27-65: load
one static model, restore one sequence, print PSNR before/after and the
time, append the metric logs, optionally write the reconstruction),
`sweep` (cmd_sweep, cli.py:68-82: the JCT-VC manifest or a JSON manifest
over a list of QPs, one model per QP), `validate` (cmd_validate,
cli.py:277-294: the viewmem report of the literal net on the first frame
of an anchor or of synthetic frames, and optionally the feature dump) and
`calibrate-dynamic` (cmd_calibrate_dynamic, cli.py:297-346: the dynamic
path's per-frame max_u telemetry appended to `--out` as int32, and with
`--b-adj-out` its adjusted biases; `--mode hybrid` runs the reference's
hybrid forward on a static model instead), with the same flags, text and
files, plus `--device`.

`--impl` picks the program: kernel = generation 3 (the counterpart of the
JAX `pallas`), kernel1 / kernel2 / kernel3 = the literal-requant /
frame-pair / one-frame kernel, reference = the float64-exact reference
net, auto = generation 3 inside the table's saturation window, else
generation 1. On `--device cpu` a kernel runs as its plain version.
`--transport` picks the wire of the pipelined stream (cli.py:388, :408):
raw (2 B/px each way), duplex (block-sparse temporal deltas up, predicted
residual-delta blocks down; for static-camera content), or auto (measure
the link against the device rate, best of 3 samples each, and pick).

One departure: `validate` and `calibrate-dynamic --mode hybrid` read a
static model with `runner.read_model` in each of the three formats, where
the JAX CLI reads a `pc` file with the hwcn reader.
"""

from __future__ import annotations

import argparse
import struct
import sys

from qcnn_gpu_tpu_torch.data import model_files, yuv
from qcnn_gpu_tpu_torch.data.manifest import JCTVC_SEQUENCES, load_manifest
from qcnn_gpu_tpu_torch.engine import validate as V
from qcnn_gpu_tpu_torch.engine.calibrate import calibrate_dynamic, save_b_adj
from qcnn_gpu_tpu_torch.engine.runner import IMPLS, TRANSPORTS, Engine, read_model
from qcnn_gpu_tpu_torch.models.qvrcnn_dynamic import make_hybrid_forward
from qcnn_gpu_tpu_torch.testing import synth_frames

MODEL_FORMATS = ["vect_c", "hwcn", "pc"]


def cmd_run(args) -> int:
    eng = Engine(device=args.device, impl=args.impl, out_dir=args.out_dir)
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
        f"transport={rec.transport['served']})"
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
    p.add_argument("--height", type=int, required=True)
    p.add_argument("--width", type=int, required=True)
    p.add_argument("--frames", type=int, default=1)
    p.add_argument("--model", required=True)
    p.add_argument("--qp", type=int, required=True)
    p.add_argument("--recon", default=None)
    _add_engine_flags(p)
    p.set_defaults(fn=cmd_run)

    p = sub.add_parser("sweep", help="run the JCT-VC manifest (run_all analog)")
    p.add_argument("--data-root", required=True)
    p.add_argument("--model-pattern", required=True, help="e.g. models/q%%d.data")
    p.add_argument("--qps", default="22,27,32,37")
    p.add_argument("--manifest", default=None, help="JSON manifest (default: JCT-VC set)")
    _add_engine_flags(p)
    p.set_defaults(fn=cmd_sweep)

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
    p.add_argument("--height", type=int, required=True)
    p.add_argument("--width", type=int, required=True)
    p.add_argument("--frames", type=int, default=1)
    p.add_argument("--out", default="max_u_C1.data")
    p.add_argument("--mode", choices=["dynamic", "hybrid"], default="dynamic")
    p.add_argument("--b-adj-out", default=None, help="append save_b_adj telemetry here")
    _add_device_flag(p)
    p.set_defaults(fn=cmd_calibrate_dynamic)
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
