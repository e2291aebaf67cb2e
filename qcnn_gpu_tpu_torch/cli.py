"""Command-line interface of the PyTorch port.

    python -m qcnn_gpu_tpu_torch.cli run --ori ori.yuv --anchor anchor.yuv \
        --height 1080 --width 1920 --frames 16 --model model_q37.data \
        --qp 37 --device cuda --transport raw
    python -m qcnn_gpu_tpu_torch.cli sweep --data-root /data \
        --model-pattern models/model_q%d.data --qps 22,27,32,37

Counterpart of `qcnn_gpu_tpu/cli.py` `run` (cmd_run, cli.py:27-65: load
one static model, restore one sequence, print PSNR before/after and the
time, append the metric logs, optionally write the reconstruction) and
`sweep` (cmd_sweep, cli.py:68-82: the JCT-VC manifest or a JSON manifest
over a list of QPs, one model per QP). `--impl` picks the program:
kernel = generation 3 (the counterpart of the JAX `pallas`),
kernel2 / kernel3 = the frame-pair / one-frame kernel, reference = the
float64-exact reference net, auto = kernel. On `--device cpu` a kernel
runs as its plain version. `--transport` picks the wire of the pipelined
stream (cli.py:388, :408): raw (2 B/px each way), duplex (block-sparse
temporal deltas up, predicted residual-delta blocks down; for
static-camera content), or auto (measure the link against the device
rate, best of 3 samples each, and pick).
"""

from __future__ import annotations

import argparse
import sys

from qcnn_gpu_tpu_torch.data.manifest import JCTVC_SEQUENCES, load_manifest
from qcnn_gpu_tpu_torch.engine.runner import IMPLS, TRANSPORTS, Engine


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


def _add_engine_flags(p) -> None:
    p.add_argument("--model-format", default="vect_c", choices=["vect_c", "hwcn", "pc"])
    p.add_argument("--impl", default="auto", choices=list(IMPLS))
    p.add_argument("--device", default="cuda", help="torch device, e.g. cuda, cuda:1, cpu")
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
