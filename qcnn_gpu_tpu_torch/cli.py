"""Command-line interface of the PyTorch port.

    python -m qcnn_gpu_tpu_torch.cli run --ori ori.yuv --anchor anchor.yuv \
        --height 1080 --width 1920 --frames 16 --model model_q37.data \
        --qp 37 --device cuda

Counterpart of `qcnn_gpu_tpu/cli.py` `run` (cmd_run, cli.py:27-65): load
one static model, restore one sequence, print PSNR before/after and the
time, append the metric logs, optionally write the reconstruction.
"""

from __future__ import annotations

import argparse
import sys

from qcnn_gpu_tpu_torch.engine.runner import IMPLS, Engine


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
    )
    print(
        f"before net: PSNR={rec.psnr_before:.3f}\n"
        f"after quantized net: PSNR={rec.psnr_after:.3f}\n"
        f"time: {rec.time_us}us ({rec.fps:.1f} fps, impl={rec.impl})"
    )
    return 0


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
    p.add_argument("--model-format", default="vect_c", choices=["vect_c", "hwcn", "pc"])
    p.add_argument("--qp", type=int, required=True)
    p.add_argument(
        "--impl", default="auto", choices=list(IMPLS),
        help="kernel = the fused CUDA kernel (its plain version on --device "
        "cpu); reference = the float64-exact reference net; auto = kernel",
    )
    p.add_argument("--device", default="cuda", help="torch device, e.g. cuda, cuda:1, cpu")
    p.add_argument("--recon", default=None)
    p.add_argument("--out-dir", default=".")
    p.set_defaults(fn=cmd_run)
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
