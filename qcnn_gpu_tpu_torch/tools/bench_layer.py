"""One layer's convolution on one CUDA GPU: the port's counterpart of
`scripts/bench_layer.py`, itself the counterpart of the reference's
`test_layer` (kernel.cu:28-73: one cuDNN convolution, a performance
counter around it).

    python -m qcnn_gpu_tpu_torch.tools.bench_layer [--layer C2_2] \
        [--height 720 --width 1280] [--batch 4] [--iters 30]

The script's argv, input and computation: frames of `default_rng(0)`
integers in [0, 128), NHWC with the layer's input channels; the layer's
SAME convolution of the synthetic QP37 weights plus its bias, as int32.
The JAX script runs it as an XLA convolution on bf16 operands with f32
accumulation; here it is `ops/int8_conv.conv_int8` (im2col and
`torch._int_mm` on a CUDA tensor, the port's counterpart of an XLA int8
convolution; the plain float64-exact convolution on the CPU). On the
card the GEMM route is first checked equal to the plain route, then
`--iters` calls are timed with the host clock and one synchronize, as
the script times them. Prints the script's line, then the layer's bound
on the card (its operations over 1,979 TOP/s int8 against its bytes, each
input read once and the int32 output written once, over 3.35 TB/s) and
the card's name and power limit.
"""

from __future__ import annotations

import argparse
import time

import numpy as np
import torch

from qcnn_gpu_tpu_torch.models.topology import QVRCNN_LAYERS
from qcnn_gpu_tpu_torch.ops.int8_conv import conv_int8, gemm_operand
from qcnn_gpu_tpu_torch.testing import synth_engine_params
from qcnn_gpu_tpu_torch.tools import PEAK_BYTES, PEAK_INT8_OPS, smi

LAYER_NAMES = [layer.name for layer in QVRCNN_LAYERS]


def layer_inputs(idx: int, batch: int, h: int, w: int, device) -> tuple:
    """(x int8 NHWC, the weight's GEMM operand, bias int32) of layer `idx`:
    the script's input and the synthetic QP37 model's weights."""
    layer = QVRCNN_LAYERS[idx]
    p = synth_engine_params(37)
    rng = np.random.default_rng(0)
    x = torch.from_numpy(rng.integers(0, 128, (batch, h, w, layer.in_ch)).astype(np.int8))
    wt = torch.from_numpy(np.asarray(p.weights[idx], np.int8))
    b = torch.from_numpy(np.asarray(p.biases[idx], np.int32))
    return x.to(device), gemm_operand(wt.to(device)), b.to(device)


def bound_s(idx: int, h: int, w: int) -> tuple:
    """(seconds, "operations" or "bytes"): the least time the card takes
    for the layer on one frame of h x w."""
    layer = QVRCNN_LAYERS[idx]
    px = h * w
    ops = 2 * layer.ksize ** 2 * layer.in_ch * layer.out_ch * px
    nbytes = px * layer.in_ch + layer.ksize ** 2 * layer.in_ch * layer.out_ch \
        + 4 * layer.out_ch + 4 * px * layer.out_ch
    t_ops, t_bytes = ops / PEAK_INT8_OPS, nbytes / PEAK_BYTES
    return (t_ops, "operations") if t_ops >= t_bytes else (t_bytes, "bytes")


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(prog="qcnn_gpu_tpu_torch.tools.bench_layer")
    ap.add_argument("--layer", default="C1", choices=LAYER_NAMES)
    ap.add_argument("--height", type=int, default=720)
    ap.add_argument("--width", type=int, default=1280)
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--iters", type=int, default=30)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("bench_layer times a CUDA GPU: no CUDA device")
    device = torch.device("cuda")
    idx = LAYER_NAMES.index(args.layer)
    layer = QVRCNN_LAYERS[idx]
    x, wop, b = layer_inputs(idx, args.batch, args.height, args.width, device)
    got = conv_int8(x, wop, b)
    if not torch.equal(got, conv_int8(x, wop, b, route="plain")):
        raise SystemExit(f"{args.layer}: the GEMM route differs from the plain convolution")
    torch.cuda.synchronize(device)
    t0 = time.perf_counter()
    for _ in range(args.iters):
        conv_int8(x, wop, b)
    torch.cuda.synchronize(device)
    dt = (time.perf_counter() - t0) / (args.iters * args.batch)
    macs = layer.ksize ** 2 * layer.in_ch * layer.out_ch * args.height * args.width
    bound, by = bound_s(idx, args.height, args.width)
    card = smi()
    print(f"{args.layer} {layer.ksize}x{layer.ksize} {layer.in_ch}->{layer.out_ch} "
          f"@{args.width}x{args.height}: {dt * 1e6:.0f} us/frame "
          f"({2 * macs / dt / 1e12:.1f} TFLOP/s)")
    print(f"  bound {bound * 1e6:.3f} us/frame ({by}), {bound / dt:.4f} of it reached; "
          f"exact against the plain convolution; [{card}]")
    return {"layer": args.layer, "us_per_frame": dt * 1e6, "bound_us_per_frame": bound * 1e6,
            "bound_by": by, "card": card}


if __name__ == "__main__":
    main()
