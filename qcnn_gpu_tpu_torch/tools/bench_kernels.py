"""Time the three generations of the fused-network kernel on one CUDA GPU.

    python -m qcnn_gpu_tpu_torch.tools.bench_kernels [--model PATH] [--format vect_c]

Counterpart of `scripts/bench_pallas.py` and `scripts/profile_pallas.py`,
and the entry point of generation 1. For each generation

  v1  ops/literal.literal_forward   literal BLU chain, int16 residual, add outside
  v2  ops/pair.pair_forward         frame pairs, folded epilogue
  v3  ops/fused.fused_forward       one frame per block, folded epilogue

it checks exactness on a small frame (2x37x53, seeded) against the plain
version, then times ms/frame at 1920x1080 batch 4 with CUDA events, and
prints one line each with the card's name and power limit. v2 and v3
need a table inside the solver's saturation window (every committed
model is); v1 takes any table.

`profile_pallas.py`'s row-tile (th) sweep and XLA-prep timing measure TPU
layout knobs and the XLA window gather in front of the Pallas call; the
port's kernels have no tile knob yet and read the frame directly, so
neither has a counterpart here.
"""

from __future__ import annotations

import argparse
import os

import numpy as np
import torch

from qcnn_gpu_tpu_torch.engine.runner import read_model
from qcnn_gpu_tpu_torch.ops.fused import FusedWeights, fused_forward, fused_forward_reference
from qcnn_gpu_tpu_torch.ops.literal import (
    LiteralWeights,
    literal_forward,
    literal_forward_reference,
)
from qcnn_gpu_tpu_torch.ops.pair import pair_forward, pair_forward_reference
from qcnn_gpu_tpu_torch.tools import events_ms, smi

_REPO = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
MODEL = os.path.join(_REPO, "assets", "golden", "model_q37.data")
H, W, BATCH, REPS = 1080, 1920, 4, 20


def generations(p, device):
    """name -> (kernel fn, plain fn), each uint8 [B, H, W] -> uint8."""
    fw = FusedWeights.from_engine(p, device)
    lw = LiteralWeights.from_engine(p, device)
    return {
        "v1": (lambda x: literal_forward(x, lw),
               lambda x: literal_forward_reference(x, lw)),
        "v2": (lambda x: pair_forward(x, fw), lambda x: pair_forward_reference(x, fw)),
        "v3": (lambda x: fused_forward(x, fw), lambda x: fused_forward_reference(x, fw)),
    }


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--model", default=MODEL)
    ap.add_argument("--format", default="vect_c", choices=["vect_c", "hwcn", "pc"])
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise RuntimeError("this benchmark needs a CUDA GPU")
    dev = torch.device("cuda")
    card = smi()
    rng = np.random.default_rng(0)
    small = torch.from_numpy(rng.integers(0, 256, (2, 37, 53), dtype=np.uint8)).to(dev)
    big = torch.from_numpy(rng.integers(0, 256, (BATCH, H, W), dtype=np.uint8)).to(dev)
    for name, (kernel, plain) in generations(read_model(args.model, args.format), dev).items():
        got = kernel(small)
        torch.cuda.synchronize()
        err = int((got.to(torch.int16) - plain(small).to(torch.int16)).abs().max())
        if err:
            raise RuntimeError(f"{name}: kernel differs from its plain version by {err}")
        kernel(big)
        ms = events_ms(lambda: kernel(big), REPS) / BATCH
        print(f"{name}: exact (2x37x53); {ms:.4f} ms/frame at {W}x{H} batch {BATCH} [{card}]")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
