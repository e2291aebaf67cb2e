"""The frame-pair kernel (generation 2): wrapper and plain version.

Counterpart of `qcnn_gpu_tpu/ops/pallas_pipeline2.py`. `pair_forward` runs
the whole QVRCNN (S1..S4 + residual add) on uint8 frames in one launch of
the hand-written CUDA kernel `csrc/qvrcnn_pair.cu`, generation 3's split
design (`csrc/qvrcnn_split.cuh`) on frame pairs: a persistent block
computes the 24x40 tile of one frame of a pair, then of the other. It
computes the function of the one-frame kernel (ops/fused.py) with the
same folded epilogue, so it takes the same `FusedWeights`, which refuse a
table outside the solver's saturation window. An odd batch's last frame
runs alone. The whole frame is valid (no frame bounds), as in the TPU
version.
"""

from __future__ import annotations

import ctypes

import torch

from qcnn_gpu_tpu_torch.ops import build
from qcnn_gpu_tpu_torch.ops.fused import (
    TILE_H,
    TILE_W,
    FusedWeights,
    check_frames,
    fused_forward_reference,
)

KERNEL = "qvrcnn_pair"
MAX_ITEMS_PER_LAUNCH = 2**31 - 1  # the kernel counts (pair, tile) items in an int
_ARGTYPES = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 6 + [ctypes.c_void_p]


def pair_forward_reference(x_u8: torch.Tensor, fw: FusedWeights) -> torch.Tensor:
    """Plain PyTorch version: uint8 [B, H, W] -> uint8. Pairing frames
    changes which tiles run together, not the arithmetic, so this is the
    one-frame plain version over the whole frame."""
    check_frames(x_u8, fw.vec.device)
    return fused_forward_reference(x_u8, fw)


def pair_forward(x_u8: torch.Tensor, fw: FusedWeights) -> torch.Tensor:
    """Restore uint8 frames [B, H, W] two at a time.

    A CUDA tensor goes through the CUDA kernel (one launch on the current
    stream; counted in `pair_forward.launches`) or raises. A CPU tensor
    goes through `pair_forward_reference`."""
    check_frames(x_u8, fw.vec.device)
    if x_u8.device.type == "cpu":
        return pair_forward_reference(x_u8, fw)
    if x_u8.device.type != "cuda":
        raise ValueError(f"no kernel for device {x_u8.device}")
    b, h, w = x_u8.shape
    items = -(-b // 2) * -(-h // TILE_H) * -(-w // TILE_W)
    if items > MAX_ITEMS_PER_LAUNCH:
        raise ValueError(f"at most {MAX_ITEMS_PER_LAUNCH} work items per launch, got {items}")
    out = torch.empty_like(x_u8)
    if x_u8.numel() == 0:
        return out
    fn = build.function(KERNEL, "qvrcnn_pair_forward", _ARGTYPES)
    with torch.cuda.device(x_u8.device):
        err = fn(
            x_u8.data_ptr(), out.data_ptr(), fw.split.data_ptr(), fw.vec.data_ptr(),
            b, h, w, fw.b4, fw.mul4, fw.shift4, build.stream_of(x_u8),
        )
    build.check(KERNEL, err)
    pair_forward.launches += 1
    return out


pair_forward.launches = 0
