"""The frame-pair kernel (generation 2): wrapper and plain version.

Counterpart of `qcnn_gpu_tpu/ops/pallas_pipeline2.py`. `pair_forward` runs
the whole QVRCNN (S1..S4 + residual add) on uint8 frames in one launch of
the hand-written CUDA kernel `csrc/qvrcnn_pair.cu`, one block per (frame
pair, 16x16 tile): every weight fragment it loads feeds both frames. It
computes the function of the one-frame kernel (ops/fused.py) with the
same folded epilogue, so it takes the same `FusedWeights`, which refuse a
table outside the solver's saturation window. Odd batches run their last
frame alone. The whole frame is valid (no frame bounds), as in the TPU
version.
"""

from __future__ import annotations

import ctypes

import torch

from qcnn_gpu_tpu_torch.ops import build
from qcnn_gpu_tpu_torch.ops.fused import FusedWeights, check_frames, fused_forward_reference

KERNEL = "qvrcnn_pair"
MAX_FRAMES_PER_LAUNCH = 2 * 65535  # gridDim.z pairs
_ARGTYPES = [ctypes.c_void_p] * 7 + [ctypes.c_int] * 6 + [ctypes.c_void_p]


def pair_forward_reference(x_u8: torch.Tensor, fw: FusedWeights) -> torch.Tensor:
    """Plain PyTorch version: uint8 [B, H, W] -> uint8. Pairing frames
    changes which loads are shared, not the arithmetic, so this is the
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
    if b > MAX_FRAMES_PER_LAUNCH:
        raise ValueError(f"at most {MAX_FRAMES_PER_LAUNCH} frames per launch, got {b}")
    out = torch.empty_like(x_u8)
    if x_u8.numel() == 0:
        return out
    fn = build.function(KERNEL, "qvrcnn_pair_forward", _ARGTYPES)
    with torch.cuda.device(x_u8.device):
        err = fn(
            x_u8.data_ptr(), out.data_ptr(),
            *(t.data_ptr() for t in fw.frag), fw.vec.data_ptr(),
            b, h, w, fw.b4, fw.mul4, fw.shift4, build.stream_of(x_u8),
        )
    build.check(KERNEL, err)
    pair_forward.launches += 1
    return out


pair_forward.launches = 0
