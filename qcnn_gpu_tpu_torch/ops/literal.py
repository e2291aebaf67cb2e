"""The literal-requant kernel (generation 1): weights, wrapper and plain version.

Counterpart of `qcnn_gpu_tpu/ops/pallas_pipeline.py`. `literal_residual`
runs the network on uint8 frames in one launch of the hand-written CUDA
kernel `csrc/qvrcnn_literal.cu` (generation 3's split design, 24x40 tiles,
on `csrc/qvrcnn_split.cuh`) and returns the S4 residual as int16 [B, H,
W], clamped to +-255; S1-S3 end in the literal BLU chain (`_requant_vec`,
pallas_pipeline.py:117-119)

    u > blu_q -> 127;  u < 0 -> 0;  else ((u + bias_pre) * mul) >> shift

which, unlike the folded epilogue of ops/fused.py, is exact for every
table the engine accepts, inside the solver's saturation window or not.
`literal_forward` adds the residual with a torch elementwise step outside
the kernel, as the TPU version does in XLA (pallas_pipeline.py:344-347).
`literal_residual_reference` is the plain PyTorch version the kernel is
held against bit for bit.
"""

from __future__ import annotations

import ctypes
import dataclasses
from typing import Optional, Tuple

import numpy as np
import torch

from qcnn_gpu_tpu_torch.models.engine_params import EngineParams
from qcnn_gpu_tpu_torch.models.qvrcnn import MergedParams, conv_exact
from qcnn_gpu_tpu_torch.ops import build
from qcnn_gpu_tpu_torch.ops.fused import TILE_H, TILE_W, check_frames, split_operand
from qcnn_gpu_tpu_torch.ops.requant import THRESHOLD, apply_residual_u8, final_residual_i32

KERNEL = "qvrcnn_literal"
MAX_TILES_PER_LAUNCH = 2**31 - 1  # the kernel counts tiles in an int
RESIDUAL_CLAMP = 255
_ARGTYPES = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 6 + [ctypes.c_void_p]


def literal_refusal(mp: MergedParams) -> Optional[str]:
    """Why the literal kernel cannot compute this table, or None: a final
    mul above 127 (the TPU kernel's assert, pallas_pipeline.py:184-186),
    or a stage whose largest kept value ((blu_q + bias_pre) * mul) >> shift
    exceeds 255 (the kernel holds activations as unsigned bytes)."""
    if mp.mul4 > 127:
        return f"final mul {mp.mul4} too large for int32 requant"
    for i in range(3):
        blu, mul, bias_pre, shift = (x[i].numpy().astype(np.int64)
                                     for x in (mp.blu_q, mp.mul, mp.bias_pre, mp.shift))
        top = ((blu + bias_pre) * mul) >> shift
        if top.max() > 255:
            c = int(np.argmax(top))
            return (
                f"stage S{i + 1} channel {c}: the largest kept value "
                f"((blu_q + bias_pre) * mul) >> shift = {int(top[c])} exceeds 255, "
                "the range of the literal kernel's uint8 activations"
            )
    return None


@dataclasses.dataclass(frozen=True)
class LiteralWeights:
    """Everything the literal kernel reads, on one device (counterpart of
    PackedWeights, pallas_pipeline.py:52-114): the merged weights and
    their split image (`ops/fused.split_operand`, the kernel's B operand),
    and per S1..S3 channel the unfolded (b, blu_q, mul, bias_pre, shift);
    S4 keeps (b4, mul4, shift4).

    `from_engine` does not check the saturation window. It raises
    ValueError where the TPU kernel asserts mul4 <= 127
    (pallas_pipeline.py:184-186), and where a stage's largest kept value
    ((blu_q + bias_pre) * mul) >> shift exceeds 255: the kernel holds
    activations as unsigned bytes."""

    w: Tuple[torch.Tensor, ...]  # 4 merged int8 HWIO (plain version)
    split: torch.Tensor  # int8 [SPLIT_BYTES]: the kernel's weight image
    bias: Tuple[torch.Tensor, ...]  # 4 raw int32 biases (S4: [1])
    blu_q: Tuple[torch.Tensor, ...]  # S1..S3, int32 [C]
    mul: Tuple[torch.Tensor, ...]
    bias_pre: Tuple[torch.Tensor, ...]
    shift: Tuple[torch.Tensor, ...]
    b4: int
    mul4: int
    shift4: int
    vec: torch.Tensor  # int32 [800]: per stage [b | blu_q | mul | bias_pre | shift]

    @classmethod
    def from_engine(cls, p: EngineParams, device) -> "LiteralWeights":
        mp = MergedParams.from_engine(p, "cpu")
        why = literal_refusal(mp)
        if why is not None:
            raise ValueError(why)
        rows = [[x[i].numpy().astype(np.int64)
                 for x in (mp.b_i32, mp.blu_q, mp.mul, mp.bias_pre, mp.shift)]
                for i in range(3)]
        device = torch.device(device)
        as_t = lambda a, dt: torch.as_tensor(np.asarray(a, dt), device=device)  # noqa: E731
        w = [x.numpy() for x in mp.w_i8]
        return cls(
            w=tuple(as_t(x, np.int8) for x in w),
            split=as_t(split_operand(w), np.int8),
            bias=tuple(as_t(x.numpy(), np.int32) for x in mp.b_i32),
            blu_q=tuple(as_t(r[1], np.int32) for r in rows),
            mul=tuple(as_t(r[2], np.int32) for r in rows),
            bias_pre=tuple(as_t(r[3], np.int32) for r in rows),
            shift=tuple(as_t(r[4], np.int32) for r in rows),
            b4=int(mp.b_i32[3][0]),
            mul4=mp.mul4,
            shift4=mp.shift4,
            vec=as_t(np.concatenate([np.concatenate(r) for r in rows]), np.int32),
        )


def literal_residual_reference(x_u8: torch.Tensor, lw: LiteralWeights) -> torch.Tensor:
    """Plain PyTorch version of the kernel: uint8 [B, H, W] -> int16
    residual, clamped to +-255."""
    check_frames(x_u8, lw.vec.device)

    def ch(t):  # per-channel vector -> NCHW-broadcastable [C, 1, 1] int64
        return t.to(torch.int64).view(-1, 1, 1)

    v = x_u8.to(torch.int64)[:, None] - 128
    for i in range(3):
        u = conv_exact(v, lw.w[i], lw.bias[i])
        kept = ((u + ch(lw.bias_pre[i])) * ch(lw.mul[i])) >> ch(lw.shift[i])
        v = torch.where(u > ch(lw.blu_q[i]), THRESHOLD, torch.where(u < 0, 0, kept))
    res = final_residual_i32(conv_exact(v, lw.w[3], lw.bias[3]), lw.mul4, lw.shift4)[:, 0]
    return res.clamp(-RESIDUAL_CLAMP, RESIDUAL_CLAMP).to(torch.int16)


def literal_residual(x_u8: torch.Tensor, lw: LiteralWeights) -> torch.Tensor:
    """int16 residual [B, H, W] of uint8 frames [B, H, W].

    A CUDA tensor goes through the CUDA kernel (one launch on the current
    stream; counted in `literal_residual.launches`) or raises. A CPU tensor
    goes through `literal_residual_reference`."""
    check_frames(x_u8, lw.vec.device)
    if x_u8.device.type == "cpu":
        return literal_residual_reference(x_u8, lw)
    if x_u8.device.type != "cuda":
        raise ValueError(f"no kernel for device {x_u8.device}")
    b, h, w = x_u8.shape
    tiles = b * -(-h // TILE_H) * -(-w // TILE_W)
    if tiles > MAX_TILES_PER_LAUNCH:
        raise ValueError(f"at most {MAX_TILES_PER_LAUNCH} tiles per launch, got {tiles}")
    out = torch.empty(x_u8.shape, dtype=torch.int16, device=x_u8.device)
    if x_u8.numel() == 0:
        return out
    fn = build.function(KERNEL, "qvrcnn_literal_residual", _ARGTYPES)
    with torch.cuda.device(x_u8.device):
        err = fn(
            x_u8.data_ptr(), out.data_ptr(),
            lw.split.data_ptr(), lw.vec.data_ptr(),
            b, h, w, lw.b4, lw.mul4, lw.shift4, build.stream_of(x_u8),
        )
    build.check(KERNEL, err)
    literal_residual.launches += 1
    return out


literal_residual.launches = 0


def literal_forward(x_u8: torch.Tensor, lw: LiteralWeights) -> torch.Tensor:
    """Restored uint8 frames: clip(x + literal_residual(x), 0, 255)."""
    return apply_residual_u8(x_u8, literal_residual(x_u8, lw))


def literal_forward_reference(x_u8: torch.Tensor, lw: LiteralWeights) -> torch.Tensor:
    """Plain PyTorch version of `literal_forward`."""
    return apply_residual_u8(x_u8, literal_residual_reference(x_u8, lw))
