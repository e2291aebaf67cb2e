"""The fused whole-network kernel: weights, wrapper and plain version.

Counterpart of `qcnn_gpu_tpu/ops/pallas_pipeline3.py`. `fused_forward`
runs the whole QVRCNN (S1..S4 + residual add) on uint8 frames in one
launch of the hand-written CUDA kernel `csrc/qvrcnn_fused.cu`;
`fused_forward_reference` is the plain PyTorch version of the same
function, with the same folded epilogue and frame-bounds masking, that
the kernel is held against bit for bit.

Frame bounds `[row_lo, row_hi) x [col_lo, col_hi)` (default the whole
frame) stand in for the JAX kernel's `row_bounds`/`col_bounds`
(pallas_pipeline3.py:750-755): input pixels outside read as 0 in the
x-128 domain, and every stage output outside is zeroed — per-layer SAME
padding at a frame edge that lies inside the array, as a halo-extended
spatial shard needs.
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
from qcnn_gpu_tpu_torch.ops.requant import (
    apply_residual_u8,
    final_residual_i32,
    requant_fast,
)

KERNEL = "qvrcnn_fused"
MAX_FRAMES_PER_LAUNCH = 65535  # gridDim.z


def mma_b_fragments(w_hwio: np.ndarray) -> np.ndarray:
    """int8 HWIO [k, k, Cin, Cout] -> the kernel's B operand: flat int8 in
    `mma.m16n8k32` fragment order [kc, nt, lane, 8].

    The stage GEMM is W[kk, n] = w[dy, dx, ch, n] with kk = (dy*k + dx)*Cin
    + ch (the HWIO flattening), zero-padded to K = 32*KC rows and N = 8*NT
    columns. Lane (g = lane>>2, t = lane&3) of k-chunk kc, n-tile nt holds
    b0 = W[kc*32 + t*4 + 0..3, nt*8 + g] and b1 = the same at +16 rows."""
    k, _, cin, cout = w_hwio.shape
    kk = k * k * cin
    kc, nt = -(-kk // 32), -(-cout // 8)
    wp = np.zeros((kc * 32, nt * 8), np.int8)
    wp[:kk, :cout] = np.asarray(w_hwio, np.int8).reshape(kk, cout)
    # [kc, h, t, j, nt, g] -> [kc, nt, g, t, h, j]
    frag = wp.reshape(kc, 2, 4, 4, nt, 8).transpose(0, 4, 5, 2, 1, 3)
    return np.ascontiguousarray(frag).reshape(-1)


@dataclasses.dataclass(frozen=True)
class FusedWeights:
    """Everything the fused kernel reads, on one device (counterpart of
    PackedWeights3, pallas_pipeline3.py:75-169).

    The per-channel int32 vectors are folded as the TPU kernel folds them:
    bias b' = b + bias_pre and bound B = blu_q + bias_pre for S1..S3
    (pallas_pipeline3.py:117-131, :153-159), with mul and shift. S4 keeps
    its raw bias and the final (mul4, shift4). `from_engine` raises
    ValueError for a table whose bound does not requantize to 127, where
    the fold would differ from the literal BLU."""

    w: Tuple[torch.Tensor, ...]  # 4 merged int8 HWIO (plain version)
    frag: Tuple[torch.Tensor, ...]  # 4 int8 B operands in fragment order
    bias: Tuple[torch.Tensor, ...]  # S1..S3 folded b' [C], S4 raw b [1], int32
    bound: Tuple[torch.Tensor, ...]  # S1..S3 B [C], int32
    mul: Tuple[torch.Tensor, ...]
    shift: Tuple[torch.Tensor, ...]
    b4: int
    mul4: int
    shift4: int
    vec: torch.Tensor  # int32 [640]: per stage [b' | B | mul | shift]

    @classmethod
    def from_engine(cls, p: EngineParams, device="cpu") -> "FusedWeights":
        mp = MergedParams.from_engine(p, "cpu")
        device = torch.device(device)
        w = [x.numpy() for x in mp.w_i8]
        bias, bound, mul, shift = [], [], [], []
        for i in range(3):
            bp = mp.bias_pre[i].numpy().astype(np.int64)
            bias.append(mp.b_i32[i].numpy().astype(np.int64) + bp)
            bound.append(mp.blu_q[i].numpy().astype(np.int64) + bp)
            mul.append(mp.mul[i].numpy())
            shift.append(mp.shift[i].numpy())
            # The folded epilogue equals the literal BLU only when the clip
            # bound requantizes to exactly 127 (pallas_pipeline2._requant_fast):
            # below, u > blu_q would give less than 127; above, u <= blu_q
            # could give more than the folded min(., 127) lets through.
            top = (bound[i] * mul[i].astype(np.int64)) >> shift[i].astype(np.int64)
            off = np.flatnonzero(top != 127)
            if off.size:
                c = int(off[0])
                raise ValueError(
                    f"stage S{i + 1} channel {c}: (blu_q + bias_pre) * mul >> shift "
                    f"= {int(top[c])}, not 127 (blu_q={int(mp.blu_q[i][c])}, "
                    f"mul={int(mul[i][c])}, shift={int(shift[i][c])}); the folded "
                    "requant of the fused kernel is exact only inside the "
                    "solver's saturation window"
                )
        bias.append(mp.b_i32[3].numpy())
        vec = np.concatenate(
            [np.concatenate([bias[i], bound[i], mul[i], shift[i]]) for i in range(3)]
        )
        as_t = lambda a, dt: torch.as_tensor(np.asarray(a, dt), device=device)  # noqa: E731
        return cls(
            w=tuple(as_t(x, np.int8) for x in w),
            frag=tuple(as_t(mma_b_fragments(x), np.int8) for x in w),
            bias=tuple(as_t(x, np.int32) for x in bias),
            bound=tuple(as_t(x, np.int32) for x in bound),
            mul=tuple(as_t(x, np.int32) for x in mul),
            shift=tuple(as_t(x, np.int32) for x in shift),
            b4=int(bias[3][0]),
            mul4=mp.mul4,
            shift4=mp.shift4,
            vec=as_t(vec, np.int32),
        )


def _bounds(h: int, w: int, row_lo, row_hi, col_lo, col_hi):
    row_hi = h if row_hi is None else row_hi
    col_hi = w if col_hi is None else col_hi
    return int(row_lo), int(row_hi), int(col_lo), int(col_hi)


def check_frames(x_u8: torch.Tensor, weights_device: torch.device) -> None:
    """Raise unless x_u8 is a contiguous uint8 [B, H, W] tensor on the
    weights' device."""
    if not isinstance(x_u8, torch.Tensor):
        raise TypeError(f"expected a torch.Tensor, got {type(x_u8).__name__}")
    if x_u8.dtype != torch.uint8 or x_u8.dim() != 3:
        raise ValueError(
            f"expected uint8 frames [B, H, W], got {x_u8.dtype} {tuple(x_u8.shape)}"
        )
    if not x_u8.is_contiguous():
        raise ValueError("frames must be contiguous")
    if x_u8.device != weights_device:
        raise ValueError(f"frames on {x_u8.device} but weights on {weights_device}")


def fused_forward_reference(
    x_u8: torch.Tensor,
    fw: FusedWeights,
    row_lo: int = 0,
    row_hi: Optional[int] = None,
    col_lo: int = 0,
    col_hi: Optional[int] = None,
) -> torch.Tensor:
    """Plain PyTorch version of the kernel: uint8 [B, H, W] -> uint8."""
    check_frames(x_u8, fw.vec.device)
    b, h, w = x_u8.shape
    row_lo, row_hi, col_lo, col_hi = _bounds(h, w, row_lo, row_hi, col_lo, col_hi)
    rows = torch.arange(h, device=x_u8.device)
    cols = torch.arange(w, device=x_u8.device)
    inside = (((rows >= row_lo) & (rows < row_hi))[:, None]
              & ((cols >= col_lo) & (cols < col_hi))[None, :])

    def mask(v):
        return torch.where(inside, v, torch.zeros((), dtype=v.dtype, device=v.device))

    def ch(t):  # per-channel vector -> NCHW-broadcastable [C, 1, 1]
        return t.view(-1, 1, 1)

    v = mask(x_u8.to(torch.int64) - 128)[:, None]  # [B, 1, H, W]
    for i in range(3):
        u = conv_exact(v, fw.w[i], fw.bias[i])
        v = mask(requant_fast(u, ch(fw.bound[i]), ch(fw.mul[i]), ch(fw.shift[i])))
    u4 = conv_exact(v, fw.w[3], fw.bias[3])
    res = final_residual_i32(u4, fw.mul4, fw.shift4)[:, 0]
    return apply_residual_u8(x_u8, res)


_ARGTYPES = [ctypes.c_void_p] * 7 + [ctypes.c_int] * 10 + [ctypes.c_void_p]


def fused_forward(
    x_u8: torch.Tensor,
    fw: FusedWeights,
    row_lo: int = 0,
    row_hi: Optional[int] = None,
    col_lo: int = 0,
    col_hi: Optional[int] = None,
) -> torch.Tensor:
    """Restore uint8 frames [B, H, W] through the fused network.

    A CUDA tensor goes through the CUDA kernel (one launch on the current
    stream; counted in `fused_forward.launches`) or raises. A CPU tensor
    goes through `fused_forward_reference`, the kernel's plain version."""
    check_frames(x_u8, fw.vec.device)
    if x_u8.device.type == "cpu":
        return fused_forward_reference(x_u8, fw, row_lo, row_hi, col_lo, col_hi)
    if x_u8.device.type != "cuda":
        raise ValueError(f"no kernel for device {x_u8.device}")
    b, h, w = x_u8.shape
    if b > MAX_FRAMES_PER_LAUNCH:
        raise ValueError(f"at most {MAX_FRAMES_PER_LAUNCH} frames per launch, got {b}")
    row_lo, row_hi, col_lo, col_hi = _bounds(h, w, row_lo, row_hi, col_lo, col_hi)
    out = torch.empty_like(x_u8)
    if x_u8.numel() == 0:
        return out
    fn = build.function(KERNEL, "qvrcnn_fused_forward", _ARGTYPES)
    with torch.cuda.device(x_u8.device):
        err = fn(
            x_u8.data_ptr(), out.data_ptr(),
            *(t.data_ptr() for t in fw.frag), fw.vec.data_ptr(),
            b, h, w, row_lo, row_hi, col_lo, col_hi,
            fw.b4, fw.mul4, fw.shift4, build.stream_of(x_u8),
        )
    build.check(KERNEL, err)
    fused_forward.launches += 1
    return out


fused_forward.launches = 0
