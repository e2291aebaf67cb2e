"""QVRCNN parameters and reference forward in PyTorch.

Counterpart of `qcnn_gpu_tpu/models/qvrcnn.py`. `ModelParams` (literal
6-conv graph) and `MergedParams` (branch-merged 4-conv graph) carry an
`EngineParams` (numpy: int8 HWIO weights, int32 biases, scalar or
per-channel quant rows) onto a torch device. The forward is the plain
PyTorch version of the network that the fused kernel (ops/fused.py) is
held against.

Exactness: the convolutions run in float64 on CPU and CUDA alike. Every
partial product is an integer <= 128*128 and every accumulator stays below
2^25 (`exactness_bounds`), far inside float64's 2^53 integer range, so a
direct or implicit-GEMM float64 convolution is exact; the result is
rounded before the int64 cast, so any cuDNN algorithm whose error stays
below 0.5 (FFT and Winograd included) gives the same integers. Epilogues
run in int64. int8 convolution has no CUDA path in torch, and float32
convolutions may go through TF32.

Layouts at the public functions follow the JAX package (NHWC activations,
HWIO weights, channels-last requant vectors) so that tests compare like
with like; the convolutions themselves run NCHW/OIHW.
"""

from __future__ import annotations

import dataclasses
from typing import List, Optional, Tuple, Union

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from qcnn_gpu_tpu_torch.models.engine_params import EngineParams
from qcnn_gpu_tpu_torch.models.topology import QVRCNN_LAYERS
from qcnn_gpu_tpu_torch.ops.requant import (
    apply_residual_u8,
    blu_requant_i32,
    check_blu_requant_i32_safe,
    final_residual_i32,
    normalize_mul_shift,
)

Row = Union[int, torch.Tensor]  # scalar quant row, or a [C] int64 vector


def exactness_bounds(p: EngineParams) -> List[int]:
    """Per-layer worst-case |accumulator|: max over output channels of
    sum(|w|) * in_amax + |b| (in_amax 128 for C1's x-128 input, 127 for
    BLU-fed layers)."""
    bounds = []
    for i, layer in enumerate(QVRCNN_LAYERS):
        in_amax = 128 if layer.input == "input" else 127
        w_l1 = np.abs(p.weights[i].astype(np.int64)).sum(axis=(0, 1, 2))
        bound = int(np.max(w_l1 * in_amax + np.abs(p.biases[i].astype(np.int64))))
        bounds.append(bound)
    return bounds


def _normalized_table(p: EngineParams):
    """Per-layer (mul, shift) with common powers of two stripped (exact),
    then range-checked so no int32 requant of the engine can wrap: BLU
    layers against their clamped product, the final layer against its
    worst-case accumulator bound. Raises ValueError like the JAX version."""
    muls, shifts = [], []
    for i in range(6):
        if np.ndim(p.mul[i]) or np.ndim(p.shift[i]):
            mv, sv = np.broadcast_arrays(
                np.asarray(p.mul[i], np.int64), np.asarray(p.shift[i], np.int64)
            )
            bv = np.broadcast_to(np.asarray(p.blu_q[i], np.int64), mv.shape)
            pairs = [normalize_mul_shift(m, s) for m, s in zip(mv, sv)]
            m = np.asarray([q[0] for q in pairs], np.int64)
            s = np.asarray([q[1] for q in pairs], np.int64)
            if i < 5:
                for c in range(len(m)):
                    check_blu_requant_i32_safe(
                        bv[c], m[c], s[c], name=f"layer {i} ch {c}"
                    )
        else:
            m, s = normalize_mul_shift(p.mul[i], p.shift[i])
            if i < 5:
                check_blu_requant_i32_safe(p.blu_q[i], m, s, name=f"layer {i}")
        muls.append(m)
        shifts.append(s)
    bound5 = exactness_bounds(p)[5]
    if bound5 * muls[5] + (1 << (shifts[5] - 1)) >= 1 << 31:
        raise ValueError(
            f"final requant (mul={muls[5]}, shift={shifts[5]}) can wrap "
            f"int32 at accumulator bound {bound5}; re-solve with a smaller shift"
        )
    return tuple(muls), tuple(shifts)


def _row(v, device) -> Row:
    """Scalar rows stay Python ints; per-channel rows become int64 tensors."""
    if np.ndim(v):
        return torch.as_tensor(np.asarray(v, np.int64), device=device)
    return int(v)


@dataclasses.dataclass(frozen=True)
class ModelParams:
    """The literal 6-conv graph's parameters on `device`: int8 HWIO
    weights, int32 biases, and per-layer quant rows after normalization."""

    weights_i8: Tuple[torch.Tensor, ...]
    biases_i32: Tuple[torch.Tensor, ...]
    blu_q: Tuple[Row, ...]
    mul: Tuple[Row, ...]
    shift: Tuple[Row, ...]
    device: torch.device

    @classmethod
    def from_engine(cls, p: EngineParams, device) -> "ModelParams":
        p.validate()
        device = torch.device(device)
        mul, shift = _normalized_table(p)
        return cls(
            weights_i8=tuple(
                torch.as_tensor(np.asarray(w, np.int8), device=device) for w in p.weights
            ),
            biases_i32=tuple(
                torch.as_tensor(np.asarray(b, np.int32), device=device) for b in p.biases
            ),
            blu_q=tuple(_row(v, device) for v in p.blu_q),
            mul=tuple(_row(v, device) for v in mul),
            shift=tuple(_row(v, device) for v in shift),
            device=device,
        )


@dataclasses.dataclass(frozen=True)
class MergedParams:
    """Branch-merged parameters on `device`: each concat stage's two convs
    fused into one by zero-padding the smaller kernel and stacking output
    channels in concat order (bit-identical: padded taps add exact zeros).

      S1: 5x5x 1->64  (C1)
      S2: 5x5x64->48  (C2_1 3x3 zero-padded to 5x5 | C2_2)
      S3: 3x3x48->48  (C3_1 | C3_2 1x1 zero-padded to 3x3)
      S4: 3x3x48->1   (C4)

    Requant rows become per-output-channel int32 vectors [C]."""

    w_i8: Tuple[torch.Tensor, ...]  # 4 int8 HWIO
    b_i32: Tuple[torch.Tensor, ...]  # 4 int32 [Cout]
    blu_q: Tuple[torch.Tensor, ...]  # stages 1..3, int32 [C]
    mul: Tuple[torch.Tensor, ...]
    bias_pre: Tuple[torch.Tensor, ...]  # (1<<(shift-1))//mul
    shift: Tuple[torch.Tensor, ...]
    mul4: int
    shift4: int
    device: torch.device

    @classmethod
    def from_engine(cls, p: EngineParams, device) -> "MergedParams":
        p.validate()
        device = torch.device(device)

        def pad_kernel(w: np.ndarray, k_to: int) -> np.ndarray:
            r = (k_to - w.shape[0]) // 2
            return np.pad(w, ((r, r), (r, r), (0, 0), (0, 0)))

        w = [np.asarray(x, dtype=np.int8) for x in p.weights]
        b = [np.asarray(x, dtype=np.int32) for x in p.biases]
        ws = [
            w[0],
            np.concatenate([pad_kernel(w[1], 5), w[2]], axis=3),
            np.concatenate([w[3], pad_kernel(w[4], 3)], axis=3),
            w[5],
        ]
        bs = [b[0], np.concatenate([b[1], b[2]]), np.concatenate([b[3], b[4]]), b[5]]
        n_mul, n_shift = _normalized_table(p)

        def vec(idx_pairs):
            blu, mul, bias, shift = [], [], [], []
            for idx, nch in idx_pairs:
                bq = np.broadcast_to(np.asarray(p.blu_q[idx], np.int64), (nch,))
                m = np.broadcast_to(np.asarray(n_mul[idx], np.int64), (nch,))
                s = np.broadcast_to(np.asarray(n_shift[idx], np.int64), (nch,))
                blu += list(bq)
                mul += list(m)
                bias += list((1 << (s - 1)) // m)
                shift += list(s)
            return tuple(
                torch.as_tensor(np.asarray(v, np.int32), device=device)
                for v in (blu, mul, bias, shift)
            )

        v = [vec([(0, 64)]), vec([(1, 32), (2, 16)]), vec([(3, 16), (4, 32)])]
        return cls(
            w_i8=tuple(torch.as_tensor(x, device=device) for x in ws),
            b_i32=tuple(torch.as_tensor(x, device=device) for x in bs),
            blu_q=tuple(s[0] for s in v),
            mul=tuple(s[1] for s in v),
            bias_pre=tuple(s[2] for s in v),
            shift=tuple(s[3] for s in v),
            mul4=int(n_mul[5]),
            shift4=int(n_shift[5]),
            device=device,
        )


# torch's float64 convolution on the CPU unfolds its whole input first
# (im2col: cin * k * k * 8 B per output pixel, 12,800 B for C2, 26.5 GB for
# one 1080p frame); conv_exact bounds that buffer by convolving row bands
CPU_UNFOLD_BYTES = 1 << 28


def conv_exact(x: torch.Tensor, w_hwio: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Integer SAME cross-correlation + bias: x NCHW (integer-valued, any
    dtype), w int8 HWIO -> int64 NCHW accumulators, through float64. On
    the CPU, one frame's row band at a time, each unfolding at most
    CPU_UNFOLD_BYTES."""
    k = w_hwio.shape[0]
    w = w_hwio.to(torch.float64).permute(3, 2, 0, 1).contiguous()  # OIHW
    bias = b.to(torch.int64).view(1, -1, 1, 1)
    n, cin, h, wd = x.shape
    rows = max(1, CPU_UNFOLD_BYTES // (cin * k * k * 8 * wd))
    if x.device.type != "cpu" or n * h <= rows:
        return torch.round(F.conv2d(x.to(torch.float64), w, padding=k // 2)).to(torch.int64) + bias
    p = k // 2
    xp = F.pad(x, (p, p, p, p))
    out = torch.empty((n, w.shape[0], h, wd), dtype=torch.int64)
    for i in range(n):
        for r0 in range(0, h, rows):
            r1 = min(h, r0 + rows)
            u = F.conv2d(xp[i:i + 1, :, r0:r1 + 2 * p].to(torch.float64), w)
            out[i:i + 1, :, r0:r1] = torch.round(u).to(torch.int64)
    return out + bias


def _chan(v: Row) -> Row:
    """A channels-last [C] quant vector as an NCHW-broadcastable [C,1,1]."""
    return v.to(torch.int64).view(-1, 1, 1) if isinstance(v, torch.Tensor) else v


def _valid_mask(row_valid, col_valid):
    """Stage-output mask from optional [H] row / [W] col validity vectors,
    applied to NCHW activations."""
    if row_valid is None and col_valid is None:
        return lambda v: v
    m = None
    if row_valid is not None:
        m = row_valid.view(1, 1, -1, 1)
    if col_valid is not None:
        cv = col_valid.view(1, 1, 1, -1)
        m = cv if m is None else (m & cv)
    return lambda v: torch.where(m, v, torch.zeros((), dtype=v.dtype, device=v.device))


def residual_blu_merged(
    x_ppro: torch.Tensor,
    mp: MergedParams,
    row_valid: Optional[torch.Tensor] = None,
    col_valid: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """Merged-stage core: x_ppro [N, H, W, 1] (= x_uint8 - 128) -> int64
    residual [N, H, W]. row_valid [H] / col_valid [W] mark rows/cols inside
    the frame: the input and every stage output are zeroed outside, which
    is per-layer SAME padding at a frame edge inside the array."""
    mask = _valid_mask(row_valid, col_valid)

    def requant(u, i):
        return mask(
            blu_requant_i32(u, _chan(mp.blu_q[i]), _chan(mp.mul[i]), _chan(mp.shift[i]))
        )

    v = mask(x_ppro.to(torch.int64).permute(0, 3, 1, 2))
    for i in range(3):
        v = requant(conv_exact(v, mp.w_i8[i], mp.b_i32[i]), i)
    u4 = conv_exact(v, mp.w_i8[3], mp.b_i32[3])
    return final_residual_i32(u4, mp.mul4, mp.shift4)[:, 0]


# the accumulators residual_blu's collector keeps, in layer order (the
# oracle's forward_blu intermediates, oracle.py:250-262)
U_NAMES = ("u1", "u2_1", "u2_2", "u3_1", "u3_2", "u4")


def residual_blu(
    x_ppro: torch.Tensor,
    mp: ModelParams,
    row_valid: Optional[torch.Tensor] = None,
    col_valid: Optional[torch.Tensor] = None,
    collect: Optional[dict] = None,
) -> torch.Tensor:
    """The literal 6-conv/2-concat core: x_ppro [N, H, W, 1] -> int64
    residual [N, H, W], masked as residual_blu_merged. With a `collect`
    dict, it also keeps the intermediates as int64 NCHW tensors: the
    accumulators U_NAMES and the requantized v1, conc1 and conc2."""
    mask = _valid_mask(row_valid, col_valid)

    def conv(v, i):
        u = conv_exact(v, mp.weights_i8[i], mp.biases_i32[i])
        if collect is not None:
            collect[U_NAMES[i]] = u
        return u

    def layer(v, i):
        u = conv(v, i)
        return mask(
            blu_requant_i32(u, _chan(mp.blu_q[i]), _chan(mp.mul[i]), _chan(mp.shift[i]))
        )

    v1 = layer(mask(x_ppro.to(torch.int64).permute(0, 3, 1, 2)), 0)
    conc1 = torch.cat([layer(v1, 1), layer(v1, 2)], dim=1)
    conc2 = torch.cat([layer(conc1, 3), layer(conc1, 4)], dim=1)
    u4 = conv(conc2, 5)
    if collect is not None:
        collect.update(v1=v1, conc1=conc1, conc2=conc2)
    return final_residual_i32(u4, mp.mul[5], mp.shift[5])[:, 0]


def forward_blu(x_uint8: torch.Tensor, mp: ModelParams) -> torch.Tensor:
    """The production static-fused pipeline, literal graph: uint8 [N,H,W]."""
    x = x_uint8[..., None].to(torch.int64) - 128  # ppro (cnn.cu:449)
    return apply_residual_u8(x_uint8, residual_blu(x, mp))


class QVRCNN(nn.Module):
    """The reference network as a module: uint8 [N, H, W] -> uint8.

    `params` is the container it was built from, on `device`, which is
    fixed at construction; its tensors are also registered as buffers
    (integers, never trained here) so that `state_dict` carries them.
    merged=False runs the literal 6-conv graph."""

    def __init__(self, p: EngineParams, merged: bool = True, *, device):
        super().__init__()
        self.merged = merged
        self.params = (MergedParams if merged else ModelParams).from_engine(p, device)
        for f in dataclasses.fields(self.params):
            val = getattr(self.params, f.name)
            for j, t in enumerate(val if isinstance(val, tuple) else ()):
                if isinstance(t, torch.Tensor):
                    self.register_buffer(f"{f.name}_{j}", t)

    def forward(self, x_uint8: torch.Tensor) -> torch.Tensor:
        if not self.merged:
            return forward_blu(x_uint8, self.params)
        x = x_uint8[..., None].to(torch.int64) - 128
        return apply_residual_u8(x_uint8, residual_blu_merged(x, self.params))


def make_forward(p: EngineParams, device, merged: bool = True):
    """fn(uint8 tensor [N,H,W] on `device`) -> restored uint8 tensor,
    through the reference network (float64-exact convolutions)."""
    model = QVRCNN(p, merged=merged, device=device)

    @torch.no_grad()
    def run(x_uint8: torch.Tensor) -> torch.Tensor:
        return model(x_uint8)

    run.model = model
    run.impl = "reference"
    run.merged = merged
    return run
