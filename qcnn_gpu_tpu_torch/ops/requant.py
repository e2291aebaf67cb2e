"""Exact integer requantization epilogues on torch tensors.

Counterpart of `qcnn_gpu_tpu/ops/requant.py` (and of `_requant_fast`,
`qcnn_gpu_tpu/ops/pallas_pipeline2.py:137`). The results equal the JAX
int32 versions bit for bit wherever those do not wrap, which the model
build guarantees (`normalize_mul_shift` + `check_blu_requant_i32_safe`).
Products are formed in int64 so that a lane a select later discards can
never wrap; each function returns the dtype of its accumulator input.

`blu_q`/`mul`/`shift` are Python ints or integer tensors that broadcast
against the accumulator (per-channel tables: a [C] vector for
channels-last, [C, 1, 1] for NCHW).

`bias_blu_requant_i8` is a hidden layer's bias add and BLU requant on the
card in one pass, the CUDA kernel `csrc/requant_epilogue.cu` (no Pallas
counterpart: the JAX package runs this epilogue as XLA elementwise ops);
`blu_requant_clamped_i32` of the biased accumulators is its plain version.

Two DIFFERENT rounding-bias placements, per the reference (do not unify):
  * BLU layers: bias PRE-multiply, integer-divided by mul (mat.cu:262-303)
  * final residual: bias POST-multiply, arithmetic (floor) shift
    (cnn.cu:507-523)
"""

from __future__ import annotations

import ctypes

import torch

from qcnn_gpu_tpu_torch.ops import build

THRESHOLD = 127


def normalize_mul_shift(mul: int, shift: int):
    """Strip common powers of two from a (mul, shift) pair — an exact
    identity for both rounding forms (see the JAX module's docstring for
    the proof). Brings power-of-two-heavy solver pairs (INT4: mul=2^25,
    shift=27) back into the int32 envelope without changing an output bit."""
    mul, shift = int(mul), int(shift)
    while mul >= 2 and mul % 2 == 0 and shift > 1:
        mul //= 2
        shift -= 1
    return mul, shift


def check_blu_requant_i32_safe(blu_q: int, mul: int, shift: int, name: str = "") -> None:
    """Raise unless the kept branch's largest product (blu_q + bias) * mul
    fits int32 — the envelope of the reference engine (mat.cu:262-303)."""
    bias = (1 << (shift - 1)) // mul if mul else 0
    prod = (int(blu_q) + bias) * int(mul)
    if prod >= 1 << 31:
        raise ValueError(
            f"requant table {name or ''} (blu_q={blu_q}, mul={mul}, "
            f"shift={shift}) needs {prod.bit_length()}-bit products; "
            "outside the int32 engine envelope even after mul/shift "
            "normalization — re-solve with a smaller shift"
        )


def _i64(v):
    return v.to(torch.int64) if isinstance(v, torch.Tensor) else int(v)


def blu_requant_i32(u: torch.Tensor, blu_q, mul, shift) -> torch.Tensor:
    """u accumulator -> int8-valued tensor in [0, 127]:
    u > blu_q -> 127; u < 0 -> 0; else ((u + (1<<(shift-1))//mul)*mul)>>shift."""
    u64 = u.to(torch.int64)
    blu_q, mul, shift = _i64(blu_q), _i64(mul), _i64(shift)
    bias = (1 << (shift - 1)) // mul
    mid = ((u64 + bias) * mul) >> shift
    out = torch.where(u64 > blu_q, THRESHOLD, torch.where(u64 < 0, 0, mid))
    return out.to(u.dtype)


def final_residual_i32(u: torch.Tensor, mul: int, shift: int) -> torch.Tensor:
    """res = (u*mul + (1<<(shift-1))) >> shift, arithmetic shift (floor)."""
    res = (u.to(torch.int64) * int(mul) + (1 << (int(shift) - 1))) >> int(shift)
    return res.to(u.dtype)


def apply_residual_u8(x_uint8: torch.Tensor, res: torch.Tensor) -> torch.Tensor:
    """rec = clamp(x + res, 0, 255) -> uint8."""
    rec = x_uint8.to(torch.int64) + res.to(torch.int64)
    return rec.clamp(0, 255).to(torch.uint8)


def mul_shift_i32(u: torch.Tensor, mul: int, shift: int) -> torch.Tensor:
    """Unfused static requant with PRE-multiply bias and int8 wrap — the
    `mul_shift` kernel (mat.cu:248-261). Returns int8-valued u.dtype."""
    bias = (1 << (int(shift) - 1)) // int(mul)
    out = ((u.to(torch.int64) + bias) * int(mul)) >> int(shift)
    return out.to(torch.int8).to(u.dtype)


def requant_fast(u_folded: torch.Tensor, blu_b, mul, shift) -> torch.Tensor:
    """Folded BLU + requant on u' = u + bias_pre with B = blu_q + bias_pre:

        min((clip(u', 0, B) * mul) >> shift, 127)

    equal to `blu_requant_i32(u, ...)` for every table whose clip bound
    maps to 127 (the solver's saturation window; proof at
    pallas_pipeline2._requant_fast). This is the epilogue the fused kernel
    runs after S1-S3."""
    u = u_folded.to(torch.int64).clamp(min=0)
    u = torch.minimum(u, torch.as_tensor(blu_b, dtype=torch.int64, device=u.device))
    out = torch.clamp((u * _i64(mul)) >> _i64(shift), max=THRESHOLD)
    return out.to(u_folded.dtype)


def blu_requant_clamped_i32(u: torch.Tensor, blu_q, mul, shift) -> torch.Tensor:
    """`blu_requant_i32` in int32 arithmetic, for an int32 accumulator u:
    u is clamped to [0, blu_q] before the product, so the largest product
    is (blu_q + bias) * mul, which `check_blu_requant_i32_safe` bounds
    below 2^31 (no int32 wrap is relied on). A clamped negative u gives
    (bias * mul) >> shift = 0, since bias * mul <= 2^(shift-1); u above
    blu_q gives 127. Returns int8. The rows are Python ints or int32
    tensors broadcasting against u (channels-last [C] vectors)."""
    if isinstance(mul, torch.Tensor):
        bias = torch.div(1 << (shift - 1), mul, rounding_mode="floor")
        mid = torch.minimum(u.clamp_min(0), blu_q)
    else:
        bias = (1 << (int(shift) - 1)) // int(mul)
        mid = u.clamp(0, int(blu_q))
    mid.add_(bias).mul_(mul).bitwise_right_shift_(shift)
    return mid.masked_fill_(u > blu_q, THRESHOLD).to(torch.int8)


# ---- the card's epilogue: csrc/requant_epilogue.cu ------------------------

KERNEL = "requant_epilogue"
THREADS = 256  # the kernel's block (csrc/requant_epilogue.cu)
VECTOR = 16  # channels a thread of its vector path owns
_ARGTYPES = (
    ctypes.c_void_p, ctypes.c_longlong, ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int,
    ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
    ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_void_p,
)


def row_stride(u: torch.Tensor) -> int:
    """u's row stride in elements, u seen as an [M, C] matrix (C =
    u.shape[-1]) whose channels are contiguous and whose rows lie ld >= C
    apart: a contiguous tensor (ld = C) or a `[..., :C]` view of a wider
    one. Raises ValueError for any other layout."""
    c = u.shape[-1]
    if c > 1 and u.stride(-1) != 1:
        raise ValueError(f"channels must be contiguous, got strides {u.stride()}")
    ld = nxt = None
    for size, stride in zip(reversed(u.shape[:-1]), reversed(u.stride()[:-1])):
        if size == 1:
            continue
        if ld is None:
            if stride < c:
                raise ValueError(f"rows {stride} apart overlap {c} channels")
            ld = stride
        elif stride != nxt:
            raise ValueError(f"not an [M, C] matrix of rows: shape {tuple(u.shape)}, "
                             f"strides {u.stride()}")
        nxt = stride * size
    return c if ld is None else ld


def vector_path(c: int, ld: int, u_ptr: int, out_ptr: int) -> bool:
    """Whether the kernel takes its vector path (16 channels a thread,
    16-byte loads and stores) for C = c, row stride ld and these addresses."""
    return (c % VECTOR == 0 and c // VECTOR <= THREADS and ld % 4 == 0
            and u_ptr % 16 == 0 and out_ptr % 16 == 0)


def bias_blu_requant_i8(u: torch.Tensor, b: torch.Tensor, blu_q, mul, shift) -> torch.Tensor:
    """`blu_requant_clamped_i32(u + b, blu_q, mul, shift)` in one pass:
    int32 accumulators u [..., C] (channels contiguous, rows any ld >= C
    apart: `row_stride`), an int32 bias b [C], and the rows as Python ints
    (one per layer) or [C] int32 tensors on u's device (one per channel)
    -> contiguous int8 [..., C].

    A CUDA tensor goes through the kernel `csrc/requant_epilogue.cu` (one
    launch on the current stream, counted in `bias_blu_requant_i8.launches`)
    or raises; it allocates only the output. A CPU tensor takes the plain
    version. Raises TypeError for a dtype, ValueError for a shape or a
    device the kernel does not take."""
    if u.dtype != torch.int32 or b.dtype != torch.int32:
        raise TypeError(f"int32 accumulators and bias, got {u.dtype}, {b.dtype}")
    if u.dim() == 0:
        raise ValueError("u needs a channel axis")
    c = u.shape[-1]
    if b.shape != (c,) or b.device != u.device or not b.is_contiguous():
        raise ValueError(f"bias {tuple(b.shape)} on {b.device} for {c} channels on {u.device}, "
                         "contiguous")
    rows = (blu_q, mul, shift)
    per_channel = [isinstance(r, torch.Tensor) for r in rows]
    if any(per_channel):
        if not all(per_channel) or any(
                r.dtype != torch.int32 or r.shape != (c,) or r.device != u.device
                or not r.is_contiguous() for r in rows):
            raise ValueError(f"per-channel rows are three contiguous int32 [{c}] tensors on "
                             f"{u.device}")
    ld = row_stride(u)
    if u.device.type == "cpu":
        return blu_requant_clamped_i32(u + b, blu_q, mul, shift)
    if u.device.type != "cuda":
        raise ValueError(f"no kernel for device {u.device}")
    out = torch.empty(u.shape, dtype=torch.int8, device=u.device)
    if u.numel() == 0:
        return out
    if any(per_channel):
        vecs, scalars = [r.data_ptr() for r in rows], (0, 1, 1)
    else:
        vecs, scalars = [None] * 3, tuple(int(r) for r in rows)
    vec = vector_path(c, ld, u.data_ptr(), out.data_ptr())
    fn = build.function(KERNEL, "requant_epilogue", _ARGTYPES)
    with torch.cuda.device(u.device):
        err = fn(u.data_ptr(), ld, out.data_ptr(), u.numel() // c, c, b.data_ptr(), *vecs,
                 *scalars, int(vec), build.stream_of(u))
    build.check(KERNEL, err)
    bias_blu_requant_i8.launches += 1
    return out


bias_blu_requant_i8.launches = 0
