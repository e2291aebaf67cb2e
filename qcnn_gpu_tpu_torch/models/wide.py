"""The wide (EDSR-scale) restoration CNN: the port's counterpart of
`qcnn_gpu_tpu/models/wide.py` (:36-364).

Topology (configurable): a 3x3 head conv 1->C, `blocks` 3x3 convs C->C and
a 3x3 tail conv C->1; every hidden layer ends in QVRCNN's BLU requant, the
tail in its final-residual requant, and the residual is added to the frame
and clamped to [0, 255]. INT8 x INT8 -> INT32 throughout, with the QVRCNN
engine's fixed-point contract, so the tables come from the port's
`quant/solver.py` exactly as the JAX package chains them.

  * `WideParams` (with `save`/`load`: npz files that cross the two
    packages both ways), `_solve_layer_capped`, `solve_wide_table`,
    `quantize_wide`, `synth_wide_params`: numpy, the JAX package's
    arithmetic (:36-200): the same seed gives the same int8 weights, int32
    biases and table rows;
  * `forward_wide`: the plain version, float64-exact `conv_exact` and the
    int64 epilogues of `ops/requant.py`, on any device (JAX's numpy
    oracle, :227);
  * `make_wide_forward`: the card program (:246): `ops/int8_conv`'s
    im2col + `_int_mm` GEMMs, each hidden layer's bias and BLU requant in
    one pass from its int32 accumulators to int8
    (`ops/requant.bias_blu_requant_i8`, the CUDA kernel
    `csrc/requant_epilogue.cu`), the tail's int32 epilogue (program spans
    `wide.input`, `wide.requant`, `wide.residual`, `qcnn_gpu_tpu_torch/
    spans.py`); on the CPU the plain version;
  * `float_forward`: the float twin, torch and differentiable, at full
    float32 (:205);
  * `quantize_wide_fp8`, `make_wide_forward_fp8`: the FP8 variant
    (:283-360), held to tolerance, not bit-equality, as in JAX.

The int32 epilogue: `_solve_layer_capped` guarantees (blu_q + bias) * mul
< 2^31 for a table it solves; a table read from a file carries no such
guarantee, so `make_wide_forward` checks every row (after the exact
`normalize_mul_shift`) and raises where one fails.
"""

from __future__ import annotations

import dataclasses
from typing import List, Optional, Sequence

import numpy as np
import torch
import torch.nn.functional as F

from qcnn_gpu_tpu_torch import spans
from qcnn_gpu_tpu_torch.models.float_model import fp32_convs
from qcnn_gpu_tpu_torch.models.qvrcnn import conv_exact
from qcnn_gpu_tpu_torch.ops.int8_conv import GEMM_BYTES, conv_fp8, conv_int8, gemm_operand
from qcnn_gpu_tpu_torch.ops.requant import (
    apply_residual_u8,
    bias_blu_requant_i8,
    blu_requant_i32,
    check_blu_requant_i32_safe,
    final_residual_i32,
    normalize_mul_shift,
)
from qcnn_gpu_tpu_torch.quant.params import LayerQuant
from qcnn_gpu_tpu_torch.quant.solver import solve_last, solve_layer, stepw_from_weights
from qcnn_gpu_tpu_torch.spans import span

# live bytes per pixel and channel of a hidden layer on the card: the int8
# input, the int32 accumulators and the int8 output take 6; the 4 of an
# int32 temporary, which the one-pass epilogue no longer makes, are kept as
# headroom on purpose, so that a chunk's frames and each GEMM's work stay
# as they were. A forward runs as many frames at once as keep them under
# GEMM_BYTES.
LIVE_BYTES = 10


@dataclasses.dataclass
class WideParams:
    """INT8 wide-net parameters: per-layer int8 weights [3, 3, cin, cout],
    int32 biases, and the fixed-point requant table. Layers in order:
    head, blocks x body, tail. blu_q/mul/shift rows cover head + body;
    (mul_last, shift_last) is the tail's residual requant."""

    weights: List[np.ndarray]
    biases: List[np.ndarray]
    blu_q: List[int]
    mul: List[int]
    shift: List[int]
    mul_last: int
    shift_last: int

    @property
    def channels(self) -> int:
        return self.weights[0].shape[3]

    @property
    def blocks(self) -> int:
        return len(self.weights) - 2

    # persistence: the JAX package's npz keys (:63-87), so a file crosses
    # the packages both ways
    def save(self, path: str) -> None:
        arrs = {"mul_last": self.mul_last, "shift_last": self.shift_last}
        for i, (w, b) in enumerate(zip(self.weights, self.biases)):
            arrs[f"w{i}"] = w
            arrs[f"b{i}"] = b
        arrs["blu_q"] = np.asarray(self.blu_q, np.int64)
        arrs["mul"] = np.asarray(self.mul, np.int64)
        arrs["shift"] = np.asarray(self.shift, np.int64)
        np.savez(path, **arrs)

    @classmethod
    def load(cls, path: str) -> "WideParams":
        with np.load(path) as z:
            n = sum(1 for k in z.files if k.startswith("w"))
            return cls(
                weights=[z[f"w{i}"] for i in range(n)],
                biases=[z[f"b{i}"] for i in range(n)],
                blu_q=[int(v) for v in z["blu_q"]],
                mul=[int(v) for v in z["mul"]],
                shift=[int(v) for v in z["shift"]],
                mul_last=int(z["mul_last"]),
                shift_last=int(z["shift_last"]),
            )


def _solve_layer_capped(ratio: float, stepw: float, blu: float, cap: int = 24) -> LayerQuant:
    """solve_layer with the shift capped at `cap` for int32 headroom, then
    blu_q nudged down until requant(blu_q) <= 127 (:90-127: where the
    window search falls back to shift 27, (u + bias) * mul reaches
    ~127.5 * 2^27; solve_layer recentres the bound from the chosen pair, so
    a capped pair is self-consistent). Raises ValueError when even then
    (blu_q + bias) * mul reaches 2^31."""
    row = solve_layer(ratio, stepw, blu)
    if row.shift > cap:
        blu_q0 = round(blu * ratio / stepw)
        mul = max(1, round(127.5 * 2.0**cap / blu_q0))
        blu_adj = 127.0 * 2.0**cap / mul * stepw / ratio
        blu_q = round(blu_adj * ratio / stepw)
        row = LayerQuant(stepw, ratio, blu_adj, blu_q, mul, cap)
    bias = (1 << (row.shift - 1)) // row.mul
    for _ in range(4):
        if ((row.blu_q + bias) * row.mul) >> row.shift <= 127:
            break
        row = LayerQuant(row.stepw, row.ratio, row.blu_adj, row.blu_q - 1, row.mul, row.shift)
    if (row.blu_q + bias) * row.mul >= 2**31:
        raise ValueError(
            f"blu_q={row.blu_q} x mul={row.mul} overflows int32 even at "
            f"shift={row.shift} — rescale the float weights/BLU"
        )
    return row


def solve_wide_table(stepw: Sequence[float], blu: Sequence[float]) -> List[LayerQuant]:
    """Chain the fixed-point solve through the linear wide graph: head and
    body by `_solve_layer_capped`, the tail by solve_last against the
    final pixel scale 255 (:130-144)."""
    rows = []
    ratio = 255.0
    for sw, bl in zip(stepw[:-1], blu[:-1]):
        row = _solve_layer_capped(ratio, sw, bl)
        rows.append(row)
        ratio = ratio / row.stepw * row.mul / 2.0**row.shift
    rows.append(solve_last(ratio, stepw[-1]))
    return rows


def quantize_wide(
    ws_float: Sequence[np.ndarray],
    bs_float: Sequence[np.ndarray],
    blu: Sequence[float],
    wbits: int = 8,
) -> WideParams:
    """Float weights + BLU bounds -> INT8 WideParams through the solver
    (:147-185): w_int = round(w/stepw) on the signed grid, b_int =
    round(b * ratio_in / stepw). Raises ValueError where the tail's int32
    residual requant could wrap."""
    stepw = stepw_from_weights(list(ws_float), bits=wbits)
    rows = solve_wide_table(stepw, list(blu))
    lim = (1 << (wbits - 1)) - 1
    ws, bs = [], []
    for w, b, row in zip(ws_float, bs_float, rows):
        ws.append(np.clip(np.round(np.asarray(w) / row.stepw), -lim - 1, lim).astype(np.int8))
        bs.append(np.round(np.asarray(b) * row.ratio / row.stepw).astype(np.int32))
    u_max = int(np.abs(ws[-1].astype(np.int64)).sum() * 127
                + np.abs(bs[-1].astype(np.int64)).max())
    if u_max * rows[-1].mul >= 2**30:
        raise ValueError(
            f"tail mul={rows[-1].mul} x max accumulator {u_max} overflows"
            " the int32 residual requant — rescale the float weights"
        )
    return WideParams(
        weights=ws,
        biases=bs,
        blu_q=[r.blu_q for r in rows[:-1]],
        mul=[r.mul for r in rows[:-1]],
        shift=[r.shift for r in rows[:-1]],
        mul_last=rows[-1].mul,
        shift_last=rows[-1].shift,
    )


def synth_float_wide(channels: int, blocks: int, seed: int):
    """The float weights and biases `synth_wide_params` quantizes (numpy
    float32, HWIO), drawn as the JAX package draws them (:188-200)."""
    rng = np.random.default_rng(seed)
    shapes = [(3, 3, 1, channels)] + [(3, 3, channels, channels)] * blocks + [(3, 3, channels, 1)]
    ws, bs = [], []
    for shp in shapes:
        fan_in = shp[0] * shp[1] * shp[2]
        ws.append(rng.normal(0, 0.6 / np.sqrt(fan_in), shp).astype(np.float32))
        bs.append(rng.normal(0, 0.01, shp[3]).astype(np.float32))
    return ws, bs


def synth_wide_params(channels: int = 256, blocks: int = 10, seed: int = 0,
                      wbits: int = 8) -> WideParams:
    """Realistically scaled synthetic WideParams (the tests' and the
    benchmark's fixture)."""
    ws, bs = synth_float_wide(channels, blocks, seed)
    return quantize_wide(ws, bs, [2.0] * (blocks + 1) + [0.0], wbits=wbits)


def _oihw(w: torch.Tensor) -> torch.Tensor:
    return w.permute(3, 2, 0, 1)


def float_forward(ws, bs, x_norm: torch.Tensor, blu: float = 2.0) -> torch.Tensor:
    """The float twin for training (:205-224): HWIO weight tensors, [Cout]
    biases and the normalized input x_norm = (x - 128)/255, NHWC, ->
    the float residual NHWC. Hidden layers clip to [0, blu] (with the
    tie-splitting torch.maximum / minimum, as jnp.clip's gradient);
    float32 convolutions, TF32 off."""
    v = x_norm.permute(0, 3, 1, 2)
    with fp32_convs():
        for i in range(len(ws) - 1):
            u = F.conv2d(v, _oihw(ws[i]), bs[i], padding=1)
            v = torch.minimum(torch.maximum(u, u.new_zeros(())), u.new_tensor(float(blu)))
        u = F.conv2d(v, _oihw(ws[-1]), bs[-1], padding=1)
    return u.permute(0, 2, 3, 1)


def forward_wide(x_uint8: torch.Tensor, p: WideParams) -> torch.Tensor:
    """The plain version: uint8 [N, H, W] -> restored uint8, on x's device:
    float64-exact convolutions and int64 epilogues, equal to the JAX
    package's numpy oracle `forward_wide`."""
    dev = x_uint8.device
    v = x_uint8[:, None].to(torch.int64) - 128
    n = len(p.weights)
    for i in range(n):
        w = torch.as_tensor(np.asarray(p.weights[i], np.int8), device=dev)
        b = torch.as_tensor(np.asarray(p.biases[i], np.int32), device=dev)
        u = conv_exact(v, w, b)
        if i < n - 1:
            v = blu_requant_i32(u, p.blu_q[i], p.mul[i], p.shift[i])
    res = final_residual_i32(u, p.mul_last, p.shift_last)[:, 0]
    return apply_residual_u8(x_uint8, res)


def int32_table(p: WideParams):
    """The hidden layers' (blu_q, mul, shift) rows after the exact
    `normalize_mul_shift`, each checked for the int32 epilogue (raises
    ValueError naming the layer)."""
    rows = []
    for i, (bq, m, s) in enumerate(zip(p.blu_q, p.mul, p.shift)):
        m, s = normalize_mul_shift(m, s)
        check_blu_requant_i32_safe(bq, m, s, name=f"wide layer {i}")
        rows.append((int(bq), m, s))
    return rows


def frames_per_chunk(h: int, w: int, channels: int, budget: int = GEMM_BYTES) -> int:
    """How many frames a forward runs at once (LIVE_BYTES a pixel and channel)."""
    return max(1, budget // (h * w * channels * LIVE_BYTES))


def _chunked(run_chunk, x_uint8: torch.Tensor, channels: int) -> torch.Tensor:
    n, h, w = x_uint8.shape
    f = frames_per_chunk(h, w, channels)
    if n <= f:
        return run_chunk(x_uint8)
    return torch.cat([run_chunk(x_uint8[i:i + f]) for i in range(0, n, f)])


def make_wide_forward(p: WideParams, *, device, route: Optional[str] = None):
    """fn(uint8 tensor [N, H, W] on `device`) -> restored uint8 tensor,
    bit-equal to `forward_wide`. route "gemm" (the default on CUDA): the
    card program, NHWC int8 activations through `ops/int8_conv.conv_int8`
    (im2col + `_int_mm`), each hidden layer's bias and requant in one
    `bias_blu_requant_i8` launch, the tail's int32 epilogue, frames in chunks
    (`frames_per_chunk`); route "plain" (the default on the CPU):
    `forward_wide`. Raises ValueError for a table the int32 epilogue
    cannot hold."""
    dev = torch.device(device)
    route = route or ("gemm" if dev.type == "cuda" else "plain")
    if route not in ("gemm", "plain"):
        raise ValueError(f"route {route!r}: 'gemm' or 'plain'")
    table = int32_table(p)
    if route == "gemm":
        ops = [gemm_operand(torch.as_tensor(np.asarray(w, np.int8), device=dev))
               for w in p.weights]
        bs = [torch.as_tensor(np.asarray(b, np.int32), device=dev) for b in p.biases]

    def run_chunk(x_uint8):
        with span(spans.WIDE_INPUT):
            v = (x_uint8[..., None].to(torch.int16) - 128).to(torch.int8)
        for op, b, row in zip(ops, bs, table):
            u = conv_int8(v, op, None, route="gemm")
            with span(spans.WIDE_REQUANT):
                v = bias_blu_requant_i8(u, b, *row)
            del u  # freed before the next layer allocates its accumulators
        u = conv_int8(v, ops[-1], bs[-1], route="gemm")
        with span(spans.WIDE_RESIDUAL):
            res = final_residual_i32(u[..., 0], p.mul_last, p.shift_last)
            return apply_residual_u8(x_uint8, res)

    @torch.no_grad()
    def run(x_uint8: torch.Tensor) -> torch.Tensor:
        if route == "plain":
            return forward_wide(x_uint8, p)
        return _chunked(run_chunk, x_uint8, p.channels)

    run.impl = "wide-int"
    run.route = route
    return run


# ---------------------------------------------------------------------------
# FP8 (BASELINE config 5 stretch)
# ---------------------------------------------------------------------------


def quantize_wide_fp8(ws: Sequence[np.ndarray], bs: Sequence[np.ndarray]):
    """Per-output-channel absmax scaling of float weights onto
    float8_e4m3fn (range +-448), as :283-297: s = float32(amax / 448),
    w8 = (w / s in float32) rounded to nearest even. Returns (w8 HWIO
    tensors, scales float32 [Cout] tensors), on the CPU; biases stay
    float32."""
    w8, scales = [], []
    for w in ws:
        amax = np.maximum(np.abs(w).max(axis=(0, 1, 2)), 1e-12)
        s = (amax / 448.0).astype(np.float32)
        w8.append(torch.from_numpy(np.ascontiguousarray(w / s)).to(torch.float8_e4m3fn))
        scales.append(torch.from_numpy(s))
    return w8, scales


def make_wide_forward_fp8(ws, bs, blu: float = 2.0, *, device, route: Optional[str] = None):
    """The FP8 twin of make_wide_forward (:299-364): fn(uint8 tensor
    [N, H, W] on `device`) -> uint8. fp8 e4m3 weights with per-channel
    scales, fp8 inter-layer activations at the scale sa = blu/448, float32
    accumulation. The JAX numerics, each kept:

      * the head's input is bf16((x - 128)/255), its activation scale 1;
      * a hidden layer's output is clip(u, 0, blu) / sa (float32 sa), cast
        to fp8 (nearest even);
      * the next epilogue multiplies by scales[i] * act_s in float32, with
        act_s = bfloat16(sa);
      * the output is clip(x + round(res * 255), 0, 255).

    route "gemm" (the default on CUDA): body and tail are FP8 GEMMs
    (`ops/int8_conv.conv_fp8`: fp8 im2col + `_scaled_mm`); the head (K = 9)
    a float32 conv. route "plain" (the default on the CPU): float32 convs
    (TF32 off) of the fp8- and bf16-valued operands, whose products are
    exact in float32. Not bit-exact (float sums in another order): held
    to tolerance. `run.weight_bytes` is 1 B per parameter."""
    dev = torch.device(device)
    route = route or ("gemm" if dev.type == "cuda" else "plain")
    if route not in ("gemm", "plain"):
        raise ValueError(f"route {route!r}: 'gemm' or 'plain'")
    w8, scales = quantize_wide_fp8(ws, bs)
    n = len(w8)
    sa = torch.tensor(np.float32(blu / 448.0), device=dev)
    act_bf16 = np.float32(torch.tensor(blu / 448.0, dtype=torch.float32).to(torch.bfloat16).item())
    mults = [(scales[i] * np.float32(1.0 if i == 0 else act_bf16)).to(dev) for i in range(n)]
    biases = [torch.as_tensor(np.asarray(b, np.float32), device=dev) for b in bs]
    w8 = [w.to(dev) for w in w8]
    plain_w = [_oihw(w.to(torch.float32)).contiguous() for w in w8]  # the head's, on both routes
    ops = [gemm_operand(w, align=16) for w in w8[1:]] if route == "gemm" else None
    lo, hi = torch.zeros((), device=dev), torch.tensor(float(blu), device=dev)

    def requant(u, i):  # NHWC float32 accumulators -> fp8 activations
        v = torch.minimum(torch.maximum(u * mults[i] + biases[i], lo), hi)
        return (v / sa).to(torch.float8_e4m3fn)

    def run_chunk(x_uint8):
        x = ((x_uint8[:, None].to(torch.float32) - 128.0) / 255.0).to(torch.bfloat16)
        with fp32_convs():
            if route == "plain":
                v = x.to(torch.float32)
                for i in range(n - 1):
                    u = F.conv2d(v, plain_w[i], padding=1).permute(0, 2, 3, 1)
                    v = requant(u, i).to(torch.float32).permute(0, 3, 1, 2)
                u = F.conv2d(v, plain_w[-1], padding=1).permute(0, 2, 3, 1)
            else:
                v = requant(F.conv2d(x.to(torch.float32), plain_w[0], padding=1).permute(0, 2, 3, 1), 0)
                for i in range(1, n - 1):
                    v = requant(conv_fp8(v, ops[i - 1]), i)
                u = conv_fp8(v, ops[-1])
        res = (u * mults[-1] + biases[-1])[..., 0]
        rec = x_uint8.to(torch.float32) + torch.round(res * 255.0)
        return torch.clamp(rec, 0.0, 255.0).to(torch.uint8)

    @torch.no_grad()
    def run(x_uint8: torch.Tensor) -> torch.Tensor:
        return _chunked(run_chunk, x_uint8, w8[0].shape[3])

    run.impl = "wide-fp8"
    run.route = route
    run.weight_bytes = sum(w.numel() for w in w8)
    return run
