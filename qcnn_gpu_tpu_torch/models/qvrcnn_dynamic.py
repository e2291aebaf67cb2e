"""The dynamic-quantization (calibration) forward and the hybrid forward.

Counterpart of `qcnn_gpu_tpu/models/qvrcnn_dynamic.py`: `make_dynamic_forward`
(:79-171) is the device twin of the oracle's `forward_calibrate`, the
reference's pure-dynamic path (per-layer abs-max -> runtime step_y ->
round-half-away requantization, the sorted-step bias walk, the dynamic
concat scale negotiation; cnn.cu:169-188, 285-320; qvrcnn.cu:82-167,
305-349, 368-385), which is how the static tables were calibrated.
`make_hybrid_forward` (:174-244) is the twin of `forward_dynamic_hybrid`,
the reference's committed `forward()`: C1's static mul/shift requant
without the BLU clamp, stored through int8 (it wraps), static BLU concats,
and the hardcoded (141, 16) output rescale.

Torch operations on one explicit device; this is XLA in JAX, not a Pallas
kernel, and calibration is not a hot path, so it has no kernel of its own:

  * the convolutions go through `models/qvrcnn.conv_exact` (float64; every
    accumulator is an integer far below 2^53, while C2's can pass 2^24);
  * the bias walk and the output rescale run in int64 (the reference's
    long long, qvrcnn.cu:338, :374);
  * divisions are floor divisions (`torch.div(..., rounding_mode="floor")`)
    inside `_round_half_away_div`, as JAX's `//`;
  * the int8 stores that wrap (:145, :212, :223, :229) are the
    two's-complement wrap ((t + 128) & 255) - 128 in int64;
  * the abs-max reductions run over the whole batch, as in JAX; the step
    scalars stay 0-d device tensors, and each call reads its telemetry
    back in one copy.

One departure: `make_hybrid_forward` raises ValueError for a per-channel
table, where the JAX function fails on `int(v)` of a vector row
(qvrcnn_dynamic.py:188-190).
"""

from __future__ import annotations

from typing import List, Sequence

import numpy as np
import torch

from qcnn_gpu_tpu_torch.models.engine_params import DynamicParams, EngineParams
from qcnn_gpu_tpu_torch.models.qvrcnn import conv_exact

THRESHOLD = 127
# the output rescale of the hybrid forward, hardcoded in the reference
# (adjustOutput_static, qvrcnn.cu:157)
HYBRID_OUT_MUL, HYBRID_OUT_SHIFT = 141, 16


def _wrap_int8(t: torch.Tensor) -> torch.Tensor:
    """Store an int64 value through int8 and read it back (C char wraps)."""
    return ((t + 128) & 255) - 128


def _floordiv(x, d):
    return torch.div(x, d, rounding_mode="floor")


def _round_half_away_div(x, d):
    """(x +/- d/2) / d with C's truncating division: round half away
    from zero (oracle contract item 6)."""
    half = _floordiv(d, 2) if isinstance(d, torch.Tensor) else d // 2
    return torch.where(x >= 0, _floordiv(x + half, d), -_floordiv(-x + half, d))


def _quant_div_clamp(u, step):
    return _round_half_away_div(u, step).clamp(-128, 127)


def _step_from_max(max_u):
    return _floordiv(max_u, THRESHOLD + 1) + 1


def _concat_dynamic_steps(sw1: int, max1, sw2: int, max2):
    """Dynamic concat scale negotiation (cnn.cu:285-343)."""
    sy1 = torch.where(max1 > THRESHOLD, _step_from_max(max1), 1)
    sy2 = torch.where(max2 > THRESHOLD, _step_from_max(max2), 1)
    cond = sw1 * sy2 > sw2 * sy1
    sy1_adj = _floordiv(sw1 * sy2 + (sw2 >> 1), sw2)
    sy2_adj = _floordiv(sw2 * sy1 + (sw1 >> 1), sw1)
    return torch.where(cond, sy1_adj, sy1), torch.where(cond, sy2, sy2_adj)


def _adjust_basic(b, stepw_sorted: Sequence[int], stepy_sorted, n: int):
    """b_adj: multiply by the n largest stepw (descending), then
    round-half-away divide by the n smallest stepy (ascending)."""
    t = b
    for i in range(n):
        t = t * stepw_sorted[i]
    for i in range(n):
        t = _round_half_away_div(t, stepy_sorted[i])
    return t


def _frames(x_u8, device) -> torch.Tensor:
    x = torch.as_tensor(x_u8, device=device)
    if x.dtype != torch.uint8 or x.dim() != 3:
        raise ValueError(f"expected uint8 frames [N, H, W], got {x.dtype} {tuple(x.shape)}")
    return x


def _restore(x_u8: torch.Tensor, res: torch.Tensor) -> torch.Tensor:
    return (x_u8.to(torch.int64) + res).clamp(0, 255).to(torch.uint8)


def make_dynamic_forward(p: DynamicParams, *, device):
    """fn(uint8 [N, H, W], numpy or a tensor) -> (rec uint8 tensor on
    `device`, telemetry).

    Telemetry, as in JAX: "max_u" (max1, (m2_1, m2_2), (m3_1, m3_2)) and
    "step_y" (sy1, (sy2_1, sy2_2), (sy3_1, sy3_2)) as ints, and "b_adj",
    the six adjusted biases each conv added this call (C1, C2_1, C2_2,
    C3_1, C3_2, C4; C1's is never walked) as int64 numpy vectors."""
    p.validate()
    device = torch.device(device)
    w = [torch.as_tensor(np.asarray(x, np.int8), device=device) for x in p.weights]
    b = [torch.as_tensor(np.asarray(x, np.int64), device=device) for x in p.biases]
    sw = [int(v) for v in p.step_w]

    @torch.no_grad()
    def run(x_u8):
        x_u8 = _frames(x_u8, device)
        x = x_u8.to(torch.int64)[:, None] - 128

        u1 = conv_exact(x, w[0], b[0])
        max1 = u1.abs().max()
        sy1 = _step_from_max(max1)
        v1 = _quant_div_clamp(u1, sy1)

        # layer 2 (ReLU before the dynamic concat, qvrcnn.cu:115-120)
        b2_1 = _adjust_basic(b[1], [sw[0]], [sy1], 1)
        b2_2 = _adjust_basic(b[2], [sw[0]], [sy1], 1)
        u2_1 = conv_exact(v1, w[1], b2_1).clamp(min=0)
        u2_2 = conv_exact(v1, w[2], b2_2).clamp(min=0)
        m2_1, m2_2 = u2_1.max(), u2_2.max()
        sy2_1, sy2_2 = _concat_dynamic_steps(sw[1], m2_1, sw[2], m2_2)
        conc1 = torch.cat([_quant_div_clamp(u2_1, sy2_1), _quant_div_clamp(u2_2, sy2_2)], 1)

        sw_sorted2 = sorted(sw[:2], reverse=True)
        sy_sorted2 = torch.sort(torch.stack([sy1, sy2_1])).values

        # layer 3
        b3_1 = _adjust_basic(b[3], sw_sorted2, sy_sorted2, 2)
        b3_2 = _adjust_basic(b[4], sw_sorted2, sy_sorted2, 2)
        u3_1 = conv_exact(conc1, w[3], b3_1).clamp(min=0)
        u3_2 = conv_exact(conc1, w[4], b3_2).clamp(min=0)
        m3_1, m3_2 = u3_1.max(), u3_2.max()
        sy3_1, sy3_2 = _concat_dynamic_steps(sw[3], m3_1, sw[4], m3_2)
        conc2 = torch.cat([_quant_div_clamp(u3_1, sy3_1), _quant_div_clamp(u3_2, sy3_2)], 1)

        sw_sorted3 = sorted([sw[0], sw[1], sw[3]], reverse=True)
        sy_sorted3 = torch.sort(torch.stack([sy1, sy2_1, sy3_1])).values

        # layer 4 + the dynamic output rescale (adjustOutput, qvrcnn.cu:368-385)
        b4 = _adjust_basic(b[5], sw_sorted3, sy_sorted3, 3)
        t = conv_exact(conc2, w[5], b4)[:, 0]
        sw_sorted4 = sorted([sw[0], sw[1], sw[3], sw[5]], reverse=True)
        for i in range(3):  # multiply by stepy[0..n-2], n = 4
            t = t * sy_sorted3[i]
        for i in range(3, -1, -1):  # divide by stepw[n-1..0]
            t = _round_half_away_div(t, sw_sorted4[i])
        rec = _restore(x_u8, _wrap_int8(t))

        # the telemetry, read back in one copy
        scalars = [max1, m2_1, m2_2, m3_1, m3_2, sy1, sy2_1, sy2_2, sy3_1, sy3_2]
        b_adj = [b[0], b2_1, b2_2, b3_1, b3_2, b4]
        host = torch.cat([torch.stack(scalars)] + b_adj).cpu().numpy()
        s = [int(v) for v in host[:10]]
        vecs, pos = [], 10
        for v in b_adj:
            vecs.append(host[pos:pos + v.numel()].copy())
            pos += v.numel()
        telemetry = {
            "max_u": (s[0], (s[1], s[2]), (s[3], s[4])),
            "step_y": (s[5], (s[6], s[7]), (s[8], s[9])),
            "b_adj": tuple(vecs),
        }
        return rec, telemetry

    return run


def _scalar_rows(p: EngineParams) -> List[tuple]:
    for name in ("blu_q", "mul", "shift"):
        for i, v in enumerate(getattr(p, name)):
            if np.ndim(v):
                raise ValueError(
                    f"the hybrid forward takes scalar quant rows (qvrcnn.cu:82-167); "
                    f"layer {i}'s {name} is per-channel"
                )
    return [(int(bq), int(m), int(s)) for bq, m, s in zip(p.blu_q, p.mul, p.shift)]


def make_hybrid_forward(p: EngineParams, *, device):
    """fn(uint8 [N, H, W], numpy or a tensor) -> (rec uint8 tensor on
    `device`, max_u_c1 int): the reference's hybrid `forward()`. max_u_c1
    is what `save_steps` recorded per call on this path (qvrcnn.cu:163).
    A per-channel table raises ValueError."""
    p.validate()
    rows = _scalar_rows(p)
    device = torch.device(device)
    w = [torch.as_tensor(np.asarray(x, np.int8), device=device) for x in p.weights]
    b = [torch.as_tensor(np.asarray(x, np.int64), device=device) for x in p.biases]

    def blu_requant64(u, i):
        blu_q, mul, shift = rows[i]
        mid = ((u + (1 << (shift - 1)) // mul) * mul) >> shift
        return torch.where(u > blu_q, THRESHOLD, torch.where(u < 0, 0, mid))

    def stage(v, i1, i2):
        u_a = conv_exact(v, w[i1], b[i1]).clamp(min=0)
        u_b = conv_exact(v, w[i2], b[i2]).clamp(min=0)
        return _wrap_int8(torch.cat([blu_requant64(u_a, i1), blu_requant64(u_b, i2)], 1))

    @torch.no_grad()
    def run(x_u8):
        x_u8 = _frames(x_u8, device)
        x = x_u8.to(torch.int64)[:, None] - 128
        u1 = conv_exact(x, w[0], b[0])
        max_u_c1 = u1.abs().max()
        _, mul0, shift0 = rows[0]
        # mul_shift (mat.cu:248-261): pre-multiply bias, no BLU clamp, int8 store
        v1 = _wrap_int8(((u1 + (1 << (shift0 - 1)) // mul0) * mul0) >> shift0)
        conc2 = stage(stage(v1, 1, 2), 3, 4)
        u4 = conv_exact(conc2, w[5], b[5])[:, 0]
        res = _wrap_int8((u4 * HYBRID_OUT_MUL + (1 << (HYBRID_OUT_SHIFT - 1))) >> HYBRID_OUT_SHIFT)
        return _restore(x_u8, res), int(max_u_c1)

    return run
