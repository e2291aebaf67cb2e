"""Fixed-point quantization parameter solver — the port's own copy.

Mirrors `qcnn_gpu_tpu/quant/solver.py` (:38-280), pure Python and numpy:
`BLU_INIT`, `BLU_INIT_FINETUNE`, `solve_mul_shift`,
`solve_mul_shift_float`, `solve_layer`, `solve_concat`, `solve_last`,
`solve_network`, `stepw_from_weights`, `solve_from_weights` and the
per-channel solver (`stepw_per_channel`, `solve_layer_pc`,
`solve_concat_pc`, `solve_network_per_channel`). It is the re-derivation
of the reference's offline quantization math (`training/quantization.py:
5-98`), which turns float weight statistics and per-QP activation bounds
into the integer (mul, shift, blu_q) tables the INT8 engine consumes.

Core identities:
  * requant of an accumulator u (scale ratio/stepw) back to the pixel scale:
        y_int8 = (u * mul) >> shift,  chosen so  blu_q*mul/2^shift in (127,127.5]
    i.e. the int8 saturation at 127 IS the BLU activation clip.
  * the running pixel scale chains through the graph as
        ratio' = ratio / stepw * mul / 2^shift          (quantization.py:58-62)
  * concat branches must agree on the output scale; the weaker branch's
    stepw is adjusted so both land on the same ratio'   (quantization.py:42-45)
  * the last (linear) layer is solved against the final pixel scale 255.

`round()` here is Python 3 banker's rounding — load-bearing: the shipped
tables were produced with it. `solve_mul_shift`'s search jumps between
(mul, shift) pairs for small changes of its argument, so two tables agree
byte for byte only when they were solved from the same BLU bounds.
"""

from __future__ import annotations

from typing import List, Sequence, Tuple

import numpy as np

from qcnn_gpu_tpu_torch.quant.params import LayerQuant, LayerQuantVec, QuantTable

# Per-QP initial BLU upper bounds in the float activation domain for the five
# BLU layers (C1, C2_1, C2_2, C3_1, C3_2) + 0 for the linear C4. Observed
# 3-sigma activation statistics (quantization.py:69-76, the quantNsave set).
BLU_INIT = {
    22: [0.1111, 0.05, 0.05, 0.022, 0.022, 0.0],
    27: [0.294, 0.172, 0.172, 0.101, 0.101, 0.0],
    32: [0.316, 0.198, 0.198, 0.125, 0.125, 0.0],
    37: [0.349, 0.243, 0.243, 0.169, 0.169, 0.0],
}

# Alternative init used by the fine-tune path (quantization.py:107-117);
# differs only at QP22.
BLU_INIT_FINETUNE = dict(BLU_INIT)
BLU_INIT_FINETUNE[22] = [0.265, 0.140, 0.140, 0.0742, 0.0742, 0.0]


def solve_mul_shift(max_u: float) -> Tuple[int, int]:
    """Smallest shift whose (mul, shift) pair maps max_u into (127, 127.5).

    Search i in [1, 27] for mul = round(127.5*2^i / max_u) such that
    max_u*mul/2^i lands in the open-open window — guaranteeing that any
    accumulator <= max_u requantizes to <= 127 under floor((u*mul)>>shift).
    (quantization.py:5-14; falls back to the last candidate if no i hits
    the window, as the reference does.)
    """
    mul, i = None, None
    for i in range(1, 28):
        max_int = 127.5 * 2.0**i
        if max_int > max_u:
            mul = round(max_int / max_u)
            scaled = max_u * mul / 2.0**i
            if 127.0 < scaled < 127.5:
                return mul, i
    if mul is None:
        raise ValueError(f"max_u={max_u} out of range for mul/shift solve")
    return mul, i


def solve_mul_shift_float(ratio: float) -> Tuple[int, int]:
    """(mul, shift) with 2^shift/mul approximating `ratio` within 2%.

    Used for the final linear layer where there is no BLU window; the
    approximation error is folded back into an adjusted stepw.
    (quantization.py:15-24.)
    """
    mul, i = None, None
    for i in range(10, 28):
        max_int = 2.0**i
        if max_int > ratio:
            mul = round(max_int / ratio)
            if abs(max_int / mul - ratio) < 0.02 * ratio:
                return mul, i
    if mul is None:
        raise ValueError(f"ratio={ratio} out of range for float mul/shift solve")
    return mul, i


def solve_layer(ratio: float, stepw: float, blu: float) -> LayerQuant:
    """Solve one BLU conv layer given its input pixel scale. (py:25-31.)"""
    blu_q = round(blu * ratio / stepw)
    mul, shift = solve_mul_shift(blu_q)
    # re-center the float BLU bound so int 127 == the clip exactly:
    # blu_adj * ratio/stepw * mul/2^shift == 127
    blu_adj = 127.0 * 2.0**shift / mul * stepw / ratio
    blu_q = round(blu_adj * ratio / stepw)
    return LayerQuant(stepw, ratio, blu_adj, blu_q, mul, shift)


def solve_concat(
    ratio: float, stepw1: float, blu1: float, stepw2: float, blu2: float
) -> Tuple[LayerQuant, LayerQuant]:
    """Solve two concat branches onto a common output scale. (py:32-49.)

    Both branches take the max of the two BLU bounds; after the per-branch
    mul/shift solve, the branch with the larger effective gain
    mul/(stepw*2^shift) has its stepw re-derived from the other's so that
    ratio' = ratio/stepw*mul/2^shift is identical for both.
    """
    hi = max(blu1, blu2)
    blu1 = blu2 = hi
    blu_q1 = round(blu1 * ratio / stepw1)
    blu_q2 = round(blu2 * ratio / stepw2)
    mul1, shift1 = solve_mul_shift(blu_q1)
    mul2, shift2 = solve_mul_shift(blu_q2)

    if mul1 / stepw1 / 2.0**shift1 > mul2 / stepw2 / 2.0**shift2:
        stepw1 = stepw2 * 2.0**shift2 / mul2 * mul1 / 2.0**shift1
    else:
        stepw2 = stepw1 * 2.0**shift1 / mul1 * mul2 / 2.0**shift2

    blu1_adj = 127.0 * 2.0**shift1 / mul1 * stepw1 / ratio
    blu2_adj = 127.0 * 2.0**shift2 / mul2 * stepw2 / ratio
    return (
        LayerQuant(stepw1, ratio, blu1_adj, blu_q1, mul1, shift1),
        LayerQuant(stepw2, ratio, blu2_adj, blu_q2, mul2, shift2),
    )


def solve_last(ratio: float, stepw: float) -> LayerQuant:
    """Solve the linear output layer against the final pixel scale 255.

    (py:50-53.) The residual leaves the net at scale ratio/stepw_adj *
    mul/2^shift == 255 exactly, with the rational-approximation slack
    absorbed into stepw_adj.
    """
    mul, shift = solve_mul_shift_float(ratio / 255.0 / stepw)
    stepw_adj = ratio * mul / 2.0**shift / 255.0
    return LayerQuant(stepw_adj, ratio, 0.0, 0, mul, shift)


def solve_network(stepw: Sequence[float], blu: Sequence[float]) -> QuantTable:
    """Chain the per-layer solves through the QVRCNN graph. (py:55-64.)

    stepw/blu are 6-vectors in topology order. The running `ratio` starts at
    255 (uint8 pixels, symmetric-shifted) and chains through C1 -> Conc1 ->
    Conc2 -> C4; concat branch 1 defines the chained scale (both branches are
    equal by construction).
    """
    ratio = 255.0
    c1 = solve_layer(ratio, stepw[0], blu[0])
    ratio = ratio / c1.stepw * c1.mul / 2.0**c1.shift
    c2_1, c2_2 = solve_concat(ratio, stepw[1], blu[1], stepw[2], blu[2])
    ratio = ratio / c2_1.stepw * c2_1.mul / 2.0**c2_1.shift
    c3_1, c3_2 = solve_concat(ratio, stepw[3], blu[3], stepw[4], blu[4])
    ratio = ratio / c3_1.stepw * c3_1.mul / 2.0**c3_1.shift
    c4 = solve_last(ratio, stepw[5])
    return QuantTable([c1, c2_1, c2_2, c3_1, c3_2, c4])


def stepw_from_weights(weights: Sequence[np.ndarray], bits: int = 8) -> List[float]:
    """Asymmetric abs-max weight step per layer. (py:77-86.)

    stepw = max/(2^(b-1)-1) if the positive tail dominates else
    -min/2^(b-1), mapping the observed range onto the full signed `bits`
    grid (bits=8 reproduces the reference's /127 vs /128; bits=4 is the
    INT4 stretch variant)."""
    hi_div = float((1 << (bits - 1)) - 1)
    lo_div = float(1 << (bits - 1))
    steps = []
    for w in weights:
        hi = float(np.max(w))
        lo = float(np.min(w))
        steps.append(hi / hi_div if hi / hi_div > -lo / lo_div else -lo / lo_div)
    return steps


def solve_from_weights(weights: Sequence[np.ndarray], qp: int) -> QuantTable:
    """Full offline solve from float weights, per QP. (quantNsave, py:66-98.)"""
    return solve_network(stepw_from_weights(weights), BLU_INIT[qp])


# ---------------------------------------------------------------------------
# Per-output-channel solve (the INT4 quality closure, round 5)
# ---------------------------------------------------------------------------


def stepw_per_channel(
    weights: Sequence[np.ndarray], bits: int = 8
) -> List[np.ndarray]:
    """Per-OUTPUT-CHANNEL asymmetric abs-max weight steps.

    Generalizes stepw_from_weights (quantization.py:77-86) from one step
    per layer to one per out channel: channels with small weights get a
    proportionally finer grid — on the 4-bit grid (15 levels) this is
    where most of the INT8->INT4 quality loss lives. A channel whose
    weights are all zero falls back to the layer-wide step (its grid is
    irrelevant; avoids a zero divide)."""
    hi_div = float((1 << (bits - 1)) - 1)
    lo_div = float(1 << (bits - 1))
    layer_steps = stepw_from_weights(weights, bits=bits)
    out = []
    for w, fallback in zip(weights, layer_steps):
        hi = np.max(w, axis=(0, 1, 2))
        lo = np.min(w, axis=(0, 1, 2))
        s = np.maximum(hi / hi_div, -lo / lo_div)
        out.append(np.where(s > 0, s, fallback).astype(np.float64))
    return out


def _equalize_channels(ratio: float, stepw: np.ndarray, blu: float):
    """Per-channel (mul, shift) solve + exact common-output-scale
    equalization.

    Each channel first gets the standard window solve for its own
    blu_q_c = round(blu*ratio/stepw_c). Channels then all adopt the
    SMALLEST effective gain g_c = mul_c/(stepw_c*2^shift_c) — the same
    direction as the reference's concat rule (quantization.py:42-45,
    the stronger branch's stepw is re-derived from the weaker's), so
    every adjustment only *increases* a stepw (weights still fit the
    grid) by the rational-approximation slack (<0.5%). After
    equalization blu_adj = 127*2^shift/mul*stepw/ratio is channel-
    independent by construction. Returns (stepw', blu_adj, blu_q, mul,
    shift, ratio_out)."""
    stepw = np.asarray(stepw, np.float64)
    muls, shifts = [], []
    for s in stepw:
        m, sh = solve_mul_shift(round(blu * ratio / s))
        muls.append(m)
        shifts.append(sh)
    mul = np.asarray(muls, np.int64)
    shift = np.asarray(shifts, np.int64)
    gains = mul / (stepw * np.exp2(shift))
    g = float(np.min(gains))
    stepw_adj = mul / (np.exp2(shift) * g)
    blu_adj = 127.0 / (ratio * g)
    blu_q = np.asarray(
        [round(blu_adj * ratio / s) for s in stepw_adj], np.int64
    )
    return stepw_adj, blu_adj, blu_q, mul, shift, ratio * g


def solve_layer_pc(
    ratio: float, stepw: np.ndarray, blu: float
) -> Tuple[LayerQuantVec, float]:
    """One BLU layer, per-channel. Returns (row, output ratio)."""
    sw, blu_adj, blu_q, mul, shift, r_out = _equalize_channels(ratio, stepw, blu)
    return LayerQuantVec(sw, ratio, blu_adj, blu_q, mul, shift), r_out


def solve_concat_pc(
    ratio: float, stepw1: np.ndarray, blu1: float, stepw2: np.ndarray, blu2: float
) -> Tuple[LayerQuantVec, LayerQuantVec, float]:
    """Concat branches solved JOINTLY: both take the max BLU bound
    (quantization.py:33-34) and all channels of both branches equalize to
    one common output scale — the per-channel generalization of the
    reference's two-branch rule. Returns (row1, row2, output ratio)."""
    hi = max(blu1, blu2)
    n1 = len(stepw1)
    sw, blu_adj, blu_q, mul, shift, r_out = _equalize_channels(
        ratio, np.concatenate([stepw1, stepw2]), hi
    )
    mk = lambda sl: LayerQuantVec(  # noqa: E731
        sw[sl], ratio, blu_adj, blu_q[sl], mul[sl], shift[sl]
    )
    return mk(slice(0, n1)), mk(slice(n1, None)), r_out


def solve_network_per_channel(
    stepw: Sequence[np.ndarray], blu: Sequence[float]
) -> QuantTable:
    """Per-channel analog of solve_network: identical ratio chain (the
    equalized common scale IS ratio/stepw_c*mul_c/2^shift_c for every
    channel), scalar solve_last for the single-channel output layer."""
    ratio = 255.0
    c1, ratio = solve_layer_pc(ratio, stepw[0], blu[0])
    c2_1, c2_2, ratio = solve_concat_pc(ratio, stepw[1], blu[1], stepw[2], blu[2])
    c3_1, c3_2, ratio = solve_concat_pc(ratio, stepw[3], blu[3], stepw[4], blu[4])
    c4 = solve_last(ratio, float(np.asarray(stepw[5]).ravel()[0]))
    return QuantTable([c1, c2_1, c2_2, c3_1, c3_2, c4])
