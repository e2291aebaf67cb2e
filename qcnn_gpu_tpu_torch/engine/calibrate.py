"""Calibration — from a float checkpoint to static INT8 engine tables, and
the dynamic path's telemetry: the port's counterpart of
`qcnn_gpu_tpu/engine/calibrate.py`.

`calibrate_blu_bounds` (:27-34) takes the BLU upper bounds as 3 sigma of
each layer's float pre-activation on sample frames, which the float model
computes on a torch device at full float32 (`float_model.fp32_convs`);
`solve_table` (:37-65) solves the fixed-point table from the float weights
and the bounds (or the per-QP presets), per layer or per output channel,
in numpy; `quantize_model` (:68-73) puts the float params on the integer
grid (`EngineParams.from_float`). The solve jumps between (mul, shift)
pairs for bound changes of 0.25%, so two devices' tables agree byte for
byte only from the same bounds.

`save_b_adj` / `read_b_adj` (:76-103) write and read the reference's
save_b_adj dump (qvrcnn.cu:288-304) with the same bytes, little-endian
float32 through numpy. `calibrate_dynamic` (:104-118) runs the dynamic
forward one frame at a time and collects its max_u telemetry, the
`save_steps` flow that fed the offline mul/shift solve; it runs the port's
`make_dynamic_forward` on a torch device where JAX runs the numpy oracle,
with the same return value.
"""

from __future__ import annotations

from typing import List, Optional, Sequence, Tuple

import numpy as np

from qcnn_gpu_tpu_torch.models import float_model as FM
from qcnn_gpu_tpu_torch.models.engine_params import DynamicParams, EngineParams
from qcnn_gpu_tpu_torch.models.qvrcnn_dynamic import make_dynamic_forward
from qcnn_gpu_tpu_torch.quant.params import QuantTable
from qcnn_gpu_tpu_torch.quant.solver import (
    BLU_INIT,
    solve_network,
    solve_network_per_channel,
    stepw_from_weights,
    stepw_per_channel,
)

B_ADJ_SIZES = (64, 32, 16, 16, 32, 1)  # C1, C2_1, C2_2, C3_1, C3_2, C4


def calibrate_blu_bounds(
    params: FM.Params, sample_frames: np.ndarray, n_sigma: float = 3.0, *, device
) -> List[float]:
    """BLU upper bounds as n_sigma * std of each layer's pre-activation on
    sample frames, the float model on `device` — how the reference's per-QP
    blu_init tables were obtained ('observed 3sigma', quantization.py:70)."""
    sigmas = FM.activation_sigmas(FM.params_from_jax(params, device), sample_frames)
    return [n_sigma * s for s in sigmas[:5]] + [0.0]


def solve_table(
    params: FM.Params,
    blu_bounds: Optional[Sequence[float]] = None,
    qp: Optional[int] = None,
    wbits: int = 8,
    per_channel: bool = False,
) -> QuantTable:
    """Fixed-point table from float weights; blu_bounds from calibration or
    the reference's per-QP presets. wbits=4 solves for the INT4 stretch
    grid (larger stepw; the mul/shift chain adapts automatically).
    per_channel=True gives every output channel its own stepw and
    (mul, shift), equalized to a common output scale (the INT4 quality
    closure, quant/solver.solve_network_per_channel)."""
    if blu_bounds is None:
        if qp is None:
            raise ValueError("need blu_bounds or qp")
        blu_bounds = BLU_INIT[qp]
    ws = [np.asarray(w) for w in FM.params_to_lists(params)[0]]
    if per_channel:
        return solve_network_per_channel(stepw_per_channel(ws, bits=wbits), blu_bounds)
    return solve_network(stepw_from_weights(ws, bits=wbits), blu_bounds)


def quantize_model(params: FM.Params, table: QuantTable, wbits: int = 8) -> EngineParams:
    """Float params (JAX layout, numpy) -> integer engine params on the
    signed `wbits` grid."""
    ws, bs = FM.params_to_lists(params)
    return EngineParams.from_float([np.asarray(w) for w in ws], [np.asarray(b) for b in bs],
                                   table, wbits=wbits)


def save_b_adj(path: str, b_adj: Sequence[np.ndarray]) -> None:
    """Append the six adjusted bias vectors, in order C1, C2_1, C2_2, C3_1,
    C3_2, C4, as btype (float under the INT8x4 config, mat.cuh:65):
    little-endian float32."""
    if len(b_adj) != 6:
        raise ValueError(f"expected 6 layers of b_adj, got {len(b_adj)}")
    with open(path, "ab") as fp:
        for b in b_adj:
            fp.write(np.asarray(b, dtype="<f4").tobytes())


def read_b_adj(path: str) -> List[List[np.ndarray]]:
    """Read back a save_b_adj file: one record per call, each the six
    b_adj vectors (64, 32, 16, 16, 32, 1 channels)."""
    raw = np.fromfile(path, dtype="<f4")
    per_call = sum(B_ADJ_SIZES)
    if raw.size % per_call:
        raise ValueError(f"corrupt b_adj file: {raw.size} floats")
    records = []
    for off in range(0, raw.size, per_call):
        rec, pos = [], off
        for s in B_ADJ_SIZES:
            rec.append(raw[pos:pos + s].copy())
            pos += s
        records.append(rec)
    return records


def calibrate_dynamic(
    p: DynamicParams, frames: np.ndarray, *, device
) -> Tuple[List[int], List[dict]]:
    """Run the dynamic integer path per frame on `device`, collecting max_u
    telemetry. Returns (per-group running maxima [C1, C2, C3], per-frame
    telemetry dicts)."""
    run = make_dynamic_forward(p, device=device)
    telemetry = []
    maxima = [0, 0, 0]
    for i in range(frames.shape[0]):
        _, tel = run(frames[i:i + 1])
        telemetry.append(tel)
        for j, m in enumerate(tel["max_u"]):
            maxima[j] = max(maxima[j], max(m) if isinstance(m, tuple) else m)
    return maxima, telemetry
