"""Calibration telemetry of the dynamic path — the port's part of
`qcnn_gpu_tpu/engine/calibrate.py`.

`save_b_adj` / `read_b_adj` (:76-103) write and read the reference's
save_b_adj dump (qvrcnn.cu:288-304) with the same bytes, little-endian
float32 through numpy. `calibrate_dynamic` (:104-118) runs the dynamic
forward one frame at a time and collects its max_u telemetry, the
`save_steps` flow that fed the offline mul/shift solve; it runs the port's
`make_dynamic_forward` on a torch device where JAX runs the numpy oracle,
with the same return value. The float-model calibration (the 3-sigma BLU
bounds, the table solve and the model quantization) belongs to a later
slice with the float model.
"""

from __future__ import annotations

from typing import List, Sequence, Tuple

import numpy as np

from qcnn_gpu_tpu_torch.models.engine_params import DynamicParams
from qcnn_gpu_tpu_torch.models.qvrcnn_dynamic import make_dynamic_forward

B_ADJ_SIZES = (64, 32, 16, 16, 32, 1)  # C1, C2_1, C2_2, C3_1, C3_2, C4


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
