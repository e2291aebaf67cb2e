"""Validation tools — the port's part of `qcnn_gpu_tpu/engine/validate.py`.

`viewmem_report` (:132-160) is the viewmem analog (cnn.cu:203-248): the
5x5 corner of each layer's accumulator, and of C1's requantized output,
with the layer's mul/shift/blu, as text; `dump_features` (:109-129) is
the dump_feature analog (model.py:342-364): the six post-requant
activation tensors of the first frame written as raw int32 arrays in layer
order. Both read the intermediates of the port's literal reference net
(`models/qvrcnn.residual_blu` with a collector) on a torch device, and give
the JAX functions' text and bytes. `conv_validation`, which compares the
float model's scaled accumulators, belongs to a later slice with the float
model.
"""

from __future__ import annotations

from typing import Dict

import numpy as np
import torch

from qcnn_gpu_tpu_torch.models.engine_params import EngineParams
from qcnn_gpu_tpu_torch.models.qvrcnn import ModelParams, residual_blu

# layer name, its accumulator, its requantized output where viewmem shows it
_STAGES = (
    ("C1", "u1", "v1"), ("C2_1", "u2_1", None), ("C2_2", "u2_2", None),
    ("C3_1", "u3_1", None), ("C3_2", "u3_2", None), ("C4", "u4", None),
)
FEATURES = ("blu1", "blu2_1", "blu2_2", "blu3_1", "blu3_2", "conv4")


@torch.no_grad()
def _intermediates(p: EngineParams, frames: np.ndarray, device) -> Dict[str, np.ndarray]:
    """The literal net's intermediates on `device`, as NHWC int64 numpy
    arrays (the oracle's layout)."""
    inter: Dict[str, torch.Tensor] = {}
    x = torch.as_tensor(np.ascontiguousarray(frames, np.uint8), device=device)
    residual_blu(x[..., None].to(torch.int64) - 128, ModelParams.from_engine(p, device),
                 collect=inter)
    return {k: v.permute(0, 2, 3, 1).cpu().numpy() for k, v in inter.items()}


def dump_features(p: EngineParams, frames: np.ndarray, path: str, *, device) -> Dict[str, np.ndarray]:
    """Write the six post-requant activation tensors of `frames` to `path`
    as little-endian int32 arrays in layer order (blu1, blu2_1, blu2_2,
    blu3_1, blu3_2, conv4); returns them keyed by name."""
    inter = _intermediates(p, frames, device)
    conc1, conc2 = inter["conc1"], inter["conc2"]
    feats = {
        "blu1": inter["v1"],
        "blu2_1": conc1[..., :32],
        "blu2_2": conc1[..., 32:],
        "blu3_1": conc2[..., :16],
        "blu3_2": conc2[..., 16:],
        "conv4": inter["u4"],
    }
    with open(path, "wb") as fp:
        for name in FEATURES:
            fp.write(np.asarray(feats[name], dtype="<i4").tobytes())
    return feats


def viewmem_report(p: EngineParams, frames: np.ndarray, *, device) -> str:
    """Per-stage corner dump: each layer's mul/shift/blu, then the 5x5
    corner of its accumulator (and of C1's requantized output) in the
    first frame's first channel."""
    inter = _intermediates(p, frames, device)
    lines = []
    for idx, (name, ukey, vkey) in enumerate(_STAGES):
        lines.append(f"== {name} ==")
        lines.append(f"mul:{p.mul[idx]} shift:{p.shift[idx]} blu:{p.blu_q[idx]}")
        for label, key in (("u:", ukey), ("v:", vkey)):
            if key:
                lines.append(label)
                for r in inter[key][0, :5, :5, 0]:
                    lines.append("\t".join(str(int(v)) for v in r))
    return "\n".join(lines)
