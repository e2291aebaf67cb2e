"""Validation tools — the port's part of `qcnn_gpu_tpu/engine/validate.py`.

`viewmem_report` (:132-160) is the viewmem analog (cnn.cu:203-248): the
5x5 corner of each layer's accumulator, and of C1's requantized output,
with the layer's mul/shift/blu, as text; `dump_features` (:109-129) is
the dump_feature analog (model.py:342-364): the six post-requant
activation tensors of the first frame written as raw int32 arrays in layer
order. Both read the intermediates of the port's literal reference net
(`models/qvrcnn.residual_blu` with a collector) on a torch device, and give
the JAX functions' text and bytes. `conv_validation` (:35-106, the
reference's conv_validation, model.py:366-383) runs the float model on the
same device and compares each layer's float pre-activation, scaled into
the integer domain by ratio_in/stepw, with the engine's exact accumulator
from the same collector.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List

import numpy as np
import torch

from qcnn_gpu_tpu_torch.models import float_model as FM
from qcnn_gpu_tpu_torch.models.engine_params import EngineParams
from qcnn_gpu_tpu_torch.models.qvrcnn import U_NAMES, ModelParams, residual_blu
from qcnn_gpu_tpu_torch.models.topology import QVRCNN_LAYERS
from qcnn_gpu_tpu_torch.quant.params import QuantTable

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


@dataclasses.dataclass
class LayerDiff:
    name: str
    max_abs_diff: float  # float-model-int-domain vs engine accumulator
    mean_abs_diff: float
    engine_corner: np.ndarray  # 5x5 corner of the engine value (viewmem)
    float_corner: np.ndarray


def conv_validation(
    float_params: FM.Params,
    table: QuantTable,
    engine_params: EngineParams,
    frames: np.ndarray,
    *,
    device,
) -> List[LayerDiff]:
    """Per-layer comparison of the float model's integer-scaled
    accumulators vs the INT engine's exact accumulators, both on `device`.

    The float value of layer L's pre-activation (activations clipped at
    the table's blu_adj), multiplied by ratio_in/stepw (model.py:379-382),
    should land within quantization error of the engine's accumulator u.
    Large deviations localize numeric breakage to a layer."""
    with torch.no_grad():
        pre = FM.pre_activations(FM.params_from_jax(float_params, device), frames, table.blu_adj)
    engine_u = _intermediates(engine_params, frames, device)
    out = []
    for i, layer in enumerate(QVRCNN_LAYERS):
        row = table[i]
        scaled = pre[layer.name].permute(0, 2, 3, 1).cpu().numpy() * (row.ratio / row.stepw)
        eng = engine_u[U_NAMES[i]].astype(np.float64)
        diff = np.abs(scaled - eng)
        out.append(LayerDiff(
            name=layer.name,
            max_abs_diff=float(diff.max()),
            mean_abs_diff=float(diff.mean()),
            engine_corner=eng[0, :5, :5, 0].copy(),
            float_corner=np.round(scaled[0, :5, :5, 0]).copy(),
        ))
    return out
