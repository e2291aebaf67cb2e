"""QVRCNN network topology — the port's own copy.

Mirrors `qcnn_gpu_tpu/models/topology.py:19-64` (LayerDef, QVRCNN_LAYERS,
QVRCNN_CONCATS, RECEPTIVE_RADIUS, MACS_PER_PIXEL, weight_shape_hwio). The 4-stage
variable-filter-size CNN predicting a residual over the decoded Y plane;
all convs are stride-1 SAME cross-correlations.

Layer order everywhere (files, tables, parameter tuples):
    C1, C2_1, C2_2, C3_1, C3_2, C4
"""

from __future__ import annotations

import dataclasses
from typing import Tuple


@dataclasses.dataclass(frozen=True)
class LayerDef:
    name: str
    ksize: int
    in_ch: int
    out_ch: int
    blu: bool  # bounded-linear-unit activation (clip 0..blu); False => linear
    input: str  # name of the producing node: "input" | layer | concat name


QVRCNN_LAYERS: Tuple[LayerDef, ...] = (
    LayerDef("C1", 5, 1, 64, True, "input"),
    LayerDef("C2_1", 3, 64, 32, True, "C1"),
    LayerDef("C2_2", 5, 64, 16, True, "C1"),
    LayerDef("C3_1", 3, 48, 16, True, "Conc1"),
    LayerDef("C3_2", 1, 48, 32, True, "Conc1"),
    LayerDef("C4", 3, 48, 1, False, "Conc2"),
)

# concat nodes: (name, (branch_a, branch_b)) — channel concat, a first
QVRCNN_CONCATS = (
    ("Conc1", ("C2_1", "C2_2")),
    ("Conc2", ("C3_1", "C3_2")),
)

# Spatial receptive-field radius: 2 (5x5) + 2 (5x5 via C2_2) + 1 + 1 = 6 px,
# the halo a tile needs to be bit-exact at its seams.
RECEPTIVE_RADIUS = 6

# Useful multiply-accumulates per output pixel (54,512).
MACS_PER_PIXEL = sum(l.ksize * l.ksize * l.in_ch * l.out_ch for l in QVRCNN_LAYERS)


def weight_shape_hwio(layer: LayerDef) -> Tuple[int, int, int, int]:
    """Training-side HWIO (a.k.a. HWCN in the reference's file naming)."""
    return (layer.ksize, layer.ksize, layer.in_ch, layer.out_ch)
