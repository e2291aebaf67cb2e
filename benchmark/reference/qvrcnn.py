"""QVRCNN's integer forward pass, plain, and the reader of its static
model file.

The network (binbinmeng/QCNN_GPU `inference/qvrcnn.cu:10-18`,
`training/model.py:34-49`), on the decoded luma x:

    v1    = BLU(C1 5x5 1->64 (x - 128))
    conc1 = BLU(C2_1 3x3 64->32 (v1)) ++ BLU(C2_2 5x5 64->16 (v1))
    conc2 = BLU(C3_1 3x3 48->16 (conc1)) ++ BLU(C3_2 1x1 48->32 (conc1))
    out   = clamp(x + residual(C4 3x3 48->1 (conc2)), 0, 255)

with each BLU its layer's (blu_q, mul, shift) requant and the residual the
floor-shifted (mul, shift) of C4, as `conv.py` defines them. Every layer
pads its input with zeros at the frame's edge.

The model file is the engine-side NCHW_VECT_C layout: per layer in the
order above, int8 weights [cout][ceil4(cin)/4][k][k][4] (channel c in
block c // 4, lane c % 4, the tail lanes zero), int32 biases [cout], then
blu_q, mul and shift as three little-endian int32.
"""

from __future__ import annotations

import dataclasses
import hashlib
import os
from typing import List, Sequence

import numpy as np
import torch

from benchmark.reference.conv import blu_requant, conv_same, final_residual, int4_weights, restored


@dataclasses.dataclass
class Params:
    """weights int8 HWIO [k, k, cin, cout], biases int32 [cout] (numpy) and
    the scalar rows, one per layer in file order."""

    weights: List[np.ndarray]
    biases: List[np.ndarray]
    blu_q: List[int]
    mul: List[int]
    shift: List[int]


def read_vect_c(path: str, layers: Sequence[Sequence]) -> Params:
    """Read a static vect_c model file for `layers`, each [name, k, cin,
    cout] in file order; raises ValueError on a short or long file."""
    with open(path, "rb") as fp:
        data = fp.read()
    off = 0
    p = Params([], [], [], [], [])

    def take(n: int) -> bytes:
        nonlocal off
        if off + n > len(data):
            raise ValueError(f"{path}: ends at byte {len(data)}, needs {off + n}")
        off += n
        return data[off - n:off]

    for _, k, cin, cout in layers:
        c4 = (cin + 3) // 4 * 4
        v = np.frombuffer(take(k * k * c4 * cout), np.int8).reshape(cout, c4 // 4, k, k, 4)
        w = v.transpose(2, 3, 1, 4, 0).reshape(k, k, c4, cout)[:, :, :cin]
        p.weights.append(np.ascontiguousarray(w))
        p.biases.append(np.frombuffer(take(4 * cout), "<i4").astype(np.int32))
        blu, mul, shift = np.frombuffer(take(12), "<i4")
        p.blu_q.append(int(blu))
        p.mul.append(int(mul))
        p.shift.append(int(shift))
    if off != len(data):
        raise ValueError(f"{path}: {len(data) - off} bytes past the last layer")
    return p


def load(config: dict, seed: int, root: str, device) -> Params:
    """The configuration's model file (a path from the checkout's root),
    checked against its sha256; the seed plays no part."""
    path = os.path.join(root, config["model_file"])
    with open(path, "rb") as fp:
        digest = hashlib.sha256(fp.read()).hexdigest()
    if digest != config["model_sha256"]:
        raise ValueError(f"{path}: sha256 {digest}, the configuration states {config['model_sha256']}")
    return read_vect_c(path, config["layers"])


def forward(x_u8: torch.Tensor, p: Params, int4: bool = False) -> torch.Tensor:
    """uint8 [N, H, W] -> restored uint8 [N, H, W], on x's device. int4:
    the weights carried at 4 bits (the control)."""
    dev = x_u8.device
    ws = [torch.as_tensor(w, device=dev) for w in p.weights]
    if int4:
        ws = [int4_weights(w) for w in ws]
    bs = [torch.as_tensor(b, device=dev) for b in p.biases]

    def layer(v, i):
        return blu_requant(conv_same(v, ws[i], bs[i]), p.blu_q[i], p.mul[i], p.shift[i])

    x = x_u8[:, None].to(torch.int64) - 128
    v1 = layer(x, 0)
    conc1 = torch.cat([layer(v1, 1), layer(v1, 2)], dim=1)
    del v1
    conc2 = torch.cat([layer(conc1, 3), layer(conc1, 4)], dim=1)
    del conc1
    res = final_residual(conv_same(conc2, ws[5], bs[5]), p.mul[5], p.shift[5])[:, 0]
    return restored(x_u8, res)
