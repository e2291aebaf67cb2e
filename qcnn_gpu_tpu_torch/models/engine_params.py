"""Integer parameters of the static and dynamic engines — the port's own
containers.

Mirrors `EngineParams` of `qcnn_gpu_tpu/models/oracle.py:50-73` (fields and
`validate`) and `DynamicParams` (:109-118, plus a `validate`, which the JAX
container lacks). Each `from_arrays` carries parameters across from any
object with the same attributes (the JAX package's containers included)
without importing it: scalar quant rows stay Python ints, per-channel rows
become int64 vectors, as `oracle.py:91-95` keeps them. `from_float`
(oracle.py:76-106) quantizes float HWIO weights and biases with a quant
table, in numpy and in the caller's dtype, as the JAX package does.
"""

from __future__ import annotations

import dataclasses
from typing import List, Union

import numpy as np

from qcnn_gpu_tpu_torch.models.topology import QVRCNN_LAYERS

Row = Union[int, np.ndarray]


def _validate_layers(weights, biases) -> None:
    for i, (layer, w, b) in enumerate(zip(QVRCNN_LAYERS, weights, biases)):
        k, _, cin, cout = w.shape
        assert w.dtype == np.int8, f"layer {i} weights must be int8"
        assert (k, cin, cout) == (layer.ksize, layer.in_ch, layer.out_ch), (
            f"layer {layer.name}: got {w.shape}"
        )
        assert b.shape == (layer.out_ch,)


def _row(v) -> Row:
    return np.asarray(v, np.int64) if np.ndim(v) else int(v)


@dataclasses.dataclass
class EngineParams:
    """weights: 6 int8 arrays in HWIO order [k, k, in_ch, out_ch]
    biases:  6 int32 arrays [out_ch] (accumulator domain)
    blu_q:   6 rows — BLU bound in the accumulator domain (0 for C4)
    mul/shift: 6 rows — per-layer requant scale
    (a row is an int, or an [out_ch] int64 vector for per-channel tables)"""

    weights: List[np.ndarray]
    biases: List[np.ndarray]
    blu_q: List[Row]
    mul: List[Row]
    shift: List[Row]

    def validate(self) -> None:
        _validate_layers(self.weights, self.biases)

    @classmethod
    def from_arrays(cls, obj) -> "EngineParams":
        """Read `obj.weights, .biases, .blu_q, .mul, .shift` as numpy."""
        return cls(
            weights=[np.asarray(w) for w in obj.weights],
            biases=[np.asarray(b) for b in obj.biases],
            blu_q=[_row(v) for v in obj.blu_q],
            mul=[_row(v) for v in obj.mul],
            shift=[_row(v) for v in obj.shift],
        )

    @classmethod
    def from_float(cls, weights_f, biases_f, table, wbits: int = 8) -> "EngineParams":
        """Quantize float HWIO weights/biases (numpy) onto the signed `wbits`
        grid with a QuantTable: w_int = clip(round(w/stepw), -2^(b-1),
        2^(b-1)-1) and b_int = round(b * ratio_in / stepw), the integer bias
        the engine adds in the accumulator domain. The arithmetic stays in
        the arrays' own dtype (float32 weights divided by a Python float
        stay float32 under NumPy 2) and rounds half to even, as the JAX
        package does, so both give the same integers. Per-channel rows
        (LayerQuantVec) broadcast over the output-channel axis and stay
        [out_ch] int64 vectors. wbits=4 is the INT4 stretch grid: its stepw
        must come from stepw_from_weights(bits=4) for full-range use."""
        lo, hi = -(1 << (wbits - 1)), (1 << (wbits - 1)) - 1
        ws, bs, blus, muls, shifts = [], [], [], [], []
        for wf, bf, row in zip(weights_f, biases_f, table):
            ws.append(np.clip(np.round(wf / row.stepw), lo, hi).astype(np.int8))
            bs.append(np.round(np.asarray(bf) * row.ratio / row.stepw).astype(np.int32))
            blus.append(_row(row.blu_q))
            muls.append(_row(row.mul))
            shifts.append(_row(row.shift))
        return cls(ws, bs, blus, muls, shifts)


@dataclasses.dataclass
class DynamicParams:
    """Parameters of the dynamic-quantization (calibration) engine:
    per-layer integer stepw plus int8 HWIO weights / int32 biases."""

    step_w: List[int]
    weights: List[np.ndarray]
    biases: List[np.ndarray]

    def validate(self) -> None:
        """The layer checks of EngineParams.validate; and six positive
        integer steps (the bias walk and the output rescale divide by
        them), else ValueError."""
        _validate_layers(self.weights, self.biases)
        if len(self.step_w) != len(QVRCNN_LAYERS):
            raise ValueError(f"expected {len(QVRCNN_LAYERS)} step_w values, got {len(self.step_w)}")
        for i, s in enumerate(self.step_w):
            if int(s) != s or s <= 0:
                raise ValueError(f"layer {i}: step_w must be a positive integer, got {s}")

    @classmethod
    def from_arrays(cls, obj) -> "DynamicParams":
        """Read `obj.step_w, .weights, .biases` as ints and numpy."""
        return cls(
            step_w=[int(v) for v in obj.step_w],
            weights=[np.asarray(w) for w in obj.weights],
            biases=[np.asarray(b) for b in obj.biases],
        )
