"""Integer parameters of the static and dynamic engines — the port's own
containers.

Mirrors `EngineParams` of `qcnn_gpu_tpu/models/oracle.py:50-73` (fields and
`validate`) and `DynamicParams` (:109-118, plus a `validate`, which the JAX
container lacks). Each `from_arrays` carries parameters across from any
object with the same attributes (the JAX package's containers included)
without importing it: scalar quant rows stay Python ints, per-channel rows
become int64 vectors, as `oracle.py:91-95` keeps them. Calibration
(`from_float`) belongs to a later slice.
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
