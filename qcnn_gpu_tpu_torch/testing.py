"""Shared fixtures of the port — its part of `qcnn_gpu_tpu/testing.py`.

`synth_frames` (:70-82) makes plausible video-like uint8 frames from a
seed; `cli validate` uses them when it is given no anchor. The synthetic
parameters (`synth_engine_params`, `synth_dynamic_params`) need the quant
tables and `EngineParams.from_float`, and belong to a later slice.
"""

from __future__ import annotations

import numpy as np


def synth_frames(n: int, h: int, w: int, seed: int = 0) -> np.ndarray:
    """Plausible video-ish frames: smooth gradients + blocky noise, uint8."""
    rng = np.random.default_rng(seed + 2)
    yy, xx = np.mgrid[0:h, 0:w]
    base = (
        128
        + 60 * np.sin(yy / 37.0)[None]
        + 50 * np.cos(xx / 53.0)[None]
        + rng.normal(0, 12, size=(n, h, w))
    )
    block = rng.integers(-6, 7, size=(n, (h + 7) // 8, (w + 7) // 8))
    base = base + np.kron(block, np.ones((1, 8, 8)))[:, :h, :w]
    return np.clip(base, 0, 255).astype(np.uint8)
