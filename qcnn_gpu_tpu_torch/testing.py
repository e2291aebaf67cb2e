"""Shared fixtures of the port — its copy of `qcnn_gpu_tpu/testing.py`
(:23-82) and of `scripts/train_demo.py`'s data (:32-68).

The committed assets hold per-QP quant tables but no int8 weights, so
tests and the smoke run synthesize weights on the int8 grid from the real
tables (`assets/quant_params*.data`): `synth_float_weights`,
`synth_engine_params`, `synth_dynamic_params`, with the JAX package's
draws from the same seeds. `synth_frames` makes plausible video-like
uint8 frames (`cli validate` uses them when it is given no anchor);
`make_clean_frames` and `dct_compress` make the training demo's clean
frames and their 8x8 block-DCT-quantized anchors (codec-like blocking
and ringing).
"""

from __future__ import annotations

import os

import numpy as np

from qcnn_gpu_tpu_torch.models.engine_params import DynamicParams, EngineParams
from qcnn_gpu_tpu_torch.models.topology import QVRCNN_LAYERS, weight_shape_hwio
from qcnn_gpu_tpu_torch.quant.params import QuantTable

ASSETS_DIR = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "assets")


def asset(name: str) -> str:
    return os.path.join(ASSETS_DIR, name)


def load_table(qp: int = 37) -> QuantTable:
    return QuantTable.load_pickle(asset(f"quant_params{qp}.data"))


def synth_float_weights(seed: int = 0, scale: float = 0.06):
    """He-ish float weights + small biases, shaped per topology."""
    rng = np.random.default_rng(seed)
    ws, bs = [], []
    for layer in QVRCNN_LAYERS:
        fan_in = layer.ksize * layer.ksize * layer.in_ch
        ws.append(rng.normal(0.0, scale / np.sqrt(fan_in / 25.0),
                             size=weight_shape_hwio(layer)).astype(np.float32))
        bs.append(rng.normal(0.0, 0.01, size=(layer.out_ch,)).astype(np.float32))
    return ws, bs


def synth_engine_params(qp: int = 37, seed: int = 0) -> EngineParams:
    """EngineParams with the real QP table and synthesized int8 weights.

    fixed_last_row() repairs QP22's stale shift=24 output row (which would
    zero the residual, see QuantTable.last_row_stale); the other QPs pass
    through unchanged."""
    ws, bs = synth_float_weights(seed)
    return EngineParams.from_float(ws, bs, load_table(qp).fixed_last_row())


def synth_dynamic_params(qp: int = 37, seed: int = 0) -> DynamicParams:
    """DynamicParams (stepw, w, b) for the calibration path: the weights of
    the unrepaired table, and a small positive integer step per layer as
    the dynamic format stores it (cnn.cu:78)."""
    rng = np.random.default_rng(seed + 1)
    ws, bs = synth_float_weights(seed)
    p = EngineParams.from_float(ws, bs, load_table(qp))
    step_w = [int(rng.integers(2, 30)) for _ in range(6)]
    return DynamicParams(step_w, p.weights, p.biases)


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


def make_clean_frames(n: int, h: int, w: int, seed: int = 0) -> np.ndarray:
    """Natural-ish luma: smooth gradients + oriented textures + edges."""
    rng = np.random.default_rng(seed)
    yy, xx = np.mgrid[0:h, 0:w].astype(np.float64)
    out = np.empty((n, h, w))
    for i in range(n):
        f1, f2 = rng.uniform(0.01, 0.1, 2)
        ph = rng.uniform(0, 6.28, 4)
        img = (
            120
            + 45 * np.sin(f1 * xx + ph[0]) * np.cos(f2 * yy + ph[1])
            + 30 * np.sin(0.5 * f2 * (xx + yy) + ph[2])
        )
        # hard edges (blocking shows strongly on these)
        for _ in range(6):
            x0, y0 = rng.integers(0, w), rng.integers(0, h)
            val = rng.uniform(-50, 50)
            img[y0:, x0:] += val * 0.5
            img[: y0 // 2] -= val * 0.25
        img += rng.normal(0, 3, size=(h, w))
        out[i] = img
    return np.clip(out, 0, 255).astype(np.uint8)


def dct_compress(frames: np.ndarray, q: float = 28.0) -> np.ndarray:
    """8x8 block DCT quantization — codec-like degradation (scipy)."""
    from scipy.fft import dctn, idctn

    f = frames.astype(np.float64) - 128.0
    n, h, w = f.shape
    out = np.empty_like(f)
    for i in range(n):
        for y in range(0, h, 8):
            for x in range(0, w, 8):
                c = dctn(f[i, y:y + 8, x:x + 8], norm="ortho")
                out[i, y:y + 8, x:x + 8] = idctn(np.round(c / q) * q, norm="ortho")
    return np.clip(out + 128.0, 0, 255).astype(np.uint8)
