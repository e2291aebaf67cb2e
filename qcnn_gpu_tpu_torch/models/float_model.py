"""Float VRCNN in PyTorch — the training-side twin of the int8 engine.

Counterpart of `qcnn_gpu_tpu/models/float_model.py` (:30-172):
`init_params` (the same numpy draws), `residual_float` with `collect`,
`predict_uint8`, `predict_uint8_tiled`, `l2_loss` and
`activation_sigmas`, plus `FloatVRCNN`, the net as an `nn.Module`. Two
activation variants, as in the reference (`training/model.py:72-110`):
ReLU for the float training, clip(x, 0, blu_ub[i]) for the BLU retrain.
Both are written as torch.maximum / torch.minimum, whose gradient splits a
tie evenly, as jnp.maximum / jnp.clip do (a pre-activation of exactly 0 is
common at init: zero biases, and inputs at pixel value 128).

Normalization contract (model.py:32-33): x_norm = (x - 128)/255; the net
predicts a residual in normalized units; pred = residual + x_norm; raw
pixels = pred*255 + 128 (model.py:285).

Two layouts of the parameters:
  * `Params`, the JAX package's: a dict of numpy float32 arrays, `w_<layer>`
    HWIO and `b_<layer>` [out]. Checkpoints, the quant solver and
    `quantize_model` take this one.
  * `TorchParams`, the module's: the same names, weights OIHW, as tensors
    on one device. The functions below take this one.
`params_from_jax` / `params_to_jax` convert. Activations enter and leave
as [N, H, W, 1] (NHWC with C=1), which is [N, 1, H, W] in memory: a
reshape, not a copy.

Precision: every float convolution here runs at full float32. On the card
cuDNN would run float32 convolutions in TF32 (about three decimal digits)
by default, and the calibration solve jumps between (mul, shift) pairs
for bound changes of 0.25%; `fp32_convs` scopes the setting to the
float code (forward and backward) and restores it on exit.
"""

from __future__ import annotations

import contextlib
from typing import Dict, List, Mapping, Optional, Sequence

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from qcnn_gpu_tpu_torch.models.topology import QVRCNN_LAYERS, weight_shape_hwio

Params = Dict[str, np.ndarray]  # w_* HWIO, b_* [out]: the JAX package's layout
TorchParams = Mapping[str, torch.Tensor]  # w_* OIHW, b_* [out], on one device

# the parameter names in sorted order, which is the JAX package's pytree
# flatten order (and so the checkpoint's p0..p11): the six biases, then the
# six weights
PARAM_NAMES = tuple(sorted(f"{k}_{l.name}" for l in QVRCNN_LAYERS for k in ("w", "b")))


@contextlib.contextmanager
def fp32_convs():
    """Inside, cuDNN runs float32 convolutions in full float32 (not TF32);
    the previous setting comes back on exit."""
    conv = torch.backends.cudnn.conv
    prev = conv.fp32_precision
    conv.fp32_precision = "ieee"
    try:
        yield
    finally:
        conv.fp32_precision = prev


def init_params(seed: int = 0) -> Params:
    """He/variance-scaling init (model.py:35-40), biases zero (model.py:
    43-48): the JAX package's draws from numpy's default_rng(seed), in
    float32."""
    rng = np.random.default_rng(seed)
    params = {}
    for layer in QVRCNN_LAYERS:
        fan_in = layer.ksize * layer.ksize * layer.in_ch
        w = rng.normal(0.0, np.sqrt(2.0 / fan_in), size=weight_shape_hwio(layer))
        params[f"w_{layer.name}"] = w.astype(np.float32)
        params[f"b_{layer.name}"] = np.zeros((layer.out_ch,), np.float32)
    return params


def params_to_lists(params: Mapping):
    """(weights, biases) in layer order."""
    return ([params[f"w_{l.name}"] for l in QVRCNN_LAYERS],
            [params[f"b_{l.name}"] for l in QVRCNN_LAYERS])


def params_from_jax(params: Mapping, device) -> Dict[str, torch.Tensor]:
    """JAX-layout params (HWIO weights; numpy or anything np.array
    reads) -> float32 tensors on `device`, weights OIHW. Always copies:
    training the tensors never writes to the caller's arrays."""
    out = {}
    for name in PARAM_NAMES:
        t = torch.from_numpy(np.array(params[name], np.float32))
        out[name] = (t.permute(3, 2, 0, 1) if name[0] == "w" else t).contiguous().to(device)
    return out


def params_to_jax(params: TorchParams) -> Params:
    """Module-layout tensors -> JAX-layout float32 numpy arrays (HWIO),
    copies that later steps on the tensors leave as they are."""
    out = {}
    for name in PARAM_NAMES:
        t = params[name].detach().to("cpu", copy=True)
        out[name] = (t.permute(2, 3, 1, 0) if name[0] == "w" else t).contiguous().numpy()
    return out


def _conv(x: torch.Tensor, params: TorchParams, name: str) -> torch.Tensor:
    """SAME cross-correlation + bias, NCHW."""
    w = params[f"w_{name}"]
    return F.conv2d(x, w, params[f"b_{name}"], padding=w.shape[-1] // 2)


def _act(x: torch.Tensor, blu_ub, i: int) -> torch.Tensor:
    """ReLU (blu_ub None) or clip(x, 0, blu_ub[i]), with tie-splitting
    gradients."""
    a = torch.maximum(x, x.new_zeros(()))
    return a if blu_ub is None else torch.minimum(a, x.new_tensor(float(blu_ub[i])))


def _nchw(x: torch.Tensor) -> torch.Tensor:
    """[N, H, W, 1] -> [N, 1, H, W] (the same memory)."""
    n, h, w, c = x.shape
    if c != 1:
        raise ValueError(f"expected [N, H, W, 1] activations, got {tuple(x.shape)}")
    return x.reshape(n, 1, h, w)


def _nhwc(x: torch.Tensor) -> torch.Tensor:
    return x.permute(0, 2, 3, 1)


def _normalize(x_uint8, params: TorchParams) -> torch.Tensor:
    """uint8 frames [N, H, W] (numpy or tensor) -> x_norm [N, H, W, 1]
    float32 on the parameters' device."""
    x = torch.as_tensor(x_uint8, device=params[PARAM_NAMES[0]].device)
    return (x[..., None].to(torch.float32) - 128.0) / 255.0


def _pre_activations(params: TorchParams, x: torch.Tensor, blu_ub) -> Dict[str, torch.Tensor]:
    """The net on x [N, 1, H, W]: each layer's pre-activation (conv + bias,
    before its clip), NCHW, keyed by layer name; C4's is the residual."""
    with fp32_convs():
        pre = {"C1": _conv(x, params, "C1")}
        a1 = _act(pre["C1"], blu_ub, 0)
        pre["C2_1"], pre["C2_2"] = _conv(a1, params, "C2_1"), _conv(a1, params, "C2_2")
        c2 = torch.cat([_act(pre["C2_1"], blu_ub, 1), _act(pre["C2_2"], blu_ub, 2)], dim=1)
        pre["C3_1"], pre["C3_2"] = _conv(c2, params, "C3_1"), _conv(c2, params, "C3_2")
        c3 = torch.cat([_act(pre["C3_1"], blu_ub, 3), _act(pre["C3_2"], blu_ub, 4)], dim=1)
        pre["C4"] = _conv(c3, params, "C4")
    return pre


def residual_float(
    params: TorchParams,
    x_norm: torch.Tensor,
    blu_ub: Optional[Sequence[float]] = None,
    collect: bool = False,
):
    """x_norm: [N, H, W, 1] normalized input -> residual [N, H, W, 1].

    blu_ub None => ReLU variant; else the 6-vector of BLU upper bounds
    (last entry unused — C4 is linear). collect=True also returns the
    post-activations a1, a2_1, a2_2, a3_1, a3_2 and res, [N, H, W, C]."""
    pre = _pre_activations(params, _nchw(x_norm), blu_ub)
    out = pre["C4"].reshape(x_norm.shape)
    if collect:
        acts = {f"a{l.name[1:]}": _nhwc(_act(pre[l.name], blu_ub, i))
                for i, l in enumerate(QVRCNN_LAYERS[:5])}
        return out, {**acts, "res": _nhwc(pre["C4"])}
    return out


@torch.no_grad()
def predict_uint8(params: TorchParams, x_uint8, blu_ub=None) -> torch.Tensor:
    """Full float restoration of [N, H, W] uint8 frames -> uint8 tensor on
    the parameters' device (round half to even, as jnp.round)."""
    x_norm = _normalize(x_uint8, params)
    pred = residual_float(params, x_norm, blu_ub) + x_norm
    raw = pred[..., 0] * 255.0 + 128.0
    return torch.clamp(torch.round(raw), 0.0, 255.0).to(torch.uint8)


def predict_uint8_tiled(
    params: TorchParams,
    x_uint8: np.ndarray,
    blu_ub=None,
    tile: int = 768,
    pad: int = 10,
) -> np.ndarray:
    """Tiled float restoration for frames too large for one pass — the
    divided_run analog (model.py:235-255): overlapping tiles with a
    `pad`-pixel halo (>= the receptive radius 6; the reference used 10),
    halo cropped at stitch time. Every kept pixel's receptive field lies
    inside its tile, so the output equals predict_uint8 wherever the
    convolution sums each pixel in the same order for both shapes (on the
    CPU it does; on the card cuDNN may pick another algorithm per tile
    shape). uint8 numpy [N, H, W] in and out."""
    x = np.asarray(x_uint8)
    n, h, w = x.shape
    out = np.empty_like(x)
    for y0 in range(0, h, tile):
        for x0 in range(0, w, tile):
            y1, x1 = min(y0 + tile, h), min(x0 + tile, w)
            ys, xs = max(0, y0 - pad), max(0, x0 - pad)
            ye, xe = min(h, y1 + pad), min(w, x1 + pad)
            pred = predict_uint8(params, np.ascontiguousarray(x[:, ys:ye, xs:xe]), blu_ub)
            out[:, y0:y1, x0:x1] = pred[:, y0 - ys:y1 - ys, x0 - xs:x1 - xs].cpu().numpy()
    return out


def l2_loss(params: TorchParams, images: torch.Tensor, labels: torch.Tensor, blu_ub=None):
    """0.5 * sum((labels_norm - pred)^2), the tf.nn.l2_loss objective
    (model.py:59). images/labels: [N, H, W, 1] raw-valued float32 on the
    parameters' device."""
    x_norm = (images - 128.0) / 255.0
    y_norm = (labels - 128.0) / 255.0
    pred = residual_float(params, x_norm, blu_ub) + x_norm
    return 0.5 * torch.sum(torch.square(y_norm - pred))


def pre_activations(params: TorchParams, x_uint8, blu_ub=None) -> Dict[str, torch.Tensor]:
    """Each layer's float pre-activation (conv + bias, before its clip),
    NCHW, keyed by layer name, for uint8 frames [N, H, W]."""
    return _pre_activations(params, _nchw(_normalize(x_uint8, params)), blu_ub)


@torch.no_grad()
def activation_sigmas(params: TorchParams, x_uint8, blu_ub=None) -> List[float]:
    """Per-layer activation std-devs (pre-clip) for 3-sigma BLU calibration
    (the 'observed 3sigma' comments, quantization.py:70-76). Returns 6
    floats; the last is 0 (linear layer). The population std (ddof 0, as
    jnp.std), summed in float64 over the float32 pre-activations."""
    pre = pre_activations(params, x_uint8, blu_ub)
    return [float(pre[l.name].to(torch.float64).std(correction=0))
            for l in QVRCNN_LAYERS[:5]] + [0.0]


class FloatVRCNN(nn.Module):
    """The float net as a module: `forward(x_norm [N, H, W, 1])` -> the
    residual. Its parameters are `PARAM_NAMES` (weights OIHW), registered
    in that order, so `parameters()` runs in the checkpoint's order.
    `device` is required (no CPU default)."""

    def __init__(self, params: Mapping, *, device, blu_ub: Optional[Sequence[float]] = None):
        super().__init__()
        for name, t in params_from_jax(params, device).items():
            self.register_parameter(name, nn.Parameter(t))
        self.blu_ub = list(blu_ub) if blu_ub is not None else None

    def tensors(self) -> Dict[str, torch.Tensor]:
        return {name: getattr(self, name) for name in PARAM_NAMES}

    def to_jax(self) -> Params:
        return params_to_jax(self.tensors())

    def forward(self, x_norm: torch.Tensor) -> torch.Tensor:
        return residual_float(self.tensors(), x_norm, self.blu_ub)
