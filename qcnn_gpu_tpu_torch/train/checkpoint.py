"""Checkpoint/resume of the training state, in the JAX package's layout.

Counterpart of `qcnn_gpu_tpu/train/checkpoint.py` (:27-62), which writes
the flattened pytrees of the params and of optax's Adam state. The same
npz keys here, so each package reads the other's files:

    p0-p5    the six biases, b_C1 .. b_C4          (sorted name order,
    p6-p11   the six HWIO weights, w_C1 .. w_C4     the pytree flatten order)
    o0       Adam's step count, an int32 scalar
    o1-o12   Adam's first moments (mu), in the params' order
    o13-o24  Adam's second moments (nu), in the params' order

`<path>/ckpt-<step>.npz` and the `<path>/latest` JSON pointer ({"file",
"step"}) as in the JAX package. `adam_from_torch` / `adam_to_torch` map
`AdamState` to and from a `torch.optim.Adam` over a `FloatVRCNN`'s
parameters (`step`, `exp_avg`, `exp_avg_sq`; OIHW <-> HWIO). torch's
Adam and optax's `adam` compute the same update: lr * m_hat /
(sqrt(v_hat) + eps) with both moments bias-corrected.
"""

from __future__ import annotations

import dataclasses
import json
import os
from typing import Tuple

import numpy as np
import torch

from qcnn_gpu_tpu_torch.models.float_model import (
    PARAM_NAMES,
    FloatVRCNN,
    Params,
    params_from_jax,
    params_to_jax,
)


@dataclasses.dataclass
class AdamState:
    """optax's ScaleByAdamState in the JAX layout: count, mu, nu."""

    count: int
    mu: Params
    nu: Params

    @classmethod
    def zeros(cls, params: Params) -> "AdamState":
        """optax.adam(lr).init(params): count 0, zero moments."""
        return cls(0, {k: np.zeros_like(params[k]) for k in PARAM_NAMES},
                   {k: np.zeros_like(params[k]) for k in PARAM_NAMES})


def save_checkpoint(path: str, params: Params, adam: AdamState, step: int) -> None:
    """Writes `<path>/ckpt-<step>.npz` and updates `<path>/latest`."""
    os.makedirs(path, exist_ok=True)
    arrays = {f"p{i}": np.asarray(params[k], np.float32) for i, k in enumerate(PARAM_NAMES)}
    arrays["o0"] = np.asarray(adam.count, np.int32)
    for j, moments in enumerate((adam.mu, adam.nu)):
        for i, k in enumerate(PARAM_NAMES):
            arrays[f"o{1 + j * len(PARAM_NAMES) + i}"] = np.asarray(moments[k], np.float32)
    fname = os.path.join(path, f"ckpt-{step}.npz")
    np.savez(fname, **arrays)
    with open(os.path.join(path, "latest"), "w") as fp:
        json.dump({"file": os.path.basename(fname), "step": step}, fp)


def latest_checkpoint(path: str):
    """(file, step) that `<path>/latest` points at, or None."""
    meta_path = os.path.join(path, "latest")
    if not os.path.exists(meta_path):
        return None
    with open(meta_path) as fp:
        meta = json.load(fp)
    return os.path.join(path, meta["file"]), meta["step"]


def load_checkpoint(path: str) -> Tuple[Params, AdamState, int]:
    """The latest checkpoint under `path`: (params, Adam state, step)."""
    found = latest_checkpoint(path)
    if found is None:
        raise FileNotFoundError(f"no checkpoint under {path}")
    fname, step = found
    n = len(PARAM_NAMES)
    with np.load(fname) as data:
        params = {k: data[f"p{i}"] for i, k in enumerate(PARAM_NAMES)}
        mu = {k: data[f"o{1 + i}"] for i, k in enumerate(PARAM_NAMES)}
        nu = {k: data[f"o{1 + n + i}"] for i, k in enumerate(PARAM_NAMES)}
        count = int(data["o0"])
    return params, AdamState(count, mu, nu), step


def adam_from_torch(opt: torch.optim.Adam, model: FloatVRCNN) -> AdamState:
    """The optimizer's state over `model`'s parameters as an AdamState
    (zeros and count 0 before its first step)."""
    params = model.tensors()
    if not any(opt.state.get(p) for p in params.values()):
        return AdamState.zeros(model.to_jax())
    state = {k: opt.state[p] for k, p in params.items()}
    counts = {int(s["step"]) for s in state.values()}
    if len(counts) != 1:
        raise ValueError(f"parameters at different Adam steps: {sorted(counts)}")
    return AdamState(counts.pop(), params_to_jax({k: s["exp_avg"] for k, s in state.items()}),
                     params_to_jax({k: s["exp_avg_sq"] for k, s in state.items()}))


def adam_to_torch(adam: AdamState, opt: torch.optim.Adam, model: FloatVRCNN) -> None:
    """Load an AdamState into `opt`, an Adam over `model`'s parameters."""
    params = model.tensors()
    dev = next(iter(params.values())).device
    mu, nu = params_from_jax(adam.mu, dev), params_from_jax(adam.nu, dev)
    for k, p in params.items():
        opt.state[p] = {
            "step": torch.tensor(float(adam.count), dtype=torch.float32),
            "exp_avg": mu[k],
            "exp_avg_sq": nu[k],
        }
