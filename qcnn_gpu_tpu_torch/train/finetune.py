"""Quantization-aware fine-tune — the shadow-weight scheme of model.py:
170-233, the port's counterpart of `qcnn_gpu_tpu/train/finetune.py`
(:34-91).

Contract (per reference step):
  * the model always runs on grid weights  wq = round(wf/stepw)*stepw
    (initialized with a clip to [-2^(b-1), 2^(b-1)-1] steps, model.py:199-202);
  * Adam's update is folded back into the float shadow wf, which is
    clipped to the representable range [qlo*stepw, qhi*stepw]
    (model.py:218-222: we = wn - wq; wf += we; clip; requantize);
  * biases keep training in plain float (their quantize-assign is
    commented out in the reference, model.py:203-206/223-227).

Here the shadow floats are the optimizer's parameters: each step builds
wq from them without grad, and sets each shadow weight's gradient to
dL/dwq (the straight-through estimate), which is what the JAX step does
when it differentiates at wq and adds the update to wf. The gradients come
from `trainer.make_grad_fn` over a (dp, sp) mesh, as finetune.py:52 takes
them (default: `trainer.default_mesh(device)`). The mesh may span
processes (`parallel/mesh.make_global_mesh`): every rank then runs the
fine-tune on the same batches, `make_grad_fn` gives each the global
gradients, and every rank returns the same grid weights; nothing here
changes for it. Grid arithmetic is
float32 with a float32 step tensor, as the JAX package's, and rounds half
to even. A per-channel table's [out_ch] steps broadcast over the output
channels.
"""

from __future__ import annotations

from typing import Optional, Sequence

import numpy as np
import torch

from qcnn_gpu_tpu_torch.models import float_model as FM
from qcnn_gpu_tpu_torch.models.topology import QVRCNN_LAYERS
from qcnn_gpu_tpu_torch.parallel.mesh import Mesh
from qcnn_gpu_tpu_torch.train.trainer import default_mesh, make_adam, make_grad_fn


def _quantize_w(wf: torch.Tensor, stepw: torch.Tensor) -> torch.Tensor:
    return torch.round(wf / stepw) * stepw


def quant_finetune(
    params: FM.Params,
    stepw: Sequence,
    batches,
    *,
    device=None,
    mesh: Optional[Mesh] = None,
    blu_ub: Optional[Sequence[float]] = None,
    lr: float = 1e-4,
    log_every: int = 10,
    log_fn=print,
    wbits: int = 8,
) -> FM.Params:
    """Run the shadow-weight fine-tune on `mesh` (or on the default mesh of
    `device`: give exactly one; a mesh that spans processes is called on
    every rank of it with the same batches) over `batches` of (images, labels)
    raw-valued float32 [N,H,W,1]. Returns params (JAX
    layout) whose weights sit exactly on the signed `wbits` grid
    (round(w/stepw) in [-2^(b-1), 2^(b-1)-1]; wbits=4 is the INT4 stretch
    variant — same shadow-weight contract, coarser grid)."""
    if (mesh is None) == (device is None):
        raise TypeError("quant_finetune: give exactly one of mesh and device")
    mesh = mesh if mesh is not None else default_mesh(device)
    grad_fn = make_grad_fn(mesh, blu_ub)
    qlo, qhi = float(-(1 << (wbits - 1))), float((1 << (wbits - 1)) - 1)
    wf = FM.FloatVRCNN(params, device=mesh.first, blu_ub=blu_ub)
    dev = next(wf.parameters()).device

    def per_out_channel(v):  # [out_ch] or scalar, float32 -> [O, 1, 1, 1] on dev
        return torch.as_tensor(np.asarray(v, np.float32)).reshape(-1, 1, 1, 1).to(dev)

    grid = {}  # weight name -> (step, lowest, highest), the clip bounds from float64
    for i, layer in enumerate(QVRCNN_LAYERS):
        s = np.asarray(stepw[i], np.float64)
        grid[f"w_{layer.name}"] = (per_out_channel(s), per_out_channel(qlo * s),
                                   per_out_channel(qhi * s))

    # shadow floats; initial clip onto the grid range (model.py:199-202)
    with torch.no_grad():
        for name, (s, _, _) in grid.items():
            w = getattr(wf, name)
            w.copy_(torch.clamp(torch.round(w / s), qlo, qhi) * s)
    opt = make_adam(wf, lr)

    for n, (images, labels) in enumerate(batches, 1):
        wq = wf.tensors()
        with torch.no_grad():
            for name, (s, _, _) in grid.items():
                wq[name] = _quantize_w(wq[name], s)
        loss, grads = grad_fn(wq, images, labels)
        for name in FM.PARAM_NAMES:
            getattr(wf, name).grad = grads[name]
        opt.step()
        with torch.no_grad():
            for name, (_, lo, hi) in grid.items():
                w = getattr(wf, name)
                w.copy_(torch.minimum(torch.maximum(w, lo), hi))
        if log_every and n % log_every == 0:
            log_fn(f"finetune step {n}: loss {loss.item():.6f}")

    # final grid weights (sess.run(update) before save, model.py:228)
    out = wf.tensors()
    with torch.no_grad():
        for name, (s, _, _) in grid.items():
            out[name] = _quantize_w(out[name], s)
    return FM.params_to_jax(out)
