"""Float VRCNN training — the port's counterpart of
`qcnn_gpu_tpu/train/trainer.py` (:19-242).

The reference trains with TF1 Adam on 64x64 patch batches, the L2 loss
over normalized pixels (model.py:112-149). The JAX package's step is one
SPMD program over a (dp, sp) mesh; here `make_grad_fn` runs it over the
port's `Mesh` (:71-132):

  dp  batch sharding: the patches split over the mesh's dp axis;
  sp  row sharding with a halo exchange: each block takes RECEPTIVE_RADIUS
      rows of the normalized input from its row neighbours (zeros at the
      frame's edges, `parallel/spatial.halo_exchange_rows`: `narrow`,
      `.to()` and `torch.cat`, which autograd differentiates), and every
      activation is masked to the frame's rows, so the sharded forward is
      the unsharded one and the loss, a sum over kept rows, too.

Each shard takes its local loss and `torch.autograd.grad` of it (the
halo carries data, not parameters), and the losses and gradients are
summed over the mesh in shard order on its first device, which is the
JAX psum of local gradients. The shards run in turn from the caller's
thread, one device each (a virtual mesh repeats one device). The mesh
is one process's (`make_mesh`; a mesh that spans processes raises
NotImplementedError), so the sums cover this process's patches only,
whatever process group exists; to train dp across processes the caller
passes a gloo `group`, each process its own patches, and the sums are
all-reduced over it; sp stays in a process. With sp = 1 no halo is exchanged (as
`parallel/spatial` extends no unsplit axis): a block's loss is
`float_model.l2_loss`, so the 1x1 mesh's gradients are its backward.

`torch.optim.Adam(lr, betas=(0.9, 0.999), eps=1e-8)` is optax's default
`adam`; the loss is 0.5 * sum of squares (tf.nn.l2_loss); the
convolutions, forward and backward, run at full float32
(`float_model.fp32_convs`).
"""

from __future__ import annotations

import dataclasses
import json
import math
import os
import time
from typing import Optional, Sequence

import numpy as np
import torch
import torch.distributed as dist

from qcnn_gpu_tpu_torch.models import float_model as FM
from qcnn_gpu_tpu_torch.models.topology import RECEPTIVE_RADIUS
from qcnn_gpu_tpu_torch.parallel.mesh import Mesh, make_mesh, mesh_on
from qcnn_gpu_tpu_torch.parallel.spatial import halo_exchange_rows, split_blocks
from qcnn_gpu_tpu_torch.train.checkpoint import (
    adam_from_torch,
    adam_to_torch,
    load_checkpoint,
    save_checkpoint,
)


@dataclasses.dataclass
class TrainConfig:
    """The run's knobs; the BLU variant is `Trainer`'s `blu_ub`."""

    lr: float = 1e-4  # main.py:19
    batch_size: int = 64  # main.py:14
    patch: int = 64  # main.py:15 sub_image_size
    epochs: int = 30  # main.py:10
    seed: int = 0
    log_every: int = 10


def make_adam(model: torch.nn.Module, lr: float) -> torch.optim.Adam:
    """optax.adam(lr) as a torch optimizer over `model`'s parameters."""
    return torch.optim.Adam(model.parameters(), lr=lr, betas=(0.9, 0.999), eps=1e-8)


def dump_image_triplet(image_dir, step, inp, out, target) -> str:
    """Write one input|output|target side-by-side PNG — the reference's
    tf.summary.image triplet (model.py:61-69) as a plain file artifact;
    a raw PGM where PIL is missing. inp/out/target: uint8 [H, W]. Returns
    the written path."""
    os.makedirs(image_dir, exist_ok=True)
    sep = np.full((inp.shape[0], 4), 255, np.uint8)
    strip = np.concatenate([inp, sep, out, sep, target], axis=1)
    path = os.path.join(image_dir, f"triplet_{step:07d}.png")
    try:
        from PIL import Image

        Image.fromarray(strip, "L").save(path)
    except ImportError:  # PNG writer unavailable: fall back to raw PGM
        path = path[:-4] + ".pgm"
        with open(path, "wb") as fp:
            fp.write(b"P5\n%d %d\n255\n" % (strip.shape[1], strip.shape[0]))
            fp.write(strip.tobytes())
    return path


def _masked_residual(params: FM.TorchParams, x_norm: torch.Tensor, blu_ub, row_valid):
    """The float residual of x_norm [n, 1, h, w] with the input and every
    activation zeroed outside `row_valid` [h] (:71-85): per-layer SAME
    padding at a frame edge inside the block."""
    keep = row_valid.view(1, 1, -1, 1)

    def mask(a):
        return torch.where(keep, a, a.new_zeros(()))

    def layer(a, name, i):
        return mask(FM._act(FM._conv(a, params, name), blu_ub, i))

    a1 = layer(mask(x_norm), "C1", 0)
    c2 = torch.cat([layer(a1, "C2_1", 1), layer(a1, "C2_2", 2)], dim=1)
    c3 = torch.cat([layer(c2, "C3_1", 3), layer(c2, "C3_2", 4)], dim=1)
    return FM._conv(c3, params, "C4")


def _allreduce(tensors, group):
    """Sum `tensors` over the processes of `group` (one gloo all-reduce of
    their host copies); -> the sums on their devices."""
    flat = torch.cat([t.detach().reshape(-1).cpu() for t in tensors])
    dist.all_reduce(flat, group=group)
    out, at = [], 0
    for t in tensors:
        out.append(flat[at:at + t.numel()].view(t.shape).to(t.device))
        at += t.numel()
    return out


def make_grad_fn(mesh: Mesh, blu_ub: Optional[Sequence[float]] = None,
                 halo: int = RECEPTIVE_RADIUS, group=None):
    """The sharded (loss, grads) function over the (dp, sp) mesh, shared by
    float training and the quant fine-tune (:88-132): fn(params, images,
    labels) -> (loss, {name: grad}), for module-layout params on the mesh's
    first device and raw-valued float32 [N, H, W, 1] images and labels
    (arrays or tensors), N divisible by dp and H by sp (else ValueError).
    The sums cover the mesh's shards; with a process `group` (a gloo group:
    the sums cross as host tensors) each process passes its own patches and
    the sums cover every process's. No group, no all-reduce."""
    if mesh.devices.ndim != 2:
        raise ValueError(f"make_grad_fn takes a (dp, sp) mesh, got {mesh.label()}")
    if mesh.world > 1:
        raise NotImplementedError(
            f"make_grad_fn: mesh {mesh!r} spans processes, and the differentiable halo "
            "crosses no process; give each process its own mesh and a `group`")
    sp = mesh.shape["sp"]

    def shard_loss(params, x, y, ext, j):
        if ext is None:
            return FM.l2_loss(params, x, y, blu_ub)
        h_ext = ext.shape[1]
        row = torch.arange(h_ext, device=ext.device)
        valid = (row >= (halo if j == 0 else 0)) & (row < (h_ext - halo if j == sp - 1 else h_ext))
        res = _masked_residual(params, FM._nchw(ext), blu_ub, valid)[:, :, halo:-halo]
        pred = res.reshape(x.shape) + (x - 128.0) / 255.0
        return 0.5 * torch.sum(torch.square((y - 128.0) / 255.0 - pred))

    def grad_fn(params: FM.TorchParams, images, labels):
        dev = mesh.first
        xb = split_blocks(torch.as_tensor(images).to(dev), mesh)
        yb = split_blocks(torch.as_tensor(labels).to(dev), mesh)
        ext = np.full(xb.shape, None, dtype=object)
        if sp > 1:
            norm = np.empty(xb.shape, dtype=object)
            for idx in np.ndindex(xb.shape):
                norm[idx] = (xb[idx] - 128.0) / 255.0
            ext = halo_exchange_rows(norm, halo, fill=0)
        loss, grads = None, None
        with FM.fp32_convs():
            for idx in np.ndindex(xb.shape):
                d = mesh.devices[idx]
                local = {k: v.detach().to(d).requires_grad_() for k, v in params.items()}
                l = shard_loss(local, xb[idx], yb[idx], ext[idx], idx[1])
                g = torch.autograd.grad(l, [local[k] for k in FM.PARAM_NAMES])
                l, g = l.detach().to(dev), [t.to(dev) for t in g]
                loss = l if loss is None else loss + l
                grads = g if grads is None else [a + b for a, b in zip(grads, g)]
        if group is not None:
            loss, *grads = _allreduce([loss, *grads], group)
        return loss, dict(zip(FM.PARAM_NAMES, grads))

    return grad_fn


def make_train_step(mesh: Mesh, blu_ub: Optional[Sequence[float]] = None, lr: float = 1e-4,
                    halo: int = RECEPTIVE_RADIUS, group=None):
    """-> (step, make_opt) (:135-153): step(model, opt, images, labels)
    sets the model's gradients from `make_grad_fn` and takes one Adam step,
    returning the loss (taken before the update); make_opt(model) is the
    Adam optimizer at `lr`, the counterpart of optax's init."""
    grad_fn = make_grad_fn(mesh, blu_ub, halo, group)

    def step(model: FM.FloatVRCNN, opt: torch.optim.Adam, images, labels) -> torch.Tensor:
        loss, grads = grad_fn(model.tensors(), images, labels)
        for name in FM.PARAM_NAMES:
            getattr(model, name).grad = grads[name]
        opt.step()
        return loss

    return step, lambda model: make_adam(model, lr)


def default_mesh(device) -> Mesh:
    """The trainer's mesh for a device, as `cli train` builds it (cli.py:
    148, make_mesh(len(jax.devices()), 1)): "cuda" (no index) spreads dp
    over the visible CUDA devices (RuntimeError when there is none); one
    device ("cuda:0", "cpu") is 1x1."""
    d = torch.device(device)
    if d.type == "cuda" and d.index is None:
        if not torch.cuda.is_available():
            raise RuntimeError("device 'cuda': no CUDA device is visible")
        return make_mesh(torch.cuda.device_count(), 1)
    return mesh_on(d, 1, 1)


class Trainer:
    """Orchestrates training over a (dp, sp) mesh: the step loop, the
    metrics and image logs, checkpoints. The model lives on the mesh's
    first device. `mesh` defaults to `default_mesh(device)`; give one of
    the two. `params` (JAX layout) default to `init_params(cfg.seed)`."""

    def __init__(
        self,
        cfg: TrainConfig,
        mesh: Optional[Mesh] = None,
        *,
        device=None,
        blu_ub: Optional[Sequence[float]] = None,
        params: Optional[FM.Params] = None,
    ):
        if (mesh is None) == (device is None):
            raise TypeError("Trainer: give exactly one of mesh and device")
        self.cfg = cfg
        self.mesh = mesh if mesh is not None else default_mesh(device)
        self.model = FM.FloatVRCNN(params if params is not None else FM.init_params(cfg.seed),
                                   device=self.mesh.first, blu_ub=blu_ub)
        self.step_fn, make_opt = make_train_step(self.mesh, blu_ub, cfg.lr)
        self.opt = make_opt(self.model)
        self.global_step = 0

    @property
    def params(self) -> FM.Params:
        """The current params in the JAX layout (numpy, HWIO)."""
        return self.model.to_jax()

    def fit_batches(
        self,
        batches,
        log_fn=print,
        metrics_path: Optional[str] = None,
        image_dir: Optional[str] = None,
    ):
        """batches: iterable of (images, labels) float32 [N, H, W, 1] raw-
        valued arrays (labels = originals, images = codec anchors — the
        reference feeds batch[1] as images, batch[0] as labels,
        model.py:140). Returns the last step's loss.

        Every `cfg.log_every` steps: a log line with the loss and the batch
        PSNR of the updated model; with metrics_path, a JSONL record of
        them (the replacement for the reference's TensorBoard summaries,
        model.py:61-69, 116-117, 144-145); with image_dir, an
        input|output|target triptych of the batch's first patch."""
        loss = None
        for images, labels in batches:
            loss = self.step_fn(self.model, self.opt, images, labels)
            self.global_step += 1
            if self.cfg.log_every and self.global_step % self.cfg.log_every == 0:
                self._log(images, labels, float(loss), log_fn, metrics_path, image_dir)
        return float(loss) if loss is not None else None

    @torch.no_grad()
    def _log(self, images, labels, loss, log_fn, metrics_path, image_dir):
        dev = next(self.model.parameters()).device
        x_norm = (torch.as_tensor(images).to(dev) - 128.0) / 255.0
        pred = (self.model(x_norm) + x_norm).cpu().numpy()
        # batch PSNR in the raw-pixel domain (the summary scalar, model.py:63-66)
        mse = float(np.mean((pred * 255.0 + 128.0 - labels) ** 2))
        psnr = 10.0 * math.log10(255.0**2 / mse) if mse > 0 else float("inf")
        log_fn(f"step {self.global_step}: loss {loss:.6f} batch-PSNR {psnr:.2f} dB")
        if metrics_path:
            with open(metrics_path, "a") as fp:
                fp.write(json.dumps({"step": self.global_step, "loss": loss,
                                     "batch_psnr": psnr, "ts": time.time()}) + "\n")
        if image_dir:
            out = np.clip(pred * 255.0 + 128.0, 0, 255).astype(np.uint8)
            dump_image_triplet(image_dir, self.global_step, images[0, ..., 0].astype(np.uint8),
                               out[0, ..., 0], labels[0, ..., 0].astype(np.uint8))

    # -- checkpointing (replacing tf.train.Saver, model.py:70,146-149) --
    def save_checkpoint(self, path: str) -> None:
        save_checkpoint(path, self.params, adam_from_torch(self.opt, self.model), self.global_step)

    def load_checkpoint(self, path: str) -> None:
        params, adam, self.global_step = load_checkpoint(path)
        with torch.no_grad():
            for name, t in FM.params_from_jax(params, next(self.model.parameters()).device).items():
                getattr(self.model, name).copy_(t)
        adam_to_torch(adam, self.opt, self.model)
