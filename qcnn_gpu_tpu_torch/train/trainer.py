"""Float VRCNN training — the port's counterpart of
`qcnn_gpu_tpu/train/trainer.py` (:19-242).

The reference trains with TF1 Adam on 64x64 patch batches, the L2 loss
over normalized pixels (model.py:112-149). The JAX package's step is one
SPMD program over a (dp, sp) mesh; here `make_grad_fn` runs it over the
port's `Mesh` (:71-132):

  dp  batch sharding: the patches split over the mesh's dp axis;
  sp  row sharding with a halo exchange: each block takes RECEPTIVE_RADIUS
      rows of the normalized input from its row neighbours (zeros at the
      frame's edges, `parallel/spatial.halo_exchange_rows`), and every
      activation is masked to the frame's rows, so the sharded forward is
      the unsharded one and the loss, a sum over kept rows, too.

Each shard takes its local loss and `torch.autograd.grad` of it with
respect to the parameters only: the halo carries the normalized input,
which no parameter moves, so no gradient flows back through it (nor
through the JAX ppermute). Each rank sums its own shards' losses and
gradients in shard order on its first device, which is the JAX psum of
local gradients over one process. The shards run in turn from the
caller's thread, one device each (a virtual mesh repeats one device).

The mesh may span processes (`parallel/mesh.make_global_mesh`, or
`default_mesh("cuda")` inside a process group): every rank then passes
the same global batch, as every JAX process hands the jitted step the
same numpy batch; each rank moves only its slice of it
(`Mesh.local_slice`) to its devices, trades the halo rows of a neighbour
on another rank over the mesh's gloo group as host tensors, and
all-reduces the flat host copy of its sums over that group, so every rank
holds the global loss and gradients and the Adam state stays replicated.
A one-process mesh (`make_mesh`) trains alone, whatever process group
exists. With sp = 1 no halo is exchanged (as `parallel/spatial` extends
no unsplit axis): a block's loss is `float_model.l2_loss`, so the 1x1
mesh's gradients are its backward.

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
from qcnn_gpu_tpu_torch.parallel.distributed import global_mesh
from qcnn_gpu_tpu_torch.parallel.mesh import Mesh, mesh_on
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
    """Sum `tensors`, on one device, over the processes of `group`: one
    gloo all-reduce of their concatenation, copied to the host and back
    once (each copy waits its turn on a card that other processes share);
    -> (the sums on that device, the bytes of the flat copy)."""
    flat = torch.cat([t.detach().reshape(-1) for t in tensors]).cpu()
    dist.all_reduce(flat, group=group)
    flat = flat.to(tensors[0].device)
    out, at = [], 0
    for t in tensors:
        out.append(flat[at:at + t.numel()].view(t.shape))
        at += t.numel()
    return out, flat.numel() * flat.element_size()


def make_grad_fn(mesh: Mesh, blu_ub: Optional[Sequence[float]] = None,
                 halo: int = RECEPTIVE_RADIUS):
    """The sharded (loss, grads) function over the (dp, sp) mesh, shared by
    float training and the quant fine-tune (:88-132): fn(params, images,
    labels) -> (loss, {name: grad}), for module-layout params on the mesh's
    first device and raw-valued float32 [N, H, W, 1] images and labels
    (arrays or tensors).

    On a mesh that spans processes every rank of it calls fn at once with
    the same global batch; the result, the sum over every shard of the
    mesh, is bit-equal on every rank. fn raises ValueError, on every rank
    and before any exchange, unless N divides by dp and H by sp, and each
    sp block keeps at least `halo` rows; building it raises ValueError for
    a mesh that is not (dp, sp) or whose positions a rank holds are no
    rectangle. `fn.cross_bytes` holds the last call's bytes across ranks:
    the halo rows sent and received (`halo_sent`, `halo_received`) and the
    all-reduce's flat copy (`allreduce`); all 0 on one process."""
    if mesh.devices.ndim != 2:
        raise ValueError(f"make_grad_fn takes a (dp, sp) mesh, got {mesh.label()}")
    for r in range(mesh.world):  # the same answer on every rank
        mesh.owned(r)
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
        images, labels = torch.as_tensor(images), torch.as_tensor(labels)
        shape = tuple(images.shape)
        if len(shape) != 4 or shape[3] != 1 or tuple(labels.shape) != shape:
            raise ValueError(f"make_grad_fn: expected images and labels [N, H, W, 1], got "
                             f"{shape} and {tuple(labels.shape)}")
        own = mesh.local_slice(mesh.rank, shape)  # ValueError unless N, H split
        if sp > 1 and shape[1] // sp < halo:
            raise ValueError(f"make_grad_fn: batch {shape} on mesh {mesh.label()}: each sp "
                             f"block needs >= {halo} rows")
        dev = mesh.first
        xb = split_blocks(images[own].to(dev), mesh)
        yb = split_blocks(labels[own].to(dev), mesh)
        mine = [idx for idx in np.ndindex(xb.shape) if xb[idx] is not None]
        stats = {"sent": 0, "received": 0}
        ext = np.full(xb.shape, None, dtype=object)
        if sp > 1:
            norm = np.full(xb.shape, None, dtype=object)
            for idx in mine:
                norm[idx] = (xb[idx] - 128.0) / 255.0
            ext = halo_exchange_rows(norm, halo, fill=0, mesh=mesh, stats=stats)
        loss, grads = None, None
        with FM.fp32_convs():
            for idx in mine:
                d = mesh.devices[idx]
                local = {k: v.detach().to(d).requires_grad_() for k, v in params.items()}
                l = shard_loss(local, xb[idx], yb[idx], ext[idx], idx[1])
                g = torch.autograd.grad(l, [local[k] for k in FM.PARAM_NAMES])
                l, g = l.detach().to(dev), [t.to(dev) for t in g]
                loss = l if loss is None else loss + l
                grads = g if grads is None else [a + b for a, b in zip(grads, g)]
        reduced = 0
        if mesh.world > 1:
            (loss, *grads), reduced = _allreduce([loss, *grads], mesh.group)
        grad_fn.cross_bytes = {"halo_sent": stats["sent"], "halo_received": stats["received"],
                               "allreduce": reduced}
        return loss, dict(zip(FM.PARAM_NAMES, grads))

    grad_fn.cross_bytes = {"halo_sent": 0, "halo_received": 0, "allreduce": 0}
    return grad_fn


def make_train_step(mesh: Mesh, blu_ub: Optional[Sequence[float]] = None, lr: float = 1e-4,
                    halo: int = RECEPTIVE_RADIUS):
    """-> (step, make_opt) (:135-153): step(model, opt, images, labels)
    sets the model's gradients from `make_grad_fn` and takes one Adam step,
    returning the loss (taken before the update); make_opt(model) is the
    Adam optimizer at `lr`, the counterpart of optax's init."""
    grad_fn = make_grad_fn(mesh, blu_ub, halo)

    def step(model: FM.FloatVRCNN, opt: torch.optim.Adam, images, labels) -> torch.Tensor:
        loss, grads = grad_fn(model.tensors(), images, labels)
        for name in FM.PARAM_NAMES:
            getattr(model, name).grad = grads[name]
        opt.step()
        return loss

    return step, lambda model: make_adam(model, lr)


def default_mesh(device) -> Mesh:
    """The trainer's mesh for a device, as `cli train` builds it (cli.py:
    148, make_mesh(len(jax.devices()), 1)): "cuda" (no index) puts dp over
    every process's visible CUDA devices (`parallel/distributed.
    global_mesh`: this process's alone without a process group; a
    collective call inside one; RuntimeError when no CUDA device is
    visible); one device ("cuda:0", "cpu") is this process's 1x1."""
    d = torch.device(device)
    if d.type == "cuda" and d.index is None:
        if not torch.cuda.is_available():
            raise RuntimeError("device 'cuda': no CUDA device is visible")
        return global_mesh()
    return mesh_on(d, 1, 1)


class Trainer:
    """Orchestrates training over a (dp, sp) mesh: the step loop, the
    metrics and image logs, checkpoints. The model lives on the mesh's
    first device (this rank's, on a mesh that spans processes, where every
    rank runs the same Trainer on the same batches and holds the same
    params). `mesh` defaults to `default_mesh(device)`; give one of the
    two. `params` (JAX layout) default to `init_params(cfg.seed)`."""

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
        """`checkpoint.save_checkpoint` of the params and Adam state. On a
        mesh that spans processes only rank 0 writes (every rank holds the
        same state; ranks writing one path at once could leave a torn
        `latest` or .npz). A departure: the JAX `save_checkpoint` is called
        by every process."""
        if self.mesh.rank != 0:
            return
        save_checkpoint(path, self.params, adam_from_torch(self.opt, self.model), self.global_step)

    def load_checkpoint(self, path: str) -> None:
        params, adam, self.global_step = load_checkpoint(path)
        with torch.no_grad():
            for name, t in FM.params_from_jax(params, next(self.model.parameters()).device).items():
                getattr(self.model, name).copy_(t)
        adam_to_torch(adam, self.opt, self.model)
