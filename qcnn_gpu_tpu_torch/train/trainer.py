"""Float VRCNN training on one device — the port's counterpart of
`qcnn_gpu_tpu/train/trainer.py` (:19-242).

The reference trains with TF1 Adam on 64x64 patch batches, the L2 loss
over normalized pixels (model.py:112-149). The JAX package's step is one
SPMD program over a (dp, sp) mesh (`make_grad_fn`, :88-132); this is its
single-device case: with dp = sp = 1 its halo rows are zeros and its row
mask keeps every row, which is the SAME convolution `l2_loss` runs here.
Data- and row-sharded training come with the port's parallel slice.

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

from qcnn_gpu_tpu_torch.models import float_model as FM
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


def train_step(model: FM.FloatVRCNN, opt: torch.optim.Adam, images, labels) -> torch.Tensor:
    """One Adam step on a batch of raw-valued float32 [N, H, W, 1] arrays
    or tensors; returns the loss (a device tensor, taken before the
    update, as the JAX step returns it)."""
    dev = next(model.parameters()).device
    x = torch.as_tensor(images).to(dev)
    y = torch.as_tensor(labels).to(dev)
    opt.zero_grad(set_to_none=True)
    with FM.fp32_convs():
        loss = FM.l2_loss(model.tensors(), x, y, model.blu_ub)
        loss.backward()
    opt.step()
    return loss.detach()


class Trainer:
    """Orchestrates training on `device`: the step loop, the metrics and
    image logs, checkpoints. `params` (JAX layout) default to
    `init_params(cfg.seed)`."""

    def __init__(
        self,
        cfg: TrainConfig,
        *,
        device,
        blu_ub: Optional[Sequence[float]] = None,
        params: Optional[FM.Params] = None,
    ):
        self.cfg = cfg
        self.model = FM.FloatVRCNN(params if params is not None else FM.init_params(cfg.seed),
                                   device=device, blu_ub=blu_ub)
        self.opt = make_adam(self.model, cfg.lr)
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
            loss = train_step(self.model, self.opt, images, labels)
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
