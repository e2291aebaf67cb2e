"""The inference engine — program cache, batched restore, metrics.

Counterpart of `qcnn_gpu_tpu/engine/runner.py:Engine` on one torch
device. A program is the restorer for one (qp, device, program name):

  impl="kernel"     generation 3, the counterpart of the JAX engine's
                    "pallas" (no H100 table picks another generation yet)
  impl="kernel3"    the one-frame fused kernel, `ops/fused.fused_forward`
  impl="kernel2"    the frame-pair kernel, `ops/pair.pair_forward`
  impl="reference"  the float64-exact reference net (models/qvrcnn.py)
  impl="auto"       "kernel"

A kernel runs as its CUDA kernel on a CUDA device and as its plain
version on the CPU. The program name, and so the cache key and
`RunRecord.impl`, is the generation that runs ("kernel2", "kernel3") or
"reference".

The device is explicit and nothing changes it: a CUDA device without
CUDA raises, and a failed kernel build or launch raises. There is no
demotion to another program, no host tiling, mesh or wire transport.

Timing follows the reference's definition: wall clock around the whole
frame loop including host->device and device->host copies
(kernel.cu:89-101).
"""

from __future__ import annotations

import functools
import os
import time
from typing import Callable, Dict, Optional, Tuple

import numpy as np
import torch

from qcnn_gpu_tpu_torch.data import yuv
from qcnn_gpu_tpu_torch.data.model_files import (
    read_static_qfp_hwcn,
    read_static_qfp_pc,
    read_static_qfp_vect_c,
)
from qcnn_gpu_tpu_torch.engine.metrics import MetricsLog, RunRecord
from qcnn_gpu_tpu_torch.models.engine_params import EngineParams
from qcnn_gpu_tpu_torch.models.qvrcnn import make_forward
from qcnn_gpu_tpu_torch.ops.fused import FusedWeights, fused_forward
from qcnn_gpu_tpu_torch.ops.pair import pair_forward

IMPLS = ("auto", "kernel", "kernel2", "kernel3", "reference")
_READERS = {
    "vect_c": read_static_qfp_vect_c,
    "hwcn": read_static_qfp_hwcn,
    "pc": read_static_qfp_pc,  # per-channel INT4 extension
}
_GENERATIONS = {"kernel2": pair_forward, "kernel3": fused_forward}


def read_model(path: str, fmt: str = "vect_c") -> EngineParams:
    """Read a static model file (`vect_c`, `hwcn` or `pc`) into EngineParams."""
    if not os.path.exists(path):
        raise FileNotFoundError(f"cannot open model file: {path}")
    if fmt not in _READERS:
        raise ValueError(f"unknown model format {fmt!r}")
    return _READERS[fmt](path)


class Engine:
    def __init__(
        self,
        device="cuda",
        impl: str = "auto",
        out_dir: str = ".",
        batch_frames: int = 4,
    ):
        if impl not in IMPLS:
            raise ValueError(f"impl must be one of {IMPLS}, got {impl!r}")
        if batch_frames < 1:
            raise ValueError(f"batch_frames must be >= 1, got {batch_frames}")
        self.device = torch.device(device)
        self.impl = "kernel" if impl == "auto" else impl
        self.batch_frames = batch_frames
        self.metrics = MetricsLog(out_dir)
        self._models: Dict[int, EngineParams] = {}
        self._programs: Dict[Tuple, Callable] = {}

    # ---- model management (load_static_para analog, qvrcnn.cu:47-63) ----
    def load_model(self, qp: int, path: str, fmt: str = "vect_c") -> None:
        self.set_model(qp, read_model(path, fmt))

    def set_model(self, qp: int, params: EngineParams) -> None:
        self._models[qp] = params
        self._programs = {k: v for k, v in self._programs.items() if k[0] != qp}

    @property
    def program_name(self) -> str:
        """The program that runs: "reference", or the kernel generation,
        "kernel2" or "kernel3"."""
        return "kernel3" if self.impl == "kernel" else self.impl

    def _program(self, qp: int) -> Callable:
        name = self.program_name
        key = (qp, str(self.device), name)
        if key not in self._programs:
            if qp not in self._models:
                raise KeyError(f"no model loaded for QP{qp}")
            p = self._models[qp]
            if name == "reference":
                run = make_forward(p, device=self.device)
            else:
                fw = FusedWeights.from_engine(p, self.device)
                run = functools.partial(_GENERATIONS[name], fw=fw)
            self._programs[key] = run
        return self._programs[key]

    # ---- restoration ----
    def restore(self, frames: np.ndarray, qp: int) -> np.ndarray:
        """uint8 [N, H, W] -> restored uint8 [N, H, W] (blocking)."""
        x = torch.from_numpy(np.ascontiguousarray(frames, np.uint8)).to(self.device)
        return self._program(qp)(x).cpu().numpy()

    def restore_stream(self, frames: np.ndarray, qp: int) -> np.ndarray:
        """Restore `frames` in batches of batch_frames: copy up, run, copy
        down, one batch after the other."""
        run = self._program(qp)
        n = frames.shape[0]
        out = np.empty_like(frames)
        for i in range(0, n, self.batch_frames):
            x = torch.from_numpy(np.ascontiguousarray(frames[i : i + self.batch_frames]))
            out[i : i + x.shape[0]] = run(x.to(self.device)).cpu().numpy()
        return out

    def warmup(self, qp: int, height: int, width: int, frames: int = 1) -> None:
        """Build the program (kernel compile, weight upload) and run every
        batch shape restore_stream will use, ahead of the timed span."""
        bs = self.batch_frames
        sizes = {min(bs, max(frames, 1))}
        if frames > bs and frames % bs:
            sizes.add(frames % bs)
        for n in sorted(sizes):
            self.restore(np.zeros((n, height, width), np.uint8), qp)

    # ---- the testqvrcnn analog (kernel.cu:74-116) ----
    def run_sequence(
        self,
        name: str,
        ori_path: str,
        anchor_path: str,
        height: int,
        width: int,
        qp: int,
        frames: int = 1,
        recon_path: Optional[str] = None,
    ) -> RunRecord:
        ori = yuv.read_y(ori_path, height, width, frames)
        anchor = yuv.read_y(anchor_path, height, width, frames)
        self.warmup(qp, height, width, frames)

        t0 = time.perf_counter()
        recon = self.restore_stream(anchor, qp)
        time_us = int((time.perf_counter() - t0) * 1e6)

        rec = RunRecord(
            sequence=name,
            qp=qp,
            frames=frames,
            height=height,
            width=width,
            psnr_before=yuv.psnr(anchor, ori),
            psnr_after=yuv.psnr(recon, ori),
            time_us=time_us,
            impl=self.program_name,
            device=str(self.device),
        )
        self.metrics.append(rec)
        if recon_path:
            yuv.write_y_as_420(recon_path, recon)
        return rec

    def run_manifest(self, specs, data_root: str, qps=(22, 27, 32, 37), **kw):
        """The run_all analog: sweep sequences x QPs (kernel.cu:117-131)."""
        records = []
        for qp in qps:
            for s in specs:
                records.append(
                    self.run_sequence(
                        s.name,
                        s.ori_path(data_root),
                        s.anchor_path(data_root, qp),
                        s.height,
                        s.width,
                        qp,
                        frames=s.frames,
                        **kw,
                    )
                )
        return records
