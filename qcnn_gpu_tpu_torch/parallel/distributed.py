"""Process groups and frame-sharded restoration across processes.

Counterpart of `qcnn_gpu_tpu/parallel/distributed.py`:

  * `initialize()` wraps `torch.distributed.init_process_group` (a no-op
    for one process, distributed.py:33-47); the caller gives the address
    (`tcp://host:port`), the world size and its rank;
  * `global_mesh()` factors every process's CUDA devices together
    (`mesh_shape_for`) and returns this process's part of that mesh;
  * `DistributedRunner` restores this process's frames on its mesh, then
    all-gathers the restored uint8 frames, so every process returns the
    global batch (the JAX runner's `process_allgather`, :77-87); its
    one-process stream is `Engine(mesh=...).restore_stream`.

Across processes the frames split over dp; sp and sw stay inside a
process (a mesh whose sp or sw axis would span processes raises
NotImplementedError). The gather runs on a gloo group over host tensors:
the frames come back to the host anyway, and NCCL cannot place two ranks
on one GPU. With one process everything here runs unchanged, which is how
the tests drive it on a virtual CPU mesh.

Departure from the JAX runner: a failure of the duplex stream raises
after the transport is evicted. The JAX runner falls back to raw
(distributed.py:138-140).
"""

from __future__ import annotations

from typing import Dict, Optional

import numpy as np
import torch
import torch.distributed as dist

from qcnn_gpu_tpu_torch.engine.runner import Engine
from qcnn_gpu_tpu_torch.models.engine_params import EngineParams
from qcnn_gpu_tpu_torch.parallel.mesh import Mesh, make_mesh, mesh_shape_for
from qcnn_gpu_tpu_torch.parallel.spatial import make_sharded_forward, psnr_sharded

STREAM_TRANSPORTS = ("raw", "duplex")
STREAM_QP = 0  # the key of the runner's one model in its streaming Engines


def initialize(
    init_method: Optional[str] = None,
    world_size: Optional[int] = None,
    rank: Optional[int] = None,
    backend: str = "gloo",
) -> None:
    """Join the process group; a no-op for a single process. Call it on
    every process before building a runner."""
    if world_size is None or world_size <= 1:
        return
    dist.init_process_group(backend, init_method=init_method, world_size=world_size, rank=rank)


def world_size() -> int:
    return dist.get_world_size() if dist.is_available() and dist.is_initialized() else 1


def global_mesh(frames_hint: Optional[int] = None, rows_hint: Optional[int] = None) -> Mesh:
    """This process's part of the (dp, sp) mesh over every process's CUDA
    devices: `mesh_shape_for(processes x local devices, ...)`, dp split
    over the processes. Raises ValueError without a CUDA device, and
    NotImplementedError when the sp axis would span processes."""
    local = torch.cuda.device_count()
    if local == 0:
        raise ValueError("global_mesh: no CUDA device")
    world = world_size()
    dp, sp = mesh_shape_for(world * local, frames_hint, rows_hint)
    if dp % world:
        raise NotImplementedError(
            f"mesh {dp}x{sp} over {world} processes of {local} devices: its sp axis would "
            "span processes; the port shards rows and columns within a process only"
        )
    return make_mesh(dp // world, sp)


class DistributedRunner:
    """Frame-sharded restoration over every process's mesh."""

    def __init__(self, params: EngineParams, mesh: Optional[Mesh] = None, impl: str = "auto"):
        self.mesh = mesh if mesh is not None else global_mesh()
        self.params, self.impl = params, impl
        self.run = make_sharded_forward(params, self.mesh, impl=impl)
        self.device = self.mesh.first
        self.world = world_size()
        # the gather and the PSNR's all-reduce move host tensors: a gloo group
        self._group = None
        if self.world > 1 and dist.get_backend() != "gloo":
            self._group = dist.new_group(backend="gloo")
        # batch_frames -> the Engine that streams over this mesh
        self.engines: Dict[int, Engine] = {}

    def restore(self, frames: np.ndarray) -> np.ndarray:
        """uint8 [N, H, W], this process's frames (N divisible by the mesh's
        dp, and the same on every process) -> the restored GLOBAL batch,
        every process's frames in rank order, on every process. Raises
        ValueError on every process when the processes' N differ."""
        if self.world > 1:
            counts = [torch.zeros(1, dtype=torch.int64) for _ in range(self.world)]
            dist.all_gather(counts, torch.tensor([frames.shape[0]]), group=self._group)
            counts = [int(c) for c in counts]
            if len(set(counts)) > 1:
                raise ValueError(f"DistributedRunner.restore: the processes hold {counts} frames "
                                 "(by rank); the gather needs the same count on each")
        x = torch.from_numpy(np.ascontiguousarray(frames, np.uint8)).to(self.device)
        out = self.run(x).cpu()
        if self.world == 1:
            return out.numpy()
        parts = [torch.empty_like(out) for _ in range(self.world)]
        dist.all_gather(parts, out, group=self._group)
        return torch.cat(parts).numpy()

    def restore_stream(
        self, frames: np.ndarray, depth: int = 3, transport: str = "raw",
        batch_frames: int = 0,
    ) -> np.ndarray:
        """Pipelined restore of uint8 [N, H, W] over the mesh, in batches of
        `batch_frames` (default: the mesh's dp), a multiple of dp, through
        the "raw" or "duplex" transport: `Engine(mesh=...).restore_stream`,
        whose program is the sharded one (a ragged tail is edge-replicated
        up to the batch and cropped; a duplex failure raises after the
        transport is evicted). One process only: it raises
        NotImplementedError across processes (distributed.py:110-114)."""
        if self.world != 1:
            raise NotImplementedError(
                "restore_stream streams the global batch from one process; across "
                f"processes use restore() on each process's frames (world size {self.world})"
            )
        if transport not in STREAM_TRANSPORTS:
            raise ValueError(f"transport must be one of {STREAM_TRANSPORTS}, got {transport!r}")
        bs = batch_frames or self.mesh.shape["dp"]
        eng = self.engines.get(bs)
        if eng is None:  # Engine raises when bs is no multiple of dp
            eng = Engine(mesh=self.mesh, impl=self.impl, batch_frames=bs)
            eng.set_model(STREAM_QP, self.params)
            self.engines[bs] = eng
        return eng.restore_stream(frames, STREAM_QP, depth, transport)

    def psnr(self, a: np.ndarray, ref: np.ndarray) -> float:
        """PSNR over the mesh (`psnr_sharded`), all-reduced across processes:
        `a` and `ref` are this process's frames, the result the PSNR of
        every process's frames together."""
        return psnr_sharded(a, ref, self.mesh, group=self._group)
