"""Process groups and sharded restoration across processes.

Counterpart of `qcnn_gpu_tpu/parallel/distributed.py`:

  * `initialize()` wraps `torch.distributed.init_process_group` (a no-op
    for one process, distributed.py:33-47); the caller gives the address
    (`tcp://host:port`), the world size and its rank;
  * `global_mesh()` factors every process's CUDA devices together
    (`mesh_shape_for`) into one mesh over all of them, process-major
    (`parallel/mesh.make_global_mesh`), as the JAX `global_mesh` over
    `jax.devices()` (:50-52): its dp, sp (and sw) axes may span processes;
  * `DistributedRunner` restores, on every process at once, each
    process's slice of the global batch (its frames along dp, its rows
    along sp, its columns along sw: the JAX runner's
    `make_array_from_process_local_data`, :67-75), the halos crossing
    between processes, then all-gathers the restored slices, so every
    process returns the global batch (the JAX runner's
    `process_allgather`, :77-87); its one-process stream is
    `Engine(mesh=...).restore_stream`.

Across processes a runner takes a mesh over every process
(`make_global_mesh`; `make_mesh` builds one process's). The halos, the
gather and the PSNR's all-reduce run on a gloo group over host tensors:
the frames come back to the host anyway, and NCCL cannot place two ranks
on one GPU. With one process everything here runs unchanged, which is how the
tests drive it on a virtual CPU mesh. Still one process only:
`restore_stream`.

Training takes the same meshes: `train/trainer.make_grad_fn` (and
`Trainer`, `quant_finetune`) over a `global_mesh()` or `make_global_mesh`
mesh, every process passing the same global batch, exchanges the halo
rows over the mesh's gloo group and all-reduces the loss and gradients
there; `trainer.default_mesh("cuda")` inside a process group is
`global_mesh()`, dp over every process's devices.

Departure from the JAX runner: a failure of the duplex stream raises
after the transport is evicted. The JAX runner falls back to raw
(distributed.py:138-140).
"""

from __future__ import annotations

from typing import Dict, List, Optional

import numpy as np
import torch
import torch.distributed as dist

from qcnn_gpu_tpu_torch.engine.runner import Engine
from qcnn_gpu_tpu_torch.models.engine_params import EngineParams
from qcnn_gpu_tpu_torch.parallel.mesh import Mesh, make_global_mesh, mesh_shape_for
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


def host_group():
    """The group for host tensors: None (the default group) when it is a
    gloo group or there is one process, else a new gloo group over every
    process (a collective call: every process makes it)."""
    if world_size() == 1 or dist.get_backend() == "gloo":
        return None
    return dist.new_group(backend="gloo")


def global_mesh(frames_hint: Optional[int] = None, rows_hint: Optional[int] = None) -> Mesh:
    """The (dp, sp) mesh over every process's CUDA devices:
    `mesh_shape_for(processes x local devices, ...)`, process-major
    (`make_global_mesh`), whose axes may span processes. Every process
    calls it. Raises ValueError without a CUDA device."""
    local = torch.cuda.device_count()
    if local == 0:
        raise ValueError("global_mesh: no CUDA device")
    dp, sp = mesh_shape_for(world_size() * local, frames_hint, rows_hint)
    return make_global_mesh(dp, sp, [torch.device("cuda", i) for i in range(local)],
                            group=host_group())


class DistributedRunner:
    """Sharded restoration over a mesh of every process's devices."""

    def __init__(self, params: EngineParams, mesh: Optional[Mesh] = None, impl: str = "auto"):
        """mesh: a mesh over every process (`global_mesh`, the default, or
        `make_global_mesh`). Raises ValueError, on every process, when the
        mesh spans another number of processes than the world holds (a
        `make_mesh` mesh spans one) or a process owns no rectangle of it."""
        mesh = mesh if mesh is not None else global_mesh()
        self.world = world_size()
        if mesh.world != self.world:
            raise ValueError(f"mesh {mesh!r} spans {mesh.world} process(es); the world has "
                             f"{self.world}: build it with make_global_mesh")
        for r in range(mesh.world):  # the same answer on every process
            mesh.owned(r)
        self.mesh, self.params, self.impl = mesh, params, impl
        self.run = make_sharded_forward(params, mesh, impl=impl)
        self.device = mesh.first
        self._group = mesh.group
        # batch_frames -> the Engine that streams over this mesh
        self.engines: Dict[int, Engine] = {}

    def _global_shape(self, shape) -> tuple:
        """All-gather every process's local shape and return the global
        batch's; raises ValueError on every process when a shape is not
        its process's slice of one global batch (`Mesh.local_slice`)."""
        mine = torch.zeros(4, dtype=torch.int64)
        mine[0] = len(shape)
        mine[1:1 + min(len(shape), 3)] = torch.tensor(list(shape)[:3])
        got = [torch.zeros(4, dtype=torch.int64) for _ in range(self.world)]
        dist.all_gather(got, mine, group=self._group)
        shapes: List[tuple] = [tuple(int(v) for v in t[1:1 + int(t[0])]) for t in got]
        grid, own0 = self.mesh.devices.shape, self.mesh.owned(0)
        want = None
        if all(len(s) == 3 for s in shapes):
            sub0 = [o.stop - o.start for o in own0] + [1] * (3 - len(grid))
            grid3 = list(grid) + [1] * (3 - len(grid))
            if all(v % k == 0 for v, k in zip(shapes[0], sub0)):
                full = tuple(v // k * g for v, k, g in zip(shapes[0], sub0, grid3))
                want = [tuple(sl.stop - sl.start for sl in self.mesh.local_slice(r, full))
                        + full[len(grid):] for r in range(self.world)]
        if want is None or want != shapes:
            raise ValueError(
                f"DistributedRunner.restore: the processes hold {[s[0] if s else 0 for s in shapes]} "
                f"frames of {[s[1:] for s in shapes]} (by rank); on mesh {self.mesh.label()} over "
                f"{self.world} processes each holds its slice of one global uint8 [N, H, W] batch"
                + ("" if want is None else f": {want}"))
        return full

    def restore(self, frames: np.ndarray) -> np.ndarray:
        """uint8 [N, H, W], this process's slice of the global batch (its
        frames along dp, rows along sp and columns along sw of the mesh:
        `Mesh.local_slice`) -> the restored GLOBAL batch on every process.
        Raises ValueError on every process when a process's shape is not
        its slice of one global batch (unequal frame counts over dp among
        them)."""
        x = np.ascontiguousarray(frames, np.uint8)
        if self.world == 1:
            return self.run(torch.from_numpy(x).to(self.device)).cpu().numpy()
        result = np.empty(self._global_shape(x.shape), np.uint8)
        out = self.run(torch.from_numpy(x).to(self.device)).cpu().reshape(-1)
        slices = [self.mesh.local_slice(r, result.shape) for r in range(self.world)]
        size = max(result[sl].size for sl in slices)
        if out.numel() < size:  # all_gather takes one size: pad to the largest
            out = torch.cat([out, out.new_zeros(size - out.numel())])
        parts = [torch.empty_like(out) for _ in range(self.world)]
        dist.all_gather(parts, out, group=self._group)
        for sl, part in zip(slices, parts):
            result[sl] = part[:result[sl].size].numpy().reshape(result[sl].shape)
        return result

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
        `a` and `ref` are this process's slice of the global batch (as
        `restore` takes it), the result the PSNR of the global batch."""
        return psnr_sharded(a, ref, self.mesh, group=self._group)
