"""Device meshes for sharded restoration.

Counterpart of `qcnn_gpu_tpu/parallel/mesh.py`. A `Mesh` is an array of
torch devices with named axes, ("dp", "sp") or ("dp", "sp", "sw"):

  dp  data parallel over frames (no exchange between shards)
  sp  spatial parallel over frame rows, with a halo exchange
  sw  spatial parallel over frame columns too (the 2-D case)

`mesh.shape` is a dict of the axes' extents, as `jax.sharding.Mesh` gives
it. One device may stand at several places of a mesh: a virtual mesh, on
which every shard runs in turn on that device (the counterpart of the
JAX tests' 8-device virtual CPU mesh). `make_mesh` spreads a mesh over
the visible CUDA devices unless given devices, and never falls back to
the CPU.

Every position also has the rank that owns it (`mesh.ranks`), and the
mesh knows which rank it was built on (`mesh.rank`) of how many
(`mesh.world`). `make_mesh` builds a one-process mesh: every position on
rank 0, world 1. `make_global_mesh` builds the mesh over every rank's
local devices, process-major as the JAX `make_mesh` lays out
`jax.devices()` (mesh.py:60-76): position k of the flattened grid is
local device k % L of rank k // L. A rank owns a rectangle of the grid
(`owned`) and so the matching slice of a global [N, H, W] batch
(`local_slice`): its frames along dp, its rows along sp and its columns
along sw, the process-local data of the JAX runner's
`make_array_from_process_local_data` (distributed.py:67-75).
"""

from __future__ import annotations

from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.distributed as dist


def _normalized(d) -> torch.device:
    """torch.device(d), with a CUDA device's index made explicit (the
    current device), so that it compares equal to a tensor's device."""
    d = torch.device(d)
    if d.type == "cuda" and d.index is None:
        return torch.device("cuda", torch.cuda.current_device())
    return d


class Mesh:
    """An array of torch devices (dp, sp) or (dp, sp, sw), axis names
    ("dp", "sp") or ("dp", "sp", "sw"), with the rank that owns each
    position (`ranks`, default all 0), the rank this object was built on
    (`rank`), the number of ranks (`world`) and their process group
    (`group`, None: the default group). Where another rank owns a
    position, its device is that rank's."""

    def __init__(self, devices: np.ndarray, axis_names: Tuple[str, ...],
                 ranks: Optional[np.ndarray] = None, rank: int = 0, world: int = 1,
                 group=None):
        if devices.ndim != len(axis_names):
            raise ValueError(f"{devices.ndim}-D device array for axes {axis_names}")
        self.devices = np.empty(devices.shape, dtype=object)
        for idx in np.ndindex(devices.shape):
            self.devices[idx] = _normalized(devices[idx])
        self.axis_names = tuple(axis_names)
        self.ranks = (np.zeros(devices.shape, np.int64) if ranks is None
                      else np.asarray(ranks, np.int64).reshape(devices.shape))
        if not 0 <= rank < world or self.ranks.min() < 0 or self.ranks.max() >= world:
            raise ValueError(f"ranks {sorted(set(self.ranks.flat))} and rank {rank} "
                             f"outside a world of {world}")
        self.rank, self.world, self.group = rank, world, group

    @property
    def shape(self) -> Dict[str, int]:
        return dict(zip(self.axis_names, self.devices.shape))

    @property
    def first(self) -> torch.device:
        """The device that takes a sharded program's input and output: this
        rank's first position's."""
        return self.devices[tuple(s.start for s in self.owned())]

    def owned(self, rank: Optional[int] = None) -> Tuple[slice, ...]:
        """The sub-grid of positions that `rank` (default this mesh's rank)
        owns, a slice per axis. Raises ValueError, naming the mesh's shape,
        when the rank owns no position or its positions are no rectangle."""
        rank = self.rank if rank is None else rank
        where = np.argwhere(self.ranks == rank)
        if where.size == 0:
            raise ValueError(f"rank {rank} owns no position of mesh {self.label()}")
        box = tuple(slice(int(lo), int(hi) + 1) for lo, hi in zip(where.min(0), where.max(0)))
        if not (self.ranks[box] == rank).all():
            raise ValueError(
                f"rank {rank}'s positions of mesh {self.label()} ({', '.join(self.axis_names)}) "
                f"are no rectangle of the grid: ranks by position {self.ranks.tolist()}")
        return box

    def local_slice(self, rank: Optional[int], shape: Sequence[int]) -> Tuple[slice, ...]:
        """The slice of a global batch of `shape` ([N, H, W, ...]) that
        `rank` (None: this mesh's rank) owns: its dp range of frames, its
        sp range of rows and its sw range of columns. Raises ValueError
        unless each split extent divides by its axis."""
        grid = self.devices.shape
        if any(s % g for s, g in zip(shape, grid)):
            raise ValueError(f"batch {tuple(shape)} does not split over mesh {self.label()} "
                             f"({', '.join(self.axis_names)})")
        return tuple(slice(o.start * s // g, o.stop * s // g)
                     for o, s, g in zip(self.owned(rank), shape, grid))

    def local_devices(self) -> List[torch.device]:
        """The distinct devices of this rank's positions, in grid order."""
        own = self.devices[self.owned()]
        return list(dict.fromkeys(own.flat))

    def label(self) -> str:
        """"DPxSP" or "DPxSPxSW" (`RunRecord.mesh`)."""
        return "x".join(str(n) for n in self.devices.shape)

    def __repr__(self) -> str:
        devices = sorted({str(d) for d in self.devices.flat})
        ranks = "" if self.world == 1 else f", rank {self.rank} of {self.world}"
        return f"Mesh({self.label()}, {self.axis_names}, {devices}{ranks})"


def mesh_shape_for(
    n_devices: int,
    frames: Optional[int] = None,
    rows: Optional[int] = None,
    cols: Optional[int] = None,
):
    """Pick a mesh factorization: prefer pure DP (no collectives) when
    there are enough frames to keep every device busy; otherwise give the
    remainder to spatial sharding.

    Returns (dp, sp) — or (dp, sp, sw) when `cols` is given: the spatial
    factor splits over rows first (sp), then frame columns (sw) once row
    shards would drop under 64 rows each. sw > 1 only when the column
    shards keep >= 128 px of width.

    A copy of `qcnn_gpu_tpu/parallel/mesh.py:25-57` (pure Python), which
    the tests hold equal to it."""
    if frames is None or frames >= n_devices:
        return (n_devices, 1) if cols is None else (n_devices, 1, 1)
    dp = max(1, frames)
    while n_devices % dp:
        dp -= 1
    sp = n_devices // dp
    if rows is not None:
        # each spatial shard should carry enough rows to dwarf its halo
        while sp > 1 and rows // sp < 64:
            sp //= 2
    if cols is None:
        return (dp, sp)
    sw = 1
    spare = (n_devices // dp) // sp
    while spare > 1 and cols // (sw * 2) >= 128:
        sw *= 2
        spare //= 2
    return (dp, sp, sw)


def make_mesh(
    dp: int,
    sp: int = 1,
    devices: Optional[Sequence] = None,
    sw: int = 1,
) -> Mesh:
    """(dp, sp) mesh, or (dp, sp, sw) when sw > 1, over the first
    dp * sp * sw of `devices` (default: the visible CUDA devices). Raises
    ValueError when no devices are given and there is no CUDA device, and
    when the mesh needs more devices than there are (mesh.py:70-71).
    Repeat a device in `devices` for a virtual mesh."""
    if min(dp, sp, sw) < 1:
        raise ValueError(f"mesh {dp}x{sp}x{sw}: every axis needs >= 1 device")
    if devices is None:
        if not torch.cuda.is_available():
            raise ValueError(
                "make_mesh: no CUDA device and no devices given; pass devices "
                "(e.g. [torch.device('cpu')] * n for a virtual CPU mesh)"
            )
        devices = [torch.device("cuda", i) for i in range(torch.cuda.device_count())]
    devices = list(devices)
    need = dp * sp * sw
    if need > len(devices):
        raise ValueError(f"mesh {dp}x{sp}x{sw} needs {need} devices, have {len(devices)}")
    arr = np.empty(need, dtype=object)
    arr[:] = devices[:need]
    if sw == 1:
        return Mesh(arr.reshape(dp, sp), ("dp", "sp"))
    return Mesh(arr.reshape(dp, sp, sw), ("dp", "sp", "sw"))


def make_global_mesh(
    dp: int,
    sp: int = 1,
    local_devices: Optional[Sequence] = None,
    sw: int = 1,
    group=None,
) -> Mesh:
    """The (dp, sp[, sw]) mesh over every rank's `local_devices` (default:
    the visible CUDA devices), process-major: the global device list is
    rank 0's local devices, then rank 1's, ..., and the mesh takes its
    first dp * sp * sw (the JAX `make_mesh` over `jax.devices()`). Every
    rank of `group` (default: the default group; one process without an
    initialized group) calls it: the ranks exchange their device lists,
    and raise ValueError when the lists' lengths differ or there are too
    few devices. Repeat a device for a virtual mesh."""
    if min(dp, sp, sw) < 1:
        raise ValueError(f"mesh {dp}x{sp}x{sw}: every axis needs >= 1 device")
    if local_devices is None:
        if not torch.cuda.is_available():
            raise ValueError("make_global_mesh: no CUDA device and no local devices given")
        local_devices = [torch.device("cuda", i) for i in range(torch.cuda.device_count())]
    local = [str(_normalized(d)) for d in local_devices]
    if dist.is_available() and dist.is_initialized():
        world, rank = dist.get_world_size(group), dist.get_rank(group)
    else:
        world, rank = 1, 0
    lists: List[List[str]] = [local]
    if world > 1:
        lists = [None] * world
        dist.all_gather_object(lists, local, group=group)
    if len({len(v) for v in lists}) > 1:
        raise ValueError(f"make_global_mesh: the ranks hold {[len(v) for v in lists]} local "
                         "devices (by rank); a process-major mesh needs the same count on each")
    need = dp * sp * sw
    flat = [(r, d) for r, v in enumerate(lists) for d in v]
    if need > len(flat):
        raise ValueError(f"mesh {dp}x{sp}x{sw} needs {need} devices, have {len(flat)} "
                         f"({world} ranks of {len(local)})")
    shape = (dp, sp) if sw == 1 else (dp, sp, sw)
    devices = np.empty(need, dtype=object)
    devices[:] = [torch.device(d) for _, d in flat[:need]]
    ranks = np.array([r for r, _ in flat[:need]], np.int64)
    return Mesh(devices.reshape(shape), ("dp", "sp", "sw")[:len(shape)], ranks.reshape(shape),
                rank, world, group)


def mesh_on(device, dp: int, sp: int = 1, sw: int = 1) -> Mesh:
    """The mesh that `cli run --mesh` and `Config.make_engine` build for a
    `--device`: "cuda" (no index) spreads it over the visible CUDA devices
    (and raises when there are fewer than dp * sp * sw); one device
    ("cuda:0", "cpu") carries every shard, a virtual mesh."""
    d = torch.device(device)
    if d.type == "cuda" and d.index is None:
        return make_mesh(dp, sp, sw=sw)
    return make_mesh(dp, sp, devices=[d] * (dp * sp * sw), sw=sw)


def parse_mesh(spec: str) -> Tuple[int, int, int]:
    """"DPxSP[xSW]" -> (dp, sp, sw), as `cli run --mesh` reads it
    (qcnn_gpu_tpu/cli.py:36-46)."""
    dims = [int(v) for v in spec.split("x")]
    if len(dims) not in (1, 2, 3):
        raise SystemExit(
            f"--mesh {spec!r}: expected DPxSP[xSW] with 1-3 "
            f"'x'-separated dims, got {len(dims)}"
        )
    dp, sp = dims[0], dims[1] if len(dims) > 1 else 1
    return dp, sp, dims[2] if len(dims) > 2 else 1
