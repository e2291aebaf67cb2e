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
"""

from __future__ import annotations

from typing import Dict, Optional, Sequence, Tuple

import numpy as np
import torch


def _normalized(d) -> torch.device:
    """torch.device(d), with a CUDA device's index made explicit (the
    current device), so that it compares equal to a tensor's device."""
    d = torch.device(d)
    if d.type == "cuda" and d.index is None:
        return torch.device("cuda", torch.cuda.current_device())
    return d


class Mesh:
    """An array of torch devices (dp, sp) or (dp, sp, sw), axis names
    ("dp", "sp") or ("dp", "sp", "sw")."""

    def __init__(self, devices: np.ndarray, axis_names: Tuple[str, ...]):
        if devices.ndim != len(axis_names):
            raise ValueError(f"{devices.ndim}-D device array for axes {axis_names}")
        self.devices = np.empty(devices.shape, dtype=object)
        for idx in np.ndindex(devices.shape):
            self.devices[idx] = _normalized(devices[idx])
        self.axis_names = tuple(axis_names)

    @property
    def shape(self) -> Dict[str, int]:
        return dict(zip(self.axis_names, self.devices.shape))

    @property
    def first(self) -> torch.device:
        """The device that takes a sharded program's input and output."""
        return self.devices.flat[0]

    def label(self) -> str:
        """"DPxSP" or "DPxSPxSW" (`RunRecord.mesh`)."""
        return "x".join(str(n) for n in self.devices.shape)

    def __repr__(self) -> str:
        devices = sorted({str(d) for d in self.devices.flat})
        return f"Mesh({self.label()}, {self.axis_names}, {devices})"


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
