"""Halo-exchange spatial sharding: bit-exact restoration on a mesh.

Counterpart of `qcnn_gpu_tpu/parallel/spatial.py`. A uint8 batch [N, H, W]
is cut into a grid of blocks, N over the mesh's dp axis, H over sp and, on
a mesh with an sw axis, W over sw; each block goes to its device. Every
block then takes `halo` edge rows from its row neighbours (and columns
from its column neighbours, after the rows, so that the corners come from
the diagonal neighbour), runs the whole network on the extended block,
and drops the halo from the result; the blocks go back to the mesh's
first device and are put together.

Why it is exact (spatial.py:11-19): the halo is RECEPTIVE_RADIUS = 6, the
network's receptive radius, so every kept pixel's receptive field lies in
the extended block. A block at a frame edge gets filler there, which the
network must read as SAME padding, on every layer: generation 3 takes
per-block frame bounds (`ops/fused.fused_forward`'s row_lo..col_hi, the
JAX kernel's row_bounds/col_bounds), the reference net row/col validity
masks (`models/qvrcnn.residual_blu_merged`). The filler is the ppro-domain
zero: 128 in uint8 for the kernel, 0 in the x-128 integers for the
reference net (spatial.py:43-61).

The JAX shard_map runs the blocks at once, one per device; here each
block is launched in turn from the caller's thread, on its device's
current stream, and the copies between devices are `non_blocking`. On a
virtual mesh (one device repeated) the blocks run one after the other on
that device, and a neighbour's rows are a slice.

Departures from the JAX package: a kernel that fails to build or launch
raises (the JAX `make_sharded_forward` warns and demotes `auto` to the
sharded XLA graph, spatial.py:121-133); and a mesh axis of extent 1 gets
no halo (`extended_blocks`), where the JAX program pads it with filler.
"""

from __future__ import annotations

import math
from typing import Callable

import numpy as np
import torch
import torch.distributed as dist

from qcnn_gpu_tpu_torch.models.engine_params import EngineParams
from qcnn_gpu_tpu_torch.models.qvrcnn import MergedParams, residual_blu_merged
from qcnn_gpu_tpu_torch.models.topology import RECEPTIVE_RADIUS
from qcnn_gpu_tpu_torch.ops.fused import FusedWeights, fused_forward, window_refusal
from qcnn_gpu_tpu_torch.ops.requant import apply_residual_u8
from qcnn_gpu_tpu_torch.parallel.mesh import Mesh

NO_BOUNDS = (
    "generations 1 and 2 take no frame bounds yet (ROADMAP Queue 2 item 1), so "
    "they cannot serve under a mesh"
)


def _exchange(blocks: np.ndarray, dim: int, halo: int, fill: int) -> np.ndarray:
    """Extend tensor dimension `dim` of every block with `halo` slices from
    its neighbours along grid axis `dim` (grid axes and tensor dimensions
    line up: dp/N, sp/H, sw/W). A block at the grid's edge gets `fill`."""
    out = np.empty(blocks.shape, dtype=object)
    n = blocks.shape[dim]
    for idx in np.ndindex(blocks.shape):
        b = blocks[idx]
        parts = []
        for step in (-1, 1):
            j = idx[dim] + step
            if 0 <= j < n:
                src = blocks[idx[:dim] + (j,) + idx[dim + 1:]]
                start = src.shape[dim] - halo if step < 0 else 0
                parts.append(src.narrow(dim, start, halo).to(b.device, non_blocking=True))
            else:
                shape = list(b.shape)
                shape[dim] = halo
                parts.append(torch.full(shape, fill, dtype=b.dtype, device=b.device))
        out[idx] = torch.cat([parts[0], b, parts[1]], dim=dim)
    return out


def halo_exchange_rows(blocks: np.ndarray, halo: int, fill: int = 0) -> np.ndarray:
    """A grid of blocks [N, H_local, ...] (an object array of tensors over
    the mesh, sp on its axis 1) -> each block extended with `halo` rows
    from each row neighbour; blocks at the frame's top or bottom get
    `fill` rows there."""
    return _exchange(blocks, 1, halo, fill)


def halo_exchange_cols(blocks: np.ndarray, halo: int, fill: int = 0) -> np.ndarray:
    """As `halo_exchange_rows` over columns (sw, grid axis 2). Called on
    the row-extended blocks, the column neighbour's edge columns carry the
    diagonal neighbour's corner pixels (spatial.py:69-76)."""
    return _exchange(blocks, 2, halo, fill)


def split_blocks(x: torch.Tensor, mesh: Mesh) -> np.ndarray:
    """[N, H, W, ...] -> the grid of blocks over `mesh`, each on its device
    (a view where the device is x's). Raises ValueError unless N divides
    by dp, H by sp and W by sw, as the JAX shard_map requires."""
    grid = mesh.devices.shape
    shape = tuple(x.shape[:len(grid)])
    if any(s % g for s, g in zip(shape, grid)):
        raise ValueError(
            f"frames {tuple(x.shape)} do not split over mesh {mesh.label()} "
            f"({', '.join(mesh.axis_names)}): N, H{', W' if len(grid) > 2 else ''} must divide"
        )
    step = [s // g for s, g in zip(shape, grid)]
    blocks = np.empty(grid, dtype=object)
    for idx in np.ndindex(grid):
        b = x
        for d, i in enumerate(idx):
            b = b.narrow(d, i * step[d], step[d])
        blocks[idx] = b.to(mesh.devices[idx], non_blocking=True)
    return blocks


def join_blocks(blocks: np.ndarray, device) -> torch.Tensor:
    """The inverse of `split_blocks`: the grid put back together on `device`."""

    def join(sub, dim):
        if sub.ndim == 1:
            return torch.cat([b.to(device, non_blocking=True) for b in sub], dim=dim)
        return torch.cat([join(s, dim + 1) for s in sub], dim=dim)

    return join(blocks, 0)


def _bounds(i: int, n: int, extent: int, halo: int):
    """(lo, hi) of the frame inside a halo-extended block, the block being
    i of n along its axis: the halo at the frame's edge lies outside
    (spatial.py:135-144)."""
    return (halo if i == 0 else 0), (extent - halo if i == n - 1 else extent)


def extended_blocks(blocks: np.ndarray, halo: int, fill: int):
    """A grid of blocks (`split_blocks`; 2-D over a (dp, sp) mesh, 3-D over
    (dp, sp, sw)) -> (the halo-extended blocks, and each one's frame bounds
    (row_lo, row_hi, col_lo, col_hi)): rows exchanged, then columns on a
    3-D grid. An axis of extent 1 has no neighbour and is not extended:
    the JAX program pads it with filler that its bounds then mask, which
    costs generation 3 a tile row (2.2% of a 1080p frame's tiles)."""
    rows = blocks.shape[1] > 1
    cols = blocks.ndim == 3 and blocks.shape[2] > 1
    xe = halo_exchange_rows(blocks, halo, fill) if rows else blocks
    if cols:
        xe = halo_exchange_cols(xe, halo, fill)
    bounds = np.empty(blocks.shape, dtype=object)
    for idx in np.ndindex(blocks.shape):
        h, w = xe[idx].shape[1:3]
        bounds[idx] = ((_bounds(idx[1], blocks.shape[1], h, halo) if rows else (0, h))
                       + (_bounds(idx[2], blocks.shape[2], w, halo) if cols else (0, w)))
    return xe, bounds


def sharded_impl(p: EngineParams, impl: str) -> str:
    """The program `make_sharded_forward` runs for `impl`: "kernel3"
    (generation 3 under frame bounds; "kernel" and "auto" on a table inside
    the saturation window) or "reference". Raises ValueError for kernel1
    and kernel2, and for "auto" on a table outside the window."""
    if impl in ("kernel", "kernel3", "reference"):
        return "reference" if impl == "reference" else "kernel3"
    if impl in ("kernel1", "kernel2"):
        raise ValueError(f"--impl {impl} under a mesh: {NO_BOUNDS}; --impl reference "
                         "computes any table there")
    if impl != "auto":
        raise ValueError(f"unknown impl {impl!r} under a mesh")
    why = window_refusal(MergedParams.from_engine(p, "cpu"))
    if why is not None:
        raise ValueError(
            f"--impl auto under a mesh serves generation 3 only, which cannot compute "
            f"this table: {why}; {NO_BOUNDS}. --impl reference computes it"
        )
    return "kernel3"


def make_sharded_forward(
    p: EngineParams,
    mesh: Mesh,
    impl: str = "auto",
    halo: int = RECEPTIVE_RADIUS,
) -> Callable[[torch.Tensor], torch.Tensor]:
    """fn(uint8 tensor [N, H, W] on any device) -> restored uint8 [N, H, W]
    on the mesh's first device, over a (dp, sp) or (dp, sp, sw) mesh. N
    must divide by dp, H by sp and W by sw, and each block keep at least
    `halo` rows (and columns); otherwise ValueError.

    impl: "kernel3" ("kernel", and "auto" on a table inside the saturation
    window) launches generation 3, `fused_forward`, once per block, with
    the block's frame bounds: dp * sp * sw launches a call (on a CPU mesh,
    its plain version). "reference" runs the float64-exact reference net
    with validity masks. The others raise (`sharded_impl`). The weights
    are placed once on each distinct device of the mesh. The callable
    carries `.mesh` and `.impl`."""
    chosen = sharded_impl(p, impl)
    grid = mesh.devices.shape
    rows = grid[1] > 1
    cols = len(grid) == 3 and grid[2] > 1
    carrier = FusedWeights if chosen == "kernel3" else MergedParams
    weights = {}
    for d in mesh.devices.flat:
        if d not in weights:
            weights[d] = carrier.from_engine(p, d)

    kept = (slice(None), slice(halo, -halo) if rows else slice(None),
            slice(halo, -halo) if cols else slice(None))

    def run(x: torch.Tensor) -> torch.Tensor:
        if x.dtype != torch.uint8 or x.dim() != 3:
            raise ValueError(f"expected uint8 frames [N, H, W], got {x.dtype} {tuple(x.shape)}")
        h, w = x.shape[1:]
        if (rows and h // grid[1] < halo) or (cols and w // grid[2] < halo):
            raise ValueError(f"frames {tuple(x.shape)} on mesh {mesh.label()}: each block "
                             f"needs >= {halo} rows (and columns) along a split axis")
        blocks = split_blocks(x, mesh)
        out = np.empty(grid, dtype=object)
        if chosen == "kernel3":
            xe, bounds = extended_blocks(blocks, halo, fill=128)
            for idx in np.ndindex(grid):
                out[idx] = fused_forward(xe[idx], weights[xe[idx].device], *bounds[idx])[kept]
        else:
            ppro = np.empty(grid, dtype=object)
            for idx in np.ndindex(grid):
                ppro[idx] = blocks[idx][..., None].to(torch.int64) - 128
            xe, bounds = extended_blocks(ppro, halo, fill=0)
            for idx in np.ndindex(grid):
                e = xe[idx]
                row_lo, row_hi, col_lo, col_hi = bounds[idx]
                r = torch.arange(e.shape[1], device=e.device)
                c = torch.arange(e.shape[2], device=e.device)
                res = residual_blu_merged(
                    e, weights[e.device],
                    row_valid=(r >= row_lo) & (r < row_hi),
                    col_valid=(c >= col_lo) & (c < col_hi),
                )
                out[idx] = apply_residual_u8(blocks[idx], res[kept])
        return join_blocks(out, mesh.first)

    run.mesh = mesh
    run.impl = chosen
    return run


def pad_batch(frames: np.ndarray, n: int) -> np.ndarray:
    """A ragged batch edge-replicated up to `n` frames (its last frame
    repeated), so that the mesh's dp axis divides it (distributed.py:154-159)."""
    k = frames.shape[0]
    return np.concatenate([frames, np.repeat(frames[-1:], n - k, axis=0)]) if k < n else frames


def psnr_sharded(a, ref, mesh: Mesh, group=None) -> float:
    """PSNR from per-block float64 SSE over the mesh (spatial.py:216-249).
    `a` and `ref` are uint8 [N, H, W] arrays or tensors; each block's SSE
    is computed on its device and the blocks' sums are added. When a
    process group of more than one process is initialized, the SSE and the
    pixel count are all-reduced over `group` (default: the default group;
    host tensors, so a gloo group), and `a`, `ref` are this process's
    frames: the result is the PSNR of every process's frames together.

    Squared differences are integers <= 65025, so every float64 partial
    sum is exact below 2**53 and the result equals the host PSNR
    (`data/yuv.psnr`) to the last bit, +inf for equal inputs."""
    ta, tr = (v if isinstance(v, torch.Tensor)
              else torch.from_numpy(v if v.flags.writeable else v.copy()) for v in (a, ref))
    if ta.shape != tr.shape:
        raise ValueError(f"shapes differ: {tuple(ta.shape)} and {tuple(tr.shape)}")
    sse = 0.0
    for ba, br in zip(split_blocks(ta, mesh).flat, split_blocks(tr, mesh).flat):
        d = ba.to(torch.float64) - br.to(torch.float64)
        sse += float((d * d).sum())
    total = torch.tensor([sse, float(ta.numel())], dtype=torch.float64)
    if dist.is_available() and dist.is_initialized() and dist.get_world_size(group) > 1:
        dist.all_reduce(total, group=group)
    mse = float(total[0]) / float(total[1])
    if mse == 0.0:
        return math.inf
    return 10.0 * math.log10(65025.0 / mse)
