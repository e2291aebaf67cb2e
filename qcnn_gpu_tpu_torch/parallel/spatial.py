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
network must read as SAME padding, on every layer: generations 3 and 1
take per-block frame bounds (`ops/fused.fused_forward`'s and
`ops/literal.literal_residual`'s row_lo..col_hi, the JAX kernel's
row_bounds/col_bounds), the reference net row/col validity masks
(`models/qvrcnn.residual_blu_merged`). The filler is the ppro-domain
zero: 128 in uint8 for the kernels, 0 in the x-128 integers for the
reference net (spatial.py:43-61). Generation 1 returns the block's int16
residual, cropped to the kept rows and columns and added to the block
outside the kernel, as the reference net's is.

The JAX shard_map runs the blocks at once, one per device; here each
block is launched in turn from the caller's thread, on its device's
current stream, and the copies between devices are `non_blocking`. On a
virtual mesh (one device repeated) the blocks run one after the other on
that device, and a neighbour's rows are a slice.

A mesh may span ranks (`parallel/mesh.make_global_mesh`): each rank then
holds its slice of the global batch, runs the blocks of the positions it
owns, and trades the halo rows and columns of a neighbour on another
rank over the mesh's gloo group as host tensors (uint8 for the
kernels, the x-128 integers for the reference net; the JAX ppermutes over
DCN), rows first, so that the corners still come from the
diagonal neighbour; the frame bounds come from each block's position in
the global grid.

Departures from the JAX package: `auto` serves a table outside the
solver's saturation window with generation 1 (`ops/literal.auto_generation`,
as on one device), where the JAX package's `make_sharded_forward(impl=
"auto")` returns kernel v3, whose folded requant departs from the oracle
there (spatial.py:106-109; its CPU's XLA graph is exact); a kernel that
fails to build or launch raises (the JAX package warns and demotes `auto`
to the sharded XLA graph, spatial.py:121-133); and a mesh axis of extent
1 gets no halo (`extended_blocks`), where the JAX program pads it with
filler.
"""

from __future__ import annotations

import math
from typing import Callable, Optional

import numpy as np
import torch
import torch.distributed as dist

from qcnn_gpu_tpu_torch.models.engine_params import EngineParams
from qcnn_gpu_tpu_torch.models.qvrcnn import MergedParams, residual_blu_merged
from qcnn_gpu_tpu_torch.models.topology import RECEPTIVE_RADIUS
from qcnn_gpu_tpu_torch.ops.fused import FusedWeights, fused_forward
from qcnn_gpu_tpu_torch.ops.literal import LiteralWeights, auto_generation, literal_residual
from qcnn_gpu_tpu_torch.ops.requant import apply_residual_u8
from qcnn_gpu_tpu_torch.parallel.mesh import Mesh


def _exchange(blocks: np.ndarray, dim: int, halo: int, fill: int,
              mesh: Optional[Mesh] = None, stats: Optional[dict] = None) -> np.ndarray:
    """Extend tensor dimension `dim` of every block with `halo` slices from
    its neighbours along grid axis `dim` (grid axes and tensor dimensions
    line up: dp/N, sp/H, sw/W). A block at the grid's edge gets `fill`.

    On a `mesh` that spans ranks, `blocks` holds this rank's blocks at
    their grid positions (None elsewhere). A neighbour that another rank
    owns sends its edge slice over the mesh's process group as a host
    tensor, and this rank sends it its own: every send and receive is
    posted at once (`batch_isend_irecv`) and then awaited, so no order of
    the ranks can deadlock. The tag of a message is its receiving
    position's flat index and side, unique however many positions a rank
    owns. `stats` counts the bytes sent and received across ranks."""
    out = np.empty(blocks.shape, dtype=object)
    n = blocks.shape[dim]
    ranks = np.zeros(blocks.shape, np.int64) if mesh is None else mesh.ranks
    me = 0 if mesh is None else mesh.rank

    def tag(idx, side):  # a message's tag: its receiving position and side
        return int(np.ravel_multi_index(idx, blocks.shape)) * 2 + side

    ops, sends, recvs = [], [], {}
    for idx in np.ndindex(blocks.shape):
        if ranks[idx] != me:
            continue
        b = blocks[idx]
        for side, step in enumerate((-1, 1)):
            j = idx[dim] + step
            nb = idx[:dim] + (j,) + idx[dim + 1:]
            if not 0 <= j < n or ranks[nb] == me:
                continue
            # the neighbour's edge arrives on this side; this block's edge
            # toward it leaves, for the neighbour's other side
            shape = list(b.shape)
            shape[dim] = halo
            recvs[idx, side] = torch.empty(shape, dtype=b.dtype)
            sends.append(b.narrow(dim, 0 if step < 0 else b.shape[dim] - halo, halo)
                         .contiguous().cpu())
            peer = int(ranks[nb])
            ops.append(dist.P2POp(dist.irecv, recvs[idx, side], peer, mesh.group, tag(idx, side)))
            ops.append(dist.P2POp(dist.isend, sends[-1], peer, mesh.group, tag(nb, 1 - side)))
    if ops:
        for work in dist.batch_isend_irecv(ops):
            work.wait()
        if stats is not None:
            stats["sent"] = stats.get("sent", 0) + sum(t.nbytes for t in sends)
            stats["received"] = stats.get("received", 0) + sum(t.nbytes for t in recvs.values())
    for idx in np.ndindex(blocks.shape):
        if ranks[idx] != me:
            continue
        b = blocks[idx]
        parts = []
        for side, step in enumerate((-1, 1)):
            j = idx[dim] + step
            if (idx, side) in recvs:
                parts.append(recvs[idx, side].to(b.device, non_blocking=True))
            elif 0 <= j < n:
                src = blocks[idx[:dim] + (j,) + idx[dim + 1:]]
                start = src.shape[dim] - halo if step < 0 else 0
                parts.append(src.narrow(dim, start, halo).to(b.device, non_blocking=True))
            else:
                shape = list(b.shape)
                shape[dim] = halo
                parts.append(torch.full(shape, fill, dtype=b.dtype, device=b.device))
        out[idx] = torch.cat([parts[0], b, parts[1]], dim=dim)
    return out


def halo_exchange_rows(blocks: np.ndarray, halo: int, fill: int = 0,
                       mesh: Optional[Mesh] = None, stats: Optional[dict] = None) -> np.ndarray:
    """A grid of blocks [N, H_local, ...] (an object array of tensors over
    the mesh, sp on its axis 1) -> each block extended with `halo` rows
    from each row neighbour; blocks at the frame's top or bottom get
    `fill` rows there. On a `mesh` that spans ranks, this rank's blocks
    (None elsewhere), the rows of other ranks' blocks exchanged over
    its process group (`_exchange`)."""
    return _exchange(blocks, 1, halo, fill, mesh, stats)


def halo_exchange_cols(blocks: np.ndarray, halo: int, fill: int = 0,
                       mesh: Optional[Mesh] = None, stats: Optional[dict] = None) -> np.ndarray:
    """As `halo_exchange_rows` over columns (sw, grid axis 2). Called on
    the row-extended blocks, the column neighbour's edge columns carry the
    diagonal neighbour's corner pixels (spatial.py:69-76), across ranks
    too."""
    return _exchange(blocks, 2, halo, fill, mesh, stats)


def split_blocks(x: torch.Tensor, mesh: Mesh) -> np.ndarray:
    """[N, H, W, ...] -> the grid of blocks over `mesh`, each on its device
    (a view where the device is x's). Raises ValueError unless N divides
    by dp, H by sp and W by sw, as the JAX shard_map requires. On a mesh
    that spans ranks, `x` is this rank's slice of the global batch
    (`Mesh.local_slice`), split over the sub-grid it owns; the other
    positions hold None."""
    grid = mesh.devices.shape
    own = mesh.owned()
    sub = tuple(o.stop - o.start for o in own)
    shape = tuple(x.shape[:len(grid)])
    if any(s % g for s, g in zip(shape, sub)):
        where = "" if mesh.world == 1 else f" (rank {mesh.rank}'s sub-grid {'x'.join(map(str, sub))})"
        raise ValueError(
            f"frames {tuple(x.shape)} do not split over mesh {mesh.label()}{where} "
            f"({', '.join(mesh.axis_names)}): N, H{', W' if len(grid) > 2 else ''} must divide"
        )
    step = [s // g for s, g in zip(shape, sub)]
    blocks = np.full(grid, None, dtype=object)
    for local in np.ndindex(sub):
        b = x
        for d, i in enumerate(local):
            b = b.narrow(d, i * step[d], step[d])
        idx = tuple(o.start + i for o, i in zip(own, local))
        blocks[idx] = b.to(mesh.devices[idx], non_blocking=True)
    return blocks


def join_blocks(blocks: np.ndarray, device) -> torch.Tensor:
    """The inverse of `split_blocks`: the grid (on a mesh that spans ranks,
    this rank's sub-grid: `blocks[mesh.owned()]`) put back together on
    `device`."""

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


def extended_blocks(blocks: np.ndarray, halo: int, fill: int,
                    mesh: Optional[Mesh] = None, stats: Optional[dict] = None):
    """A grid of blocks (`split_blocks`; 2-D over a (dp, sp) mesh, 3-D over
    (dp, sp, sw)) -> (the halo-extended blocks, and each one's frame bounds
    (row_lo, row_hi, col_lo, col_hi)): rows exchanged, then columns on a
    3-D grid. An axis of extent 1 has no neighbour and is not extended:
    the JAX program pads it with filler that its bounds then mask, which
    costs generation 3 a tile row (2.2% of a 1080p frame's tiles). On a
    `mesh` that spans ranks, this rank's blocks, exchanged with the other
    ranks' (`_exchange`; `stats` counts the bytes); the bounds come from
    each block's position in the global grid."""
    rows = blocks.shape[1] > 1
    cols = blocks.ndim == 3 and blocks.shape[2] > 1
    xe = halo_exchange_rows(blocks, halo, fill, mesh, stats) if rows else blocks
    if cols:
        xe = halo_exchange_cols(xe, halo, fill, mesh, stats)
    bounds = np.full(blocks.shape, None, dtype=object)
    for idx in np.ndindex(blocks.shape):
        if xe[idx] is None:
            continue
        h, w = xe[idx].shape[1:3]
        bounds[idx] = ((_bounds(idx[1], blocks.shape[1], h, halo) if rows else (0, h))
                       + (_bounds(idx[2], blocks.shape[2], w, halo) if cols else (0, w)))
    return xe, bounds


def sharded_impl(p: EngineParams, impl: str) -> str:
    """The program `make_sharded_forward` runs for `impl`: "kernel3"
    (generation 3: "kernel", "kernel3", and "auto" on a table inside the
    saturation window), "kernel1" (generation 1: "kernel1", and "auto" on
    a table outside it that generation 1 computes), each under per-block
    frame bounds, or "reference". Raises ValueError for "kernel2", and for
    "auto" on a table that neither generation computes (naming `--impl
    reference`), as `ops/literal.auto_generation` does on one device."""
    if impl in ("kernel", "kernel3"):
        return "kernel3"
    if impl in ("kernel1", "reference"):
        return impl
    if impl == "kernel2":
        raise ValueError("--impl kernel2 under a mesh: the mesh path runs generations 3 and 1 "
                         "only, each block under its frame bounds (the JAX package's mesh path "
                         "has no frame-pair kernel); --impl reference computes any table there")
    if impl != "auto":
        raise ValueError(f"unknown impl {impl!r} under a mesh")
    return auto_generation(p)


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

    On a mesh that spans ranks, every rank of it calls fn at once, each
    on its slice of the global batch (`Mesh.local_slice`): fn runs this
    rank's blocks, exchanges the halos with the other ranks over the
    mesh's process group, and returns this rank's restored slice.

    impl: "kernel3" ("kernel", and "auto" on a table inside the saturation
    window) launches generation 3, `fused_forward`, once per block, with
    the block's frame bounds; "kernel1" ("auto" on a table outside the
    window) launches generation 1, `literal_residual`, the same way, and
    adds the residual's kept rows and columns to the block. Either is a
    launch per position the rank owns (dp * sp * sw on one process) a
    call (on a CPU mesh, its plain version). "reference" runs the
    float64-exact reference net with validity masks. The others raise
    (`sharded_impl`). The weights are placed once on each distinct device
    of this rank's positions. The callable carries
    `.mesh`, `.impl` and `.halo_bytes` (bytes sent and received across
    ranks, summed over its calls)."""
    chosen = sharded_impl(p, impl)
    grid = mesh.devices.shape
    own = mesh.owned()
    sub = tuple(o.stop - o.start for o in own)
    rows = grid[1] > 1
    cols = len(grid) == 3 and grid[2] > 1
    carrier = {"kernel3": FusedWeights, "kernel1": LiteralWeights,
               "reference": MergedParams}[chosen]
    weights = {d: carrier.from_engine(p, d) for d in mesh.local_devices()}
    stats = {"sent": 0, "received": 0}

    kept = (slice(None), slice(halo, -halo) if rows else slice(None),
            slice(halo, -halo) if cols else slice(None))

    def run(x: torch.Tensor) -> torch.Tensor:
        if x.dtype != torch.uint8 or x.dim() != 3:
            raise ValueError(f"expected uint8 frames [N, H, W], got {x.dtype} {tuple(x.shape)}")
        h, w = x.shape[1:]
        if (rows and h // sub[1] < halo) or (cols and w // sub[2] < halo):
            raise ValueError(f"frames {tuple(x.shape)} on mesh {mesh.label()}: each block "
                             f"needs >= {halo} rows (and columns) along a split axis")
        blocks = split_blocks(x, mesh)
        out = np.full(grid, None, dtype=object)
        if chosen != "reference":
            xe, bounds = extended_blocks(blocks, halo, 128, mesh, stats)
            for idx in np.ndindex(grid):
                e = xe[idx]
                if e is None:
                    continue
                if chosen == "kernel3":
                    out[idx] = fused_forward(e, weights[e.device], *bounds[idx])[kept]
                else:
                    res = literal_residual(e, weights[e.device], *bounds[idx])
                    out[idx] = apply_residual_u8(blocks[idx], res[kept])
        else:
            ppro = np.full(grid, None, dtype=object)
            for idx in np.ndindex(grid):
                if blocks[idx] is not None:
                    ppro[idx] = blocks[idx][..., None].to(torch.int64) - 128
            xe, bounds = extended_blocks(ppro, halo, 0, mesh, stats)
            for idx in np.ndindex(grid):
                e = xe[idx]
                if e is None:
                    continue
                row_lo, row_hi, col_lo, col_hi = bounds[idx]
                r = torch.arange(e.shape[1], device=e.device)
                c = torch.arange(e.shape[2], device=e.device)
                res = residual_blu_merged(
                    e, weights[e.device],
                    row_valid=(r >= row_lo) & (r < row_hi),
                    col_valid=(c >= col_lo) & (c < col_hi),
                )
                out[idx] = apply_residual_u8(blocks[idx], res[kept])
        return join_blocks(out[own], mesh.first)

    run.mesh = mesh
    run.impl = chosen
    run.halo_bytes = stats
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
    frames (on a mesh that spans ranks, its slice of the global batch):
    the result is the PSNR of every process's frames together.

    Squared differences are integers <= 65025, so every float64 partial
    sum is exact below 2**53 and the result equals the host PSNR
    (`data/yuv.psnr`) to the last bit, +inf for equal inputs."""
    ta, tr = (v if isinstance(v, torch.Tensor)
              else torch.from_numpy(v if v.flags.writeable else v.copy()) for v in (a, ref))
    if ta.shape != tr.shape:
        raise ValueError(f"shapes differ: {tuple(ta.shape)} and {tuple(tr.shape)}")
    sse = 0.0
    for ba, br in zip(split_blocks(ta, mesh).flat, split_blocks(tr, mesh).flat):
        if ba is None:  # another rank's block
            continue
        d = ba.to(torch.float64) - br.to(torch.float64)
        sse += float((d * d).sum())
    total = torch.tensor([sse, float(ta.numel())], dtype=torch.float64)
    if dist.is_available() and dist.is_initialized() and dist.get_world_size(group) > 1:
        dist.all_reduce(total, group=group)
    mse = float(total[0]) / float(total[1])
    if mse == 0.0:
        return math.inf
    return 10.0 * math.log10(65025.0 / mse)
