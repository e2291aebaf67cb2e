"""Channel-sharded (tensor-parallel) convolutions: the port's counterpart
of `qcnn_gpu_tpu/parallel/tensor.py` (:1-231).

The standard pair of shardings for back-to-back convolutions, over one
axis of a `Mesh` ("sp" by default, as the JAX package's `make_mesh(1, tp)`):

  * column-parallel: each shard holds a slice of the OUTPUT channels (and
    of their per-channel requant rows) and computes its slice of the
    feature map, with no exchange;
  * row-parallel: each shard holds a slice of the INPUT channels and
    contracts its local activations; the partial accumulators combine in
    ONE sum (the JAX `lax.psum`), exact for integers, and only then come
    the bias and the requant, so every epilogue sees the unsharded
    accumulator.

The "psum": each rank sums its shards' partials, in shard order, on its
first shard's device; where the axis spans ranks (a mesh from
`parallel/mesh.make_global_mesh`), the ranks' sums are then all-reduced
over the mesh's gloo group as host int32 tensors (exact, as the JAX
`lax.psum` over the axis is, :49). The bias and the requant run on every
rank on the full sum (the JAX program's replicated P() epilogue), and the
int8 activations go to every shard's device of the rank for the next
column-parallel layer (on a virtual mesh, one device repeated, that is
one tensor). Shards run in turn from the caller's thread, as in
`parallel/spatial.py`. Per-shard convolutions are `ops/int8_conv.conv_int8`:
im2col + `_int_mm` on CUDA, float64-exact `conv_exact` on the CPU.

Where the mesh has other axes, the JAX program replicates the whole
computation over them (its inputs and outputs are P()); here the shards
at index 0 of those axes compute it once. Across ranks, every rank of the
mesh must own shards of that line (else ValueError), passes the same
frames and gets the whole result.
"""

from __future__ import annotations

from typing import List, Optional, Sequence

import numpy as np
import torch
import torch.distributed as dist
import torch.nn.functional as F

from qcnn_gpu_tpu_torch.models.engine_params import EngineParams
from qcnn_gpu_tpu_torch.models.float_model import fp32_convs
from qcnn_gpu_tpu_torch.models.qvrcnn import MergedParams
from qcnn_gpu_tpu_torch.models.wide import WideParams, int32_table
from qcnn_gpu_tpu_torch.ops.int8_conv import conv_int8, gemm_operand
from qcnn_gpu_tpu_torch.ops.requant import (
    apply_residual_u8,
    blu_requant_clamped_i32,
    final_residual_i32,
)
from qcnn_gpu_tpu_torch.parallel.mesh import Mesh


def axis_devices(mesh: Mesh, axis: str) -> List[Optional[torch.device]]:
    """The devices along `axis`, the other axes at index 0; None where
    another rank owns the shard. Raises ValueError when the axis spans
    ranks but not all of the mesh's."""
    dim = mesh.axis_names.index(axis)
    idx = [0] * mesh.devices.ndim
    out = []
    owners = set()
    for j in range(mesh.devices.shape[dim]):
        idx[dim] = j
        owners.add(int(mesh.ranks[tuple(idx)]))
        out.append(mesh.devices[tuple(idx)] if mesh.ranks[tuple(idx)] == mesh.rank else None)
    if mesh.world > 1 and owners != set(range(mesh.world)):
        raise ValueError(f"axis {axis!r} of mesh {mesh.label()}: its shards sit on ranks "
                         f"{sorted(owners)} of {mesh.world}; every rank must own some")
    return out


def psum(partials: Sequence[torch.Tensor], device: torch.device,
         mesh: Optional[Mesh] = None) -> torch.Tensor:
    """The axis's sum of this rank's per-shard partials, in shard order, on
    `device`; on a `mesh` that spans ranks, all-reduced over its group."""
    total = partials[0].to(device, non_blocking=True)
    for t in partials[1:]:
        total = total + t.to(device, non_blocking=True)
    if mesh is not None and mesh.world > 1:
        host = total.cpu()
        dist.all_reduce(host, group=mesh.group)
        total = host.to(device)
    return total


def replicate(t: torch.Tensor, devices: Sequence[Optional[torch.device]]) -> List[torch.Tensor]:
    """`t` on the device of every shard this rank owns (None: another
    rank's; on a virtual mesh, `t` itself)."""
    return [t.to(d, non_blocking=True) for d in devices if d is not None]


def _own(devices: Sequence[Optional[torch.device]]):
    """[(shard index, device)] of this rank's shards."""
    return [(j, d) for j, d in enumerate(devices) if d is not None]


def _conv_f32(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """SAME float32 cross-correlation, NHWC x, HWIO w."""
    y = F.conv2d(x.permute(0, 3, 1, 2), w.permute(3, 2, 0, 1), padding=w.shape[0] // 2)
    return y.permute(0, 2, 3, 1)


def tp_pair_forward(x, w_a, b_a, w_b, b_b, devices: Sequence[Optional[torch.device]],
                    mesh: Optional[Mesh] = None) -> torch.Tensor:
    """Two chained float convs channel-sharded over `devices` (:39-51):
    shard j holds w_a's output-channel slice j (and b_a's) and w_b's
    input-channel slice j; h = relu(conv(x, w_a) + b_a) stays sharded, one
    sum combines conv(h, w_b)'s partials, then b_b. x NHWC, weights HWIO,
    float32, on this rank's first shard's device; returns the result
    there (`axis_devices`: None at another rank's shards, whose partials
    arrive through `psum` over `mesh`)."""
    tp = len(devices)
    c = w_a.shape[3] // tp
    own = _own(devices)
    parts = []
    with fp32_convs():
        for j, d in own:
            sl = slice(j * c, (j + 1) * c)
            h = _conv_f32(x.to(d), w_a[..., sl].to(d)) + b_a[sl].to(d)
            h = torch.maximum(h, h.new_zeros(()))
            parts.append(_conv_f32(h, w_b[:, :, sl].to(d)))
    return psum(parts, own[0][1], mesh) + b_b


def make_tp_conv_pair(mesh: Mesh, axis: str = "sp"):
    """fn(x, w_a, b_a, w_b, b_b) -> the sharded pair over mesh axis `axis`
    (:54-70); weights passed unsharded, split per shard. Raises ValueError
    unless the axis divides w_a's output channels."""
    devices = axis_devices(mesh, axis)

    def run(x, w_a, b_a, w_b, b_b):
        if w_a.shape[3] % len(devices):
            raise ValueError(f"tp={len(devices)} must divide {w_a.shape[3]} channels")
        return tp_pair_forward(x, w_a, b_a, w_b, b_b, devices, mesh)

    return run


def _to_int8(x_uint8: torch.Tensor) -> torch.Tensor:
    """uint8 [N, H, W] -> the int8 NHWC input x - 128."""
    return (x_uint8[..., None].to(torch.int16) - 128).to(torch.int8)


def make_tp_int8_forward(p: EngineParams, mesh: Mesh, axis: str = "sp"):
    """Channel-sharded INT8 QVRCNN: the merged 4-stage graph as two
    Megatron pairs over mesh axis `axis` (:73-141).

      S1 (1->64)  column-parallel: output channels and their per-channel
                  requant rows sharded; no exchange.
      S2 (64->48) row-parallel: input channels sharded; ONE exact int32 sum
                  of the partial accumulators, THEN bias and BLU requant.
      S3 (48->48) column-parallel; S4 (48->1) row-parallel, the final
                  residual requant after its sum.

    fn(uint8 tensor [N, H, W] on this rank's first shard's device) ->
    uint8, bit-equal to the unsharded engine; across ranks every rank
    passes the same frames and gets the result. Raises ValueError unless
    64 % tp == 0 and 48 % tp == 0 (the JAX assert). The int32 epilogues
    are exact for every table `MergedParams` accepts (its rows are checked
    there)."""
    devices = axis_devices(mesh, axis)
    tp = len(devices)
    if 64 % tp or 48 % tp:
        raise ValueError(f"tp={tp} must divide 64 and 48")
    own = _own(devices)
    first = own[0][1]
    mps = {d: MergedParams.from_engine(p, d) for _, d in own}

    def col(i, j, d):  # shard j's slice of column-parallel stage i
        mp = mps[d]
        c = mp.w_i8[i].shape[3] // tp
        sl = slice(j * c, (j + 1) * c)
        q = tuple(v[sl] for v in (mp.blu_q[i], mp.mul[i], mp.shift[i]))
        return gemm_operand(mp.w_i8[i][..., sl].contiguous()), mp.b_i32[i][sl], q

    def row(i, j, d):  # shard j's input-channel slice of row-parallel stage i
        w = mps[d].w_i8[i]
        c = w.shape[2] // tp
        return gemm_operand(w[:, :, j * c:(j + 1) * c].contiguous())

    shards = [(col(0, j, d), row(1, j, d), col(2, j, d), row(3, j, d)) for j, d in own]
    mp0 = mps[first]

    @torch.no_grad()
    def run(x_uint8: torch.Tensor) -> torch.Tensor:
        part = []
        for xj, (s1, s2, _, _) in zip(replicate(_to_int8(x_uint8), devices), shards):
            v1 = blu_requant_clamped_i32(conv_int8(xj, s1[0], s1[1]), *s1[2])
            part.append(conv_int8(v1, s2))
        u2 = psum(part, first, mesh) + mp0.b_i32[1]
        v2 = blu_requant_clamped_i32(u2, mp0.blu_q[1], mp0.mul[1], mp0.shift[1])
        part = []
        for vj, (_, _, s3, s4) in zip(replicate(v2, devices), shards):
            v3 = blu_requant_clamped_i32(conv_int8(vj, s3[0], s3[1]), *s3[2])
            part.append(conv_int8(v3, s4))
        u4 = psum(part, first, mesh) + mp0.b_i32[3]
        res = final_residual_i32(u4[..., 0], mp0.mul4, mp0.shift4)
        return apply_residual_u8(x_uint8, res)

    run.mesh = mesh
    run.impl = f"tp{tp}-int8"
    return run


def tp_modes(n_layers: int) -> List[str]:
    """The wide net's forced sharding chain (:177-184): a column-parallel
    layer leaves its output channel-sharded (a row-parallel layer's input),
    whose sum leaves it replicated (a column-parallel layer's input); the
    head takes the replicated frame, so layer i is 'col' iff i is even. The
    tail (Cout 1) is 'row' at an odd index; at an even one it runs
    replicated ('rep': full weights, no exchange)."""
    modes = ["col" if i % 2 == 0 else "row" for i in range(n_layers - 1)]
    modes.append("row" if (n_layers - 1) % 2 == 1 else "rep")
    return modes


def make_tp_wide_forward(p: WideParams, mesh: Mesh, axis: str = "sp"):
    """Channel-sharded INT8 wide net (:144-231): layers alternate column-
    and row-parallel (`tp_modes`), with ONE exact int32 sum per row-
    parallel layer before its requant; ceil((B+1)/2) sums for B body
    convs. fn(uint8 tensor [N, H, W] on this rank's first shard's device)
    -> uint8, bit-equal to `forward_wide`; across ranks, as
    `make_tp_int8_forward`. Raises ValueError unless channels % tp == 0,
    and for a table the int32 epilogue cannot hold."""
    devices = axis_devices(mesh, axis)
    tp = len(devices)
    c = p.channels
    if c % tp:
        raise ValueError(f"tp={tp} must divide channels={c}")
    table = int32_table(p)
    n = len(p.weights)
    modes = tp_modes(n)
    cs = c // tp

    def shard(i, j, d):  # (operand, bias or None) of layer i on shard j
        w = torch.as_tensor(np.asarray(p.weights[i], np.int8), device=d)
        b = torch.as_tensor(np.asarray(p.biases[i], np.int32), device=d)
        sl = slice(j * cs, (j + 1) * cs)
        if modes[i] == "col":
            return gemm_operand(w[..., sl].contiguous()), b[sl]
        if modes[i] == "row":
            return gemm_operand(w[:, :, sl].contiguous()), None
        return gemm_operand(w), b

    own = _own(devices)
    first = own[0][1]
    layers = [[shard(i, j, d) for j, d in own] for i in range(n)]
    bias_row = [torch.as_tensor(np.asarray(b, np.int32), device=first) for b in p.biases]

    @torch.no_grad()
    def run(x_uint8: torch.Tensor) -> torch.Tensor:
        vs = replicate(_to_int8(x_uint8), devices)
        for i, mode in enumerate(modes):
            if mode == "row":
                u = psum([conv_int8(v, op) for v, (op, _) in zip(vs, layers[i])], first, mesh)
                u = u + bias_row[i]
            elif mode == "rep":  # the tail at an even index: one shard a rank computes it
                op, b = layers[i][0]
                u = conv_int8(vs[0], op, b)
            else:  # col: each shard its output channels
                vs = [blu_requant_clamped_i32(conv_int8(v, op, b), *table[i])
                      for v, (op, b) in zip(vs, layers[i])]
                continue
            if i < n - 1:
                vs = replicate(blu_requant_clamped_i32(u, *table[i]), devices)
        res = final_residual_i32(u[..., 0], p.mul_last, p.shift_last)
        return apply_residual_u8(x_uint8, res)

    run.mesh = mesh
    run.impl = f"tp{tp}-wide-int8"
    return run
