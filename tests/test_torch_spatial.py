"""The port's sharded restoration (qcnn_gpu_tpu_torch.parallel) against the
JAX package's on its 8-device virtual CPU mesh, and against the port's
unsharded restore. Every comparison is bit-exact (tolerance 0); PSNRs are
equal to the last bit. The port's meshes here are virtual CPU meshes
(`[torch.device("cpu")] * 8`), where generations 3 and 1 run their plain
versions with the same frame bounds as on the card."""

import dataclasses
import functools

import numpy as np
import pytest
import torch
from jax.experimental.shard_map import shard_map
from jax.sharding import PartitionSpec as P

from qcnn_gpu_tpu.parallel import make_mesh as jax_make_mesh
from qcnn_gpu_tpu.parallel import make_sharded_forward as jax_sharded
from qcnn_gpu_tpu.parallel import mesh_shape_for as jax_mesh_shape_for
from qcnn_gpu_tpu.parallel import spatial as JS
from qcnn_gpu_tpu.testing import synth_engine_params as jax_synth_params
from qcnn_gpu_tpu_torch.data import yuv
from qcnn_gpu_tpu_torch.engine.runner import Engine
from qcnn_gpu_tpu_torch.models.engine_params import EngineParams
from qcnn_gpu_tpu_torch.models.qvrcnn import MergedParams, _normalized_table, make_forward
from qcnn_gpu_tpu_torch.ops.fused import window_refusal
from qcnn_gpu_tpu_torch.ops.literal import LiteralWeights, literal_forward_reference
from qcnn_gpu_tpu_torch.parallel import spatial as S
from qcnn_gpu_tpu_torch.parallel.mesh import make_mesh, mesh_on, mesh_shape_for, parse_mesh
from qcnn_gpu_tpu_torch.testing import synth_engine_params, synth_frames

CPU8 = [torch.device("cpu")] * 8
HALO = 6
MESHES = [(1, 8, 1), (2, 4, 1), (4, 2, 1), (1, 2, 2), (2, 2, 2), (2, 1, 1), (2, 1, 2)]
H, W = 64, 96  # 8 rows a block at sp 8, 48 columns at sw 2


def _port_mesh(dims):
    return make_mesh(dims[0], dims[1], devices=CPU8, sw=dims[2])


def _jax_mesh(dims):
    return jax_make_mesh(dims[0], dims[1], sw=dims[2])


def _frames(dims):
    return synth_frames(2 * dims[0], H, W, seed=sum(d * 10 ** i for i, d in enumerate(dims)))


@functools.lru_cache(maxsize=None)
def _jax_restored(dims, qp=37):
    """JAX make_sharded_forward(impl="int") on the same mesh shape."""
    run = jax_sharded(jax_synth_params(qp), _jax_mesh(dims), impl="int")
    return np.asarray(run(_frames(dims)))


def _moved_up(p):
    """p's table with C2_2's bound one output step up: outside the
    saturation window (chip_smoke.py phase 7's first table). p is the
    port's EngineParams or the JAX package's."""
    mul, shift = _normalized_table(EngineParams.from_arrays(p))
    blu = list(p.blu_q)
    blu[2] = int(blu[2]) + (1 << int(shift[2])) // int(mul[2]) + 1
    return dataclasses.replace(p, blu_q=type(p.blu_q)(blu))


def _outside_window():
    """The QP37 synth table outside the saturation window (`_moved_up`)."""
    return _moved_up(synth_engine_params(37))


OUTSIDE_X = (2, 48, 64)  # frames of the outside-window cases, seed 9


@functools.lru_cache(maxsize=None)
def _jax_outside(dims):
    """JAX make_sharded_forward(impl="auto") on the outside-window table:
    on the CPU, the sharded XLA graph (spatial.py:106-109), exact."""
    run = jax_sharded(_moved_up(jax_synth_params(37)), _jax_mesh(dims), impl="auto")
    return np.asarray(run(synth_frames(*OUTSIDE_X, seed=9)))


@pytest.mark.parametrize("dims", [(1, 2, 1), (1, 4, 1), (2, 2, 1), (1, 2, 2), (2, 2, 2)],
                         ids=lambda d: "x".join(map(str, d)))
def test_halo_exchange_equal_jax(dims):
    """Rows, then columns on a 2-D mesh, on int8 blocks: the extended
    blocks put side by side equal JAX's under shard_map."""
    x8 = (synth_frames(2 * dims[0], 48, 64, seed=3).astype(np.int16) - 128).astype(np.int8)
    two_d = dims[2] > 1
    spec = P("dp", "sp", "sw") if two_d else P("dp", "sp", None)

    def block(xb):
        xe = JS.halo_exchange_rows(xb, "sp", HALO)
        return JS.halo_exchange_cols(xe, "sw", HALO) if two_d else xe

    want = np.asarray(shard_map(block, mesh=_jax_mesh(dims), in_specs=spec, out_specs=spec,
                                check_rep=False)(x8))
    blocks = S.split_blocks(torch.from_numpy(x8), _port_mesh(dims))
    ext = S.halo_exchange_rows(blocks, HALO)
    if two_d:
        ext = S.halo_exchange_cols(ext, HALO)
    got = S.join_blocks(ext, "cpu").numpy()
    assert got.shape == want.shape and (got == want).all()


@pytest.mark.parametrize("impl", ["reference", "kernel3"])
@pytest.mark.parametrize("dims", MESHES, ids=lambda d: "x".join(map(str, d)))
def test_sharded_equal_jax_and_unsharded(dims, impl):
    """reference: the masked reference net per block; kernel3: generation
    3's plain version with each block's frame bounds (the synth table lies
    inside the saturation window)."""
    p = synth_engine_params(37)
    assert window_refusal(MergedParams.from_engine(p, "cpu")) is None
    x = _frames(dims)
    run = S.make_sharded_forward(p, _port_mesh(dims), impl=impl)
    assert run.impl == impl and run.mesh.label() == "x".join(
        str(d) for d in (dims if dims[2] > 1 else dims[:2]))
    got = run(torch.from_numpy(x)).numpy()
    whole = make_forward(p, device="cpu")(torch.from_numpy(x)).numpy()
    assert (got == _jax_restored(dims)).all()
    assert (got == whole).all()


def test_sharded_auto_is_kernel3_and_counts_blocks(monkeypatch):
    """auto on a table inside the window is generation 3, launched once per
    block per call (dp * sp * sw)."""
    calls = []
    real = S.fused_forward

    def counting(*a):
        calls.append(a[2:])
        return real(*a)

    monkeypatch.setattr(S, "fused_forward", counting)
    run = S.make_sharded_forward(synth_engine_params(37), _port_mesh((1, 2, 2)))
    assert run.impl == "kernel3"
    run(torch.from_numpy(_frames((1, 2, 2))))
    # every block's bounds: the halo outside at the frame's edges
    assert sorted(calls) == sorted([(6, 44, 6, 60), (6, 44, 0, 54), (0, 38, 6, 60),
                                    (0, 38, 0, 54)])


@pytest.mark.parametrize("dims", [(2, 4, 1), (1, 2, 2)], ids=lambda d: "x".join(map(str, d)))
def test_psnr_sharded_equal_jax_and_host(dims):
    x = _frames(dims)
    rec = _jax_restored(dims)
    got = S.psnr_sharded(rec, x, _port_mesh(dims))
    assert got == yuv.psnr(rec, x)
    assert got == JS.psnr_sharded(rec, x, _jax_mesh(dims))
    assert S.psnr_sharded(torch.from_numpy(x), x, _port_mesh(dims)) == yuv.psnr(x, x) == np.inf


def test_mesh_shape_for_equal_jax():
    for n in range(1, 17):
        for frames in (None, 1, 2, 3, 4, 8, 16):
            for rows in (None, 64, 240, 1080):
                for cols in (None, 256, 1920):
                    assert mesh_shape_for(n, frames, rows, cols) == jax_mesh_shape_for(
                        n, frames, rows, cols), (n, frames, rows, cols)


def test_make_mesh_shapes_and_virtual_devices():
    m = make_mesh(2, 4, devices=CPU8)
    assert m.axis_names == ("dp", "sp") and m.shape == {"dp": 2, "sp": 4}
    assert m.label() == "2x4" and m.first == torch.device("cpu")
    m3 = mesh_on("cpu", 1, 2, 2)
    assert m3.axis_names == ("dp", "sp", "sw") and m3.shape == {"dp": 1, "sp": 2, "sw": 2}
    assert m3.label() == "1x2x2" and m3.devices.size == 4
    assert parse_mesh("2") == (2, 1, 1) and parse_mesh("1x2x4") == (1, 2, 4)
    with pytest.raises(SystemExit, match="DPxSP"):
        parse_mesh("1x2x2x2")


def test_make_mesh_without_cuda_or_devices_raises(monkeypatch):
    """No silent CPU mesh: without CUDA a mesh needs explicit devices."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(ValueError, match="no CUDA device"):
        make_mesh(1, 2)
    with pytest.raises(ValueError, match="no CUDA device"):
        mesh_on("cuda", 1, 2)


def test_make_mesh_needs_enough_devices():
    with pytest.raises(ValueError, match="needs 8 devices, have 4"):
        make_mesh(2, 2, devices=CPU8[:4], sw=2)


@pytest.mark.parametrize("shape", [(3, 64, 96), (2, 63, 96), (2, 64, 95)],
                         ids=["N", "H", "W"])
def test_indivisible_frames_raise(shape):
    """N must divide by dp, H by sp, W by sw (the JAX shard_map's rule)."""
    run = S.make_sharded_forward(synth_engine_params(37), _port_mesh((2, 2, 2)),
                                 impl="reference")
    with pytest.raises(ValueError, match="do not split over mesh 2x2x2"):
        run(torch.zeros(shape, dtype=torch.uint8))


def test_blocks_smaller_than_the_halo_raise():
    run = S.make_sharded_forward(synth_engine_params(37), _port_mesh((1, 8, 1)))
    with pytest.raises(ValueError, match="needs >= 6 rows"):
        run(torch.zeros((1, 40, 64), dtype=torch.uint8))
    run = S.make_sharded_forward(synth_engine_params(37), _port_mesh((1, 1, 8)))
    with pytest.raises(ValueError, match="needs >= 6 rows \\(and columns\\)"):
        run(torch.zeros((1, 40, 40), dtype=torch.uint8))


def test_an_unsplit_axis_gets_no_halo():
    """sp = 1 (or sw = 1): no neighbour, so no filler rows to tile; the
    blocks keep the frame's extent and bounds."""
    blocks = S.split_blocks(torch.zeros((4, 24, 96), dtype=torch.uint8), _port_mesh((2, 1, 2)))
    xe, bounds = S.extended_blocks(blocks, HALO, 128)
    assert [tuple(e.shape) for e in xe.flat] == [(2, 24, 60)] * 4
    assert list(bounds.flat) == [(0, 24, 6, 60), (0, 24, 0, 54)] * 2


@pytest.mark.parametrize("impl", ["kernel1", "kernel2"])
def test_generations_1_and_2_refuse_a_mesh(impl):
    """Generation 2 still refuses a mesh: the mesh path runs generations 3
    and 1 only. Generation 1 refused it until it took frame bounds; now
    `--impl kernel1` serves a table inside the window too, equal to the
    unsharded restore."""
    p = synth_engine_params(37)
    mesh = _port_mesh((1, 2, 1))
    if impl == "kernel2":
        with pytest.raises(ValueError, match="generations 3 and 1 only.*--impl reference"):
            S.make_sharded_forward(p, mesh, impl=impl)
        return
    run = S.make_sharded_forward(p, mesh, impl=impl)
    assert run.impl == "kernel1"
    x = torch.from_numpy(synth_frames(2, 48, 64, seed=1))
    assert torch.equal(run(x), make_forward(p, device="cpu")(x))


def test_auto_outside_the_window_raises_and_reference_serves_it():
    """auto under a mesh serves a table outside the saturation window with
    generation 1 under each block's frame bounds, bit-equal to the JAX
    package's sharded forward (its CPU's XLA graph), to the port's
    unsharded literal plain version and to its reference net, at 1x2, 2x1
    and 1x2x2, through make_sharded_forward and Engine(mesh=). A table
    that neither generation computes raises, naming --impl reference,
    which serves it."""
    p = _outside_window()
    x = torch.from_numpy(synth_frames(*OUTSIDE_X, seed=9))
    whole = literal_forward_reference(x, LiteralWeights.from_engine(p, "cpu"))
    assert torch.equal(whole, make_forward(p, device="cpu")(x))
    for dims in ((1, 2, 1), (2, 1, 1), (1, 2, 2)):
        mesh = _port_mesh(dims)
        run = S.make_sharded_forward(p, mesh, impl="auto")
        assert run.impl == "kernel1" and _engine_name(p, mesh) == "kernel1"
        got = run(x)
        assert torch.equal(got, whole), dims
        assert (got.numpy() == _jax_outside(dims)).all(), dims
    eng = Engine(impl="auto", mesh=_port_mesh((2, 2, 1)), batch_frames=2)
    eng.set_model(37, p)
    assert (eng.restore(x.numpy(), 37) == whole.numpy()).all()
    assert list(eng._programs) == [(37, "cpu", "kernel1", "2x2")]

    mul = list(p.mul)
    mul[5] = 129  # odd: nothing to normalize away; generation 1 refuses it too
    neither = dataclasses.replace(p, mul=mul)
    mesh = _port_mesh((1, 2, 1))
    with pytest.raises(ValueError, match="no kernel computes this table.*--impl reference"):
        S.make_sharded_forward(neither, mesh, impl="auto")
    with pytest.raises(ValueError, match="--impl reference"):
        _engine_name(neither, mesh)
    got = S.make_sharded_forward(neither, mesh, impl="reference")(x)
    assert torch.equal(got, make_forward(neither, device="cpu")(x))


def test_sharded_kernel1_counts_blocks_under_their_bounds(monkeypatch):
    """Generation 1 under a mesh: one literal launch per block per call,
    each under its block's frame bounds, as generation 3's."""
    calls = []
    real = S.literal_residual

    def counting(*a):
        calls.append(a[2:])
        return real(*a)

    monkeypatch.setattr(S, "literal_residual", counting)
    run = S.make_sharded_forward(_outside_window(), _port_mesh((1, 2, 2)))
    assert run.impl == "kernel1"
    run(torch.from_numpy(synth_frames(*OUTSIDE_X, seed=9)))
    assert sorted(calls) == sorted([(6, 36, 6, 44), (6, 36, 0, 38), (0, 30, 6, 44),
                                    (0, 30, 0, 38)])


def _engine_name(p, mesh):
    eng = Engine(impl="auto", mesh=mesh)
    eng.set_model(37, p)
    return eng.program_name(37)


def test_kernel_failure_raises_under_a_mesh(monkeypatch):
    """A kernel that fails to build or launch raises through the sharded
    program, generation 3's and generation 1's: no demotion to the
    reference net (the JAX package warns and demotes, spatial.py:121-133)."""

    def broken(*a, **k):
        raise RuntimeError("nvcc not found")

    monkeypatch.setattr(S, "fused_forward", broken)
    monkeypatch.setattr(S, "literal_residual", broken)
    x = torch.from_numpy(synth_frames(2, 48, 64, seed=1))
    for p in (synth_engine_params(37), _outside_window()):
        run = S.make_sharded_forward(p, _port_mesh((1, 2, 1)))
        with pytest.raises(RuntimeError, match="nvcc not found"):
            run(x)


def test_engine_mesh_checks():
    mesh = _port_mesh((2, 2, 1))
    eng = Engine(mesh=mesh)
    assert eng.device == torch.device("cpu") and eng.mesh is mesh
    with pytest.raises(ValueError, match="not the first device"):
        Engine(device="cuda", mesh=mesh)
    with pytest.raises(ValueError, match="no multiple of the mesh's dp 2"):
        Engine(mesh=mesh, batch_frames=3)


def test_engine_restore_under_a_mesh_pads_a_ragged_batch():
    """Engine.restore on a mesh: 3 frames on dp 2 go up padded to 4 and
    come back cropped, equal to the unsharded engine."""
    p = synth_engine_params(37)
    x = synth_frames(3, 48, 64, seed=4)
    eng = Engine(mesh=_port_mesh((2, 2, 1)), impl="kernel3")
    eng.set_model(37, p)
    assert (eng.restore(x, 37) == make_forward(p, device="cpu")(torch.from_numpy(x)).numpy()).all()
    assert list(eng._programs) == [(37, "cpu", "kernel3", "2x2")]  # the mesh in the key


def test_engine_params_from_jax_equal():
    """The JAX synth table carried into the port (the tests' inputs) is the
    port's own synth table."""
    a, b = EngineParams.from_arrays(jax_synth_params(37)), synth_engine_params(37)
    assert all((np.asarray(u) == np.asarray(v)).all() for u, v in zip(a.weights, b.weights))
