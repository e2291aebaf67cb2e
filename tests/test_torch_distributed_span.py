"""Meshes whose axes span processes (parallel/mesh.make_global_mesh): the
port's DistributedRunner, halo exchange and tensor-parallel forwards over
two gloo ranks on virtual CPU devices, against the numpy oracle, the
port's one-process virtual mesh of the same shape and the JAX package's
tensor-parallel forwards on its 8-device CPU mesh. Tolerance 0 (integer
arithmetic throughout); the PSNR equal to the last bit.

The two ranks are spawned once for the module: one worker does every
case and writes each result to a file, and the tests read them."""

import json
import os
import socket
import subprocess
import sys
import textwrap

import numpy as np
import pytest
import torch

from qcnn_gpu_tpu.models import oracle as O
from qcnn_gpu_tpu.models import wide as JW
from qcnn_gpu_tpu.parallel import tensor as JT
from qcnn_gpu_tpu.parallel.mesh import make_mesh as jax_make_mesh
from qcnn_gpu_tpu.testing import synth_engine_params as jax_synth_params
from qcnn_gpu_tpu_torch.data import yuv
from qcnn_gpu_tpu_torch.engine.runner import Engine
from qcnn_gpu_tpu_torch.models import wide as W
from qcnn_gpu_tpu_torch.parallel.mesh import Mesh, make_global_mesh, make_mesh
from qcnn_gpu_tpu_torch.parallel.spatial import make_sharded_forward
from qcnn_gpu_tpu_torch.testing import synth_engine_params, synth_frames
from qcnn_gpu_tpu_torch.train.trainer import make_grad_fn

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
# label -> ((dp, sp, sw), local devices a rank)
MESHES = {
    "1x4": ((1, 4, 1), 2), "1x2x2": ((1, 2, 2), 2), "1x1x4": ((1, 1, 4), 2),
    "2x2": ((2, 2, 1), 2), "1x2": ((1, 2, 1), 1), "1x1x2": ((1, 1, 2), 1),
}
IMPLS = ["auto", "reference"]
FRAMES = dict(n=2, h=48, w=64, seed=21)
TP_FRAMES = dict(n=2, h=32, w=48, seed=22)

WORKER = textwrap.dedent(
    """
    import json, sys
    sys.path.insert(0, sys.argv[1])
    import numpy as np
    import torch
    from qcnn_gpu_tpu_torch.models.wide import synth_wide_params
    from qcnn_gpu_tpu_torch.parallel import distributed as D
    from qcnn_gpu_tpu_torch.parallel.mesh import make_global_mesh, make_mesh
    from qcnn_gpu_tpu_torch.parallel.tensor import make_tp_int8_forward, make_tp_wide_forward
    from qcnn_gpu_tpu_torch.testing import synth_engine_params, synth_frames

    repo, rank, port, out = sys.argv[1], int(sys.argv[2]), sys.argv[3], sys.argv[4]
    meshes, fr, tfr = json.loads(sys.argv[5]), json.loads(sys.argv[6]), json.loads(sys.argv[7])
    torch.set_num_threads(1)
    D.initialize(f"tcp://127.0.0.1:{port}", 2, rank)
    cpu = torch.device("cpu")
    p = synth_engine_params(37)
    frames = synth_frames(fr["n"], fr["h"], fr["w"], seed=fr["seed"])
    ori = synth_frames(fr["n"], fr["h"], fr["w"], seed=fr["seed"] + 1)
    rec = {}
    for label, ((dp, sp, sw), local) in meshes.items():
        for impl in ("auto", "reference"):
            mesh = make_global_mesh(dp, sp, [cpu] * local, sw=sw)
            runner = D.DistributedRunner(p, mesh, impl=impl)
            sl = mesh.local_slice(rank, frames.shape)
            got = runner.restore(frames[sl])
            np.save(f"{out}/{label}-{impl}-rank{rank}.npy", got)
            rec[f"{label}-{impl}"] = {
                "impl": runner.run.impl, "ranks": mesh.ranks.tolist(), "world": mesh.world,
                "halo": runner.run.halo_bytes, "local": list(frames[sl].shape),
                "psnr": runner.psnr(got[sl], ori[sl]).hex(),
            }
    x = synth_frames(tfr["n"], tfr["h"], tfr["w"], seed=tfr["seed"])
    for tp, local in ((2, 1), (4, 2)):
        mesh = make_global_mesh(1, tp, [cpu] * local)
        run = make_tp_int8_forward(p, mesh)
        np.save(f"{out}/tp{tp}-int8-rank{rank}.npy", run(torch.from_numpy(x)).numpy())
        wide = make_tp_wide_forward(synth_wide_params(32, 3, seed=6), mesh)
        np.save(f"{out}/tp{tp}-wide-rank{rank}.npy", wide(torch.from_numpy(x)).numpy())
        rec[f"tp{tp}"] = {"impl": [run.impl, wide.impl], "ranks": mesh.ranks.tolist()}

    def refused(make):
        try:
            make()
        except ValueError as e:
            return str(e)
        return None

    mesh = make_global_mesh(1, 4, [cpu] * 2)
    short = frames[mesh.local_slice(rank, frames.shape)][:, :-1 if rank else None]
    rec["wrong_shape"] = refused(lambda: D.DistributedRunner(p, mesh).restore(short))
    rec["not_a_rectangle"] = refused(
        lambda: D.DistributedRunner(p, make_global_mesh(3, 2, [cpu] * 3)))
    rec["one_process_mesh"] = refused(lambda: D.DistributedRunner(p, make_mesh(2, 1, [cpu] * 2)))
    torch.cuda.device_count = lambda: 2
    g = D.global_mesh(frames_hint=1, rows_hint=256)
    rec["global_mesh"] = {"shape": g.label(), "ranks": g.ranks.tolist(),
                          "devices": [str(d) for d in g.devices.flat], "first": str(g.first)}
    with open(f"{out}/rank{rank}.json", "w") as fp:
        json.dump(rec, fp)
    torch.distributed.destroy_process_group()
    """
)


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    """Both ranks' records (rank -> dict) and the directory of their outputs."""
    d = tmp_path_factory.mktemp("span")
    script = d / "worker.py"
    script.write_text(WORKER)
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = str(s.getsockname()[1])
    args = [json.dumps(MESHES), json.dumps(FRAMES), json.dumps(TP_FRAMES)]
    procs = [subprocess.Popen([sys.executable, str(script), REPO, str(r), port, str(d), *args],
                              stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
             for r in range(2)]
    logs = []
    try:
        for pr in procs:
            logs.append(pr.communicate(timeout=240)[0])
    finally:
        for pr in procs:
            pr.kill()
    assert [pr.returncode for pr in procs] == [0, 0], logs
    return {r: json.load(open(d / f"rank{r}.json")) for r in range(2)}, d


@pytest.fixture(scope="module")
def frames():
    return synth_frames(FRAMES["n"], FRAMES["h"], FRAMES["w"], seed=FRAMES["seed"])


@pytest.fixture(scope="module")
def oracle(frames):
    return O.forward_blu(frames, jax_synth_params(37))


def _bytes_across(ranks, dims, shape, halo=6, itemsize=1):
    """Bytes each rank sends (= receives) across ranks: rows of each block
    whose row neighbour another rank owns, then columns of the row-
    extended blocks likewise."""
    ranks = np.asarray(ranks).reshape(dims)
    n, h, w = (s // g for s, g in zip(shape, dims))
    h_ext = h + 2 * halo if dims[1] > 1 else h
    per = {0: 0, 1: 0}
    for idx in np.ndindex(dims):
        for axis, edge in ((1, n * halo * w), (2, n * h_ext * halo)):
            for step in (-1, 1):
                j = idx[axis] + step
                if dims[axis] > 1 and 0 <= j < dims[axis]:
                    nb = idx[:axis] + (j,) + idx[axis + 1:]
                    if ranks[nb] != ranks[idx]:
                        per[int(ranks[idx])] += edge * itemsize
    return per


@pytest.mark.parametrize("impl", IMPLS)
@pytest.mark.parametrize("label", list(MESHES))
def test_restore_across_ranks_equals_oracle_and_one_process(ranks, frames, oracle, label, impl):
    """Each rank passes its slice of the global batch; both return the
    global batch, bit-equal to the oracle and to the same mesh in one
    process."""
    recs, d = ranks
    (dp, sp, sw), local = MESHES[label]
    one = make_sharded_forward(synth_engine_params(37),
                               make_mesh(dp, sp, devices=["cpu"] * (dp * sp * sw), sw=sw),
                               impl=impl)(torch.from_numpy(frames)).numpy()
    assert (one == oracle).all()
    for r in range(2):
        rec = recs[r][f"{label}-{impl}"]
        got = np.load(d / f"{label}-{impl}-rank{r}.npy")
        assert got.shape == frames.shape and (got == oracle).all()
        assert rec["world"] == 2 and sorted(set(np.ravel(rec["ranks"]))) == [0, 1]
        assert rec["impl"] == ("kernel3" if impl == "auto" else "reference")


@pytest.mark.parametrize("impl", IMPLS)
@pytest.mark.parametrize("label", [k for k in MESHES if k != "2x2"])
def test_halo_bytes_cross_only_the_rank_boundary(ranks, frames, label, impl):
    """The bytes each rank sends and receives are the halo rows (and
    columns) of the blocks whose neighbour the other rank owns: uint8 for
    generation 3, int64 for the reference net's x-128 integers."""
    recs, _ = ranks
    dims = MESHES[label][0]
    for r in range(2):
        rec = recs[r][f"{label}-{impl}"]
        want = _bytes_across(rec["ranks"], dims, frames.shape, itemsize=1 if impl == "auto" else 8)
        assert rec["halo"] == {"sent": want[r], "received": want[r]} and want[r] > 0


def test_dp_across_ranks_exchanges_nothing(ranks):
    for r in range(2):
        assert ranks[0][r]["2x2-auto"]["halo"] == {"sent": 0, "received": 0}
        assert ranks[0][r]["2x2-auto"]["local"] == [1, 48, 64]


def test_psnr_across_ranks_equals_the_host_psnr(ranks, oracle):
    """runner.psnr on each rank's slices: an all-reduce of per-block SSE
    equal to the host PSNR of the global batch, to the last bit."""
    ori = synth_frames(FRAMES["n"], FRAMES["h"], FRAMES["w"], seed=FRAMES["seed"] + 1)
    want = yuv.psnr(oracle, ori)
    for r in range(2):
        for key in ("1x2x2-auto", "1x1x4-reference"):
            assert float.fromhex(ranks[0][r][key]["psnr"]) == want


@pytest.fixture(scope="module")
def tp_frames():
    return synth_frames(TP_FRAMES["n"], TP_FRAMES["h"], TP_FRAMES["w"], seed=TP_FRAMES["seed"])


@pytest.mark.parametrize("tp", [2, 4])
def test_tp_int8_across_ranks_equals_jax(ranks, tp_frames, tp):
    recs, d = ranks
    want = np.asarray(JT.make_tp_int8_forward(jax_synth_params(37), jax_make_mesh(1, tp),
                                              axis="sp")(tp_frames))
    assert (want == O.forward_blu(tp_frames, jax_synth_params(37))).all()
    for r in range(2):
        assert (np.load(d / f"tp{tp}-int8-rank{r}.npy") == want).all()
        assert recs[r][f"tp{tp}"]["impl"][0] == f"tp{tp}-int8"
        assert np.ravel(recs[r][f"tp{tp}"]["ranks"]).tolist() == [0] * (tp // 2) + [1] * (tp // 2)


@pytest.mark.parametrize("tp", [2, 4])
def test_tp_wide_across_ranks_equals_jax(ranks, tp_frames, tp):
    _, d = ranks
    jp = JW.synth_wide_params(channels=32, blocks=3, seed=6)
    want = np.asarray(JT.make_tp_wide_forward(jp, jax_make_mesh(1, tp), axis="sp")(tp_frames))
    p = W.synth_wide_params(32, 3, seed=6)
    assert (want == W.make_wide_forward(p, device="cpu")(torch.from_numpy(tp_frames)).numpy()).all()
    for r in range(2):
        assert (np.load(d / f"tp{tp}-wide-rank{r}.npy") == want).all()


def test_a_local_slice_of_the_wrong_shape_raises_on_every_rank(ranks):
    """Rank 1 passes a row short: both ranks raise ValueError, after the
    shapes' all-gather and before any exchange."""
    for r in range(2):
        msg = ranks[0][r]["wrong_shape"]
        assert msg is not None and "hold [2, 2] frames of [(24, 64), (23, 64)] (by rank)" in msg


def test_an_ownership_that_is_no_rectangle_raises_on_every_rank(ranks):
    """2 ranks of 3 devices on a 3x2 mesh: rank 0 owns (0, 0), (0, 1),
    (1, 0), which is no rectangle."""
    for r in range(2):
        msg = ranks[0][r]["not_a_rectangle"]
        assert msg is not None and "no rectangle" in msg and "3x2" in msg


def test_a_one_process_mesh_raises_across_processes(ranks):
    """A `make_mesh` mesh spans one process: across two, both ranks raise
    ValueError pointing to make_global_mesh."""
    for r in range(2):
        msg = ranks[0][r]["one_process_mesh"]
        assert msg is not None and "spans 1 process(es); the world has 2" in msg
        assert "make_global_mesh" in msg


def test_global_mesh_spans_processes(ranks):
    """Two processes of two CUDA devices, one frame: mesh_shape_for(4) gives
    1x4, process-major over (rank 0: cuda:0, cuda:1; rank 1: the same)."""
    for r in range(2):
        g = ranks[0][r]["global_mesh"]
        assert g["shape"] == "1x4" and g["ranks"] == [[0, 0, 1, 1]]
        assert g["devices"] == ["cuda:0", "cuda:1"] * 2 and g["first"] == "cuda:0"


def _spanning(dims=(1, 4)):
    devices = np.empty(int(np.prod(dims)), dtype=object)
    devices[:] = [torch.device("cpu")] * devices.size
    half = devices.size // 2
    ranks = np.repeat([0, 1], half).reshape(dims)
    return Mesh(devices.reshape(dims), ("dp", "sp"), ranks, rank=1, world=2)


def test_owned_and_local_slice():
    m = _spanning()
    assert m.owned() == (slice(0, 1), slice(2, 4)) and m.owned(0) == (slice(0, 1), slice(0, 2))
    assert m.local_slice(None, (3, 40, 8)) == (slice(0, 3), slice(20, 40))
    with pytest.raises(ValueError, match="does not split over mesh 1x4"):
        m.local_slice(0, (3, 42, 8))
    one = make_mesh(2, 2, devices=["cpu"] * 4)
    assert one.world == 1 and one.rank == 0 and (one.ranks == 0).all()
    assert one.owned() == (slice(0, 2), slice(0, 2)) and one.first == torch.device("cpu")
    with pytest.raises(ValueError, match="rank 2 owns no position"):
        m.owned(2)


def test_one_process_global_mesh_equals_make_mesh():
    g = make_global_mesh(1, 2, ["cpu"] * 4, sw=2)
    assert g.world == 1 and g.label() == "1x2x2" and (g.ranks == 0).all()
    with pytest.raises(ValueError, match="needs 4 devices, have 3"):
        make_global_mesh(2, 2, ["cpu"] * 3)


def test_engine_and_training_refuse_a_mesh_across_processes():
    """The Engine serves one process's mesh only. Training takes a (dp, sp)
    mesh across processes (tests/test_torch_train_span.py) and refuses, at
    build time and so on every rank, one whose ranks hold no rectangles
    or that is not (dp, sp)."""
    with pytest.raises(ValueError, match="spans processes"):
        Engine(mesh=_spanning())
    make_grad_fn(_spanning())
    cpu = np.empty(4, dtype=object)
    cpu[:] = [torch.device("cpu")] * 4
    with pytest.raises(ValueError, match="no rectangle"):
        make_grad_fn(Mesh(cpu.reshape(2, 2), ("dp", "sp"), [[0, 1], [1, 0]], rank=0, world=2))
    with pytest.raises(ValueError, match=r"\(dp, sp\) mesh, got 1x2x2"):
        make_grad_fn(Mesh(cpu.reshape(1, 2, 2), ("dp", "sp", "sw"), [[[0, 0], [1, 1]]],
                          rank=0, world=2))
