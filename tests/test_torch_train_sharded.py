"""The port's (dp, sp)-sharded training (train/trainer.make_grad_fn,
Trainer(mesh=), quant_finetune(mesh=)) on virtual CPU meshes, against the
JAX package's sharded step on its 8-device CPU mesh and against the port's
own 1x1 step, on the same seeded patches.

Tolerances (float32 sums in another order on each side):
  * the loss: rtol 1e-5;
  * every gradient against the port's 1x1: within 1e-5 of the tensor's
    max |g| (tests/test_torch_float_model.py's);
  * every gradient against JAX's on the same mesh: within the unsharded
    difference (the port's 1x1 against JAX's 1x1) plus 1e-5 of the
    tensor's max |g|. The unsharded implementations already differ by up
    to ~1e-4 of max |g| on these patches: a pre-activation within float32
    rounding of a ReLU kink takes the other side in one of them, which
    moves every pixel it feeds;
  * Adam steps: as tests/test_torch_train.py (params within 2*lr*steps of
    each other, their median within 1e-6);
  * the fine-tune's grid weights: equal on at least 99.9% of the weights
    and one step apart at most elsewhere."""

import functools
import json
import os
import socket
import subprocess
import sys
import textwrap

import numpy as np
import pytest
import torch

from qcnn_gpu_tpu.parallel.mesh import make_mesh as jax_make_mesh
from qcnn_gpu_tpu.train.trainer import make_grad_fn as jax_make_grad_fn
from qcnn_gpu_tpu_torch import testing as T
from qcnn_gpu_tpu_torch.data import datasets as D
from qcnn_gpu_tpu_torch.models import float_model as FM
from qcnn_gpu_tpu_torch.parallel.mesh import make_mesh
from qcnn_gpu_tpu_torch.train.finetune import quant_finetune
from qcnn_gpu_tpu_torch.train.trainer import TrainConfig, Trainer, make_grad_fn

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
BLU_UB = [0.3, 0.2, 0.2, 0.15, 0.15, 0.0]
MESHES = [(2, 1), (1, 2), (2, 2), (1, 4)]


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """These tests run small tensors: one intra-op thread each keeps them
    off the cores the other test workers use."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def cpu_mesh(dp, sp):
    return make_mesh(dp, sp, devices=[torch.device("cpu")] * (dp * sp))


def _batches(steps, batch=4, patch=32, seed=0):
    clean = T.make_clean_frames(2, 64, 96, seed=seed)
    ds = D.PatchDataset([(clean, T.dct_compress(clean, q=28.0))], patch=patch, seed=seed)
    return list(ds.batches(batch, steps))


def _grads(mesh, params, x, y, blu_ub=None):
    loss, grads = make_grad_fn(mesh, blu_ub)(FM.params_from_jax(params, mesh.first), x, y)
    return float(loss), FM.params_to_jax(grads)


def assert_grads_close(mine, theirs, slack=None):
    """Each gradient within 1e-5 of its max |g| (plus slack[k], a max |diff|)."""
    for k in FM.PARAM_NAMES:
        g = np.asarray(theirs[k])
        atol = 1e-5 * np.abs(g).max() + (slack[k] if slack else 0.0)
        np.testing.assert_allclose(mine[k], g, rtol=0, atol=atol, err_msg=k)


def _jax_grads(dp, sp, params, x, y, blu_ub=None):
    import jax

    loss, grads = jax.jit(jax_make_grad_fn(jax_make_mesh(dp, sp), blu_ub))(
        {k: jax.numpy.asarray(v) for k, v in params.items()}, x, y)
    return float(loss), {k: np.asarray(v) for k, v in grads.items()}


@functools.lru_cache(maxsize=None)
def _unsharded(blu):
    """(the port's 1x1 (loss, grads), JAX's 1x1 grads) on the test batch."""
    blu_ub = BLU_UB if blu else None
    (x, y), = _batches(1)
    params = FM.init_params(3)
    return _grads(cpu_mesh(1, 1), params, x, y, blu_ub), _jax_grads(1, 1, params, x, y, blu_ub)[1]


@pytest.mark.parametrize("blu", [False, True], ids=["relu", "blu"])
@pytest.mark.parametrize("dp,sp", MESHES, ids=[f"{a}x{b}" for a, b in MESHES])
def test_grad_fn_equals_jax_and_1x1(dp, sp, blu):
    """The sharded (loss, grads) at dp x sp equal the port's 1x1 (no halo)
    and JAX's make_grad_fn on the same mesh (the BLU variant's at 2x2), within
    the tolerances above."""
    blu_ub = BLU_UB if blu else None
    (x, y), = _batches(1)
    params = FM.init_params(3)
    loss, grads = _grads(cpu_mesh(dp, sp), params, x, y, blu_ub)
    (loss1, grads1), jgrads1 = _unsharded(blu)
    assert loss == pytest.approx(loss1, rel=1e-5)
    assert_grads_close(grads, grads1)
    if blu and (dp, sp) != (2, 2):
        return
    jloss, jgrads = _jax_grads(dp, sp, params, x, y, blu_ub)
    assert loss == pytest.approx(jloss, rel=1e-5)
    assert_grads_close(grads, jgrads, {k: np.abs(grads1[k] - jgrads1[k]).max() for k in grads})


def test_grad_fn_1x1_is_the_unsharded_loss():
    """On a 1x1 mesh the loss and gradients are l2_loss's backward, bit for bit."""
    (x, y), = _batches(1)
    params = FM.init_params(0)
    loss, grads = _grads(cpu_mesh(1, 1), params, x, y, BLU_UB)
    model = FM.FloatVRCNN(params, device="cpu", blu_ub=BLU_UB)
    with FM.fp32_convs():
        want = FM.l2_loss(model.tensors(), torch.as_tensor(x), torch.as_tensor(y), BLU_UB)
        want.backward()
    assert loss == want.item()
    for k in FM.PARAM_NAMES:
        g = getattr(model, k).grad
        assert np.array_equal(grads[k], (g.permute(2, 3, 1, 0) if k[0] == "w" else g).numpy()), k


@pytest.mark.parametrize("dp,sp,shape", [(3, 1, (4, 32, 32, 1)), (1, 3, (4, 32, 32, 1)),
                                         (2, 1, (4, 32, 32, 3))])
def test_grad_fn_refuses_unsplittable_batches(dp, sp, shape):
    x = np.zeros(shape, np.float32)
    with pytest.raises(ValueError):
        make_grad_fn(cpu_mesh(dp, sp))(FM.params_from_jax(FM.init_params(0), "cpu"), x, x)


def test_trainer_on_a_2x2_mesh_matches_1x1():
    """5 Adam steps on one batch, Trainer(mesh=2x2) against
    Trainer(device="cpu") (1x1): the batch's loss falls on both, and the
    params agree as two Adam runs whose gradients differ in rounding do."""
    batches = _batches(1) * 5
    lr = 1e-4  # lr 1e-3 overshoots this batch's loss in the first steps from init
    cfg = TrainConfig(lr=lr, log_every=0)
    tr = Trainer(cfg, mesh=cpu_mesh(2, 2))
    assert tr.mesh.label() == "2x2"
    losses = [float(tr.step_fn(tr.model, tr.opt, x, y)) for x, y in batches]
    ref = Trainer(cfg, device="cpu")
    assert ref.mesh.label() == "1x1"
    ref_losses = [float(ref.step_fn(ref.model, ref.opt, x, y)) for x, y in batches]
    assert losses[-1] < losses[0] and ref_losses[-1] < ref_losses[0]
    np.testing.assert_allclose(losses, ref_losses, rtol=1e-4)
    diffs = np.concatenate([np.abs(tr.params[k] - ref.params[k]).ravel() for k in FM.PARAM_NAMES])
    assert diffs.max() <= 2 * lr * 5 and np.median(diffs) <= 1e-6


def test_quant_finetune_on_a_1x2_mesh():
    """3 fine-tune steps on a 1x2 mesh: weights on the grid, and equal to
    the 1x1 run's grid integers on at least 99.9% of them."""
    params = FM.init_params(0)
    stepw = [0.01, 0.012, 0.011, 0.003, 0.011, 0.002]
    batches = _batches(3)
    out = quant_finetune(params, stepw, batches, mesh=cpu_mesh(1, 2), blu_ub=BLU_UB, log_every=0)
    ref = quant_finetune(params, stepw, batches, device="cpu", blu_ub=BLU_UB, log_every=0)
    for i, name in enumerate(f"w_{n}" for n in ("C1", "C2_1", "C2_2", "C3_1", "C3_2", "C4")):
        q, r = out[name] / stepw[i], ref[name] / stepw[i]
        assert np.abs(q - np.round(q)).max() < 1e-3
        d = np.abs(np.round(q) - np.round(r))
        assert d.max() <= 1 and (d == 0).mean() >= 0.999, name
    with pytest.raises(TypeError, match="device"):
        quant_finetune(params, stepw, batches, device="cpu", mesh=cpu_mesh(1, 2))


WORKER = textwrap.dedent(
    """
    import json
    import sys
    sys.path.insert(0, {repo!r})
    import numpy as np
    import torch
    from qcnn_gpu_tpu_torch.models import float_model as FM
    from qcnn_gpu_tpu_torch.parallel.distributed import initialize
    from qcnn_gpu_tpu_torch.parallel.mesh import make_global_mesh, make_mesh
    from qcnn_gpu_tpu_torch.train.trainer import default_mesh, make_grad_fn

    rank, world, port, out = int(sys.argv[1]), int(sys.argv[2]), sys.argv[3], sys.argv[4]
    torch.set_num_threads(2)
    initialize(f"tcp://127.0.0.1:{{port}}", world, rank)
    data = np.load(out.rsplit("rank", 1)[0] + "batch.npz")
    cpu = torch.device("cpu")
    params = FM.params_from_jax(FM.init_params(3), "cpu")
    # "world": the global 2x1 mesh, dp across the processes, each passing
    # the whole batch; "local": this process's 1x1 mesh on its own patches
    cases = (("world", make_global_mesh(world, 1, [cpu]), data["x"], data["y"]),
             ("local", make_mesh(1, 1, devices=[cpu]),
              *(np.array_split(data[k], world)[rank] for k in ("x", "y"))))
    for tag, mesh, x, y in cases:
        loss, grads = make_grad_fn(mesh)(params, x, y)
        np.savez(out + tag + ".npz", loss=loss.numpy(), **FM.params_to_jax(grads))
    torch.cuda.is_available = lambda: True  # one CUDA device a process, stubbed
    torch.cuda.device_count = lambda: 1
    m = default_mesh("cuda")
    with open(out + "default.json", "w") as fp:
        json.dump({{"label": m.label(), "ranks": m.ranks.tolist(), "world": m.world,
                   "devices": [str(d) for d in m.devices.flat]}}, fp)
    torch.distributed.destroy_process_group()
    """
)


def _free_port():
    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    port = s.getsockname()[1]
    s.close()
    return port


@pytest.fixture(scope="module")
def two_processes(tmp_path_factory):
    """Two processes in one gloo group, each taking the gradients of the
    whole test batch on the global 2x1 mesh and of its own two patches on
    a 1x1 CPU mesh, then its default mesh for "cuda": (the batch,
    {(rank, "world" | "local"): (loss, grads), (rank, "default"): mesh})."""
    tmp_path = tmp_path_factory.mktemp("dp2")
    (x, y), = _batches(1)
    np.savez(tmp_path / "batch.npz", x=x, y=y)
    script = tmp_path / "worker.py"
    script.write_text(WORKER.format(repo=REPO))
    port = str(_free_port())
    outs = [str(tmp_path / f"rank{r}") for r in range(2)]
    procs = [subprocess.Popen([sys.executable, str(script), str(r), "2", port, outs[r]],
                              stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
             for r in range(2)]
    logs = []
    try:
        for pr in procs:
            logs.append(pr.communicate(timeout=120)[0])
    finally:
        for pr in procs:
            pr.kill()
    assert [pr.returncode for pr in procs] == [0, 0], logs
    got = {}
    for r, out in enumerate(outs):
        for tag in ("world", "local"):
            f = np.load(out + tag + ".npz")
            got[r, tag] = float(f["loss"]), {k: f[k] for k in FM.PARAM_NAMES}
        with open(out + "default.json") as fp:
            got[r, "default"] = json.load(fp)
    return (x, y), got


def test_two_process_dp_gradients(two_processes):
    """On the global 2x1 mesh (dp across the two processes) both processes
    return the loss and gradients of the whole batch of four, equal to the
    one-process 2x1 mesh's within the tolerances above."""
    (x, y), got = two_processes
    loss, grads = _grads(cpu_mesh(2, 1), FM.init_params(3), x, y)
    for r in range(2):
        assert got[r, "world"][0] == pytest.approx(loss, rel=1e-5)
        assert_grads_close(got[r, "world"][1], grads)


def test_local_mesh_in_a_process_group_keeps_its_own_gradients(two_processes):
    """A process in a group of two takes the gradients of its own two
    patches on its one-process 1x1 mesh (`make_mesh`), within the
    tolerances above: the existing default group does not all-reduce
    them."""
    (x, y), got = two_processes
    params = FM.init_params(3)
    for r in range(2):
        xr, yr = np.array_split(x, 2)[r], np.array_split(y, 2)[r]
        loss, grads = _grads(cpu_mesh(1, 1), params, xr, yr)
        assert got[r, "local"][0] == pytest.approx(loss, rel=1e-5)
        assert_grads_close(got[r, "local"][1], grads)
    assert got[0, "local"][0] != pytest.approx(got[0, "world"][0], rel=1e-2)


def test_default_mesh_in_a_process_group_spans_the_processes(two_processes):
    """default_mesh("cuda") in a group of two processes of one CUDA device
    each (the count stubbed in the worker) is the global 2x1 mesh, dp over
    both processes: the JAX make_mesh(len(jax.devices()), 1) under
    jax.distributed."""
    _, got = two_processes
    for r in range(2):
        assert got[r, "default"] == {"label": "2x1", "ranks": [[0], [1]], "world": 2,
                                     "devices": ["cuda:0", "cuda:0"]}
