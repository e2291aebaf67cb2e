"""(dp, sp)-sharded training over meshes whose axes span processes
(train/trainer.make_grad_fn, Trainer and quant_finetune on
`parallel/mesh.make_global_mesh` meshes): two gloo ranks on virtual CPU
devices, each passing the same global batch, against the port's
one-process mesh of the same shape and the JAX package's make_grad_fn on
its 8-device CPU mesh.

Tolerances are tests/test_torch_train_sharded.py's: the loss rel 1e-5;
every gradient within 1e-5 of its max |g| (against JAX's, plus the
unsharded port-JAX difference); Adam steps within 2*lr*steps, their
median within 1e-6. The two ranks are bit-equal to each other (both hold
the one all-reduced sum), and the bytes that cross ranks are exact.

The two ranks are spawned once for the module: one worker does every
case and writes each result to a file, and the tests read them. The
cuda-marked test runs the gradients on 2 ranks over cuda:0 against the
1x1 step on the card; it imports no JAX module, and this file imports
none at top level."""

import json
import os
import socket
import subprocess
import sys

import numpy as np
import pytest
import torch

from qcnn_gpu_tpu_torch import testing as T
from qcnn_gpu_tpu_torch.data import datasets as D
from qcnn_gpu_tpu_torch.models import float_model as FM
from qcnn_gpu_tpu_torch.parallel.mesh import make_mesh
from qcnn_gpu_tpu_torch.train.finetune import quant_finetune
from qcnn_gpu_tpu_torch.train.trainer import TrainConfig, Trainer, make_grad_fn

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
# label -> (dp, sp, local devices a rank); process-major, so rank 0 owns
# the first half of the flattened grid
MESHES = {"2x1": (2, 1, 1), "1x2": (1, 2, 1), "1x4": (1, 4, 2), "2x2": (2, 2, 2)}
# the halo rows a rank sends (= receives) across ranks a call, float32:
# 6 rows x 32 columns x 4 patches at the one sp boundary between the
# ranks (1x2; 1x4's middle); dp alone (2x1) and sp inside each rank (2x2)
# cross none
HALO_BYTES = {"2x1": 0, "1x2": 6 * 32 * 4 * 4, "1x4": 6 * 32 * 4 * 4, "2x2": 0}
BLU_UB = [0.3, 0.2, 0.2, 0.15, 0.15, 0.0]
STEPW = [0.01, 0.012, 0.011, 0.003, 0.011, 0.002]
LR = 1e-4
STEPS = 3

WORKER = """
import json, sys
sys.path.insert(0, sys.argv[1])
import numpy as np
import torch
import torch.distributed as dist
from qcnn_gpu_tpu_torch.models import float_model as FM
from qcnn_gpu_tpu_torch.parallel.distributed import initialize
from qcnn_gpu_tpu_torch.parallel.mesh import make_global_mesh
from qcnn_gpu_tpu_torch.train.finetune import quant_finetune
from qcnn_gpu_tpu_torch.train.trainer import TrainConfig, Trainer, make_grad_fn

repo, rank, port, d, device, mode = sys.argv[1:7]
rank, device = int(rank), torch.device(device)
meshes, extra = json.loads(sys.argv[7]), json.loads(sys.argv[8])
torch.set_num_threads(1)
initialize(f"tcp://127.0.0.1:{port}", 2, rank)
data = np.load(f"{d}/batches.npz")
batches = list(zip(data["x"], data["y"]))
params = FM.params_from_jax(FM.init_params(3), device)
rec = {}
for label, (dp, sp, local) in meshes.items():
    mesh = make_global_mesh(dp, sp, [device] * local)
    fn = make_grad_fn(mesh)
    loss, grads = fn(params, *batches[0])
    np.savez(f"{d}/{label}-rank{rank}.npz", loss=loss.cpu().numpy(), **FM.params_to_jax(grads))
    rec[label] = {"cross": fn.cross_bytes, "ranks": mesh.ranks.tolist(), "world": mesh.world}

if mode == "all":
    mesh = make_global_mesh(1, 2, [device])
    tr = Trainer(TrainConfig(lr=extra["lr"], log_every=0), mesh=mesh)
    rec["losses"] = [float(tr.step_fn(tr.model, tr.opt, x, y)) for x, y in batches]
    tr.save_checkpoint(f"{d}/ckpt-rank{rank}")
    np.savez(f"{d}/trainer-rank{rank}.npz", **tr.params)
    out = quant_finetune(FM.init_params(0), extra["stepw"], batches, mesh=mesh,
                         blu_ub=extra["blu_ub"], log_every=0)
    np.savez(f"{d}/finetune-rank{rank}.npz", **out)

    def refused(call):
        try:
            call()
        except ValueError as e:
            return str(e)
        return None

    dp2 = make_grad_fn(make_global_mesh(2, 1, [device]))
    odd = np.zeros((3, 32, 32, 1), np.float32)
    rec["unsplittable"] = refused(lambda: dp2(params, odd, odd))
    short = np.zeros((4, 16, 32, 1), np.float32)  # 4 rows a block at 1x4
    rec["short"] = refused(
        lambda: make_grad_fn(make_global_mesh(1, 4, [device] * 2))(params, short, short))
    # the ranks still pair their collectives after both refusals
    rec["after"] = float(dp2(params, *batches[0])[0]).hex()
with open(f"{d}/rank{rank}.json", "w") as fp:
    json.dump(rec, fp)
dist.destroy_process_group()
"""


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _spawn(d, device, mode, batches, extra=None):
    """Run WORKER as ranks 0 and 1 of a gloo group over `batches`; -> each
    rank's record."""
    np.savez(d / "batches.npz", x=np.stack([x for x, _ in batches]),
             y=np.stack([y for _, y in batches]))
    script = d / "worker.py"
    script.write_text(WORKER)
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = str(s.getsockname()[1])
    args = [json.dumps(MESHES), json.dumps(extra or {})]
    procs = [subprocess.Popen([sys.executable, str(script), REPO, str(r), port, str(d), device,
                               mode, *args],
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
    return [json.load(open(d / f"rank{r}.json")) for r in range(2)]


def _load(path):
    f = np.load(path)
    return {k: f[k] for k in f.files}


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    """(the batches, both ranks' records, the directory of their outputs)."""
    from test_torch_train_sharded import _batches

    d = tmp_path_factory.mktemp("train_span")
    batches = _batches(STEPS)
    recs = _spawn(d, "cpu", "all", batches,
                  {"lr": LR, "stepw": STEPW, "blu_ub": BLU_UB})
    return batches, recs, d


def _grads(d, label, r):
    got = _load(d / f"{label}-rank{r}.npz")
    return float(got["loss"]), {k: got[k] for k in FM.PARAM_NAMES}


def _one_process(label, params, x, y):
    dp, sp, _ = MESHES[label]
    loss, grads = make_grad_fn(make_mesh(dp, sp, devices=["cpu"] * (dp * sp)))(
        FM.params_from_jax(params, "cpu"), x, y)
    return float(loss), FM.params_to_jax(grads)


@pytest.mark.parametrize("label", list(MESHES))
def test_grads_across_ranks_equal_one_process(ranks, label):
    """Both ranks' loss and gradients equal the one-process mesh of the
    same shape's, within the tolerances above."""
    from test_torch_train_sharded import assert_grads_close

    batches, recs, d = ranks
    loss, grads = _one_process(label, FM.init_params(3), *batches[0])
    for r in range(2):
        got_loss, got = _grads(d, label, r)
        assert got_loss == pytest.approx(loss, rel=1e-5)
        assert_grads_close(got, grads)
        assert recs[r][label]["world"] == 2
        assert sorted(set(np.ravel(recs[r][label]["ranks"]))) == [0, 1]


@pytest.mark.parametrize("label", ["2x1", "1x2"])
def test_grads_across_ranks_equal_jax(ranks, label):
    """Both ranks against JAX's make_grad_fn on its CPU mesh of the same
    shape: the loss rel 1e-5, each gradient within 1e-5 of its max |g|
    plus the unsharded port-JAX difference."""
    from test_torch_train_sharded import _jax_grads, _unsharded, assert_grads_close

    batches, _, d = ranks
    dp, sp, _ = MESHES[label]
    (_, grads1), jgrads1 = _unsharded(False)
    jloss, jgrads = _jax_grads(dp, sp, FM.init_params(3), *batches[0])
    slack = {k: np.abs(grads1[k] - jgrads1[k]).max() for k in FM.PARAM_NAMES}
    for r in range(2):
        loss, grads = _grads(d, label, r)
        assert loss == pytest.approx(jloss, rel=1e-5)
        assert_grads_close(grads, jgrads, slack)


@pytest.mark.parametrize("label", list(MESHES))
def test_ranks_are_bit_equal(ranks, label):
    _, _, d = ranks
    a, b = _load(d / f"{label}-rank0.npz"), _load(d / f"{label}-rank1.npz")
    assert a.keys() == b.keys()
    for k in a:
        assert np.array_equal(a[k], b[k]), k


@pytest.mark.parametrize("label", list(MESHES))
def test_bytes_across_ranks(ranks, label):
    """Each rank sends and receives the halo rows at the rank boundary
    only, and all-reduces every weight, bias and the loss in float32."""
    _, recs, _ = ranks
    n = sum(v.size for v in FM.init_params(0).values()) + 1
    assert n == 54_512 + 161 + 1
    for r in range(2):
        assert recs[r][label]["cross"] == {"halo_sent": HALO_BYTES[label],
                                           "halo_received": HALO_BYTES[label],
                                           "allreduce": 4 * n}


def test_trainer_across_ranks(ranks):
    """3 Adam steps of Trainer on the global 1x2 mesh: both ranks hold the
    same params bit for bit, close to a one-process 1x2 Trainer's as two
    Adam runs whose gradients differ in rounding are; the checkpoint is
    written by rank 0 alone."""
    batches, recs, d = ranks
    a, b = _load(d / "trainer-rank0.npz"), _load(d / "trainer-rank1.npz")
    for k in FM.PARAM_NAMES:
        assert np.array_equal(a[k], b[k]), k
    assert recs[0]["losses"] == recs[1]["losses"]
    ref = Trainer(TrainConfig(lr=LR, log_every=0), mesh=make_mesh(1, 2, devices=["cpu"] * 2))
    ref_losses = [float(ref.step_fn(ref.model, ref.opt, x, y)) for x, y in batches]
    np.testing.assert_allclose(recs[0]["losses"], ref_losses, rtol=1e-5)
    diffs = np.concatenate([np.abs(a[k] - ref.params[k]).ravel() for k in FM.PARAM_NAMES])
    assert diffs.max() <= 2 * LR * STEPS and np.median(diffs) <= 1e-6
    assert os.path.exists(d / "ckpt-rank0" / "latest")
    assert not os.path.exists(d / "ckpt-rank1")


def test_quant_finetune_across_ranks(ranks):
    """quant_finetune on the global 1x2 mesh: both ranks return the same
    weights, on the grid, and the one-process 1x2 run's grid integers on
    at least 99.9% of them."""
    batches, _, d = ranks
    a, b = _load(d / "finetune-rank0.npz"), _load(d / "finetune-rank1.npz")
    ref = quant_finetune(FM.init_params(0), STEPW, batches, mesh=make_mesh(1, 2, devices=["cpu"] * 2),
                         blu_ub=BLU_UB, log_every=0)
    for i, name in enumerate(f"w_{n}" for n in ("C1", "C2_1", "C2_2", "C3_1", "C3_2", "C4")):
        assert np.array_equal(a[name], b[name]), name
        q, r = a[name] / STEPW[i], ref[name] / STEPW[i]
        assert np.abs(q - np.round(q)).max() < 1e-3
        diff = np.abs(np.round(q) - np.round(r))
        assert diff.max() <= 1 and (diff == 0).mean() >= 0.999, name


def test_unsplittable_batch_raises_on_both_ranks(ranks):
    """3 patches on the global 2x1 mesh: ValueError on both ranks before
    any exchange, and the ranks' next call still pairs."""
    _, recs, _ = ranks
    for r in range(2):
        msg = recs[r]["unsplittable"]
        assert msg is not None and "(3, 32, 32, 1) does not split over mesh 2x1" in msg
    assert recs[0]["after"] == recs[1]["after"]


def test_short_sp_block_raises_on_both_ranks(ranks):
    """16 rows over the global 1x4 mesh leave 4 rows a block, under the
    halo of 6: ValueError on both ranks before any exchange."""
    _, recs, _ = ranks
    for r in range(2):
        msg = recs[r]["short"]
        assert msg is not None and "each sp block needs >= 6 rows" in msg


@pytest.mark.cuda
def test_grads_across_ranks_on_cuda(tmp_path):
    """Two gloo ranks over cuda:0, 16 patches of 64x64: on each global mesh
    both ranks' loss and gradients within the tolerances above of the 1x1
    step on the card, and bit-equal to each other."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the ranks train on cuda:0")
    clean = T.make_clean_frames(4, 128, 128, seed=0)
    ds = D.PatchDataset([(clean, T.dct_compress(clean, q=28.0))], patch=64, seed=0)
    batches = list(ds.batches(16, 1))
    recs = _spawn(tmp_path, "cuda:0", "grads", batches)
    dev = torch.device("cuda", 0)
    loss1, grads1 = make_grad_fn(make_mesh(1, 1, devices=[dev]))(
        FM.params_from_jax(FM.init_params(3), dev), *batches[0])
    loss1, grads1 = float(loss1), FM.params_to_jax(grads1)
    for label in MESHES:
        for r in range(2):
            loss, grads = _grads(tmp_path, label, r)
            assert loss == pytest.approx(loss1, rel=1e-5)
            for k in FM.PARAM_NAMES:
                tol = 1e-5 * np.abs(grads1[k]).max()
                np.testing.assert_allclose(grads[k], grads1[k], rtol=0, atol=tol, err_msg=k)
            halo = HALO_BYTES[label] and 6 * 64 * 16 * 4  # 6 rows x 64 columns x 16 patches
            assert recs[r][label]["cross"] == {"halo_sent": halo, "halo_received": halo,
                                               "allreduce": 4 * (54_512 + 161 + 1)}
        a, b = _load(tmp_path / f"{label}-rank0.npz"), _load(tmp_path / f"{label}-rank1.npz")
        assert all(np.array_equal(a[k], b[k]) for k in a)
