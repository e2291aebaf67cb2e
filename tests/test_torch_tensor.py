"""The port's tensor-parallel forwards (parallel/tensor.py) on virtual CPU
meshes, against the JAX package's `parallel/tensor.py` on its 8-device CPU
mesh and against the port's unsharded forwards, on the same seeded inputs.

Tolerances: the INT8 forwards 0 (integer sums are exact); the float conv
pair within 1e-5 of the output's max |value| (float32 partial sums added
in another order)."""

import numpy as np
import pytest
import torch

from qcnn_gpu_tpu.models import oracle as O
from qcnn_gpu_tpu.models import wide as JW
from qcnn_gpu_tpu.parallel.mesh import make_mesh as jax_make_mesh
from qcnn_gpu_tpu.parallel import tensor as JT
from qcnn_gpu_tpu.testing import synth_engine_params as jax_synth_engine_params
from qcnn_gpu_tpu_torch.models import wide as W
from qcnn_gpu_tpu_torch.models.qvrcnn import make_forward
from qcnn_gpu_tpu_torch.parallel import tensor as T
from qcnn_gpu_tpu_torch.parallel.mesh import make_mesh
from qcnn_gpu_tpu_torch.testing import synth_engine_params, synth_frames

TPS = [2, 4, 8]


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


@pytest.mark.parametrize("blocks", [2, 3])  # the tail row-parallel, or replicated
@pytest.mark.parametrize("tp", TPS)
def test_tp_wide_equals_jax_and_unsharded(tp, blocks):
    p = W.synth_wide_params(channels=32, blocks=blocks, seed=6)
    jp = JW.synth_wide_params(channels=32, blocks=blocks, seed=6)
    x = synth_frames(2, 24, 40, seed=7)
    run = T.make_tp_wide_forward(p, cpu_mesh(1, tp))
    assert run.impl == f"tp{tp}-wide-int8"
    got = run(torch.from_numpy(x)).numpy()
    want = W.make_wide_forward(p, device="cpu")(torch.from_numpy(x)).numpy()
    assert (got == want).all()
    assert (np.asarray(JT.make_tp_wide_forward(jp, jax_make_mesh(1, tp), axis="sp")(x)) == want).all()


@pytest.mark.parametrize("tp", TPS)
def test_tp_int8_equals_jax_and_unsharded(tp):
    p, jp = synth_engine_params(32), jax_synth_engine_params(32)
    x = synth_frames(2, 24, 40, seed=tp)
    run = T.make_tp_int8_forward(p, cpu_mesh(1, tp))
    assert run.impl == f"tp{tp}-int8"
    got = run(torch.from_numpy(x)).numpy()
    assert (got == O.forward_blu(x, jp)).all()
    assert (got == make_forward(p, device="cpu")(torch.from_numpy(x)).numpy()).all()
    assert (np.asarray(JT.make_tp_int8_forward(jp, jax_make_mesh(1, tp), axis="sp")(x)) == got).all()


def test_tp_on_the_dp_axis_and_over_a_2d_mesh():
    """TP over axis "dp", and over "sp" of a 2x4 mesh (the replicas at
    dp index 1 compute nothing): equal to the unsharded forward."""
    p = synth_engine_params(37)
    x = torch.from_numpy(synth_frames(1, 16, 24, seed=1))
    want = make_forward(p, device="cpu")(x)
    assert torch.equal(T.make_tp_int8_forward(p, cpu_mesh(4, 1), axis="dp")(x), want)
    assert torch.equal(T.make_tp_int8_forward(p, cpu_mesh(2, 4))(x), want)


@pytest.mark.parametrize("tp", [2, 8])
def test_tp_conv_pair_equals_jax(tp):
    rng = np.random.default_rng(0)
    x = rng.normal(size=(1, 16, 24, 8)).astype(np.float32)
    w_a = rng.normal(size=(3, 3, 8, 32)).astype(np.float32)
    b_a = rng.normal(size=(32,)).astype(np.float32)
    w_b = rng.normal(size=(3, 3, 32, 8)).astype(np.float32)
    b_b = rng.normal(size=(8,)).astype(np.float32)
    want = np.asarray(JT.make_tp_conv_pair(jax_make_mesh(1, tp), axis="sp")(x, w_a, b_a, w_b, b_b))
    got = T.make_tp_conv_pair(cpu_mesh(1, tp))(*map(torch.from_numpy, (x, w_a, b_a, w_b, b_b)))
    assert np.abs(got.numpy() - want).max() <= 1e-5 * np.abs(want).max()
    whole = T.make_tp_conv_pair(cpu_mesh(1, 1))(*map(torch.from_numpy, (x, w_a, b_a, w_b, b_b)))
    assert np.abs(got.numpy() - whole.numpy()).max() <= 1e-5 * np.abs(want).max()


def test_tp_refuses_axes_that_do_not_divide_the_channels():
    with pytest.raises(ValueError, match="64 and 48"):
        T.make_tp_int8_forward(synth_engine_params(37), cpu_mesh(1, 3))
    with pytest.raises(ValueError, match="channels=24"):
        T.make_tp_wide_forward(W.synth_wide_params(channels=24, blocks=1, seed=0), cpu_mesh(1, 16))
    pair = T.make_tp_conv_pair(cpu_mesh(1, 3))
    z = torch.zeros((1, 4, 4, 2))
    with pytest.raises(ValueError, match="must divide"):
        pair(z, torch.zeros((3, 3, 2, 8)), torch.zeros(8), torch.zeros((3, 3, 8, 2)), torch.zeros(2))
