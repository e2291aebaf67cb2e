"""Port reference forward (qcnn_gpu_tpu_torch/models/qvrcnn.py) bit-equal to
the numpy oracle and to the JAX XLA graph `make_forward(impl="int")`,
merged and literal. Tolerance: 0 (float64 convolutions of integers below
2^25 are exact)."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from qcnn_gpu_tpu.models import float_model as FM
from qcnn_gpu_tpu.models import oracle as O
from qcnn_gpu_tpu.models import qvrcnn as JQ
from qcnn_gpu_tpu.quant.solver import BLU_INIT, solve_network_per_channel, stepw_per_channel
from qcnn_gpu_tpu.testing import synth_engine_params, synth_frames
from qcnn_gpu_tpu_torch.models import qvrcnn as Q
from qcnn_gpu_tpu_torch.models.engine_params import EngineParams

GEOS = [(1, 37, 53), (2, 13, 245), (3, 18, 250)]


def _port(p, x, merged=True):
    return Q.make_forward(EngineParams.from_arrays(p), "cpu", merged=merged)(torch.from_numpy(x)).numpy()


@pytest.mark.parametrize("merged", [True, False])
@pytest.mark.parametrize("n,h,w", GEOS)
def test_forward_matches_oracle_and_jax(n, h, w, merged):
    p = synth_engine_params({37: 22, 13: 27, 18: 37}[h])
    x = synth_frames(n, h, w, seed=h + w)
    got = _port(p, x, merged)
    assert got.dtype == np.uint8 and got.shape == x.shape
    assert (got == O.forward_blu(x, p)).all()
    assert (got == np.asarray(JQ.make_forward(p, impl="int", merged=merged)(x))).all()


@pytest.fixture(scope="module")
def int4_pc_params():
    """The synthetic per-channel INT4 table of tests/test_per_channel.py."""
    ws, bs = FM.params_to_lists(FM.init_params(seed=11))
    ws, bs = [np.asarray(w) for w in ws], [np.asarray(b) for b in bs]
    table = solve_network_per_channel(stepw_per_channel(ws, bits=4), BLU_INIT[37])
    return O.EngineParams.from_float(ws, bs, table, wbits=4)


@pytest.mark.parametrize("merged", [True, False])
def test_per_channel_int4_table(int4_pc_params, merged):
    x = synth_frames(2, 36, 52, seed=5)
    got = _port(int4_pc_params, x, merged)
    assert (got == O.forward_blu(x, int4_pc_params)).all()
    assert (got == np.asarray(JQ.make_forward(int4_pc_params, impl="int", merged=merged)(x))).all()


@pytest.mark.parametrize("fill", [0, 255])
def test_extreme_frames(fill):
    p = synth_engine_params(32)
    x = np.full((1, 20, 37), fill, np.uint8)
    assert (_port(p, x) == O.forward_blu(x, p)).all()
    assert (_port(p, x, merged=False) == O.forward_blu(x, p)).all()


def test_row_col_valid_match_jax():
    """Per-layer zero padding at a frame edge inside the array: the masked
    merged and literal cores equal JAX's residual_blu_merged /
    residual_blu with the same row_valid / col_valid."""
    p = synth_engine_params(27)
    x = synth_frames(2, 24, 30, seed=8)
    xp = x[..., None].astype(np.int32) - 128
    rv = (np.arange(24) >= 3) & (np.arange(24) < 20)
    cv = (np.arange(30) >= 5) & (np.arange(30) < 27)
    want = np.asarray(JQ.residual_blu_merged(
        jnp.asarray(xp), JQ.MergedParams.from_engine(p), "int",
        row_valid=jnp.asarray(rv), col_valid=jnp.asarray(cv),
    ))
    pp = EngineParams.from_arrays(p)
    got = Q.residual_blu_merged(
        torch.from_numpy(xp), Q.MergedParams.from_engine(pp, "cpu"),
        row_valid=torch.from_numpy(rv), col_valid=torch.from_numpy(cv),
    )
    assert (got.numpy() == want).all()
    want_rows = np.asarray(JQ.residual_blu(
        jnp.asarray(xp), JQ.ModelParams.from_engine(p), "int", row_valid=jnp.asarray(rv),
    ))
    got_rows = Q.residual_blu(
        torch.from_numpy(xp), Q.ModelParams.from_engine(pp, "cpu"), row_valid=torch.from_numpy(rv),
    )
    assert (got_rows.numpy() == want_rows).all()


def test_module_keeps_parameters_in_buffers():
    """Parameters are module buffers, the very tensors of the container
    the forward reads."""
    m = Q.QVRCNN(EngineParams.from_arrays(synth_engine_params(37)), device="cpu")
    bufs = dict(m.named_buffers())
    assert {"w_i8_0", "b_i32_3", "blu_q_2", "mul_0"} <= set(bufs)
    mp = m.params
    assert mp.device == torch.device("cpu") and mp.w_i8[1].shape == (5, 5, 64, 48)
    assert bufs["w_i8_1"] is mp.w_i8[1] and bufs["mul_0"] is mp.mul[0]
