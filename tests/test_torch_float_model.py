"""The port's float VRCNN (models/float_model.py), the float model files
and `conv_validation` on the CPU, against the JAX package on the same
seeded numpy inputs.

Tolerances (both sides run float32 convolutions, summed in another order):
  * residual and post-activations: 1e-5 of each tensor's max |value|;
  * activation_sigmas: rtol 1e-5 against jnp.std (float32 sums), and rtol
    1e-6 against the float64 std of JAX's own pre-activations (the port
    sums in float64);
  * predict_uint8: at most 0.01% of pixels off by 1 (a sum that lands
    within float32 rounding of a half pixel), none by more;
  * predict_uint8_tiled: equal to the whole-frame predict_uint8, exactly;
  * one gradient: within 1e-5 of each tensor's max |g|;
  * conv_validation: the engine side exactly, the float side's diffs
    within 1e-5 of the layer's max |accumulator|;
  * file formats: 0 (bytes)."""

import io

import numpy as np
import pytest
import torch

from qcnn_gpu_tpu import testing as JT
from qcnn_gpu_tpu.data import model_files as JMF
from qcnn_gpu_tpu.engine import validate as JV
from qcnn_gpu_tpu.models import float_model as JFM
from qcnn_gpu_tpu.models import oracle as O
from qcnn_gpu_tpu.quant.solver import BLU_INIT
from qcnn_gpu_tpu_torch import testing as T
from qcnn_gpu_tpu_torch.data import model_files as MF
from qcnn_gpu_tpu_torch.engine import validate as V
from qcnn_gpu_tpu_torch.models import float_model as FM
from qcnn_gpu_tpu_torch.models.engine_params import EngineParams
from qcnn_gpu_tpu_torch.train.checkpoint import load_checkpoint

BLU = {"relu": None, "blu": BLU_INIT[37]}


@pytest.fixture(scope="module")
def trained():
    """The committed demo checkpoint (step 1500), JAX layout."""
    return load_checkpoint(T.asset("demo/ckpt"))[0]


@pytest.fixture(scope="module")
def frames():
    """(clean, DCT-q28 anchor) uint8 [2, 48, 64]."""
    clean = T.make_clean_frames(2, 48, 64, seed=5)
    return clean, T.dct_compress(clean, q=28.0)


def _jax(params):
    import jax.numpy as jnp

    return {k: jnp.asarray(v) for k, v in params.items()}


def _close(mine, theirs, frac=1e-5):
    theirs = np.asarray(theirs)
    assert mine.shape == theirs.shape
    assert np.abs(mine - theirs).max() <= frac * np.abs(theirs).max(), np.abs(mine - theirs).max()


@pytest.mark.parametrize("seed", [0, 7])
def test_init_params_equal_jax(seed):
    mine, theirs = FM.init_params(seed), JFM.init_params(seed)
    assert sorted(mine) == sorted(theirs) == list(FM.PARAM_NAMES)
    for k in mine:
        assert mine[k].dtype == np.float32 and (mine[k] == np.asarray(theirs[k])).all()


@pytest.mark.parametrize("act", BLU)
def test_residual_and_activations_equal_jax(act, trained, frames):
    _, anchor = frames
    x = (anchor[..., None].astype(np.float32) - 128.0) / 255.0
    res, acts = FM.residual_float(FM.params_from_jax(trained, "cpu"), torch.from_numpy(x),
                                  BLU[act], collect=True)
    jres, jacts = JFM.residual_float(_jax(trained), x, BLU[act], collect=True)
    _close(res.numpy(), jres)
    assert sorted(acts) == sorted(jacts)
    for k in acts:
        _close(acts[k].numpy(), jacts[k])
    model = FM.FloatVRCNN(trained, device="cpu", blu_ub=BLU[act])
    assert [n for n, _ in model.named_parameters()] == list(FM.PARAM_NAMES)
    with torch.no_grad():
        assert torch.equal(model(torch.from_numpy(x)), res)


@pytest.mark.parametrize("act", BLU)
def test_activation_sigmas_equal_jax(act, trained, frames):
    import jax.numpy as jnp

    _, anchor = frames
    mine = FM.activation_sigmas(FM.params_from_jax(trained, "cpu"), anchor, BLU[act])
    theirs = JFM.activation_sigmas(_jax(trained), anchor, BLU[act])
    assert mine[5] == theirs[5] == 0.0
    np.testing.assert_allclose(mine, theirs, rtol=1e-5)
    # the float64 std of JAX's own pre-activations
    jp = _jax(trained)
    x = (jnp.asarray(anchor)[..., None].astype(jnp.float32) - 128.0) / 255.0

    def act_fn(u, i):
        return jnp.maximum(u, 0.0) if BLU[act] is None else jnp.clip(u, 0.0, BLU[act][i])

    u1 = JFM._conv(x, jp["w_C1"], jp["b_C1"])
    a1 = act_fn(u1, 0)
    u21, u22 = JFM._conv(a1, jp["w_C2_1"], jp["b_C2_1"]), JFM._conv(a1, jp["w_C2_2"], jp["b_C2_2"])
    c2 = jnp.concatenate([act_fn(u21, 1), act_fn(u22, 2)], axis=-1)
    u31, u32 = JFM._conv(c2, jp["w_C3_1"], jp["b_C3_1"]), JFM._conv(c2, jp["w_C3_2"], jp["b_C3_2"])
    exact = [np.std(np.asarray(u, np.float64)) for u in (u1, u21, u22, u31, u32)]
    np.testing.assert_allclose(mine[:5], exact, rtol=1e-6)


@pytest.mark.parametrize("act", BLU)
def test_predict_uint8_equal_jax(act, trained):
    """Two 96x128 frames: at most 0.01% of pixels (2 of 24,576) off by 1."""
    anchor = T.dct_compress(T.make_clean_frames(2, 96, 128, seed=6), q=28.0)
    mine = FM.predict_uint8(FM.params_from_jax(trained, "cpu"), anchor, BLU[act]).numpy()
    theirs = np.asarray(JFM.predict_uint8(_jax(trained), anchor, BLU[act]))
    assert mine.dtype == np.uint8 and mine.shape == anchor.shape
    diff = np.abs(mine.astype(int) - theirs.astype(int))
    assert diff.max() <= 1 and (diff > 0).sum() <= 1e-4 * diff.size


def test_predict_uint8_tiled_equals_whole_frame(trained):
    """32x32 tiles with a 10-px halo over a 70x90 frame (ragged last
    tiles): equal to the whole-frame prediction, exactly."""
    anchor = T.dct_compress(T.make_clean_frames(2, 72, 96, seed=8), q=28.0)[:, :70, :90]
    tp = FM.params_from_jax(trained, "cpu")
    tiled = FM.predict_uint8_tiled(tp, anchor, tile=32, pad=10)
    assert tiled.dtype == np.uint8 and (tiled == FM.predict_uint8(tp, anchor).numpy()).all()


@pytest.mark.parametrize("act", BLU)
def test_gradient_equal_jax(act, trained, frames):
    """One gradient of the l2 loss at the trained params, and at init
    (zero biases: pre-activations of exactly 0 split their gradient, as
    jnp.maximum's)."""
    import jax

    clean, anchor = frames
    images = anchor[..., None].astype(np.float32)
    labels = clean[..., None].astype(np.float32)
    for params in (trained, FM.init_params(3)):
        model = FM.FloatVRCNN(params, device="cpu", blu_ub=BLU[act])
        loss = FM.l2_loss(model.tensors(), torch.from_numpy(images), torch.from_numpy(labels),
                          BLU[act])
        loss.backward()
        jloss, jgrads = jax.value_and_grad(JFM.l2_loss)(_jax(params), images, labels, BLU[act])
        assert loss.item() == pytest.approx(float(jloss), rel=1e-5)
        grads = FM.params_to_jax({k: getattr(model, k).grad for k in FM.PARAM_NAMES})
        for k in FM.PARAM_NAMES:
            _close(grads[k], jgrads[k])


@pytest.mark.parametrize("fmt", ["hwcn", "nchw"])
def test_float_formats_round_trip_across_packages(fmt):
    """Each package reads the other's float file, and both write the same
    bytes."""
    ws, bs = T.synth_float_weights(seed=2)
    mine, theirs = io.BytesIO(), io.BytesIO()
    getattr(MF, f"write_float_{fmt}")(mine, ws, bs)
    getattr(JMF, f"write_float_{fmt}")(theirs, ws, bs)
    assert mine.getvalue() == theirs.getvalue()
    for reader, data in ((getattr(JMF, f"read_float_{fmt}"), mine.getvalue()),
                         (getattr(MF, f"read_float_{fmt}"), theirs.getvalue())):
        rws, rbs = reader(io.BytesIO(data))
        for a, b in zip(rws + rbs, ws + bs):
            assert a.dtype == np.float32 and a.shape == b.shape and (a == b).all()


@pytest.mark.parametrize("qp", [22, 37])
def test_conv_validation_equal_jax(qp):
    """Synthetic float weights, the committed table (QP22's stale output
    row repaired) and from_float's engine params, on one 40x56 frame."""
    ws, bs = JT.synth_float_weights(seed=qp)
    params = {f"{k}_{l}": v for l, w, b in zip(("C1", "C2_1", "C2_2", "C3_1", "C3_2", "C4"), ws, bs)
              for k, v in (("w", w), ("b", b))}
    table = JT.load_table(qp).fixed_last_row()
    ep = O.EngineParams.from_float(ws, bs, table)
    x = JT.synth_frames(1, 40, 56, seed=qp)
    mine = V.conv_validation(params, T.load_table(qp).fixed_last_row(), EngineParams.from_arrays(ep),
                             x, device="cpu")
    theirs = JV.conv_validation(_jax(params), table, ep, x)
    _, inter = O.forward_blu(x, ep, collect_intermediates=True)
    for m, j, u in zip(mine, theirs, ("u1", "u2_1", "u2_2", "u3_1", "u3_2", "u4"), strict=True):
        assert m.name == j.name
        assert (m.engine_corner == j.engine_corner).all()
        tol = 1e-5 * np.abs(inter[u]).max()
        assert abs(m.max_abs_diff - j.max_abs_diff) <= tol
        assert abs(m.mean_abs_diff - j.mean_abs_diff) <= tol
        assert np.abs(m.float_corner - j.float_corner).max() <= 1
