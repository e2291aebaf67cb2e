"""The port's quant tables, solver, `EngineParams.from_float`, synthetic
parameters and `solve_table` / `quantize_model` on the CPU, against the
JAX package on the same inputs. Tolerance: 0 everywhere (table rows,
integers and file bytes); the float pre-activations that `conv_validation`
compares are held in tests/test_torch_float_model.py.

The table solve jumps between (mul, shift) pairs for bound changes of
0.25%, so the two solvers are handed the same BLU bounds: the presets, or
the bounds one package measured."""

import io
import os
import pickle
import warnings

import numpy as np
import pytest

from qcnn_gpu_tpu import testing as JT
from qcnn_gpu_tpu.data import model_files as JMF
from qcnn_gpu_tpu.engine import calibrate as JC
from qcnn_gpu_tpu.models import oracle as O
from qcnn_gpu_tpu.quant import params as JP
from qcnn_gpu_tpu.quant import solver as JS
from qcnn_gpu_tpu_torch import testing as T
from qcnn_gpu_tpu_torch.data import model_files as MF
from qcnn_gpu_tpu_torch.engine import calibrate as C
from qcnn_gpu_tpu_torch.models import float_model as FM
from qcnn_gpu_tpu_torch.models.engine_params import EngineParams
from qcnn_gpu_tpu_torch.quant import params as P
from qcnn_gpu_tpu_torch.quant import solver as S
from qcnn_gpu_tpu_torch.train.checkpoint import load_checkpoint

QPS = [22, 27, 32, 37]
DEMO = T.asset("demo")


def _row_fields(row):
    return [np.asarray(getattr(row, f)) for f in ("stepw", "ratio", "blu_adj", "blu_q", "mul", "shift")]


def assert_tables_equal(mine, theirs):
    """Row types and every field equal (scalars exactly, vectors elementwise)."""
    assert len(mine) == len(theirs) == 6
    for a, b in zip(mine, theirs):
        assert type(a).__name__ == type(b).__name__
        for x, y in zip(_row_fields(a), _row_fields(b)):
            assert x.shape == y.shape and x.dtype == y.dtype and (x == y).all()


def _engine_bytes(writer, p) -> bytes:
    buf = io.BytesIO()
    writer(buf, p)
    return buf.getvalue()


@pytest.mark.parametrize("qp", QPS)
def test_committed_tables_load_equal_jax(qp, tmp_path):
    """quant_params{qp}.data loads to the JAX package's rows (QP22 with
    the same stale-row warning and repair); both writers give the same
    pickle and packed bytes, and the packed file reads back."""
    path = T.asset(f"quant_params{qp}.data")
    with warnings.catch_warnings(record=True) as mine_w:
        warnings.simplefilter("always")
        mine = P.QuantTable.load_pickle(path)
    with warnings.catch_warnings(record=True) as jax_w:
        warnings.simplefilter("always")
        theirs = JP.QuantTable.load_pickle(path)
    assert [str(w.message) for w in mine_w] == [str(w.message) for w in jax_w]
    assert bool(mine_w) == (qp == 22)
    assert mine.rows == tuple(P.LayerQuant(*r.as_list()) for r in theirs.rows)
    assert mine.fixed_last_row().rows[5] == P.LayerQuant(*theirs.fixed_last_row().rows[5].as_list())
    for fmt in ("pickle", "packed"):
        getattr(mine, f"save_{fmt}")(str(tmp_path / f"mine.{fmt}"))
        getattr(theirs, f"save_{fmt}")(str(tmp_path / f"theirs.{fmt}"))
        assert (tmp_path / f"mine.{fmt}").read_bytes() == (tmp_path / f"theirs.{fmt}").read_bytes()
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        assert P.QuantTable.load_packed(str(tmp_path / "mine.packed")) == mine
    with open(tmp_path / "mine.pickle", "rb") as fp:
        assert isinstance(pickle.load(fp), list)  # a plain list of rows


@pytest.mark.parametrize("qp", QPS)
@pytest.mark.parametrize("per_channel", [False, True], ids=["scalar", "per-channel"])
@pytest.mark.parametrize("wbits", [8, 4])
def test_solve_network_equal_jax(qp, per_channel, wbits):
    """stepw from synth_float_weights, bounds BLU_INIT[qp] and
    BLU_INIT_FINETUNE[qp]: the same rows, and byte-equal model files from
    from_float (pc format for per-channel tables, vect_c and hwcn else)."""
    ws, bs = T.synth_float_weights(seed=qp)
    for presets, jax_presets in ((S.BLU_INIT, JS.BLU_INIT),
                                 (S.BLU_INIT_FINETUNE, JS.BLU_INIT_FINETUNE)):
        assert presets[qp] == jax_presets[qp]
        if per_channel:
            mine = S.solve_network_per_channel(S.stepw_per_channel(ws, bits=wbits), presets[qp])
            theirs = JS.solve_network_per_channel(JS.stepw_per_channel(ws, bits=wbits), presets[qp])
        else:
            mine = S.solve_network(S.stepw_from_weights(ws, bits=wbits), presets[qp])
            theirs = JS.solve_network(JS.stepw_from_weights(ws, bits=wbits), presets[qp])
        assert_tables_equal(mine, theirs)
        ep = EngineParams.from_float(ws, bs, mine, wbits=wbits)
        jep = O.EngineParams.from_float(ws, bs, theirs, wbits=wbits)
        pairs = [(MF.write_static_qfp_pc, JMF.write_static_qfp_pc)] if per_channel else [
            (MF.write_static_qfp_vect_c, JMF.write_static_qfp_vect_c),
            (MF.write_static_qfp_hwcn, JMF.write_static_qfp_hwcn)]
        for w_mine, w_theirs in pairs:
            assert _engine_bytes(w_mine, ep) == _engine_bytes(w_theirs, jep)


@pytest.mark.parametrize("qp", QPS)
def test_solver_primitives_equal_jax(qp):
    """solve_mul_shift over a range of bounds (the search's jumps
    included), solve_mul_shift_float, solve_layer, solve_concat and
    solve_last on the committed table's ratios."""
    for u in np.geomspace(130, 5e6, 400):
        assert S.solve_mul_shift(float(u)) == JS.solve_mul_shift(float(u))
        assert S.solve_mul_shift_float(float(u)) == JS.solve_mul_shift_float(float(u))
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        t = JT.load_table(qp)
    b = JS.BLU_INIT[qp]
    r0, r1 = t[0], t[1]
    assert S.solve_layer(r0.ratio, r0.stepw, b[0]).as_list() == JS.solve_layer(r0.ratio, r0.stepw, b[0]).as_list()
    for m, j in zip(S.solve_concat(r1.ratio, t[1].stepw, b[1], t[2].stepw, b[2]),
                    JS.solve_concat(r1.ratio, t[1].stepw, b[1], t[2].stepw, b[2])):
        assert m.as_list() == j.as_list()
    assert S.solve_last(t[5].ratio, t[5].stepw).as_list() == JS.solve_last(t[5].ratio, t[5].stepw).as_list()


@pytest.mark.parametrize("qp", QPS)
@pytest.mark.parametrize("seed", [0, 3])
def test_synth_params_equal_jax(qp, seed):
    """synth_float_weights, synth_engine_params (through from_float) and
    synth_dynamic_params equal the JAX package's."""
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        for a, b in zip(*[T.synth_float_weights(seed), JT.synth_float_weights(seed)]):
            for x, y in zip(a, b):
                assert x.dtype == y.dtype == np.float32 and (x == y).all()
        ep, jep = T.synth_engine_params(qp, seed), JT.synth_engine_params(qp, seed)
        dp, jdp = T.synth_dynamic_params(qp, seed), JT.synth_dynamic_params(qp, seed)
    assert _engine_bytes(MF.write_static_qfp_vect_c, ep) == _engine_bytes(JMF.write_static_qfp_vect_c, jep)
    assert ep.mul == list(jep.mul) and ep.shift == list(jep.shift) and ep.blu_q == list(jep.blu_q)
    assert _engine_bytes(MF.write_dynamic_hwcn, dp) == _engine_bytes(JMF.write_dynamic_hwcn, jdp)


def test_from_float_keeps_the_callers_dtype():
    """float32 weights divided by a Python float stay float32 (NumPy 2):
    a weight whose float64 quotient rounds otherwise lands where the JAX
    package puts it."""
    table = JT.load_table(37)
    ws, bs = T.synth_float_weights(0)
    s = table[0].stepw
    # float32 values within 8 ulps of a half step whose float32 and float64
    # quotients round to different integers
    halves = ((np.arange(-128, 127) + 0.5) * s).astype(np.float32)
    near = (halves[:, None] + np.arange(-8, 9)[None, :] * np.spacing(halves)[:, None])
    near = near.astype(np.float32).ravel()
    split = near[np.round(near / s) != np.round(near.astype(np.float64) / s)]
    assert split.size > 100
    w0 = ws[0].copy()
    w0.flat[:split.size] = split
    ws = [w0] + ws[1:]
    mine = EngineParams.from_float(ws, bs, table)
    theirs = O.EngineParams.from_float(ws, bs, table)
    for a, b in zip(mine.weights + mine.biases, theirs.weights + theirs.biases):
        assert a.dtype == b.dtype and (a == b).all()
    assert (mine.weights[0].flat[:split.size] == np.round(split / s)).all()


def test_demo_byte_target():
    """The port alone: ckpt-1500 (port's checkpoint reader), the committed
    quant_table.data, quantize_model, the vect_c writer: byte for byte
    assets/demo/model_q.data."""
    params, _, step = load_checkpoint(os.path.join(DEMO, "ckpt"))
    assert step == 1500
    table = P.QuantTable.load_pickle(os.path.join(DEMO, "quant_table.data"))
    got = _engine_bytes(MF.write_static_qfp_vect_c, C.quantize_model(params, table))
    with open(os.path.join(DEMO, "model_q.data"), "rb") as fp:
        assert got == fp.read()


@pytest.mark.parametrize("per_channel", [False, True], ids=["scalar", "per-channel"])
def test_calibrated_table_and_model_equal_jax_from_the_same_bounds(per_channel):
    """The demo's flow on ckpt-1500: the JAX package's 3-sigma bounds on
    two 48x64 DCT anchors, handed to both solve_table, give equal tables
    and byte-equal model files; the port's own bounds (its float model on
    the CPU) agree with JAX's within rtol 1e-5 (float32 convolutions summed
    in another order; jnp.std sums in float32, the port in float64: at
    4x64x64 jnp.std alone drifts 2.2e-5 from the float64 value, so the
    sample is kept small; tests/test_torch_float_model.py holds the port
    to the float64 std at rtol 1e-6)."""
    import jax.numpy as jnp

    params, _, _ = load_checkpoint(os.path.join(DEMO, "ckpt"))
    anchor = T.dct_compress(T.make_clean_frames(2, 48, 64, seed=0), q=28.0)
    jparams = {k: jnp.asarray(v) for k, v in params.items()}
    blu = JC.calibrate_blu_bounds(jparams, anchor)
    mine_blu = C.calibrate_blu_bounds(params, anchor, device="cpu")
    np.testing.assert_allclose(mine_blu, blu, rtol=1e-5)
    mine = C.solve_table(params, blu_bounds=blu, per_channel=per_channel)
    theirs = JC.solve_table(jparams, blu_bounds=blu, per_channel=per_channel)
    assert_tables_equal(mine, theirs)
    ep, jep = C.quantize_model(params, mine), JC.quantize_model(jparams, theirs)
    writers = (MF.write_static_qfp_pc, JMF.write_static_qfp_pc) if per_channel else (
        MF.write_static_qfp_vect_c, JMF.write_static_qfp_vect_c)
    assert _engine_bytes(writers[0], ep) == _engine_bytes(writers[1], jep)
    preset = C.solve_table(params, qp=37, wbits=4)
    assert_tables_equal(preset, JC.solve_table(jparams, qp=37, wbits=4))
    with pytest.raises(ValueError, match="need blu_bounds or qp"):
        C.solve_table(params)


def test_float_params_lists_round_trip():
    """init_params -> FloatVRCNN layout and back is the identity."""
    p = FM.init_params(4)
    back = FM.params_to_jax(FM.params_from_jax(p, "cpu"))
    assert list(back) == list(FM.PARAM_NAMES)
    for k in p:
        assert back[k].dtype == np.float32 and (back[k] == p[k]).all()
