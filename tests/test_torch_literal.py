"""The literal-requant kernel's wrapper (qcnn_gpu_tpu_torch/ops/literal.py).

On the CPU: the plain version `literal_residual_reference` equal to the
int16 residual of the Pallas TPU kernel `build_pallas_forward`
(pallas_pipeline.py, interpret mode), captured at its `pallas_call`
without changing the JAX package, and the restored frames equal to the
JAX function's and the oracle's, for synthetic QP22/QP37 tables, the
committed per-channel INT4 model and tables outside the solver's
saturation window, which the folded-epilogue weights refuse. On a GPU
(skipped here): the CUDA kernel equal to the plain version. Tolerance: 0
everywhere (integer arithmetic). Under frame bounds (a block of a mesh)
the plain version equals generation 3's plain version on a table inside
the window, and the CUDA kernel equals the plain version.

No JAX module is imported at the top of this file, so that the CUDA test
also runs on a GPU machine without jax:
`python -m pytest --noconftest -m cuda tests/test_torch_literal.py`."""

import dataclasses
import os

import numpy as np
import pytest
import torch

from qcnn_gpu_tpu_torch.data.model_files import read_static_qfp_pc
from qcnn_gpu_tpu_torch.models import qvrcnn as Q
from qcnn_gpu_tpu_torch.models.engine_params import EngineParams
from qcnn_gpu_tpu_torch.ops import literal as LI
from qcnn_gpu_tpu_torch.ops.fused import FusedWeights, fused_forward_reference
from qcnn_gpu_tpu_torch.ops.requant import apply_residual_u8

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
INT4 = os.path.join(REPO, "assets", "golden", "model_q22_int4.data")


def _synth(qp):
    from qcnn_gpu_tpu.testing import synth_engine_params

    return synth_engine_params(qp)


def _frames(n, h, w, seed):
    from qcnn_gpu_tpu.testing import synth_frames

    return synth_frames(n, h, w, seed=seed)


def _jax_v1(jp, x):
    """(int16 residual [B, H, W], restored uint8) of build_pallas_forward in
    interpret mode; the residual is read at the pallas_call through a
    forwarding stand-in for the module's `pl`."""
    import jax
    from jax.experimental import pallas as pl

    import qcnn_gpu_tpu.ops.pallas_pipeline as PP

    seen = []

    class _Recording:
        def __getattr__(self, name):
            return getattr(pl, name)

        @staticmethod
        def pallas_call(*a, **k):
            call = pl.pallas_call(*a, **k)

            def run(*args):
                out = call(*args)
                jax.debug.callback(lambda v: seen.append(np.asarray(v)), out)
                return out

            return run

    mp = pytest.MonkeyPatch()
    mp.setattr(PP, "pl", _Recording())
    try:
        fn = PP.build_pallas_forward(jp, interpret=True)
        restored = np.asarray(fn(x))
    finally:
        mp.undo()
    th, we, tw = fn.geometry
    b, h, w = x.shape
    nh, nw = -(-h // th), -(-w // tw)
    res = seen[-1].reshape(b, nh, nw, th, we)[..., :tw]  # the wrapper's unpacking
    res = res.transpose(0, 1, 3, 2, 4).reshape(b, nh * th, nw * tw)[:, :h, :w]
    return res, restored


def _moved(jp, layer, sign):
    """The table with one BLU bound moved by one output step out of the
    saturation window (as tests/test_torch_params.py moves it)."""
    p = EngineParams.from_arrays(jp)
    mul, shift = Q._normalized_table(p)
    blu = list(p.blu_q)
    blu[layer] = int(blu[layer]) + sign * ((1 << int(shift[layer])) // int(mul[layer]) + 1)
    return dataclasses.replace(jp, blu_q=tuple(blu))


def _check_against_jax(jp, x):
    from qcnn_gpu_tpu.models import oracle as O

    lw = LI.LiteralWeights.from_engine(EngineParams.from_arrays(jp), "cpu")
    xt = torch.from_numpy(x)
    got = LI.literal_residual_reference(xt, lw)
    want_res, want_rec = _jax_v1(jp, x)
    assert got.dtype == torch.int16 and got.shape == xt.shape
    assert (got.numpy() == want_res).all()
    restored = LI.literal_forward(xt, lw).numpy()
    assert (restored == want_rec).all()
    assert (restored == O.forward_blu(x, jp)).all()


@pytest.mark.parametrize("model,geo", [(22, (1, 37, 53)), (37, (2, 20, 30)), ("int4", (1, 21, 40))])
def test_plain_matches_pallas_v1_residual(model, geo):
    jp = read_static_qfp_pc(INT4) if model == "int4" else _synth(model)
    _check_against_jax(jp, _frames(*geo, seed=sum(geo)))


@pytest.mark.parametrize("layer,sign", [(2, +1), (4, -1)])
def test_plain_matches_pallas_v1_outside_saturation_window(layer, sign):
    """A BLU bound one output step above (kept values reach 128) or below
    the window: the folded weights refuse the table, the literal chain
    stays exact."""
    jp = _moved(_synth(37), layer, sign)
    with pytest.raises(ValueError, match="saturation window"):
        FusedWeights.from_engine(EngineParams.from_arrays(jp), "cpu")
    _check_against_jax(jp, _frames(1, 24, 31, seed=layer))


def test_weights_refuse_final_mul_above_127_like_jax():
    from qcnn_gpu_tpu.ops.pallas_pipeline import build_pallas_forward

    jp = _synth(37)
    mul = list(jp.mul)
    mul[5] = 129  # odd: nothing to normalize away
    bad = dataclasses.replace(jp, mul=tuple(mul))
    Q.MergedParams.from_engine(EngineParams.from_arrays(bad), "cpu")  # the engine accepts it
    with pytest.raises(ValueError, match="final mul 129 too large"):
        LI.LiteralWeights.from_engine(EngineParams.from_arrays(bad), "cpu")
    with pytest.raises(AssertionError, match="final mul 129 too large"):
        build_pallas_forward(bad, interpret=True)(_frames(1, 8, 8, seed=0))


def test_weights_refuse_activations_above_255():
    p = EngineParams.from_arrays(_synth(37))
    blu = list(p.blu_q)
    blu[0] = 3 * int(blu[0])  # kept values up to about 3 * 127
    with pytest.raises(ValueError, match="exceeds 255"):
        LI.LiteralWeights.from_engine(dataclasses.replace(p, blu_q=blu), "cpu")


def test_vectors_hold_the_unfolded_rows():
    p = EngineParams.from_arrays(_synth(22))
    lw, mp = LI.LiteralWeights.from_engine(p, "cpu"), Q.MergedParams.from_engine(p, "cpu")
    vec = lw.vec.numpy().astype(np.int64)
    off = 0
    for i, c in enumerate((64, 48, 48)):
        rows = (mp.b_i32[i], mp.blu_q[i], mp.mul[i], mp.bias_pre[i], mp.shift[i])
        for j, r in enumerate(rows):
            assert (vec[off + j * c: off + (j + 1) * c] == r.numpy()).all()
        off += 5 * c
    assert off == vec.size == 800
    assert (lw.b4, lw.mul4, lw.shift4) == (int(mp.b_i32[3][0]), mp.mul4, mp.shift4)


def test_cpu_tensor_takes_the_plain_version():
    lw = LI.LiteralWeights.from_engine(EngineParams.from_arrays(_synth(37)), "cpu")
    x = torch.from_numpy(_frames(1, 19, 23, seed=3))
    before = LI.literal_residual.launches
    assert torch.equal(LI.literal_residual(x, lw), LI.literal_residual_reference(x, lw))
    assert LI.literal_residual.launches == before
    with pytest.raises(ValueError, match="uint8 frames"):
        LI.literal_residual(x.to(torch.int32), lw)


@pytest.mark.parametrize("bounds", [(3, 33, 5, 47), (-2, 30, 9, 60)])
def test_plain_under_bounds_matches_fused_plain(bounds):
    """On a table inside the saturation window the literal chain and the
    folded epilogue agree, under frame bounds too: restored frames equal at
    every pixel, bounds past the frame clipped. The wrapper hands a CPU
    tensor's bounds to its plain version."""
    p = EngineParams.from_arrays(_synth(37))
    lw = LI.LiteralWeights.from_engine(p, "cpu")
    x = torch.from_numpy(_frames(2, 37, 53, seed=4))
    res = LI.literal_residual_reference(x, lw, *bounds)
    want = fused_forward_reference(x, FusedWeights.from_engine(p, "cpu"), *bounds)
    assert torch.equal(apply_residual_u8(x, res), want)
    assert torch.equal(LI.literal_forward(x, lw, *bounds), want)
    assert torch.equal(LI.literal_residual(x, lw, *bounds), res)
    assert not torch.equal(res, LI.literal_residual_reference(x, lw))


def _off_window_tables(p):
    """Two tables outside the saturation window, from the port's own
    containers (no JAX): C2_2's bound one output step up, and S1's bound
    raised by half (kept values past 127 on random frames)."""
    mul, shift = (np.asarray(v[2], np.int64) for v in Q._normalized_table(p))
    up = list(p.blu_q)
    up[2] = np.asarray(up[2], np.int64) + (np.int64(1) << shift) // mul + 1
    half = list(p.blu_q)
    half[0] = np.asarray(half[0], np.int64) * 3 // 2
    return dataclasses.replace(p, blu_q=up), dataclasses.replace(p, blu_q=half)


@pytest.mark.cuda
def test_cuda_kernel_matches_plain():
    """The committed INT4 model and two tables outside the window, odd
    batch included, over whole frames and under frame bounds (a row band
    and a rectangle, as the blocks of a mesh pass them)."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernel has no CPU mode")
    p = EngineParams.from_arrays(read_static_qfp_pc(INT4))
    rng = np.random.default_rng(7)
    for table in (p, *_off_window_tables(p)):
        lw = LI.LiteralWeights.from_engine(table, "cuda")
        for shape in ((1, 37, 53), (2, 13, 245), (3, 40, 50)):
            x = torch.from_numpy(rng.integers(0, 256, shape, dtype=np.uint8)).cuda()
            for bounds in ((), (6, shape[1] - 2), (2, shape[1] - 3, 5, shape[2] - 6)):
                got = LI.literal_residual(x, lw, *bounds)
                torch.cuda.synchronize()
                want = LI.literal_residual_reference(x, lw, *bounds)
                assert torch.equal(got, want), (shape, bounds)
