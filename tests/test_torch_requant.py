"""Port requant epilogues (qcnn_gpu_tpu_torch/ops/requant.py) bit-equal to
the JAX ones (qcnn_gpu_tpu/ops/requant.py, pallas_pipeline2._requant_fast)
and to the oracle, on seeded int32 arrays. Tolerance: 0 (integer math)."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from qcnn_gpu_tpu.models import oracle as O
from qcnn_gpu_tpu.models.qvrcnn import MergedParams as JMergedParams
from qcnn_gpu_tpu.ops import requant as JR
from qcnn_gpu_tpu.ops.pallas_pipeline2 import _requant_fast as j_requant_fast
from qcnn_gpu_tpu.testing import synth_engine_params
from qcnn_gpu_tpu_torch.ops import requant as R

pytestmark = pytest.mark.quick

# power-of-two-heavy INT4 solver pairs and shipped pairs (test_requant_norm.py)
PAIRS = [(1 << 25, 27), (6 << 20, 24), (723, 16), (10, 5)]


def _u(shape, lo=-(1 << 20), hi=1 << 20, seed=0):
    return np.random.default_rng(seed).integers(lo, hi, size=shape).astype(np.int32)


def _eq(port: torch.Tensor, want) -> None:
    want = np.asarray(want)
    assert port.numpy().shape == want.shape
    assert (port.numpy().astype(np.int64) == want.astype(np.int64)).all()


@pytest.mark.parametrize("mul,shift", PAIRS)
def test_normalize_and_requant_on_int4_pairs(mul, shift):
    assert R.normalize_mul_shift(mul, shift) == JR.normalize_mul_shift(mul, shift)
    m, s = R.normalize_mul_shift(mul, shift)
    blu_q = (127 << s) // m  # inside the saturation window of the pair
    u = np.concatenate([_u(500, seed=mul % 97), [0, -1, 1, blu_q, blu_q + 1]]).astype(np.int32)
    got = R.blu_requant_i32(torch.from_numpy(u), blu_q, m, s)
    _eq(got, JR.blu_requant_i32(jnp.asarray(u), blu_q, m, s))
    _eq(got, O.blu_requant(u, blu_q, mul, shift))  # oracle on the raw pair
    small = (u >> 8).astype(np.int32)  # final requant: no int32 wrap
    got = R.final_residual_i32(torch.from_numpy(small), m, s)
    _eq(got, JR.final_residual_i32(jnp.asarray(small), m, s))
    _eq(got, O.final_residual_requant(small, mul, shift))


@pytest.mark.parametrize("qp", [22, 37])
def test_per_channel_vectors_match_jax(qp):
    """Merged per-channel rows broadcast over the channel axis exactly as
    in JAX: literal BLU requant and the folded epilogue, three stages."""
    mp = JMergedParams.from_engine(synth_engine_params(qp))
    for i, c in enumerate((64, 48, 48)):
        u = _u((3, 5, c), lo=-50000, hi=mp.blu_q[i].max() + 50000, seed=qp + i)
        blu, mul, bp, sh = (np.asarray(v[i]) for v in (mp.blu_q, mp.mul, mp.bias_pre, mp.shift))
        tb, tm, ts = (torch.from_numpy(v.astype(np.int64)) for v in (blu, mul, sh))
        lit = R.blu_requant_i32(torch.from_numpy(u), tb, tm, ts)
        _eq(lit, JR.blu_requant_i32(jnp.asarray(u), blu, mul, sh))
        uf = (u + bp).astype(np.int32)
        fast = R.requant_fast(torch.from_numpy(uf), torch.from_numpy((blu + bp).astype(np.int64)), tm, ts)
        _eq(fast, j_requant_fast(jnp.asarray(uf), jnp.asarray(blu + bp), jnp.asarray(mul), jnp.asarray(sh)))
        _eq(fast, lit.numpy())  # folded == literal


def test_residual_and_mul_shift_match_jax():
    x = np.random.default_rng(3).integers(0, 256, size=(2, 7, 9)).astype(np.uint8)
    res = _u((2, 7, 9), lo=-400, hi=400, seed=4)
    _eq(R.apply_residual_u8(torch.from_numpy(x), torch.from_numpy(res)),
        JR.apply_residual_u8(jnp.asarray(x), jnp.asarray(res)))
    u = _u(1000, lo=-(1 << 16), hi=1 << 16, seed=5)
    _eq(R.mul_shift_i32(torch.from_numpy(u), 723, 16), JR.mul_shift_i32(jnp.asarray(u), 723, 16))


def test_envelope_guard_matches_jax():
    with pytest.raises(ValueError, match="int32 engine envelope"):
        R.check_blu_requant_i32_safe(blu_q=100000, mul=(1 << 25) + 1, shift=27)
    R.check_blu_requant_i32_safe(blu_q=11512, mul=723, shift=16)
