"""The fused-network wrapper (qcnn_gpu_tpu_torch/ops/fused.py).

On the CPU: the kernel's plain version `fused_forward_reference` bit-equal
to the Pallas TPU kernel `build_pallas_forward3` (interpret mode), with
and without frame bounds, and to the port's masked reference core. On a
GPU (skipped here): the CUDA kernel bit-equal to the plain version.
Tolerance: 0 everywhere (integer arithmetic).

The JAX kernel is imported inside the tests that use it, so that this
file also runs on a GPU machine without jax:
`python -m pytest --noconftest -m cuda tests/test_torch_fused.py`."""

import numpy as np
import pytest
import torch

from qcnn_gpu_tpu.models import oracle as O
from qcnn_gpu_tpu.testing import synth_engine_params, synth_frames
from qcnn_gpu_tpu_torch.models import qvrcnn as Q
from qcnn_gpu_tpu_torch.models.engine_params import EngineParams
from qcnn_gpu_tpu_torch.ops import fused as FU
from qcnn_gpu_tpu_torch.ops.requant import apply_residual_u8


def build_pallas_forward3(p, **kw):
    from qcnn_gpu_tpu.ops.pallas_pipeline3 import build_pallas_forward3 as build

    return build(p, th=8, interpret=True, **kw)


def _fw(p, device="cpu"):
    return FU.FusedWeights.from_engine(EngineParams.from_arrays(p), device)


def _plain(p, x, *bounds):
    fw = _fw(p)
    return FU.fused_forward_reference(torch.from_numpy(x), fw, *bounds).numpy()


@pytest.mark.parametrize("n,h,w,qp", [(1, 37, 53, 22), (2, 13, 245, 27), (3, 18, 250, 37)])
def test_plain_matches_pallas_kernel(n, h, w, qp):
    p = synth_engine_params(qp)
    x = synth_frames(n, h, w, seed=n + h)
    got = _plain(p, x)
    assert (got == np.asarray(build_pallas_forward3(p)(x))).all()
    assert (got == O.forward_blu(x, p)).all()


def test_plain_matches_pallas_kernel_op6():
    """The shipping S1 mode (kernel v5, s1='op6') computes the same."""
    p = synth_engine_params(37)
    x = synth_frames(1, 20, 60, seed=4)
    want = np.asarray(build_pallas_forward3(p, s1="op6")(x))
    assert (_plain(p, x) == want).all()


def _outside_128(x, row_lo, row_hi, col_lo=None, col_hi=None):
    """Pixels outside the bounds set to 128 (0 in the x-128 domain): the
    sharded JAX path feeds the Pallas kernel halo rows this way."""
    x = x.copy()
    x[:, :row_lo] = x[:, row_hi:] = 128
    if col_lo is not None:
        x[:, :, :col_lo] = x[:, :, col_hi:] = 128
    return x


def test_row_bounds_match_pallas_row_bounds():
    p = synth_engine_params(37)
    x = _outside_128(synth_frames(2, 24, 40, seed=1), 3, 20)
    want = np.asarray(build_pallas_forward3(p, row_bounds=True)(x, 3, 20))
    assert (_plain(p, x, 3, 20) == want).all()


def test_col_bounds_match_pallas_col_bounds():
    p = synth_engine_params(22)
    x = _outside_128(synth_frames(1, 26, 36, seed=2), 2, 23, 5, 31)
    run = build_pallas_forward3(p, col_bounds=True)
    want = np.asarray(run(x, 2, 23, 5, 31))
    assert (_plain(p, x, 2, 23, 5, 31) == want).all()


def test_bounds_match_masked_reference_core():
    """Inputs outside the bounds read as 0 whatever their value: the plain
    kernel equals the port's residual_blu_merged with row/col validity."""
    p = synth_engine_params(27)
    x = synth_frames(2, 21, 33, seed=6)
    rv = (torch.arange(21) >= 4) & (torch.arange(21) < 17)
    cv = (torch.arange(33) >= 1) & (torch.arange(33) < 30)
    xt = torch.from_numpy(x)
    res = Q.residual_blu_merged(xt[..., None].to(torch.int64) - 128,
                                Q.MergedParams.from_engine(EngineParams.from_arrays(p), "cpu"), rv, cv)
    assert (_plain(p, x, 4, 17, 1, 30) == apply_residual_u8(xt, res).numpy()).all()


def test_cpu_tensor_takes_the_plain_version():
    fw = _fw(synth_engine_params(37))
    x = torch.from_numpy(synth_frames(1, 19, 23, seed=3))
    before = FU.fused_forward.launches
    assert (FU.fused_forward(x, fw) == FU.fused_forward_reference(x, fw)).all()
    assert FU.fused_forward.launches == before  # nothing launched


def test_wrapper_checks_inputs():
    fw = _fw(synth_engine_params(37))
    x = torch.zeros((1, 8, 8), dtype=torch.uint8)
    with pytest.raises(ValueError, match="uint8 frames"):
        FU.fused_forward(x.to(torch.int32), fw)
    with pytest.raises(ValueError, match="uint8 frames"):
        FU.fused_forward(x[0], fw)
    with pytest.raises(ValueError, match="contiguous"):
        FU.fused_forward(torch.zeros((1, 8, 16), dtype=torch.uint8)[:, :, ::2], fw)
    with pytest.raises(ValueError, match="weights on"):
        FU.fused_forward(x.to("meta"), fw)


@pytest.mark.cuda
def test_cuda_kernel_matches_plain():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernel has no CPU mode")
    fw = _fw(synth_engine_params(37), "cuda")
    for shape, bounds in (((1, 37, 53), ()), ((2, 13, 245), ()), ((2, 40, 50), (3, 33, 5, 41))):
        x = torch.from_numpy(synth_frames(*shape, seed=7)).cuda()
        got = FU.fused_forward(x, fw, *bounds)
        torch.cuda.synchronize()
        assert (got == FU.fused_forward_reference(x, fw, *bounds)).all(), (shape, bounds)
