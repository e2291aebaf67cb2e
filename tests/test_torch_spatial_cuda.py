"""Sharded generation 3 on a CUDA GPU: `make_sharded_forward` on virtual
meshes over one card (every block a launch of `csrc/qvrcnn_fused.cu`
with its frame bounds) equal to the unsharded kernel, tolerance 0. Run on
the card with `python -m pytest --noconftest -m cuda
tests/test_torch_spatial_cuda.py`; without a GPU every test skips.
Imports no JAX module."""

import os

import numpy as np
import pytest
import torch

from qcnn_gpu_tpu_torch.engine.runner import read_model
from qcnn_gpu_tpu_torch.ops.fused import FusedWeights, fused_forward
from qcnn_gpu_tpu_torch.parallel.mesh import make_mesh
from qcnn_gpu_tpu_torch.parallel.spatial import make_sharded_forward
from qcnn_gpu_tpu_torch.testing import synth_frames

MODEL = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
                     "assets", "golden", "model_q37.data")


def _cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the fused kernel has no CPU mode")
    return torch.device("cuda", 0)


@pytest.mark.cuda
@pytest.mark.parametrize("geo", [(2, 240, 416), (4, 1080, 1920)], ids=["240p", "1080p"])
@pytest.mark.parametrize("dims", [(1, 4, 1), (1, 2, 2), (2, 2, 2), (2, 1, 1)],
                         ids=lambda d: "x".join(map(str, d)))
def test_sharded_kernel_equals_unsharded(dims, geo):
    dev = _cuda()
    p = read_model(MODEL)
    mesh = make_mesh(dims[0], dims[1], devices=[dev] * 8, sw=dims[2])
    run = make_sharded_forward(p, mesh, impl="auto")
    x = torch.from_numpy(synth_frames(*geo, seed=sum(geo))).to(dev)
    before = fused_forward.launches
    got = run(x)
    torch.cuda.synchronize()
    assert fused_forward.launches - before == dims[0] * dims[1] * dims[2]
    want = fused_forward(x, FusedWeights.from_engine(p, dev))
    assert run.impl == "kernel3" and got.device == dev
    assert np.array_equal(got.cpu().numpy(), want.cpu().numpy())
