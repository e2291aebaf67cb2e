"""Sharded generations 3 and 1 on a CUDA GPU: `make_sharded_forward` on
virtual meshes over one card (every block a launch of
`csrc/qvrcnn_fused.cu`, or of `csrc/qvrcnn_literal.cu` for a table
outside the saturation window, with its frame bounds) equal to the
unsharded kernel, tolerance 0. Run on
the card with `python -m pytest --noconftest -m cuda
tests/test_torch_spatial_cuda.py`; without a GPU every test skips.
Imports no JAX module."""

import dataclasses
import os

import numpy as np
import pytest
import torch

from qcnn_gpu_tpu_torch.engine.runner import read_model
from qcnn_gpu_tpu_torch.models.qvrcnn import _normalized_table
from qcnn_gpu_tpu_torch.ops.fused import FusedWeights, fused_forward
from qcnn_gpu_tpu_torch.ops.literal import LiteralWeights, literal_forward, literal_residual
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


@pytest.mark.cuda
@pytest.mark.parametrize("dims", [(1, 2, 1), (2, 2, 1), (1, 2, 2)],
                         ids=lambda d: "x".join(map(str, d)))
def test_sharded_literal_kernel_equals_unsharded(dims):
    """A table outside the saturation window (C2_2's bound one output step
    up): auto under a mesh is generation 1, one literal launch per block,
    equal to the unsharded literal kernel."""
    dev = _cuda()
    p = read_model(MODEL)
    mul, shift = _normalized_table(p)
    blu = list(p.blu_q)
    blu[2] = int(blu[2]) + (1 << int(shift[2])) // int(mul[2]) + 1
    p = dataclasses.replace(p, blu_q=blu)
    mesh = make_mesh(dims[0], dims[1], devices=[dev] * 8, sw=dims[2])
    run = make_sharded_forward(p, mesh, impl="auto")
    x = torch.from_numpy(synth_frames(4, 240, 416, seed=3)).to(dev)
    before = literal_residual.launches
    got = run(x)
    torch.cuda.synchronize()
    assert literal_residual.launches - before == dims[0] * dims[1] * dims[2]
    want = literal_forward(x, LiteralWeights.from_engine(p, dev))
    assert run.impl == "kernel1" and got.device == dev
    assert np.array_equal(got.cpu().numpy(), want.cpu().numpy())
