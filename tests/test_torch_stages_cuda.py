"""Generation 3's diagnostic instances on the card (qcnn_gpu_tpu_torch/ops/
fused.py `fused_forward(stages=, _debug=)`, csrc/qvrcnn_fused.cu built with
`stage_defines(tile)`).

Each variant (truncated after S1, S2, S3; `zero_a1`) at each compiled tile
bit-equal to its plain version on frames ragged in both axes, smaller and
larger than a tile, and under frame bounds; each counted in
`stage_launches` alone; a bad variant raises before any launch. Without a
GPU every test skips. Imports no JAX module:
`python -m pytest --noconftest -m cuda tests/test_torch_stages_cuda.py`.
Tolerance: 0 (integer arithmetic)."""

import os

import numpy as np
import pytest
import torch

from qcnn_gpu_tpu_torch.engine.runner import read_model
from qcnn_gpu_tpu_torch.ops import fused as FU

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
MODEL = os.path.join(REPO, "assets", "golden", "model_q37.data")


def _cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernels have no CPU mode")


@pytest.mark.cuda
@pytest.mark.parametrize("tile", FU.TILES, ids=lambda t: f"{t[0]}x{t[1]}")
def test_every_variant_equals_the_plain_version(tile):
    _cuda()
    fw = FU.FusedWeights.from_engine(read_model(MODEL), "cuda")
    rng = np.random.default_rng(tile[0] + tile[1])
    cases = [((1, 13, 27), ()), ((3, 37, 53), ()), ((2, 2 * tile[0] + 5, 3 * tile[1] - 7), ()),
             ((1, 240, 416), ()), ((2, 45, 70), (3, 41, 5, 66)), ((1, 100, 130), (0, 61, 17, 130))]
    for shape, bounds in cases:
        x = torch.from_numpy(rng.integers(0, 256, shape, dtype=np.uint8)).cuda()
        for stages, debug in FU.STAGE_VARIANTS:
            key = (*tile, stages, debug)
            before = FU.fused_forward.stage_launches[key], FU.fused_forward.launches
            got = FU.fused_forward(x, fw, *bounds, tile=tile, stages=stages, _debug=debug)
            torch.cuda.synchronize()
            assert (FU.fused_forward.stage_launches[key], FU.fused_forward.launches) == (
                before[0] + 1, before[1])
            want = FU.fused_forward_reference(x, fw, *bounds, stages=stages, _debug=debug)
            assert torch.equal(got, want), (shape, bounds, stages, debug)


@pytest.mark.cuda
@pytest.mark.parametrize("stages,debug", [(0, ""), (5, ""), (2, "zero_a1"), (4, "raw_out"),
                                          (4, "no_split")])
def test_a_bad_variant_raises_before_a_launch(stages, debug):
    _cuda()
    fw = FU.FusedWeights.from_engine(read_model(MODEL), "cuda")
    x = torch.zeros((1, 24, 40), dtype=torch.uint8, device="cuda")
    before = dict(FU.fused_forward.stage_launches), FU.fused_forward.launches
    with pytest.raises(ValueError):
        FU.fused_forward(x, fw, stages=stages, _debug=debug)
    assert (dict(FU.fused_forward.stage_launches), FU.fused_forward.launches) == before
