"""Generation 3's tile instances and the tuned engine program, on the card
(qcnn_gpu_tpu_torch/ops/fused.py, ops/tuning.py).

Every compiled instance (ops/fused.TILES) bit-equal to the plain version
on frames ragged in both axes, smaller and larger than a tile; a tile
that is not compiled raises before any launch; `Engine` at 416x240,
batch 1, launches the table's instance and no other. Without a GPU every
test skips. Imports no JAX module:
`python -m pytest --noconftest -m cuda tests/test_torch_tuning_cuda.py`.
Tolerance: 0 (integer arithmetic)."""

import os

import numpy as np
import pytest
import torch

from qcnn_gpu_tpu_torch.engine.runner import Engine, read_model
from qcnn_gpu_tpu_torch.ops import fused as FU
from qcnn_gpu_tpu_torch.ops import tuning
from qcnn_gpu_tpu_torch.ops.literal import literal_residual
from qcnn_gpu_tpu_torch.ops.pair import pair_forward

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
MODEL = os.path.join(REPO, "assets", "golden", "model_q37.data")


def _cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernels have no CPU mode")


@pytest.mark.cuda
@pytest.mark.parametrize("tile", FU.TILES, ids=lambda t: f"{t[0]}x{t[1]}")
def test_every_instance_equals_the_plain_version(tile):
    _cuda()
    fw = FU.FusedWeights.from_engine(read_model(MODEL), "cuda")
    rng = np.random.default_rng(tile[0] * tile[1])
    for shape in ((1, 13, 27), (3, 37, 53), (2, 2 * tile[0] + 5, 3 * tile[1] - 7), (1, 240, 416)):
        x = torch.from_numpy(rng.integers(0, 256, shape, dtype=np.uint8)).cuda()
        before = FU.fused_forward.tile_launches[tile]
        got = FU.fused_forward(x, fw, tile=tile)
        torch.cuda.synchronize()
        assert FU.fused_forward.tile_launches[tile] == before + 1
        assert torch.equal(got, FU.fused_forward_reference(x, fw)), shape
    x = torch.from_numpy(rng.integers(0, 256, (2, 45, 70), dtype=np.uint8)).cuda()
    got = FU.fused_forward(x, fw, 3, 41, 5, 66, tile=tile)
    torch.cuda.synchronize()
    assert torch.equal(got, FU.fused_forward_reference(x, fw, 3, 41, 5, 66))


@pytest.mark.cuda
@pytest.mark.parametrize("tile", [(24, 24), (16, 40), (40, 24), (20, 40)])
def test_an_unknown_tile_raises(tile):
    _cuda()
    fw = FU.FusedWeights.from_engine(read_model(MODEL), "cuda")
    x = torch.zeros((1, 24, 40), dtype=torch.uint8, device="cuda")
    before = FU.fused_forward.launches
    with pytest.raises(ValueError, match="not a compiled instance"):
        FU.fused_forward(x, fw, tile=tile)
    assert FU.fused_forward.launches == before


@pytest.mark.cuda
def test_engine_launches_the_tables_instance_at_240p_batch_1():
    _cuda()
    want = tuning.tuned_kwargs(240, 416, 1)
    tile = (want.get("th", 24), want.get("tw", 40))
    eng = Engine(device="cuda", impl="auto", batch_frames=1)
    eng.load_model(37, MODEL)
    x = np.random.default_rng(0).integers(0, 256, (3, 240, 416), dtype=np.uint8)
    counts = dict(FU.fused_forward.tile_launches)
    others = [pair_forward.launches, literal_residual.launches]
    got = eng.restore_stream(x, 37)
    moved = {t: n - counts[t] for t, n in FU.fused_forward.tile_launches.items() if n != counts[t]}
    assert moved == {tile: 3}
    assert [pair_forward.launches, literal_residual.launches] == others
    fw = FU.FusedWeights.from_engine(read_model(MODEL), "cpu")
    assert (got == FU.fused_forward_reference(torch.from_numpy(x), fw).numpy()).all()
