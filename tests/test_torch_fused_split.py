"""Generation 3's operand layout (qcnn_gpu_tpu_torch/ops/fused.py and
csrc/qvrcnn_fused.cu, instances of the template csrc/qvrcnn_split.cuh),
emulated in numpy int64 on the CPU.

`emulate` (tests/torch_split_emulation.py) runs the kernel's arithmetic
as the kernel lays it out: a persistent block walking its tiles with one
set of shared-memory buffers; the raw window, the expanded S1 operand,
the channel-block-major activation planes with their tails, S3 written
over S1's buffer and the expanded window under S2's; each stage's
`wgmma` chunks read through descriptors (start, leading offset between
the two K halves, stride 128 between 8-position core matrices) from the
weight image `split_operand` packs; outputs computed on the input
region's pitch, wrapped columns and rows past the region dropped, frame
bounds masking every stage. Every byte a chunk reads must have been
written during the same tile; the emulation raises otherwise. It is held
bit-equal to the plain version `fused_forward_reference` and to the
Pallas TPU kernel `build_pallas_forward3` (interpret mode). Tolerance: 0
everywhere.
"""

import os
import re

import numpy as np
import pytest
import torch

from qcnn_gpu_tpu_torch.models.engine_params import EngineParams
from qcnn_gpu_tpu_torch.models.qvrcnn import MergedParams
from qcnn_gpu_tpu_torch.ops import fused as FU

import torch_split_emulation as SE

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
INT4 = os.path.join(REPO, "assets", "golden", "model_q22_int4.data")
TH, TW, P, PL = FU.TILE_H, FU.TILE_W, FU.PITCH, FU.PLANE


def _params(model):
    if model == "int4":
        from qcnn_gpu_tpu_torch.data.model_files import read_static_qfp_pc

        return EngineParams.from_arrays(read_static_qfp_pc(INT4))
    from qcnn_gpu_tpu.testing import synth_engine_params

    return EngineParams.from_arrays(synth_engine_params(model))


def _frames(n, h, w, seed):
    from qcnn_gpu_tpu.testing import synth_frames

    return synth_frames(n, h, w, seed=seed)


def emulate(x, fw, bounds=(), grid=3, zero_tails=True):
    """The kernel's arithmetic on uint8 frames [B, H, W] -> uint8
    (tests/torch_split_emulation.py, generation 3's design)."""
    return SE.emulate(x, fw, SE.GEN3, bounds, grid, zero_tails=zero_tails)


def _merged_ids():
    """Merged S1..S4 weights whose every real-layer weight is a distinct
    positive id, built as MergedParams builds the int8 ones (zero taps of
    the smaller branch padded in)."""
    shapes = [(5, 5, 1, 64), (3, 3, 64, 32), (5, 5, 64, 16), (3, 3, 48, 16), (1, 1, 48, 32),
              (3, 3, 48, 1)]
    ids, start = [], 1
    for s in shapes:
        n = int(np.prod(s))
        ids.append(np.arange(start, start + n, dtype=np.int64).reshape(s))
        start += n

    def pad(w, k):
        r = (k - w.shape[0]) // 2
        return np.pad(w, ((r, r), (r, r), (0, 0), (0, 0)))

    merged = [ids[0], np.concatenate([pad(ids[1], 5), ids[2]], 3),
              np.concatenate([ids[3], pad(ids[4], 3)], 3), ids[5]]
    return merged, start - 1


def test_split_operand_holds_every_weight_once():
    """Every weight of the six real layers sits once in the image, and
    every other byte (K and N padding, zero halves) is zero: 54,512
    weights in SPLIT_BYTES = 56,320 bytes."""
    merged, n_weights = _merged_ids()
    img = FU.split_operand(merged)
    assert img.size == FU.SPLIT_BYTES == 56320
    held = np.sort(img[img != 0])
    assert n_weights == 54512
    assert (held == np.arange(1, n_weights + 1)).all()


def test_split_operand_equals_fused_weights_split():
    p = _params(37)
    fw = FU.FusedWeights.from_engine(p, "cpu")
    want = FU.split_operand([w.numpy() for w in MergedParams.from_engine(p, "cpu").w_i8])
    assert fw.split.dtype == torch.int8 and (fw.split.numpy() == want).all()


def test_kernel_source_mirrors_the_layout():
    """csrc/qvrcnn_fused.cu states, in a static_assert for every compiled
    tile instance, the regions it derives (blocks, expanded positions,
    planes, buffers, shared memory), and the template it instantiates
    (csrc/qvrcnn_split.cuh) its weight-image constants; each equals the
    Python layout the emulation runs. The instances are ops/fused.TILES,
    listed once in the source (QVRCNN_TILES), 24x40 first, each the
    template's Cfg with the folded epilogue, signed activations, one frame
    per work item and uint8 frames out (the emulation's GEN3)."""
    csrc = os.path.join(REPO, "qcnn_gpu_tpu_torch", "csrc")
    src = open(os.path.join(csrc, "qvrcnn_fused.cu")).read()
    split = open(os.path.join(csrc, "qvrcnn_split.cuh")).read()
    got = dict(re.findall(r"static_assert\((\w+) == (\d+)", split))
    want = {"W_BYTES": FU.SPLIT_BYTES, "N_S2": len(FU.SPLIT_CHUNKS[0]),
            "N_S3": len(FU.SPLIT_CHUNKS[1]), "N_S4": len(FU.SPLIT_CHUNKS[2])}
    assert {k: int(got[k]) for k in want} == want
    regions = {(int(th), int(tw)): tuple(int(v) for v in vals.split(", ")) for th, tw, vals in
               re.findall(r"static_assert\(regions<(\d+), (\d+)>\(([\d, ]+)\), \"\"\)", src)}
    tiles = re.search(r"#define QVRCNN_TILES\(X\) (.*)", src).group(1)
    assert [tuple(map(int, t)) for t in re.findall(r"X\((\d+), (\d+)\)", tiles)] == list(FU.TILES)
    assert FU.TILES[0] == (TH, TW) and set(regions) == set(FU.TILES)
    for (th, tw), got_t in regions.items():
        lay = FU.layout(th, tw)
        assert got_t == (*lay.blocks, lay.expanded, *lay.plane, lay.bytes,
                         FU.SPLIT_BYTES + 160 * 16 + lay.bytes), (th, tw)
    assert regions[TH, TW][:8] == (*FU.BLOCKS, FU.EXPANDED, *PL)
    cfg = re.search(r"using Gen3 = split::Cfg<split::Geometry<TH, TW>, split::(\w+), (\w+), (\d+), "
                    r"(\w+), STAGES, ZERO_A1>;", src).groups()
    assert cfg == ("Folded", "false", str(SE.GEN3.frames), "false") and not SE.GEN3.literal


@pytest.mark.parametrize("model", [22, 37, "int4"])
@pytest.mark.parametrize("n,h,w", [(1, 37, 53), (1, 13, 245)])
def test_emulation_matches_plain_and_pallas(model, n, h, w):
    from qcnn_gpu_tpu.ops.pallas_pipeline3 import build_pallas_forward3

    from qcnn_gpu_tpu_torch.data.model_files import read_static_qfp_pc

    p = _params(model)
    fw = FU.FusedWeights.from_engine(p, "cpu")
    x = _frames(n, h, w, seed=h + w)
    got = emulate(x, fw)
    assert (got == FU.fused_forward_reference(torch.from_numpy(x), fw).numpy()).all()
    jp = read_static_qfp_pc(INT4) if model == "int4" else None
    if jp is None:
        from qcnn_gpu_tpu.testing import synth_engine_params

        jp = synth_engine_params(model)
    assert (got == np.asarray(build_pallas_forward3(jp, th=8, interpret=True)(x))).all()


@pytest.mark.parametrize("bounds,design", [((3, 33, 5, 47), "gen3"), ((0, 30, 9, 53), "gen3"),
                                           ((3, 33, 5, 47), "gen1")],
                         ids=["bounds0", "bounds1", "gen1"])
def test_emulation_with_frame_bounds(bounds, design):
    """Every instance of the template takes frame bounds: generation 3's
    restored frames and generation 1's int16 residual equal their plain
    versions under the same bounds."""
    x = _frames(2, 37, 53, seed=5)
    if design == "gen1":
        from qcnn_gpu_tpu_torch.ops import literal as LI

        lw = LI.LiteralWeights.from_engine(_params(22), "cpu")
        want = LI.literal_residual_reference(torch.from_numpy(x), lw, *bounds).numpy()
        assert (SE.emulate(x, lw, SE.GEN1, bounds) == want).all()
        return
    fw = FU.FusedWeights.from_engine(_params(22), "cpu")
    want = FU.fused_forward_reference(torch.from_numpy(x), fw, *bounds).numpy()
    assert (emulate(x, fw, bounds) == want).all()


def test_emulation_tile_count_not_a_multiple_of_the_grid():
    """2 frames x 3 x 2 tiles on a grid of 5 blocks: blocks walk 2 or 3
    tiles each, across frames, through the same buffers."""
    fw = FU.FusedWeights.from_engine(_params("int4"), "cpu")
    x = _frames(2, 3 * TH - 5, 2 * TW - 3, seed=9)
    want = FU.fused_forward_reference(torch.from_numpy(x), fw).numpy()
    assert (emulate(x, fw, grid=5) == want).all()


def test_emulation_catches_a_read_of_a_stale_tail():
    """Without each stage zeroing its region's tail, a later tile's MMAs
    read bytes the previous tile left there: the emulation refuses."""
    fw = FU.FusedWeights.from_engine(_params(37), "cpu")
    x = _frames(1, 37, 53, seed=1)
    with pytest.raises(AssertionError, match="not written this tile"):
        emulate(x, fw, grid=1, zero_tails=False)


@pytest.mark.cuda
def test_cuda_kernel_matches_emulation():
    """On a GPU: the CUDA kernel equals the emulation (and so the plain
    version) on a frame of 2 x 2 tiles, batch 2, with frame bounds."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernel has no CPU mode")
    from qcnn_gpu_tpu_torch.data.model_files import read_static_qfp_pc

    p = EngineParams.from_arrays(read_static_qfp_pc(INT4))
    x = np.random.default_rng(3).integers(0, 256, size=(2, 37, 53)).astype(np.uint8)
    for bounds in ((), (2, 35, 4, 50)):
        got = FU.fused_forward(torch.from_numpy(x).cuda(), FU.FusedWeights.from_engine(p, "cuda"),
                               *bounds)
        torch.cuda.synchronize()
        want = emulate(x, FU.FusedWeights.from_engine(p, "cpu"), bounds)
        assert (got.cpu().numpy() == want).all(), bounds
