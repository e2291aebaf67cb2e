"""Generation 2 on the split design (qcnn_gpu_tpu_torch/csrc/qvrcnn_pair.cu
over csrc/qvrcnn_split.cuh), emulated in numpy int64 on the CPU by
tests/torch_split_emulation.py: two frames per work item, the block
computing the item's 24x40 tile of one frame, then of the other, through
the same buffers. The emulation is held to the plain version
`pair_forward_reference` and to the Pallas TPU kernel
`build_pallas_forward2` (interpret mode) on an odd batch and a work-item
count that is not a multiple of the grid; it refuses a stage that does
not zero its tail, and each barrier dropped. The source's constants are
checked against the Python layout. Tolerance: 0 everywhere."""

import functools
import os
import re

import numpy as np
import pytest
import torch

from qcnn_gpu_tpu_torch.models.engine_params import EngineParams
from qcnn_gpu_tpu_torch.ops import fused as FU
from qcnn_gpu_tpu_torch.ops import pair as PA

import torch_split_emulation as SE

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC = os.path.join(REPO, "qcnn_gpu_tpu_torch", "csrc")
SMEM_LIMIT = 232448  # bytes of shared memory one block may use on an H100


def _synth(qp):
    from qcnn_gpu_tpu.testing import synth_engine_params

    return synth_engine_params(qp)


def _frames(n, h, w, seed):
    from qcnn_gpu_tpu.testing import synth_frames

    return synth_frames(n, h, w, seed=seed)


@functools.lru_cache(maxsize=None)
def _case(n, h, w, qp):
    """(frames, FusedWeights, Pallas v2's restored frames)."""
    from qcnn_gpu_tpu.ops.pallas_pipeline2 import build_pallas_forward2

    jp = _synth(qp)
    x = _frames(n, h, w, seed=n + h + w)
    fw = FU.FusedWeights.from_engine(EngineParams.from_arrays(jp), "cpu")
    return x, fw, np.asarray(build_pallas_forward2(jp, th=8, interpret=True)(x))


def _items(d, n, h, w):
    return -(-n // d.frames) * -(-h // d.th) * -(-w // d.tw)


@pytest.mark.parametrize("n,h,w,qp,grid", [(3, 37, 53, 22, 5), (3, 13, 245, 37, 3)])
def test_pair_emulation_matches_plain_and_pallas_v2(n, h, w, qp, grid):
    """An odd batch (the last frame alone) whose work items are no
    multiple of the grid: blocks walk different numbers of items."""
    d = SE.GEN2
    assert _items(d, n, h, w) > grid and _items(d, n, h, w) % grid
    x, fw, want = _case(n, h, w, qp)
    got = SE.emulate(x, fw, d, grid=grid)
    assert (got == PA.pair_forward_reference(torch.from_numpy(x), fw).numpy()).all()
    assert (got == want).all()


def _pair(**mutation):
    x, fw, _ = _case(3, 37, 53, 22)
    return SE.emulate(x, fw, SE.GEN2, grid=2, **mutation)


@pytest.mark.parametrize("barrier", range(SE.N_BARRIERS))
def test_pair_emulation_catches_a_dropped_barrier(barrier):
    """Each of the block's barriers is needed: without it, a warpgroup
    reads what another has not written yet."""
    with pytest.raises(AssertionError, match="not written this tile"):
        _pair(drop_barrier=barrier)


def test_pair_emulation_catches_a_read_of_a_stale_tail():
    with pytest.raises(AssertionError, match="not written this tile"):
        _pair(zero_tails=False)


def test_pair_source_mirrors_the_layout():
    """csrc/qvrcnn_pair.cu instantiates the template as the emulation's
    GEN2 design (24x40 tiles, two frames per work item), and its
    static_asserts equal the Python layout; the wrapper counts its work
    items on the same tile."""
    src = open(os.path.join(CSRC, "qvrcnn_pair.cu")).read()
    th, tw = map(int, re.search(r"Geometry<(\d+), (\d+)>", src).groups())
    cfg = re.search(r"split::Cfg<Geo, split::(\w+), (\w+), (\d+), (\w+)>", src).groups()
    d = SE.GEN2
    assert (th, tw) == (d.th, d.tw) == (FU.TILE_H, FU.TILE_W)
    assert cfg == ("Folded", "false", str(d.frames), "false")
    got = {k: int(v) for k, v in re.findall(r"static_assert\(([\w:]+) == (\d+)", src)}
    bytes_ = FU.layout(th, tw).bytes
    assert got == {"Geo::BYTES": bytes_,
                   "Pair::SMEM_BYTES": FU.SPLIT_BYTES + 160 * 16 + bytes_}  # one int4 a channel
    assert got["Pair::SMEM_BYTES"] == 218976 <= SMEM_LIMIT
    # the pair kernel runs over whole frames: no frame bounds in its entry
    entry = src[src.index("int qvrcnn_pair_forward("):]
    assert "split::launch<Pair>(" in entry and "split::Bounds{0, H, 0, W}" in entry
    assert "row_lo" not in entry.split(")")[0]


def _issued_macs_per_pixel(lay):
    """MACs the `wgmma` chunks issue per output pixel of a tile: S1's one
    chunk, S2's and S3's split chunks and S4's two, over each stage's
    64-position blocks."""
    per_position = [32 * FU.S1_N] + [sum(32 * c.n for c in s) for s in FU.SPLIT_CHUNKS]
    return sum(b * 64 * m for b, m in zip(lay.blocks, per_position)) / (lay.th * lay.tw)


def test_pair_tiles_fit_shared_memory():
    """Why the pair kernel computes its two frames in turn: two 24x40
    tiles' buffers, one for each frame at once, do not fit beside the
    weight image and the vectors; two 16x24 tiles do, but issue 1.18x
    generation 3's MACs per pixel (77,210) for their halo. Every tile
    generation 3 is compiled at fits one tile, 32x32 with 1,888 bytes to
    spare, and issues at most 1.07x 24x40's MACs per pixel."""
    fixed = FU.SPLIT_BYTES + 160 * 16
    assert fixed + 2 * FU.layout(24, 40).bytes > SMEM_LIMIT
    assert fixed + 2 * FU.layout(16, 24).bytes <= SMEM_LIMIT
    gen3 = _issued_macs_per_pixel(FU.layout(24, 40))
    assert round(gen3) == 77210
    assert round(_issued_macs_per_pixel(FU.layout(16, 24))) == 91136  # 1.18x
    assert SMEM_LIMIT - (fixed + FU.layout(32, 32).bytes) == 1888
    for th, tw in FU.TILES:
        assert fixed + FU.layout(th, tw).bytes <= SMEM_LIMIT
        assert _issued_macs_per_pixel(FU.layout(th, tw)) <= 1.07 * gen3


def test_split_kernels_issue_wgmma_only():
    """Generations 3, 2 and 1 are instances of the split template on
    `wgmma` (the literal one `.u8.s8` for S2-S4): no `mma.sync` outside the
    rate probe, no stage header of the first design, and no source keeps
    its own copy of the template's stages, epilogue, tile walk or window
    load: each launches `split::launch<...>`."""
    split = open(os.path.join(CSRC, "qvrcnn_split.cuh")).read()
    header = open(os.path.join(CSRC, "hopper_wgmma.cuh")).read()
    for name in ("qvrcnn_pair.cu", "qvrcnn_literal.cu", "qvrcnn_fused.cu"):
        src = open(os.path.join(CSRC, name)).read()
        assert "mma.sync.aligned" not in src
        assert '#include "qvrcnn_split.cuh"' in src
        assert "split::launch<" in src
        for own in ("__global__", "store_stage", "zero_tails", "stage1", "stage4", "load_window",
                    "emit_stage", "requant(", "mma_n", "<<<"):
            assert own not in src, (name, own)
    for shared in ("__global__", "store_stage", "zero_tails", "stage1", "stage4", "load_window",
                   "emit_stage", "struct Bounds", "int launch("):
        assert shared in split, shared
    assert "mma.sync.aligned" not in split and '#include "hopper_wgmma.cuh"' in split
    for n in (16, 48):
        assert f"wgmma.mma_async.sync.aligned.m64n{n}k32.s32.u8.s8" in header
    assert "mma_u8_n16" in split and "mma_u8_n48" in split
    assert not os.path.exists(os.path.join(CSRC, "qvrcnn_stage.cuh"))
