"""Generation 1 on the split design (qcnn_gpu_tpu_torch/csrc/qvrcnn_literal.cu
over csrc/qvrcnn_split.cuh), emulated in numpy int64 on the CPU by
tests/torch_split_emulation.py: generation 3's layout with uint8
activations, the literal BLU chain after S1-S3 and the int16 residual
clamped to +-255. The emulation is held to the plain version
`literal_residual_reference` and to the residual of the Pallas TPU kernel
`build_pallas_forward` (interpret mode, captured at its `pallas_call`),
on tables inside and outside the solver's saturation window, and it
refuses a stage that does not zero its tail, and each barrier dropped.
Tolerance: 0 everywhere."""

import dataclasses
import os
import re

import numpy as np
import pytest
import torch

from qcnn_gpu_tpu_torch.data.model_files import read_static_qfp_pc
from qcnn_gpu_tpu_torch.models.engine_params import EngineParams
from qcnn_gpu_tpu_torch.models.qvrcnn import MergedParams
from qcnn_gpu_tpu_torch.ops import fused as FU
from qcnn_gpu_tpu_torch.ops import literal as LI

import torch_split_emulation as SE
from test_torch_literal import INT4, _frames, _jax_v1, _moved, _synth

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC = os.path.join(REPO, "qcnn_gpu_tpu_torch", "csrc")


def _check(jp, x, grid=3, pallas=True):
    lw = LI.LiteralWeights.from_engine(EngineParams.from_arrays(jp), "cpu")
    got = SE.emulate(x, lw, SE.GEN1, grid=grid)
    assert got.dtype == np.int16
    assert (got == LI.literal_residual_reference(torch.from_numpy(x), lw).numpy()).all()
    if pallas:
        assert (got == _jax_v1(jp, x)[0]).all()


@pytest.mark.parametrize("model,geo", [(22, (1, 37, 53)), (37, (2, 13, 245)),
                                       ("int4", (1, 30, 90))])
def test_literal_emulation_matches_plain_and_pallas_v1(model, geo):
    jp = read_static_qfp_pc(INT4) if model == "int4" else _synth(model)
    _check(jp, _frames(*geo, seed=sum(geo)))


@pytest.mark.parametrize("layer,sign", [(2, +1), (4, -1)])
def test_literal_emulation_outside_saturation_window(layer, sign):
    """A BLU bound one output step above the window (a kept value can
    then reach 128) or below it."""
    _check(_moved(_synth(37), layer, sign), _frames(1, 37, 53, seed=layer))


def test_literal_emulation_activations_past_int8(monkeypatch):
    """S1's BLU bound raised by half: on uniform random frames the kept
    values reach past 127, which only the uint8 activations and the
    `.u8.s8` products of S2-S4 hold."""
    jp = _synth(37)
    blu = list(jp.blu_q)
    blu[0] = 3 * int(blu[0]) // 2
    x = np.random.default_rng(0).integers(0, 256, (1, 37, 53)).astype(np.uint8)
    peak = []
    requant = SE._requant

    def recording(acc, vec, cout, literal):
        v = requant(acc, vec, cout, literal)
        peak.append(int(v.max(initial=0)))
        return v

    monkeypatch.setattr(SE, "_requant", recording)
    _check(dataclasses.replace(jp, blu_q=tuple(blu)), x)
    assert 127 < max(peak) <= 255


def test_literal_emulation_tile_count_not_a_multiple_of_the_grid():
    """2 frames x 3 x 2 tiles on a grid of 5 blocks: blocks walk 2 or 3
    tiles each, across frames, through the same buffers."""
    x = _frames(2, 3 * FU.TILE_H - 5, 2 * FU.TILE_W - 3, seed=9)
    _check(read_static_qfp_pc(INT4), x, grid=5, pallas=False)


def test_literal_emulation_catches_a_read_of_a_stale_tail():
    lw = LI.LiteralWeights.from_engine(EngineParams.from_arrays(_synth(37)), "cpu")
    with pytest.raises(AssertionError, match="not written this tile"):
        SE.emulate(_frames(1, 37, 53, seed=1), lw, SE.GEN1, grid=1, zero_tails=False)


@pytest.mark.parametrize("barrier", range(SE.N_BARRIERS))
def test_literal_emulation_catches_a_dropped_barrier(barrier):
    """Each of the block's barriers is needed: without it, a warpgroup
    reads what another has not written yet."""
    lw = LI.LiteralWeights.from_engine(EngineParams.from_arrays(_synth(37)), "cpu")
    with pytest.raises(AssertionError, match="not written this tile"):
        SE.emulate(_frames(1, 37, 53, seed=1), lw, SE.GEN1, grid=1, drop_barrier=barrier)


def test_literal_weights_hold_the_split_image():
    """The literal kernel reads generation 3's weight image, packed from
    the same merged weights."""
    p = EngineParams.from_arrays(_synth(22))
    lw = LI.LiteralWeights.from_engine(p, "cpu")
    want = FU.split_operand([w.numpy() for w in MergedParams.from_engine(p, "cpu").w_i8])
    assert lw.split.dtype == torch.int8 and (lw.split.numpy() == want).all()
    assert torch.equal(lw.split, FU.FusedWeights.from_engine(p, "cpu").split)


def test_literal_source_mirrors_the_layout():
    """csrc/qvrcnn_literal.cu instantiates the template as the emulation's
    GEN1 design, and its static_asserts equal the Python layout: the tile's
    buffers and the shared memory (weights, two int4 per channel, buffers).
    Its C entry takes frame bounds."""
    src = open(os.path.join(CSRC, "qvrcnn_literal.cu")).read()
    th, tw = map(int, re.search(r"Geometry<(\d+), (\d+)>", src).groups())
    cfg = re.search(r"split::Cfg<Geo, split::(\w+), (\w+), (\d+), (\w+)>", src).groups()
    d = SE.GEN1
    assert (th, tw) == (d.th, d.tw)
    assert cfg == ("Literal", "true", str(d.frames), "true")
    got = {k: int(v) for k, v in re.findall(r"static_assert\(([\w:]+) == (\d+)", src)}
    bytes_ = FU.layout(th, tw).bytes
    assert got == {"Geo::BYTES": bytes_,
                   "Lit::SMEM_BYTES": FU.SPLIT_BYTES + 160 * 2 * 16 + bytes_}
    assert got["Lit::SMEM_BYTES"] == 221536 <= 232448
    # the entry takes frame bounds after H, W, as the wrapper passes them
    # (ops/literal._ARGTYPES), and hands them to the template clipped
    entry = src[src.index("int qvrcnn_literal_residual("):]
    params = [a.split()[-1].lstrip("*") for a in entry[entry.index("(") + 1:entry.index(")")]
              .split(",")]
    assert params == ["x", "res", "wsplit", "vec", "B", "H", "W", "row_lo", "row_hi", "col_lo",
                      "col_hi", "b4", "mul4", "shift4", "stream"]
    assert len(params) == len(LI._ARGTYPES)
    assert "split::Bounds::clipped(row_lo, row_hi, col_lo, col_hi, H, W)" in entry
