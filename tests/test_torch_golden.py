"""The committed golden content through the port, on the CPU.

`qcnn_gpu_tpu_torch/data/golden.py` gives clips and decoded anchors equal
to the JAX module's (tolerance 0), and the committed models reproduce the
committed golden PSNRs through `Engine(device="cpu")` and its pipelined
`restore_stream` (tolerance: the goldens' +-0.01 dB, as
tests/test_golden_psnr.py holds the JAX engine): every 240p golden (float
and INT4, 4 QPs each), the 480p composite goldens, and, `slow`-marked, the
1080p and class-A goldens over the raw and the duplex transports (the
GPU smoke run does not assume matplotlib, so these run on the CPU)."""

import json
import os

import numpy as np
import pytest

from qcnn_gpu_tpu.data import golden as JG
from qcnn_gpu_tpu_torch.data import golden as G
from qcnn_gpu_tpu_torch.data import yuv
from qcnn_gpu_tpu_torch.engine.runner import Engine

TAGS = {"hopper_eval": "golden_clip", "composite_eval": "composite_clip",
        "fullhd_eval": "fullhd_clip", "classa_eval": "classa_clip"}


def _goldens(name):
    with open(os.path.join(G.GOLDEN_DIR, name)) as fp:
        return json.load(fp)


def _clip(fn):
    if fn == "golden_clip":
        return G.golden_clip()[1]
    if fn == "composite_clip":
        g = _goldens("psnr_golden_composite.json")
        return G.composite_clip(g["frames_eval"], phase=g["phase"])
    return getattr(G, fn)()


@pytest.fixture(scope="module")
def clips():
    return {}


def _cached(clips, fn):
    if fn not in clips:
        clips[fn] = _clip(fn)
    return clips[fn]


@pytest.mark.parametrize("tag", list(TAGS))
def test_clips_and_anchors_equal_jax(tag, clips):
    fn = TAGS[tag]
    mine = _cached(clips, fn)
    if fn == "golden_clip":
        train, theirs = JG.golden_clip()
        assert (G.golden_clip()[0] == train).all()
    elif fn == "composite_clip":
        g = _goldens("psnr_golden_composite.json")
        theirs = JG.composite_clip(g["frames_eval"], phase=g["phase"])
    else:
        theirs = getattr(JG, fn)()
    assert mine.dtype == np.uint8 and mine.shape == theirs.shape and (mine == theirs).all()
    for quality in G.QP_QUALITY.values():
        a = G.jpeg_anchor(mine, quality, tag)
        assert a.dtype == np.uint8 and (a == JG.jpeg_anchor(theirs, quality, tag=tag)).all()


def test_jpeg_anchor_never_encodes():
    frames = np.zeros((1, 8, 8), np.uint8)
    with pytest.raises(FileNotFoundError, match="never re-encodes"):
        G.jpeg_anchor(frames, 35, "no_such_clip")
    with pytest.raises(ValueError, match="committed anchors for 1 frames"):
        G.jpeg_anchor(frames, 35, "hopper_eval")


def _reproduce(clips, fn, tag, golden, model, fmt, qp, transports=("raw",), batch=4):
    g = _goldens(golden)["goldens"][str(qp)]
    clip = _cached(clips, fn)
    anchor = G.jpeg_anchor(clip, G.QP_QUALITY[qp], tag)
    assert yuv.psnr(anchor, clip) == pytest.approx(g["before"], abs=0.01)
    eng = Engine(device="cpu", batch_frames=batch)
    eng.load_model(qp, os.path.join(G.GOLDEN_DIR, model), fmt=fmt)
    recs = [eng.restore_stream(anchor, qp, transport=t) for t in transports]
    for rec in recs[1:]:
        assert (rec == recs[0]).all()
    after = yuv.psnr(recs[0], clip)
    assert after == pytest.approx(g["after"], abs=0.01)
    assert after > g["before"]
    return eng


@pytest.mark.parametrize("model,fmt,golden,qp", [
    (f"model_q{qp}.data", "vect_c", "psnr_golden.json", qp) for qp in sorted(G.QP_QUALITY)
] + [
    # per-channel INT4 models ship in the pc format, the scalar one (QP27)
    # in vect_c (psnr_golden_int4.json records which)
    (f"model_q{qp}_int4.data", "vect_c" if qp == 27 else "pc", "psnr_golden_int4.json", qp)
    for qp in sorted(G.QP_QUALITY)
])
def test_committed_models_reproduce_goldens(clips, model, fmt, golden, qp):
    """The 240p goldens: the committed trained models, decoding the
    committed JPEG anchor bytes, reproduce the committed PSNRs."""
    eng = _reproduce(clips, "golden_clip", "hopper_eval", golden, model, fmt, qp)
    assert eng.program_name(qp) == "kernel3"


@pytest.mark.parametrize("qp", [  # ~12 s each here: QPs 27 and 32 run with the slow tests
    22, pytest.param(27, marks=pytest.mark.slow), pytest.param(32, marks=pytest.mark.slow), 37,
])
def test_composite_goldens(clips, qp):
    """The 832x480 composite: content the models never trained on."""
    _reproduce(clips, "composite_clip", "composite_eval", "psnr_golden_composite.json",
               f"model_q{qp}.data", "vect_c", qp)


@pytest.mark.slow
@pytest.mark.parametrize("qp", sorted(G.QP_QUALITY))
def test_fullhd_goldens_raw_and_duplex(clips, qp):
    """1920x1080, 2 frames, over raw and duplex, one frame per batch."""
    _reproduce(clips, "fullhd_clip", "fullhd_eval", "psnr_golden_1080p.json",
               f"model_q{qp}.data", "vect_c", qp, ("raw", "duplex"), batch=1)


@pytest.mark.slow
@pytest.mark.parametrize("qp", [22, 37])  # the PSNR extremes, as the JAX test
def test_classa_goldens_raw_and_duplex(clips, qp):
    """2560x1600 (class A), 2 frames, over raw and duplex."""
    _reproduce(clips, "classa_clip", "classa_eval", "psnr_golden_classa.json",
               f"model_q{qp}.data", "vect_c", qp, ("raw", "duplex"), batch=1)
