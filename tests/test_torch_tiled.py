"""The port's host tiling (engine/tiled.py), over a plain program and over
`Engine.restore`: the windows equal the JAX package's `_windows`, the tiled restore equals the
whole frame on every pixel (ragged grids, one-axis tiling, tiles larger
than the frame: the cases of tests/test_engine.py:156-175) and the numpy
oracle, and at most `chunk` windows go to the program a call. Tolerance 0."""

import numpy as np
import pytest
import torch

from qcnn_gpu_tpu.engine.tiled import _windows as jax_windows
from qcnn_gpu_tpu.models import oracle as O
from qcnn_gpu_tpu.testing import synth_engine_params as jax_synth_params
from qcnn_gpu_tpu_torch.engine.runner import Engine
from qcnn_gpu_tpu_torch.engine.tiled import _windows, restore_tiled
from qcnn_gpu_tpu_torch.models.qvrcnn import make_forward
from qcnn_gpu_tpu_torch.testing import synth_engine_params, synth_frames

TILES = [(48, 64), (50, 130), (100, 57), (128, 256), (30, 200), (17, 23)]


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def case():
    """(frames, the oracle's whole-frame restore, the port's plain net as a
    numpy program)."""
    frames = synth_frames(2, 100, 130, seed=3)
    forward = make_forward(synth_engine_params(37), device="cpu")
    return (frames, O.forward_blu(frames, jax_synth_params(37)),
            lambda w: forward(torch.from_numpy(w)).numpy())


@pytest.mark.parametrize("size", [13, 100, 130, 240, 1080, 2160])
def test_windows_equal_jax(size):
    for tile in (1, 7, 17, 64, 540, 960, size - 1, size):
        for halo in (6, 9):
            win = min(tile + 2 * halo, size)
            assert _windows(size, tile, win) == jax_windows(size, tile, win)


@pytest.mark.parametrize("tile", TILES, ids=lambda t: f"{t[0]}x{t[1]}")
def test_restore_tiled_equals_the_whole_frame(case, tile):
    frames, whole, run = case
    assert (restore_tiled(run, frames, *tile) == whole).all()


@pytest.mark.parametrize("chunk", [1, 5, 1000])
def test_at_most_chunk_windows_a_call(case, chunk):
    """48x64 tiles of 100x130 frames: 3 x 3 windows of 60x76 a frame, 18 in
    all, sent `chunk` at a time (the last call takes the rest); the
    identity program stitches back the frames."""
    frames = case[0]
    calls = []

    def counted(w):
        calls.append(w.shape)
        return w

    assert (restore_tiled(counted, frames, 48, 64, chunk=chunk) == frames).all()
    sizes = [s[0] for s in calls]
    assert sum(sizes) == 18 and max(sizes) <= chunk and len(calls) == -(-18 // chunk)
    assert {s[1:] for s in calls} == {(60, 76)}


def test_frames_within_one_window_go_whole(case):
    frames = case[0]
    calls = []
    got = restore_tiled(lambda w: calls.append(w.shape) or w + 1, frames, 90, 125)
    assert (got == frames + 1).all() and calls == [frames.shape]


def test_guards():
    f = synth_frames(1, 64, 64, seed=1)
    with pytest.raises(ValueError, match="receptive radius"):
        restore_tiled(lambda t: t, f, halo=3)
    with pytest.raises(ValueError, match="chunk"):
        restore_tiled(lambda t: t, f, 16, 16, chunk=0)
    with pytest.raises(TypeError, match="int16"):
        restore_tiled(lambda t: t.astype(np.int16), f, 16, 16)


@pytest.mark.parametrize("impl", ["kernel3", "reference"])
def test_restore_tiled_over_engine_restore_equals_whole(case, impl, monkeypatch):
    """restore_tiled over Engine.restore (48x64 tiles, chunk = batch_frames
    = 4) == the whole frame: 18 windows of 60x76 in 5 program calls of at
    most 4."""
    frames, whole, _ = case
    eng = Engine(device="cpu", impl=impl, batch_frames=4)
    eng.set_model(37, synth_engine_params(37))
    shapes = []
    program = eng._program

    def counted(qp, geo, batch):
        run = program(qp, geo, batch)
        return lambda x: shapes.append(tuple(x.shape)) or run(x)

    monkeypatch.setattr(eng, "_program", counted)
    got = restore_tiled(lambda w: eng.restore(w, 37), frames, 48, 64, chunk=4)
    assert (got == whole).all()
    assert len(shapes) == 5 and max(s[0] for s in shapes) <= 4 and {s[1:] for s in shapes} == {(60, 76)}
