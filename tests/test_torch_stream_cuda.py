"""The pipelined stream and the wire transports on a CUDA GPU: pinned
staging buffers, every transport's reconstruction equal to
Engine.restore (tolerance 0), and no host synchronisation in the
producer's dispatch. Run on the card with
`python -m pytest --noconftest -m cuda tests/test_torch_stream_cuda.py`;
without a GPU every test skips. Imports no JAX module."""

import os

import numpy as np
import pytest
import torch

from qcnn_gpu_tpu_torch.engine import packed as P
from qcnn_gpu_tpu_torch.engine.runner import Engine
from qcnn_gpu_tpu_torch.engine.stream import pipeline_restore
from qcnn_gpu_tpu_torch.tools.profile import static_camera

MODEL = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
                     "assets", "golden", "model_q37.data")
N, H, W = 9, 160, 256  # batches of 4: two full batches and a tail of 1
# where the duplex's packed steps beat raw both ways (at 160x256 its
# predicted rows alone would outweigh raw's bytes, so every step goes full)
PACKS = (240, 416)


def _cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the streams and kernels have no CPU mode")


def _scene(seed, h=H, w=W):
    """chip_smoke.py's static camera (a textured square moving over a
    fixed background), small: the residual deltas fit int8, so the
    packed steps fetch the predicted blocks only."""
    return static_camera(N, h, w, seed)[1]


def _noise_scene(seed):
    """A white-noise square moving over a noise background: the net's
    residual jumps past int8 where it moves, so packed steps take the
    dense fetch."""
    rng = np.random.default_rng(seed)
    bg = rng.integers(0, 256, (H, W))
    sq = rng.integers(0, 256, (16, 16))
    frames = np.broadcast_to(bg, (N, H, W)).copy()
    for t in range(N):
        frames[t, 40:56, 8 + 8 * t:24 + 8 * t] = sq
    return np.clip(frames + rng.integers(-6, 7, (H, W)), 0, 255).astype(np.uint8)


def _engine(transport, h=H, w=W):
    eng = Engine(device="cuda", batch_frames=4)
    eng.load_model(37, MODEL)
    eng.warmup(37, h, w, N, transport=transport)
    return eng


@pytest.mark.cuda
def test_staging_buffers_are_pinned():
    _cuda()
    eng = _engine("duplex")
    rings = list(eng._staging.values()) + [t.staging for t in eng._duplex.values()]
    assert len(rings) == 2
    for st in rings:
        bufs = [b for b in st._in + st._out if b is not None]
        assert len(bufs) == 2 * st.slots and all(b.is_pinned() for b in bufs)


@pytest.mark.cuda
@pytest.mark.parametrize("transport", ["raw", "duplex", "auto"])
def test_every_transport_equals_restore(transport):
    _cuda()
    eng = _engine(transport)
    frames = _scene(1)
    want = eng.restore(frames, 37)
    for _ in range(2):  # the second stream continues the duplex carries
        assert (eng.restore_stream(frames, 37, transport=transport) == want).all()
    if transport == "duplex":
        # at this size a packed step's predicted rows would outweigh raw's
        # bytes: every step goes full, and the wire moves raw's bytes
        stream = eng.last_stream
        assert stream["packed_steps"] == 0 and stream["full_steps"] == N // 4
        assert stream["h2d_bytes"] == stream["d2h_bytes"] == frames.nbytes
    if transport == "auto":
        dec = eng.last_stream["auto"]
        assert len(dec["link_seconds"]) == len(dec["device_seconds"]) == 3


@pytest.mark.cuda
def test_duplex_packs_where_it_pays():
    """At 416x240 the packed steps serve the sparse D2H, and the wire
    moves fewer bytes than raw both ways."""
    _cuda()
    eng = _engine("duplex", *PACKS)
    frames = _scene(1, *PACKS)
    want = eng.restore(frames, 37)
    for _ in range(2):
        assert (eng.restore_stream(frames, 37, transport="duplex") == want).all()
    stream = eng.last_stream
    assert stream["packed_steps"] >= 1 and stream["dense_fetches"] < stream["packed_steps"]
    assert stream["h2d_bytes"] < frames.nbytes and stream["d2h_bytes"] < frames.nbytes


@pytest.mark.cuda
def test_duplex_dense_fetch_is_exact():
    _cuda()
    eng = _engine("duplex")
    frames = _noise_scene(4)
    want = eng.restore(frames, 37)
    for _ in range(2):
        assert (eng.restore_stream(frames, 37, transport="duplex") == want).all()
    assert eng.last_stream["dense_fetches"] >= 1


@pytest.mark.cuda
def test_duplex_int16_cumsum_at_pm255():
    """Temporal deltas of +-255 across a batch of 4 ride the raw blocks'
    exception list and are integrated by the device's int16 cumsum."""
    _cuda()
    rng = np.random.default_rng(5)
    x0 = np.broadcast_to(rng.integers(0, 256, (64, 128), np.uint8), (4, 64, 128)).copy()
    x1 = x0.copy()
    x1[0::2, 3:5, 8:24] = 255
    x1[1::2, 3:5, 8:24] = 0
    tr = P.make_duplex_restore(lambda x: x.clone(), "cuda")
    kinds = []
    for x in (x0, x1, x0):
        item = tr.send(x)
        kinds.append(item[0])
        assert (tr.receive(x, item) == x).all()
    assert kinds == ["full", "packed", "packed"]


@pytest.mark.cuda
def test_packed_d2h_streams_on_the_card():
    _cuda()
    eng = _engine("raw")
    frames = _scene(2)
    packed, decode = P.make_packed_restore(eng._program(37, frames.shape[-2:], 4),
                                           capacity_frac=1.0)  # room for all
    got = []
    pipeline_restore(packed, [frames[:4], frames[4:8]], 2, device="cuda",
                     on_output=lambda f: got.append([np.array(a) for a in f]))
    want = eng.restore(frames[:8], 37)
    assert (np.concatenate([decode(frames[4 * i:4 * i + 4], f) for i, f in enumerate(got)])
            == want).all()


@pytest.mark.cuda
def test_producer_dispatch_does_not_synchronise():
    """Under set_sync_debug_mode("error") any host synchronisation in the
    raw and duplex streams (a hidden nonzero, a pageable copy) raises."""
    _cuda()
    eng = _engine("duplex", *PACKS)
    frames = _scene(3, *PACKS)
    want = eng.restore(frames, 37)
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        raw = eng.restore_stream(frames, 37, transport="raw")
        duplex = eng.restore_stream(frames, 37, transport="duplex")
    finally:
        torch.cuda.set_sync_debug_mode(0)
    assert (raw == want).all() and (duplex == want).all()
    assert eng.last_stream["packed_steps"] >= 1
