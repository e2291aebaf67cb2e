"""The port's packed wire transports (engine/packed.py) and its C++ copy
(qcnn_gpu_tpu_torch/native) on the CPU, against the JAX package's
engine/packed.py on the same seeded inputs. Payloads, restored frames and
wire byte counts: exact equality (tolerance 0)."""

import numpy as np
import pytest
import torch

from qcnn_gpu_tpu.engine import packed as JP
from qcnn_gpu_tpu.models import oracle as O
from qcnn_gpu_tpu.models.qvrcnn import make_forward as jax_make_forward
from qcnn_gpu_tpu.testing import synth_engine_params, synth_frames
from qcnn_gpu_tpu_torch import native
from qcnn_gpu_tpu_torch.engine import packed as P
from qcnn_gpu_tpu_torch.models.engine_params import EngineParams
from qcnn_gpu_tpu_torch.models.qvrcnn import make_forward


def _port_run(p):
    return make_forward(EngineParams.from_arrays(p), "cpu")


def _delta_case(kind):
    """(x, refs) uint8 [3, 40, 45]: 5400 px = 21 blocks + a 24-px tail."""
    rng = np.random.default_rng(11)
    h, w, b = 40, 45, 3
    bg = rng.integers(0, 256, (h, w), np.uint8)
    refs = np.broadcast_to(bg, (b, h, w)).copy()
    x = refs.copy()
    if kind == "classes":  # raw, nibble and zero blocks, a pointwise exception
        x[0, 4:20, :] = rng.integers(0, 256, (16, w), np.uint8)
        x[1] = np.clip(x[1].astype(np.int16) + rng.integers(-5, 6, (h, w)), 0, 255)
        x[1, 0, 0] = 255 if x[1, 0, 0] < 128 else 0
        x[2, -1, -5:] = x[2, -1, -5:] ^ 0x40  # the tail block
    else:  # deltas of +-255 in raw and nibble blocks
        refs[:] = 0
        x[:] = 0
        x[0, 2:10, :] = 255  # dense: raw blocks, |d| > 127 on the exception list
        refs[1, 5, 7] = 255  # -255 in a nibble block
        x[2, 30, 3] = 255
        x[2, -1, -1] = 255  # in the tail block
    return x, refs


@pytest.mark.parametrize("kind", ["classes", "pm255"])
def test_pack_payload_equals_jax_and_native(kind):
    x, refs = _delta_case(kind)
    port, n_port = P._pack_payload_numpy(x, refs)
    jax_, n_jax = JP._pack_payload_numpy(x, refs)
    nat, n_nat = native.duplex_pack(x, refs, P._bucket)
    assert n_port == n_jax == n_nat
    for a, b, c in zip(port, jax_, nat, strict=True):
        assert a.dtype == b.dtype == c.dtype and a.shape == b.shape == c.shape
        assert (a == b).all() and (a == c).all()
    nb = -(-x.size // 256)
    assert (port[2] < nb).any() and (port[4] < nb * 256).any()  # raw blocks, exceptions
    if kind == "classes":
        assert (port[0] < nb).any()  # nibble blocks
    else:
        assert 255 in port[5] and -255 in port[5]


@pytest.mark.parametrize("kind", ["classes", "pm255"])
def test_predict_changed_blocks_equals_jax_and_native(kind):
    x, refs = _delta_case(kind)
    got, nb = P._predict_changed_blocks(x, refs)
    want, jnb = JP._predict_changed_blocks(x, refs)
    nat, nnb = native.duplex_predict(x, refs)
    assert nb == jnb == nnb == -(-x.size // 256)
    assert got.dtype == nat.dtype == np.int32
    assert (got == want).all() and (got == nat).all() and got.size > 0


def test_native_duplex_decode8_equals_numpy():
    rng = np.random.default_rng(3)
    b, h, w = 3, 20, 27  # 1620 px: 6 blocks + a tail
    x = rng.integers(0, 256, (b, h, w), np.uint8)
    nbp = -(-x.size // 256)
    bidx = np.array([0, 2, 6, nbp, nbp], np.int32)  # the tail block, padding
    rows = rng.integers(-128, 128, (bidx.size, 256)).astype(np.int8)
    prev = rng.integers(-255, 256, (1, h, w)).astype(np.int16)
    want = P._duplex_decode8_numpy(x, rows, bidx, nbp, prev)
    got = native.duplex_decode8(x, rows, bidx, nbp, prev)
    assert (got[0] == want[0]).all() and (got[1] == want[1]).all()


def _shift_restorer(w, frac, seed):
    """A restorer with residuals past the nibble range at `frac` of pixels."""
    rng = np.random.default_rng(seed)
    shift = np.zeros((2, 24, w), np.int16)
    pos = rng.random(shift.shape) < frac
    shift[pos] = rng.integers(-200, 201, int(pos.sum())).astype(np.int16)
    shift[~pos] = rng.integers(-7, 8, int((~pos).sum())).astype(np.int16)

    def jax_run(x):
        import jax.numpy as jnp

        return jnp.clip(x.astype(jnp.int16) + jnp.asarray(shift), 0, 255).astype(jnp.uint8)

    def port_run(x):
        return (x.to(torch.int16) + torch.from_numpy(shift)).clamp(0, 255).to(torch.uint8)

    return shift, jax_run, port_run


@pytest.mark.parametrize("w", [64, 63])  # an odd width pads the last nibble
def test_make_packed_restore_equals_jax(w):
    shift, jax_run, port_run = _shift_restorer(w, 0.03, seed=0)
    x = synth_frames(2, 24, w, seed=9)
    want = np.clip(x.astype(np.int16) + shift, 0, 255).astype(np.uint8)
    packed, decode = P.make_packed_restore(port_run, capacity_frac=0.1)
    jpacked, _ = JP.make_packed_restore(jax_run, capacity_frac=0.1)
    got = [t.numpy() for t in packed(torch.from_numpy(x))]
    ref = [np.asarray(a) for a in jpacked(x)]
    for a, b in zip(got, ref, strict=True):
        assert a.dtype == b.dtype and a.shape == b.shape and (a == b).all()
    assert 0 < int(got[3]) <= got[1].size
    assert (decode(x, got) == want).all()
    assert (P._decode_residual_numpy(x, got) == want).all()
    assert (native.residual_decode(x, got[0], got[1], got[2], int(got[3])) == want).all()


def test_packed_overflow_raises_like_jax():
    _, jax_run, port_run = _shift_restorer(64, 0.5, seed=1)
    x = synth_frames(2, 24, 64, seed=2)
    packed, decode = P.make_packed_restore(port_run, capacity_frac=1e-4)
    fetched = packed(torch.from_numpy(x))
    jpacked, jdecode = JP.make_packed_restore(jax_run, capacity_frac=1e-4)
    assert int(fetched[3]) == int(np.asarray(jpacked(x)[3])) > fetched[1].numel()
    for dec in (decode, P._decode_residual_numpy):
        with pytest.raises(OverflowError):
            dec(x, fetched)
    with pytest.raises(OverflowError):
        jdecode(x, jpacked(x))


def test_packed_streaming_path():
    p = synth_engine_params(32)
    batches = [synth_frames(2, 32, 48, seed=s) for s in range(3)]
    packed, decode = P.make_packed_restore(_port_run(p))
    recs = []
    fps = P.measure_stream_fps_packed(
        packed, lambda x, f: recs.append(decode(x, f)), batches, 2, device="cpu")
    assert fps > 0 and len(recs) == 3
    for r, b in zip(recs, batches):
        assert (r == O.forward_blu(b, p)).all()


def _video_like(n_batches, b, h, w, seed):
    """Temporally correlated frames with occasional large jumps
    (tests/test_packed.py's _video_like_batches)."""
    rng = np.random.default_rng(seed)
    cur = rng.integers(0, 256, (h, w), np.int16)
    frames = []
    for _ in range(n_batches * b):
        step = rng.integers(-3, 4, (h, w), np.int16)
        big = rng.random((h, w)) < 0.01
        step[big] = rng.integers(-60, 61, int(big.sum())).astype(np.int16)
        cur = np.clip(cur + step, 0, 255)
        frames.append(cur.astype(np.uint8))
    fr = np.stack(frames)
    return [fr[i * b:(i + 1) * b] for i in range(n_batches)]


def _duplex_case(name):
    """(port run, JAX run, batches, the params the oracle restores with or
    None for the JAX run's output, the JAX transport's capacity_frac): the
    cases of tests/test_packed.py:107-248."""
    rng = np.random.default_rng({"chain": 5, "too_hot": 1, "dense": 4, "static": 3,
                                 "one_pixel": 8, "pm255": 2}[name])
    if name == "chain":  # odd width, video-like
        p = synth_engine_params(37)
        return _port_run(p), jax_make_forward(p, impl="int"), _video_like(3, 2, 32, 49, 5), p, 0.1
    if name == "too_hot":  # uncorrelated frames: every batch ships full
        a = rng.integers(0, 256, (2, 64, 64), np.uint8)
        b = rng.integers(0, 256, (2, 64, 64), np.uint8)
        return (lambda x: x.clone()), (lambda x: x), [a, b], None, 1e-4
    if name == "dense":  # a residual jump past int8: the dense fetch
        bg = rng.integers(0, 128, (64, 64), np.uint8)
        x0 = np.broadcast_to(bg, (2, 64, 64)).copy()
        x1 = x0.copy()
        x1[:, 10:20, 10:20] = rng.integers(0, 128, (2, 10, 10), np.uint8)
        x2 = x1.copy()
        x2[:, 30:40, 30:40] = rng.integers(0, 128, (2, 10, 10), np.uint8)

        def port_run(x):  # +200 once the background changed
            return x.clone() if int(x[0, 0, 0]) == 255 else (x.to(torch.int16) + 200).clamp(
                0, 255).to(torch.uint8)

        x0[:, 0, 0] = 255  # marks the first batch: identity there
        x1[:, 0, 0] = x2[:, 0, 0] = 0

        def jax_run(x):
            import jax.numpy as jnp

            return jnp.where(x[0, 0, 0] == 255, x,
                             jnp.clip(x.astype(jnp.int16) + 200, 0, 255).astype(jnp.uint8))

        return port_run, jax_run, [x0, x1, x2], None, 1.0 / 256
    if name == "static":  # static background, a moving uncorrelated square
        h, w, b = 128, 512, 2
        bg = rng.integers(0, 256, (h, w), np.uint8)
        batches = []
        for j in range(3):
            fr = np.broadcast_to(bg, (b, h, w)).copy()
            for i in range(b):
                x0 = ((j * b + i) * 16) % (w - 16)
                fr[i, 8:24, x0:x0 + 16] = rng.integers(0, 256, (16, 16), np.uint8)
            batches.append(fr)
        return (lambda x: x.clone()), (lambda x: x), batches, None, 1.0 / 256
    if name == "one_pixel":  # the prediction covers the receptive field
        p = synth_engine_params(32)
        base = rng.integers(0, 256, (40, 64), np.uint8)
        x0 = np.broadcast_to(base, (2, 40, 64)).copy()
        x1 = x0.copy()
        x1[:, 20, 30] ^= 0x55
        return _port_run(p), jax_make_forward(p, impl="int"), [x0, x1], p, 1.0 / 256
    # pm255: +-255 temporal deltas across a batch of 4, integrated in int16
    bg = rng.integers(0, 256, (32, 64), np.uint8)
    x0 = np.broadcast_to(bg, (4, 32, 64)).copy()
    x1 = x0.copy()
    x1[0, 3:5, 8:16] = 255
    x1[1, 3:5, 8:16] = 0
    x1[2, 3:5, 8:16] = 255
    x1[3, 3:5, 8:16] = 0
    return (lambda x: x.clone()), (lambda x: x), [x0, x1], None, 1.0 / 256


@pytest.mark.parametrize("name", ["chain", "too_hot", "dense", "static", "one_pixel", "pm255"])
def test_duplex_transport_equals_jax(name):
    """receive(x, send(x)) is the restorer's output, and the wire byte
    lists and the step kinds equal those of JAX's DuplexTransport."""
    port_run, jax_run, batches, p, cf = _duplex_case(name)
    tr = P.make_duplex_restore(port_run, "cpu")
    jtr = JP.make_duplex_restore(jax_run, capacity_frac=cf)
    kinds, jkinds = [], []
    for x in batches:
        want = O.forward_blu(x, p) if p is not None else np.asarray(jax_run(x))
        item, jitem = tr.send(x), jtr.send(x)
        kinds.append(item[0])
        jkinds.append(jitem[0])
        assert (tr.receive(x, item) == want).all()
        assert (jtr.receive(x, jitem) == want).all()
    assert kinds == jkinds
    assert tr.stats["h2d_bytes"] == jtr.stats["h2d_bytes"]
    assert tr.stats["d2h_bytes"] == jtr.stats["d2h_bytes"]
    assert tr.stats["full_steps"] + tr.stats["packed_steps"] == len(batches)
    if name == "too_hot":
        assert kinds == ["full", "full"]
    else:
        assert kinds[0] == "full" and "packed" in kinds[1:]
    assert tr.stats["dense_fetches"] == (1 if name == "dense" else 0)
    if name == "static":
        assert all(b < 0.6 * batches[0].nbytes for b in tr.stats["h2d_bytes"][1:])
        assert all(b < 0.6 * batches[0].nbytes for b in tr.stats["d2h_bytes"][1:])


def test_duplex_send_snapshots_prev_frame():
    p = synth_engine_params(37)
    tr = P.make_duplex_restore(_port_run(p), "cpu")
    buf = synth_frames(2, 32, 48, seed=40)
    assert (tr.receive(buf, tr.send(buf)) == O.forward_blu(buf, p)).all()
    buf[:] = 0  # a caller reusing its buffer must not move the reference frame
    nxt = synth_frames(2, 32, 48, seed=41)
    assert (tr.receive(nxt, tr.send(nxt.copy())) == O.forward_blu(nxt, p)).all()


def test_duplex_streaming_loop():
    p = synth_engine_params(27)
    batches = _video_like(4, 2, 32, 48, seed=7)
    tr = P.make_duplex_restore(_port_run(p), "cpu")
    recs = []
    assert P.measure_stream_fps_duplex(tr, batches, 2, on_output=recs.append) > 0
    assert len(recs) == 4
    for r, x in zip(recs, batches):
        assert (r == O.forward_blu(x, p)).all()


def test_warm_batches_pack_every_block_class():
    """The duplex warm-up's batches ship a full step, then packed steps
    with raw and nibble blocks, exceptions in both and predicted blocks,
    and restore exactly."""
    p = synth_engine_params(37)
    batches = P.warm_batches(5, 2, 96, 160)
    prev = batches[0][-1:]
    for x in batches[1:]:
        refs = np.concatenate([prev, x[:-1]], axis=0)
        (nib_idx, nib, raw_idx, raw_val, idx, val), _ = P._pack_payload_numpy(x, refs)
        assert min(nib_idx.size, raw_idx.size, idx.size) > 0
        assert (np.abs(val) > 127).any() and (np.abs(val[val != 0]) <= 127).any()
        assert P._predict_changed_blocks(x, refs)[0].size > 0
        prev = x[-1:]
    tr = P.make_duplex_restore(_port_run(p), "cpu")
    for x in batches:
        assert (tr.receive(x, tr.send(x)) == O.forward_blu(x, p)).all()
    assert tr.stats["full_steps"] == 1 and tr.stats["packed_steps"] == 4


def test_native_build_raises_without_gxx(monkeypatch, tmp_path):
    """No NumPy fallback: without a compiler the transport library raises."""
    monkeypatch.setattr(native, "_lib", None)
    monkeypatch.setattr(native, "BUILD", str(tmp_path))
    monkeypatch.setattr(native.shutil, "which", lambda name: None)
    with pytest.raises(RuntimeError, match="g\\+\\+ not found"):
        native.lib()


@pytest.mark.parametrize("shape", [(16, 1080, 1920), (3, 37, 53)])
def test_roundtrip_bytes_equal_jax(shape):
    assert P.packed_roundtrip_bytes(shape) == JP.packed_roundtrip_bytes(shape)
    assert P.duplex_roundtrip_bytes(shape) == JP.duplex_roundtrip_bytes(shape)
    assert P._h2d_layout(8, 16, 32, 64) == JP.DuplexTransport._h2d_layout(8, 16, 32, 64)
    assert [P._bucket(n) for n in (0, 1, 8, 9, 1000)] == [JP._bucket(n) for n in (0, 1, 8, 9, 1000)]
