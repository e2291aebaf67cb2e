"""The port's pipelined streaming (engine/stream.py) and Engine.restore_stream
on the CPU, against the JAX package's pipeline_restore and Engine, the
numpy oracle, and Engine.restore. Restored frames: exact equality of
bytes (tolerance 0)."""

import functools
import threading
import time
import tracemalloc
import types

import numpy as np
import pytest
import torch

from qcnn_gpu_tpu.engine.runner import Engine as JEngine
from qcnn_gpu_tpu.engine.stream import pipeline_restore as jax_pipeline_restore
from qcnn_gpu_tpu.models import oracle as O
from qcnn_gpu_tpu.models.qvrcnn import make_forward as jax_make_forward
from qcnn_gpu_tpu.testing import synth_engine_params, synth_frames
from qcnn_gpu_tpu_torch import cli
from qcnn_gpu_tpu_torch.engine import packed as P
from qcnn_gpu_tpu_torch.engine import stream as S
from qcnn_gpu_tpu_torch.engine.runner import Engine
from qcnn_gpu_tpu_torch.engine.stream import (
    RawTransport,
    Staging,
    measure_stream_fps,
    pipeline,
    pipeline_restore,
)
from qcnn_gpu_tpu_torch.models.engine_params import EngineParams
from qcnn_gpu_tpu_torch.ops.fused import FusedWeights, fused_forward


@pytest.fixture(scope="module")
def setup():
    p = synth_engine_params(37)
    run = functools.partial(fused_forward, fw=FusedWeights.from_engine(
        EngineParams.from_arrays(p), "cpu"))
    batches = [synth_frames(2, 24, 40, seed=i) for i in range(4)]
    golds = [O.forward_blu(b, p) for b in batches]
    return p, run, batches, golds


def static_scene(n, h, w, seed):
    """A static camera: one seeded background plus one fixed noise field,
    with a seeded 8x8 square moving 4 px a frame; anchors add a second
    fixed +-6 noise field (the same every frame)."""
    rng = np.random.default_rng(seed)
    bg = rng.integers(40, 216, (h, w)) + rng.integers(-3, 4, (h, w))
    sq = rng.integers(0, 256, (8, 8))
    frames = np.broadcast_to(bg, (n, h, w)).copy()
    for t in range(n):
        x0 = (4 + 4 * t) % (w - 8)
        frames[t, 4:12, x0:x0 + 8] = sq
    noise = rng.integers(-6, 7, (h, w))
    return np.clip(frames + noise, 0, 255).astype(np.uint8)


@pytest.mark.parametrize("depth", [1, 2, 4])
def test_pipeline_restore_order_and_values(setup, depth):
    p, run, batches, golds = setup
    outs = pipeline_restore(run, batches, depth, device="cpu")
    want = jax_pipeline_restore(jax_make_forward(p, impl="int"), batches, depth=depth)
    assert len(outs) == len(want) == len(batches)
    for o, w, g in zip(outs, want, golds):
        assert o.dtype == np.uint8 and (o == w).all() and (o == g).all()


def test_pipeline_restore_on_output_sink(setup):
    _, run, batches, golds = setup
    got = []
    assert pipeline_restore(run, batches, 3, device="cpu", on_output=got.append) == []
    assert len(got) == len(batches)
    for o, g in zip(got, golds):
        assert (o == g).all()


def _bounded(fn):
    """Run fn on a thread with a 60 s join: a deadlock fails, not hangs."""
    box = {}

    def target():
        try:
            fn()
        except BaseException as e:  # handed to the test's thread
            box["err"] = e

    th = threading.Thread(target=target, daemon=True)
    th.start()
    th.join(60)
    assert not th.is_alive(), "pipeline_restore deadlocked"
    return box.get("err")


def test_pipeline_restore_propagates_run_error(setup):
    _, _, batches, _ = setup

    def boom(x):
        raise RuntimeError("kaboom")

    err = _bounded(lambda: pipeline_restore(boom, batches, 2, device="cpu"))
    assert isinstance(err, RuntimeError) and "kaboom" in str(err)


@pytest.mark.parametrize("depth", [1, 3])
def test_pipeline_restore_propagates_sink_error_without_deadlock(setup, depth):
    _, run, batches, _ = setup

    def bad_sink(a):
        raise ValueError("sink broke")

    err = _bounded(lambda: pipeline_restore(run, batches, depth, device="cpu",
                                            on_output=bad_sink))
    assert isinstance(err, ValueError) and "sink broke" in str(err)


@pytest.mark.parametrize("where", ["run", "sink"])
@pytest.mark.parametrize("kind", ["raw", "duplex"])
def test_pipeline_over_each_transport_raises_and_frees_its_slots(setup, kind, where):
    """`pipeline` is one loop for both transports: an error in the
    producer's program or in the sink reaches the caller without a
    deadlock, every slot is free afterwards, and the staging streams
    again, exactly."""
    p, run, _, _ = setup
    st = Staging("cpu", 4)
    calls = {"n": 0}

    def flaky(x):
        calls["n"] += 1
        if where == "run" and calls["n"] == 3:
            raise RuntimeError("kaboom")
        return run(x)

    def sink(a):
        if where == "sink":
            raise RuntimeError("kaboom")

    def make(r):
        return RawTransport(r, st) if kind == "raw" else P.DuplexTransport(r, "cpu", st)

    frames = static_scene(10, 24, 40, seed=9)
    batches = [frames[i:i + 2] for i in range(0, 10, 2)]
    err = _bounded(lambda: pipeline(make(flaky), batches, 2, on_output=sink))
    assert isinstance(err, RuntimeError) and "kaboom" in str(err)
    assert not any(st._busy)
    got = pipeline(make(run), batches, 2)
    assert len(got) == len(batches)
    for g, b in zip(got, batches):
        assert (g == O.forward_blu(b, p)).all()


def test_pipeline_restore_tuple_outputs(setup):
    """A program with a tuple output (the packed D2H) streams component-wise."""
    _, run, batches, golds = setup
    packed, decode = P.make_packed_restore(run)
    got = pipeline_restore(packed, batches, 2, device="cpu")
    for x, fetched, g in zip(batches, got, golds):
        assert len(fetched) == 4 and (decode(x, fetched) == g).all()


def test_measure_stream_fps_counts_frames(setup):
    _, run, batches, _ = setup
    assert measure_stream_fps(run, batches, 2, device="cpu") > 0


def _measure(which, run, batches):
    if which == "raw":
        return measure_stream_fps(run, batches, 2, device="cpu")
    packed, decode = P.make_packed_restore(run)
    return P.measure_stream_fps_packed(packed, decode, batches, 2, device="cpu")


@pytest.mark.parametrize("which", ["raw", "packed"])
def test_measure_windows_reserve_before_the_clock(setup, monkeypatch, which):
    """The raw and packed windows build their staging and size its ring to
    the largest batch (raw: the input's bytes each way; packed: the
    payload's four 16-byte aligned arrays) before the clock's first read,
    and build or grow none after it."""
    _, _, batches, _ = setup
    batches = batches + [synth_frames(3, 24, 40, seed=9)]  # the largest is not the first
    run = lambda x: x + 1  # noqa: E731
    events = []
    init, reserve = Staging.__init__, Staging.reserve

    def spy_init(self, *a, **k):
        events.append("staging")
        init(self, *a, **k)

    def spy_reserve(self, in_bytes, out_bytes):
        events.append(("reserve", in_bytes, out_bytes))
        reserve(self, in_bytes, out_bytes)

    clock = types.SimpleNamespace(perf_counter=lambda: events.append("clock") or time.perf_counter())
    monkeypatch.setattr(Staging, "__init__", spy_init)
    monkeypatch.setattr(Staging, "reserve", spy_reserve)
    monkeypatch.setattr(S, "time", clock)
    monkeypatch.setattr(P, "time", clock)
    assert _measure(which, run, batches) > 0
    big = 3 * 24 * 40
    out = big if which == "raw" else Staging.offsets(P.packed_sizes((3, 24, 40)))[-1]
    assert out == (big if which == "raw" else 1440 + 4096 + 2048 + 16)
    assert events == ["staging", ("reserve", big, out), "clock", "clock"]


@pytest.mark.parametrize("shape", [(3, 24, 40), (2, 17, 33), (4, 256, 320)])
def test_packed_sizes_are_the_payload(shape):
    """The ring the packed window reserves is sized from `packed_sizes`:
    it names the bytes of each array `_pack_residual` ships, for an odd
    width and for a batch past the 1024-slot floor of the exception list."""
    x = torch.from_numpy(synth_frames(*shape, seed=4))
    got = P._pack_residual(lambda t: (t.to(torch.int16) * 3 // 2).clamp(0, 255).to(torch.uint8),
                           x, P.CAPACITY_FRAC)
    assert tuple(t.numel() * t.element_size() for t in got) == P.packed_sizes(shape)
    assert sum(P.packed_sizes(shape)) == P.packed_roundtrip_bytes(shape)[1]


@pytest.mark.parametrize("which", ["raw", "packed"])
def test_measure_windows_keep_no_output(which):
    """The windows discard what they restore (the JAX function's
    `on_output=lambda a: None`, stream.py:114): what the stream allocates on
    the host at its peak stays far below the frames it restores (a result
    array of them all was allocated and written inside the window)."""
    batches = [synth_frames(4, 128, 128, seed=i) for i in range(16)]
    total = sum(b.nbytes for b in batches)
    run = lambda x: x + 1  # noqa: E731
    _measure(which, run, batches[:1])  # imports and first-call allocations
    tracemalloc.start()
    try:
        assert _measure(which, run, batches) > 0
        peak = tracemalloc.get_traced_memory()[1]
    finally:
        tracemalloc.stop()
    assert peak < total // 4, (peak, total)


def test_staging_slots_are_taken_in_turn():
    st = Staging("cpu", slots=2)
    a, b = st.take(), st.take()
    assert (a, b) == (0, 1)
    with pytest.raises(RuntimeError, match="still holds a batch"):
        st.take()
    st.release(a)
    assert st.take() == 0
    with pytest.raises(ValueError, match="needs a staging of >= 4 slots"):
        pipeline_restore(lambda x: x, [np.zeros((1, 2, 2), np.uint8)], 2, device="cpu",
                         staging=Staging("cpu", slots=3))


def _engines(p, bs=2):
    eng = Engine(device="cpu", batch_frames=bs)
    eng.set_model(37, EngineParams.from_arrays(p))
    jeng = JEngine(impl="int", batch_frames=bs)
    jeng.set_model(37, p)
    return eng, jeng


@pytest.mark.parametrize("transport", ["raw", "duplex", "auto"])
def test_engine_restore_stream_transports_match_jax(transport):
    """7 frames in batches of 2: three full batches and a ragged tail of 1
    (raw under duplex); two streams in a row continue the duplex carries.
    Engine.restore is held to the oracle in test_torch_engine.py."""
    p = synth_engine_params(37)
    eng, jeng = _engines(p)
    frames = static_scene(7, 48, 80, seed=3)
    want = eng.restore(frames, 37)
    assert (jeng.restore_stream(frames, 37, transport=transport) == want).all()
    for _ in range(2):
        assert (eng.restore_stream(frames, 37, transport=transport) == want).all()
    stream = eng.last_stream
    if transport == "duplex":
        assert stream["served"] == "duplex" and stream["packed_steps"] >= 1
        assert stream["raw_tail_frames"] == 1
        assert stream["h2d_bytes"] < frames.nbytes and stream["d2h_bytes"] < frames.nbytes
    elif transport == "raw":
        assert stream == {"served": "raw", "h2d_bytes": frames.nbytes,
                          "d2h_bytes": frames.nbytes}
    else:
        dec = stream["auto"]
        assert stream["served"] == dec["transport"] in ("raw", "duplex")
        assert len(dec["link_seconds"]) == len(dec["device_seconds"]) == 3
        assert dec["link_fps"] == 2 / min(dec["link_seconds"])
        assert dec["device_fps"] == 2 / min(dec["device_seconds"])
        assert list(eng.transport_decisions) == [(37, (48, 80), 2)]  # probed once


def test_engine_auto_follows_a_link_bound_decision():
    p = synth_engine_params(37)
    eng, _ = _engines(p)
    frames = static_scene(4, 48, 80, seed=4)
    eng.transport_decisions[(37, (48, 80), 2)] = {
        "transport": "duplex", "link_mbps": 1.0, "link_fps": 0.5, "device_fps": 100.0,
    }
    got = eng.restore_stream(frames, 37, transport="auto")
    assert (got == O.forward_blu(frames, p)).all()
    assert eng.last_stream["served"] == "duplex"


def test_engine_duplex_failure_raises_and_evicts(monkeypatch):
    """No demotion: a failed duplex step raises. The transport, whose
    carries may be out of step, is evicted; the next stream starts afresh
    and is exact."""
    p = synth_engine_params(37)
    eng, _ = _engines(p)
    frames = static_scene(6, 48, 80, seed=5)
    want = O.forward_blu(frames, p)
    calls = {"n": 0}
    orig = P.DuplexTransport.receive

    def flaky(self, x, item, sink=None):
        calls["n"] += 1
        if calls["n"] == 2:
            raise RuntimeError("injected link failure")
        return orig(self, x, item, sink)

    monkeypatch.setattr(P.DuplexTransport, "receive", flaky)
    with pytest.raises(RuntimeError, match="injected link failure"):
        eng.restore_stream(frames, 37, transport="duplex")
    assert (37, (48, 80), 2) not in eng._duplex
    monkeypatch.setattr(P.DuplexTransport, "receive", orig)
    assert (eng.restore_stream(frames, 37, transport="duplex") == want).all()


def test_duplex_stream_records_its_host_seconds():
    """A duplex stream's `last_stream` sums the transport's host timers:
    each part within its whole, and the profile's split reads them."""
    from qcnn_gpu_tpu_torch.tools.profile import duplex_host_split

    p = synth_engine_params(37)
    eng, _ = _engines(p)
    frames = static_scene(6, 48, 80, seed=6)
    eng.restore_stream(frames, 37, transport="duplex")
    s = eng.last_stream
    assert s["packed_steps"] >= 1
    assert s["t_pack"] + s["t_predict"] + s["t_dispatch"] <= s["t_send"] + 1e-9
    assert s["t_fetch"] + s["t_decode"] <= s["t_receive"] + 1e-9
    assert min(s[k] for k in s if k[:2] == "t_") >= 0 and s["t_send"] > 0 < s["t_receive"]
    line = duplex_host_split(s, 1.0)
    assert line.startswith("window 1000.000 ms; producer: send ") and "fetcher: receive" in line


@pytest.mark.parametrize("transport", ["duplex", "auto"])
def test_cli_run_transport_matches_jax_cli(tmp_path, capsys, transport):
    from qcnn_gpu_tpu import cli as jcli
    from qcnn_gpu_tpu.data import yuv
    from qcnn_gpu_tpu.data.model_files import write_static_qfp_vect_c

    anchor = static_scene(9, 48, 80, seed=6)
    ori = static_scene(9, 48, 80, seed=7)
    yuv.write_y_as_420(str(tmp_path / "ori.yuv"), ori)
    yuv.write_y_as_420(str(tmp_path / "anchor.yuv"), anchor)
    write_static_qfp_vect_c(str(tmp_path / "m.data"), synth_engine_params(37))
    args = ["run", "--ori", str(tmp_path / "ori.yuv"), "--anchor", str(tmp_path / "anchor.yuv"),
            "--height", "48", "--width", "80", "--frames", "9",
            "--model", str(tmp_path / "m.data"), "--qp", "37", "--transport", transport]
    for name, mod, extra in (("port", cli, ["--device", "cpu"]), ("jax", jcli, ["--impl", "int"])):
        (tmp_path / name).mkdir()
        assert mod.main(args + extra + ["--out-dir", str(tmp_path / name),
                                        "--recon", str(tmp_path / name / "recon.yuv")]) == 0
    lines = capsys.readouterr().out.splitlines()
    assert lines[0] == lines[3] and lines[1] == lines[4]
    rec = {n: yuv.read_y(str(tmp_path / n / "recon.yuv"), 48, 80, 9) for n in ("port", "jax")}
    assert (rec["port"] == rec["jax"]).all()
    import json

    run = json.loads((tmp_path / "port" / "runs.jsonl").read_text())
    served = run["transport"]["served"]
    assert f"transport={served}" in lines[2]
    assert run["impl"] == "kernel3" + ("+duplex" if served == "duplex" else "")
    if transport == "duplex":
        assert served == "duplex" and run["transport"]["packed_steps"] >= 1
    else:
        assert len(run["transport"]["auto"]["device_seconds"]) == 3
