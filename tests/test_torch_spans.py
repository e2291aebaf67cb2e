"""Program spans (qcnn_gpu_tpu_torch/spans.py) on the CPU: nothing is
recorded, and no `record_function` entered, without a profiler; the
stream's and the engine's spans under one, on the threads that run them;
and the attribution of device events to spans on synthetic events
(correlation ids, threads, nesting)."""

import contextlib

import numpy as np
import pytest
import torch

from qcnn_gpu_tpu_torch import spans
from qcnn_gpu_tpu_torch.engine.runner import Engine
from qcnn_gpu_tpu_torch.engine.stream import Staging, pipeline_restore
from qcnn_gpu_tpu_torch.models import wide as W
from qcnn_gpu_tpu_torch.ops.int8_conv import conv_int8, gemm_operand
from qcnn_gpu_tpu_torch.testing import synth_engine_params, synth_frames

CPU = [torch.profiler.ProfilerActivity.CPU]


def every_thread():
    return torch._C._profiler._ExperimentalConfig(profile_all_threads=True)


def recorded(prof):
    """{span name: sorted list of the threads that recorded it}."""
    out = {}
    for name, tid, _, _ in spans.read_profiler(prof)[0]:
        out.setdefault(name, []).append(tid)
    return {k: sorted(v) for k, v in out.items()}


def test_span_is_a_shared_noop_without_a_profiler():
    assert spans.span(spans.CONV_GEMM) is spans.span(spans.STREAM_SEND)
    assert isinstance(spans.span(spans.CONV_GEMM), contextlib.nullcontext)
    with torch.profiler.profile(activities=CPU):
        assert isinstance(spans.span(spans.CONV_GEMM), torch.profiler.record_function)


def _wide():
    p = W.synth_wide_params(channels=16, blocks=2, seed=1)
    x = torch.from_numpy(synth_frames(2, 12, 16, seed=2))
    W.make_wide_forward(p, device="cpu", route="gemm")(x)


def _stream():
    batches = [synth_frames(2, 8, 12, seed=i) for i in range(4)]
    got = pipeline_restore(lambda x: x + 1, batches, depth=1, device="cpu")
    assert all(np.array_equal(g, b + 1) for g, b in zip(got, batches))


@pytest.mark.parametrize("path", [_wide, _stream], ids=["wide_gemm", "pipeline_restore"])
def test_no_record_function_without_a_profiler(monkeypatch, path):
    """Off, a span is the shared no-op: the card route and the stream
    never construct a `record_function` (~10 us each even unrecorded)."""

    def refuse(*a, **k):
        raise AssertionError("record_function entered with no profiler running")

    monkeypatch.setattr(torch.profiler, "record_function", refuse)
    path()


def test_gemm_route_spans_each_band():
    """A budget that cuts a frame into row bands: a pad, then per band its
    tap copy, GEMM and copy into the layer's output; one bias."""
    g = torch.Generator().manual_seed(3)
    x = torch.randint(-128, 128, (1, 9, 10, 8), dtype=torch.int8, generator=g)
    w = torch.randint(-128, 128, (3, 3, 8, 8), dtype=torch.int8, generator=g)
    b = torch.randint(-999, 999, (8,), dtype=torch.int32, generator=g)
    with torch.profiler.profile(activities=CPU) as prof:
        got = conv_int8(x, gemm_operand(w), b, route="gemm", budget=3000)
    assert torch.equal(got, conv_int8(x, w, b))  # the plain version
    counts = {k: len(v) for k, v in recorded(prof).items()}
    bands = counts[spans.CONV_GEMM]
    assert bands > 1
    assert counts == {spans.CONV_IM2COL: bands + 1, spans.CONV_GEMM: bands,
                      spans.CONV_ASSEMBLE: bands, spans.CONV_BIAS: 1}


def test_stream_spans_on_the_producer_and_the_fetcher():
    """Under profile_all_threads a CPU pipeline records each batch's send
    and its parts and the wait on the queue on the caller's thread, and
    its receive and sink on the fetcher's."""
    batches = [synth_frames(2, 8, 12, seed=i) for i in range(3)]
    with torch.profiler.profile(activities=CPU, experimental_config=every_thread()) as prof:
        pipeline_restore(lambda x: x + 1, batches, depth=1, device="cpu",
                         on_output=lambda a: None)
    by = recorded(prof)
    (caller,) = set(by[spans.STREAM_SEND])
    (fetcher,) = set(by[spans.STREAM_RECEIVE])
    assert caller != fetcher
    for name in (spans.STREAM_SEND, spans.STREAM_STAGE_IN, spans.STREAM_RUN,
                 spans.STREAM_BACKPRESSURE):
        assert by[name] == [caller] * 3, name
    for name in (spans.STREAM_RECEIVE, spans.STREAM_SINK):
        assert by[name] == [fetcher] * 3, name


def test_stream_fetcher_spans_need_every_thread():
    """With the profiler's default, the fetcher (started inside the
    window) records nothing; the producer's spans are there."""
    batches = [synth_frames(2, 8, 12, seed=i) for i in range(3)]
    with torch.profiler.profile(activities=CPU) as prof:
        pipeline_restore(lambda x: x + 1, batches, depth=1, device="cpu",
                         on_output=lambda a: None)
    by = recorded(prof)
    assert len(by[spans.STREAM_SEND]) == 3 and len(by[spans.STREAM_BACKPRESSURE]) == 3
    assert spans.STREAM_RECEIVE not in by and spans.STREAM_SINK not in by


def test_engine_output_span_once_a_stream():
    eng = Engine(device="cpu", impl="reference", batch_frames=2)
    eng.set_model(37, synth_engine_params(37))
    x = synth_frames(3, 8, 12, seed=4)
    with torch.profiler.profile(activities=CPU) as prof:
        out = eng.restore_stream(x, 37)
    assert np.array_equal(out, eng.restore(x, 37))
    counts = spans.host_seconds(spans.read_profiler(prof)[0])
    assert counts[spans.ENGINE_OUTPUT][0] == 1
    assert counts[spans.STREAM_SEND][0] == 2  # batches of 2 + 1
    assert all(t >= 0 for _, t in counts.values())


def test_innermost_span_at_each_time():
    sp = [("a", 0.0, 10.0), ("b", 1.0, 4.0), ("c", 2.0, 3.0), ("d", 5.0, 6.0)]
    assert spans.innermost(sp, [-1.0, 0.5, 1.5, 2.5, 3.5, 4.5, 5.5, 11.0]) == [
        None, "a", "b", "c", "b", "a", "d", None]
    assert spans.innermost([], [1.0]) == [None]


# synthetic events: spans (name, thread, start, end), launches (correlation,
# thread, time), device events (name, correlation, start, end)
SPANS = [
    ("stream.send", 1, 0.0, 10.0), ("stream.run", 1, 1.0, 9.0), ("conv.gemm", 1, 2.0, 3.0),
    ("conv.bias", 1, 4.0, 5.0),
    # the fetcher: its spans overlap the producer's in time
    ("stream.receive", 2, 1.5, 6.0), ("stream.wait", 2, 1.6, 5.9),
]
LAUNCHES = [(11, 1, 2.5), (12, 1, 4.5), (13, 1, 6.0), (14, 2, 2.6), (15, 3, 2.7)]
DEVICE = [
    ("gemm_kernel", 11, 20.0, 21.0),  # launched in conv.gemm
    ("elementwise", 12, 21.0, 22.0),  # in conv.bias
    ("elementwise", 13, 22.0, 22.5),  # in stream.run, no inner span
    ("copy", 14, 23.0, 24.0),  # launched by the fetcher, inside its wait
    ("other", 15, 24.0, 25.0),  # a thread with no span
    ("lost", 99, 25.0, 26.0),  # no launch recorded
]


def test_attribute_by_correlation_id_and_thread():
    got = {ev[0] + str(ev[1]): name for ev, name in spans.attribute(SPANS, LAUNCHES, DEVICE)}
    assert got == {"gemm_kernel11": "conv.gemm", "elementwise12": "conv.bias",
                   "elementwise13": "stream.run", "copy14": "stream.wait", "other15": None,
                   "lost99": None}


def test_attribute_ignores_another_threads_open_spans():
    """Thread 2's wait is open when thread 1 launches at 2.5: the kernel
    belongs to thread 1's innermost span, not to the later-opened wait."""
    only = [("k", 11, 0.0, 1.0)]
    ((_, name),) = spans.attribute(SPANS, LAUNCHES, only)
    assert name == "conv.gemm"
    ((_, name),) = spans.attribute([s for s in SPANS if s[1] == 2], LAUNCHES, only)
    assert name is None


def test_host_seconds_and_device_seconds_of_a_cpu_trace():
    with torch.profiler.profile(activities=CPU) as prof:
        for _ in range(2):
            with spans.span(spans.WIDE_INPUT):
                torch.ones(4).add_(1)
        with torch.profiler.record_function("bench.not_the_program"):
            pass
    counts = spans.host_seconds(spans.read_profiler(prof)[0])
    assert set(counts) == {spans.WIDE_INPUT} and counts[spans.WIDE_INPUT][0] == 2
    assert spans.device_seconds(prof) == {}  # no device on the CPU


def test_union_length_overlap():
    assert spans.union([(3, 4), (0, 1), (0.5, 2), (4, 5)]) == [[0, 2], [3, 5]]
    assert spans.length([[0, 2], [3, 5]]) == 4
    assert spans.overlap([[0, 2], [3, 5]], [[1, 3.5], [4.5, 6]]) == pytest.approx(2.0)


def test_staging_spans_on_the_cpu_ring():
    st = Staging("cpu", 3)
    a = synth_frames(1, 4, 6, seed=5)
    with torch.profiler.profile(activities=CPU) as prof:
        dev, ev = st.upload(st.take(), [a])
    assert ev is None and np.array_equal(dev.numpy(), a.reshape(-1))
    assert list(recorded(prof)) == [spans.STREAM_STAGE_IN]
