"""The program's spans in a trace (`benchmark/spans.py`) and the five
readers of them, on synthetic host and device events: device events put
down to spans by launch order on the compute stream, the copy streams'
launches set aside, the fetcher's spans ignored, a record the profiler
dropped skipped, nothing attributed where too many are, and nothing read
from a trace without spans. The `cuda` test reads them from a traced run
on the card:

    python -m pytest -m cuda benchmark/tests/test_benchmark_spans.py
"""

import json
import subprocess
import sys

import pytest
import torch

from benchmark import harness, spans
from benchmark.harness import Context
from benchmark.trace import Trace

# two batches on a 10 s window. The producer: batch 1 sent 0-3 (stage_in
# 0-0.5, upload 0.5-0.6 with its H2D launch, run 0.6-2.5 with a GEMM, a
# bias, a copy into the layer's output, and a kernel in no inner span,
# download 2.5-2.6 with its D2H launch), then waits 3-6; batch 2 sent 6-8,
# one im2col launch in its run. The fetcher's spans overlap all of it.
HOST = [
    ("bench.stream", 0.0, 10.0),
    ("stream.send", 0.0, 3.0), ("stream.stage_in", 0.0, 0.5), ("stream.upload", 0.5, 0.6),
    ("cudaMemcpyAsync", 0.55, 0.56),
    ("stream.run", 0.6, 2.5),
    ("conv.gemm", 0.7, 0.9), ("cuLaunchKernel", 0.8, 0.81),
    ("conv.bias", 1.0, 1.2), ("aten::add_", 1.05, 1.15), ("cudaLaunchKernel", 1.1, 1.11),
    ("conv.assemble", 1.3, 1.5), ("cudaMemcpyAsync", 1.4, 1.41),
    ("cudaLaunchKernel", 2.0, 2.01),
    ("stream.download", 2.5, 2.6), ("cudaEventRecord", 2.51, 2.52),
    ("cudaMemcpyAsync", 2.55, 2.56),
    ("stream.backpressure", 3.0, 6.0),
    ("stream.send", 6.0, 8.0), ("stream.stage_in", 6.0, 6.2), ("stream.upload", 6.2, 6.3),
    ("cudaMemcpyAsync", 6.25, 6.26), ("stream.run", 6.3, 7.9),
    ("conv.im2col", 6.4, 6.6), ("cudaLaunchKernel", 6.5, 6.51),
    ("stream.download", 7.9, 8.0), ("cudaMemcpyAsync", 7.95, 7.96),
    ("stream.backpressure", 8.0, 8.5),
    ("stream.receive", 0.7, 9.0), ("stream.wait", 0.75, 8.9), ("cudaEventSynchronize", 0.8, 8.9),
]
DEVICE = [  # the compute stream in launch order, then the copy streams
    ("cutlass_80_tensorop_i16832gemm_s8_128x64_128x3", 1.0, 2.0),
    ("vectorized_elementwise_kernel", 2.0, 2.5),
    ("Memcpy DtoD (Device -> Device)", 2.5, 3.0),
    ("CatArrayBatchedCopy", 3.0, 3.1),
    ("elementwise_kernel", 6.6, 7.0),
    ("Memcpy HtoD (Pinned -> Device)", 0.6, 0.9),
    ("Memcpy HtoD (Pinned -> Device)", 6.3, 6.5),
    ("Memcpy DtoH (Device -> Pinned)", 3.1, 3.3),
    ("Memcpy DtoH (Device -> Pinned)", 7.0, 7.2),
]


def ctx(host=HOST, device=DEVICE, frames=8):
    return Context(frames=frames, window_s=10.0, setup_s=1.0, ops_per_frame=1, peak_ops=None,
                   trace=Trace.from_events(device, host, 10.0))


def read(name, c):
    return harness.reader(name)(c)


def test_innermost_span_at_each_time():
    sp = [("a", 0.0, 10.0), ("b", 1.0, 4.0), ("c", 2.0, 3.0), ("d", 5.0, 6.0)]
    assert spans.innermost(sp, [-1.0, 0.5, 1.5, 2.5, 3.5, 4.5, 5.5, 11.0]) == [
        None, "a", "b", "c", "b", "a", "d", None]


def test_compute_stream_events_by_launching_span():
    by = spans.launched(ctx().trace)
    assert dict(by) == {"conv.gemm": [(1.0, 2.0)], "conv.bias": [(2.0, 2.5)],
                        "conv.assemble": [(2.5, 3.0)], "stream.run": [(3.0, 3.1)],
                        "conv.im2col": [(6.6, 7.0)]}


def test_device_readers():
    c = ctx()
    assert read("im2col_ms_per_frame", c) == pytest.approx(1e3 * 0.4 / 8)
    assert read("assemble_ms_per_frame", c) == pytest.approx(1e3 * 0.5 / 8)
    assert read("requant_ms_per_frame", c) == pytest.approx(1e3 * 0.5 / 8)
    # with the GEMMs and the kernel outside every inner span, they make up
    # the epilogue's time
    rest = 1e3 * 0.1 / 8
    assert (read("im2col_ms_per_frame", c) + read("assemble_ms_per_frame", c)
            + read("requant_ms_per_frame", c) + rest) == pytest.approx(
                read("epilogue_ms_per_frame", c))


def test_stream_readers():
    c = ctx()
    # stage_in, upload, download: 0.5 + 0.1 + 0.1 and 0.2 + 0.1 + 0.1 over 2 sends
    assert read("stream_host_ms_per_batch", c) == pytest.approx(1e3 * 1.1 / 2)
    assert read("producer_wait_pct", c) == pytest.approx(100 * 3.5 / 10)


def test_align_skips_a_record_whose_partner_is_missing():
    k, c = "kernel", "copy"
    launches = [(k, "a"), (k, "b"), (c, "c"), (k, "d"), (c, "e")]
    events = [(0, 1, k), (1, 2, k), (2, 3, c), (3, 4, k), (4, 5, c)]
    assert spans.align(launches, events) == [(o, (s, e)) for (_, o), (s, e, _) in
                                             zip(launches, events)]
    # b's kernel not recorded: a keeps its own, c re-aligns at the copy
    assert spans.align(launches, events[:1] + events[2:]) == [
        ("a", (0, 1)), ("c", (2, 3)), ("d", (3, 4)), ("e", (4, 5))]
    # d's launch not recorded: its kernel is skipped
    assert spans.align(launches[:3] + launches[4:], events) == [
        ("a", (0, 1)), ("b", (1, 2)), ("c", (2, 3)), ("e", (4, 5))]


def test_a_dropped_launch_shifts_no_copy():
    """A launch record lost early in a long stream: its kernel is left
    out, and every other event keeps its own span."""
    k, c = "kernel", "copy"
    block = [(k, "im2col"), (k, "gemm"), (c, "assemble"), (k, "bias")] + [(k, "requant")] * 7
    launches = block * 50
    events = [(t, t + 1, cls) for t, (cls, _) in enumerate(launches)]
    pairs = spans.align(launches[:1] + launches[2:], events)
    owner = {s: o for o, (s, _) in pairs}
    assert sorted(set(range(len(events))) - set(owner)) == [1]  # the GEMM's kernel
    assert all(owner[s] == launches[s][1] for s in owner)


def test_a_dropped_device_event_moves_nothing_past_the_next_copy(monkeypatch):
    """The bias kernel not recorded: the GEMM keeps its own, the copy and
    all after it too; below `MATCHED` nothing is attributed."""
    dropped = DEVICE[:1] + DEVICE[2:]
    monkeypatch.setattr(spans, "MATCHED", 0.8)
    by = spans.launched(ctx(device=dropped).trace)
    assert dict(by) == {"conv.gemm": [(1.0, 2.0)], "conv.assemble": [(2.5, 3.0)],
                        "stream.run": [(3.0, 3.1)], "conv.im2col": [(6.6, 7.0)]}
    monkeypatch.setattr(spans, "MATCHED", 0.99)
    assert spans.launched(ctx(device=dropped).trace) is None
    for name in ("im2col_ms_per_frame", "assemble_ms_per_frame", "requant_ms_per_frame"):
        assert read(name, ctx(device=dropped)) is None, name
    assert read("producer_wait_pct", ctx(device=dropped)) is not None  # host spans stand


def test_the_fetchers_spans_own_no_launch():
    """Drop the fetcher's spans and nothing changes: they opened first on
    another thread but never hold a launch."""
    host = [h for h in HOST if h[0] not in spans.FETCHER]
    assert spans.launched(ctx(host=host).trace) == spans.launched(ctx().trace)


def test_nothing_to_read_without_spans():
    """The parent's program opens no span: each reader gives None, also
    with no trace and on a trace with no device events (the CPU)."""
    bare = [h for h in HOST if not h[0].startswith(spans.PREFIXES)]
    names = ("im2col_ms_per_frame", "assemble_ms_per_frame", "requant_ms_per_frame",
             "stream_host_ms_per_batch", "producer_wait_pct")
    for c in (ctx(host=bare), Context(frames=8, window_s=10.0, setup_s=1.0, ops_per_frame=1,
                                      peak_ops=None, trace=None)):
        for name in names:
            assert read(name, c) is None, name
    for name in names[:3]:
        assert read(name, ctx(device=[])) is None, name


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the benchmark's cells run on the card")


@pytest.mark.cuda
def test_the_traced_cell_reads_every_span_metric(card):
    """The wide cell traced on the card: the five span metrics are there,
    and the device time of im2col, band assembly and the epilogues is the
    epilogue's, within 3%."""
    out = subprocess.run([sys.executable, "benchmark/run.py", "--workload",
                          "wide-c256b10.offline-480p", "--seed", str(2**31 + 7), "--seconds", "3",
                          "--trace", "1"], cwd=harness.ROOT, capture_output=True, text=True,
                         timeout=600)
    assert out.returncode == 0, out.stderr[-3000:]
    r = json.loads(out.stdout.strip().splitlines()[-1])
    m = {k: v["value"] for k, v in r["metrics"].items()}
    assert r["correct"]
    for name in ("im2col_ms_per_frame", "assemble_ms_per_frame", "requant_ms_per_frame",
                 "stream_host_ms_per_batch", "producer_wait_pct"):
        assert m.get(name) is not None and m[name] >= 0, name
    parts = m["im2col_ms_per_frame"] + m["assemble_ms_per_frame"] + m["requant_ms_per_frame"]
    assert parts == pytest.approx(m["epilogue_ms_per_frame"], rel=0.03)
