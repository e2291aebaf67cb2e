"""Each metric's reader and the trace's arithmetic on synthetic device
events: kernels and copies that overlap, idle gaps, GEMM and other
kernels, and runs with nothing to read."""

import json

import pytest

from benchmark import harness, roofline
from benchmark.harness import Context
from benchmark.trace import Trace, kind, length, overlap, union

PEAK = 1000.0  # operations a second, to keep the arithmetic plain

# a 10 s window: a port kernel 1-3 and 4-6, copies 0.5-1.5 (H2D) and 5.5-7
# (D2H), a GEMM 7-8 and 7.5-8.5, an epilogue kernel 8.5-9 and a memset
# 9-9.2; idle 0-0.5, 3-4 and 9.2-10
DEVICE = [
    ("void split::qvrcnn_kernel<split::Cfg<split::Geometry<32, 32>>>", 1.0, 3.0),
    ("void split::qvrcnn_kernel<split::Cfg<split::Geometry<32, 32>>>", 4.0, 6.0),
    ("Memcpy HtoD (Pinned -> Device)", 0.5, 1.5),
    ("Memcpy DtoH (Device -> Pinned)", 5.5, 7.0),
    ("void cutlass::Kernel2<cutlass_80_tensorop_i16832gemm_s8_128x64_128x3_tn_align16>", 7.0, 8.0),
    ("sm90_xmma_gemm_s8s8_s32_tn_n_tilesize128x128x128", 7.5, 8.5),
    ("void at::native::vectorized_elementwise_kernel<4, at::native::AUnaryFunctor>", 8.5, 9.0),
    ("Memset (Device)", 9.0, 9.2),
]
HOST = [("bench.call", 0.0, 10.0), ("bench.inner", 2.5, 4.5), ("aten::empty", 3.0, 3.1),
        ("cudaEventSynchronize", 3.2, 3.9), ("aten::copy_", 9.3, 9.4)]


def ctx(trace=True, frames=10):
    return Context(frames=frames, window_s=10.0, setup_s=3.5, ops_per_frame=200, peak_ops=PEAK,
                   trace=Trace.from_events(DEVICE, HOST, 10.0) if trace else None)


def read(name, c):
    return harness.reader(name)(c)


def test_span_arithmetic():
    assert union([(3, 4), (0, 1), (0.5, 2), (4, 5)]) == [[0, 2], [3, 5]]
    assert length([[0, 2], [3, 5]]) == 4
    assert overlap([[0, 2], [3, 5]], [[1, 3.5], [4.5, 6]]) == pytest.approx(2.0)


def test_kinds_by_name():
    assert [kind(n) for n, _, _ in DEVICE] == ["port", "port", "h2d", "d2h", "gemm", "gemm",
                                               "kernel", "copy"]


def test_busy_and_idle():
    c = ctx()
    # busy: 0.5-3, 4-9.2 -> 7.7 s of 10
    assert c.trace.busy_s() == pytest.approx(7.7)
    assert read("device_idle_pct", c) == pytest.approx(23.0)
    assert read("device_idle_pct.wide", c) == pytest.approx(23.0)


def test_rooflines_count_useful_work_over_the_kinds_time():
    c = ctx()
    # 10 frames x 200 ops at 1000 ops/s = 2 s of work: GEMMs 1.5 s
    assert read("gemm_roofline", c) == pytest.approx(100 * 2 / 1.5)
    assert read("mfu", c) == read("mfu.wide", c) == pytest.approx(20.0)


def test_epilogue_takes_every_other_kernel_and_memset():
    assert read("epilogue_ms_per_frame", ctx()) == pytest.approx(1e3 * 0.7 / 10)


def test_host_clock_readers():
    c = ctx(frames=100)
    assert read("fps", c) == read("fps.wide", c) == pytest.approx(10.0)
    assert read("setup_s", c) == 3.5


def test_a_named_reader_wins_over_its_prefix(tmp_path):
    """`metrics/<name>.py` where it exists, else the reader of the name's
    part before its first "."."""
    (tmp_path / "benchmark" / "metrics").mkdir(parents=True)
    (tmp_path / "benchmark" / "metrics" / "fps.py").write_text("def read(ctx):\n    return 1\n")
    (tmp_path / "benchmark" / "metrics" / "fps.x.py").write_text("def read(ctx):\n    return 2\n")
    root = str(tmp_path)
    assert harness.reader("fps.x", root)(None) == 2
    assert harness.reader("fps.y", root)(None) == harness.reader("fps", root)(None) == 1
    with pytest.raises(FileNotFoundError):
        harness.reader("nothing.y", root)


def test_nothing_to_read_gives_nothing():
    bare = ctx(trace=False)
    for name in ("gemm_roofline", "epilogue_ms_per_frame", "mfu", "device_idle_pct",
                 "device_idle_pct.wide", "mfu.wide"):
        assert read(name, bare) is None, name
    empty = Context(frames=4, window_s=1.0, setup_s=1.0, ops_per_frame=1,
                    peak_ops=None, trace=Trace.from_events([], [], 1.0))
    for name in ("gemm_roofline", "mfu", "device_idle_pct", "epilogue_ms_per_frame"):
        assert read(name, empty) is None, name


def test_breakdown_names_gaps_by_host_operations():
    b = ctx().trace.breakdown()
    assert b["device_ops"][0][0].startswith("void split::qvrcnn_kernel")
    assert b["device_ops"][0][1] == pytest.approx(4.0)
    # the one gap between device operations, 3-4, lies inside two of the
    # harness's spans; of the host operations in it the event sync
    # overlaps it most
    assert b["idle_gaps"] == [["cudaEventSynchronize", pytest.approx(1.0)]]
    only_spans = Trace.from_events(DEVICE, HOST[:2], 10.0).breakdown()
    assert only_spans["idle_gaps"] == [["bench.inner", pytest.approx(1.0)]]
    bare = Trace.from_events(DEVICE, [], 10.0).breakdown()
    assert bare["idle_gaps"] == [["host: no event recorded", pytest.approx(1.0)]]


def _config(name):
    with open(f"{harness.ROOT}/benchmark/configs/{name}.json") as fp:
        return json.load(fp)


def test_useful_work_from_the_topology():
    for name, want in (("qvrcnn-qp37", 54512), ("wide-c256b10", 5902848)):
        cfg = _config(name)
        assert roofline.macs_per_px(cfg["layers"]) == cfg["macs_per_px"] == want
        assert roofline.ops_per_frame(cfg, 1080, 1920) == 2 * want * 1080 * 1920
    wide = _config("wide-c256b10")
    c, b = wide["channels"], wide["blocks"]
    assert roofline.macs_per_px(wide["layers"]) == 9 * c + b * 9 * c * c + 9 * c
    assert roofline.peak_ops("NVIDIA H100 80GB HBM3", "int8") == 1979e12
    assert roofline.peak_ops("cpu", "int8") is None
