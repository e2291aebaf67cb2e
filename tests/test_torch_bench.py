"""The port's headline measurement (qcnn_gpu_tpu_torch/bench.py, `cli
bench`) and its two tools (tools/bench_layer.py, tools/bench_matrix.py)
on the CPU, where every kernel runs as its plain version.

Held against the JAX package's scripts: the static-camera pool equals
root `bench.py`'s `video_like_pool` (both encode with this machine's PIL),
the noise pool its expression (bench.py:235-245), the JSON line's
`detail` keys the keys bench.py's AST writes (with the port's two
additions, `tile` and `pool`), and bench_layer's convolution the JAX
script's expression (an XLA convolution on bf16 operands, f32
accumulation, then int32 + bias) for all six layers. The port's own
rules: an output that differs from its reference exits 1 (or raises)
before anything is timed, the packed D2H's capacity overflow and a
duplex that never packs are recorded, and bench_matrix keeps the
script's row keys and batch rule. One torch thread; the whole bench runs
once, in a subprocess, at 2 frames of 32x48. Tolerance: 0 (integer
arithmetic)."""

import ast
import functools
import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from qcnn_gpu_tpu_torch import bench as B
from qcnn_gpu_tpu_torch import cli
from qcnn_gpu_tpu_torch.engine import runner
from qcnn_gpu_tpu_torch.testing import synth_engine_params, synth_frames
from qcnn_gpu_tpu_torch.tools import bench_layer as L
from qcnn_gpu_tpu_torch.tools import bench_matrix as M

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SMALL = {"BENCH_H": "32", "BENCH_W": "48", "BENCH_BATCH": "2", "BENCH_ITERS": "1",
         "BENCH_HOST_WINDOWS": "1"}


@pytest.fixture(autouse=True)
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _flip(run):
    """`run` (its attributes too) with one output pixel changed."""
    @functools.wraps(run)
    def wrong(x):
        out = run(x).clone()
        out.view(-1)[0] ^= 1
        return out
    return wrong


# ---- the data ----------------------------------------------------------------

def test_video_like_pool_equals_the_jax_script():
    import bench as JB  # the JAX package's root script

    want = JB.video_like_pool(48, 64, 2, 2)
    got = B.video_like_pool(48, 64, 2, 2)
    assert len(got) == len(want) == 2
    for g, w in zip(got, want):
        assert g.dtype == np.uint8 and g.shape == (2, 48, 64)
        np.testing.assert_array_equal(g, w)


def test_noise_pool_equals_the_script_expression():
    base = synth_frames(2, 48, 64, seed=1)
    rng = np.random.default_rng(7)  # bench.py:235-245
    want = [
        np.clip(base.astype(np.int16) + rng.integers(-3, 4, base.shape, np.int16), 0, 255)
        .astype(np.uint8)
        for _ in range(3)
    ]
    got = B.noise_pool(base, 3)
    assert len(got) == 3
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)


def test_frame_pool_says_which_pool(monkeypatch):
    base = synth_frames(2, 48, 64, seed=1)
    pool, kind = B.frame_pool(base, 2)
    assert kind == "video"
    np.testing.assert_array_equal(pool[1], B.video_like_pool(48, 64, 2, 2)[1])

    def no_matplotlib(*a):
        raise ModuleNotFoundError("No module named 'matplotlib'")

    monkeypatch.setattr(B, "video_like_pool", no_matplotlib)
    pool, kind = B.frame_pool(base, 3)
    assert kind == "noise"
    for g, w in zip(pool, B.noise_pool(base, 3)):
        np.testing.assert_array_equal(g, w)


def test_settings_defaults_and_environment():
    assert B.Settings.from_env({}) == B.Settings(1080, 1920, 16, 16, "auto", 3, 6, 180.0, "")
    s = B.Settings.from_env({**SMALL, "BENCH_IMPL": "kernel2", "BENCH_DEPTH": "2",
                             "BENCH_HOST_BUDGET_S": "7.5", "BENCH_GEOS": "all"})
    assert s == B.Settings(32, 48, 2, 1, "kernel2", 2, 1, 7.5, "all")


# ---- the whole run -----------------------------------------------------------

@pytest.fixture(scope="module")
def small_run():
    env = {**os.environ, **SMALL, "OMP_NUM_THREADS": "1"}
    out = subprocess.run(
        [sys.executable, "-m", "qcnn_gpu_tpu_torch.bench", "--device", "cpu"],
        cwd=REPO, env=env, capture_output=True, text=True, timeout=300,
    )
    return out


def test_bench_on_cpu_prints_one_exact_json_line(small_run):
    assert small_run.returncode == 0, small_run.stderr
    lines = small_run.stdout.splitlines()
    assert len(lines) == 1
    res = json.loads(lines[0])
    d = res["detail"]
    assert d["exact_vs_xla_on_hw"] is True
    assert (d["impl"], d["tile"], d["pool"], d["backend"]) == ("kernel3", "24x32", "video", "cpu")
    assert (d["batch"], d["iters"], d["stream_depth"]) == (2, 1, 3)
    assert d["packed_exact"] is True and d["duplex_exact"] is True
    assert res["value"] > 0 and res["unit"] == "frames/s"
    assert d["mfu"]["device_kind"] == "cpu" and d["mfu"]["mfu_vs_int8_peak"] is None
    assert d["mfu"]["pass_model"]["tile"] == "24x32"
    assert d["full_bytes_per_frame"] == 2 * 32 * 48
    assert "[bench +" in small_run.stderr  # progress on stderr


def _jax_detail_keys():
    """The `detail` keys root bench.py writes: its literal, host_section's
    `d.update(...)`, `d[...] =` and `windows_of` keys, batch1_section's."""
    with open(os.path.join(REPO, "bench.py")) as fp:
        tree = ast.parse(fp.read())
    keys = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Dict):
            for k, v in zip(node.keys, node.values):
                if isinstance(k, ast.Constant) and k.value == "detail":
                    keys |= {kk.value for kk in v.keys if isinstance(kk, ast.Constant)}
        elif isinstance(node, ast.Call) and isinstance(node.func, ast.Attribute):
            if node.func.attr == "update" and getattr(node.func.value, "id", "") == "d":
                keys |= {kw.arg for kw in node.keywords if kw.arg}
        elif isinstance(node, ast.Call) and getattr(node.func, "id", "") == "windows_of":
            key = node.args[1].value
            keys |= {key, key.replace("windows_", "fps_") + "_median"}
        elif isinstance(node, ast.Assign):
            for t in node.targets:
                if (isinstance(t, ast.Subscript) and getattr(t.value, "id", "") == "d"
                        and isinstance(t.slice, ast.Constant)):
                    keys.add(t.slice.value)
    return keys


def test_detail_keys_are_the_jax_scripts(small_run):
    jax_keys = _jax_detail_keys()
    assert {"exact_vs_xla_on_hw", "windows_link_pure", "fps_full_median", "packed_exact",
            "ms_per_frame_device_batch1", "link_note", "backend"} <= jax_keys
    d = json.loads(small_run.stdout.splitlines()[-1])["detail"]
    # both write the duplex's windows only when its warm-up packs (at 32x48
    # the port's steps go full: their packed bytes would reach raw's)
    unwritten = {"windows_duplex", "fps_duplex_median"} if d["fps_duplex_transport"] is None \
        else set()
    assert set(d) == (jax_keys | {"tile", "pool"}) - unwritten


@pytest.mark.parametrize("entry", ["module", "cli"])
def test_an_unequal_output_exits_1_before_any_timing(entry, monkeypatch, capsys):
    for k, v in SMALL.items():
        monkeypatch.setenv(k, v)
    monkeypatch.setattr(B, "make_forward", lambda p, device: _flip(runner.make_forward(p, device)))

    def timed(*a, **k):
        raise AssertionError("timed an unchecked program")

    for name in ("device_fps", "measure_stream_fps", "host_section", "batch1_section"):
        monkeypatch.setattr(B, name, timed)
    argv = ["--device", "cpu"]
    rc = B.main(argv) if entry == "module" else cli.main(["bench", *argv])
    out = capsys.readouterr()
    assert rc == 1
    assert out.out == ""
    assert "differs from its reference (1 pixels)" in out.err


def test_bench_raises_for_an_impl_outside_the_ports_names(monkeypatch):
    with pytest.raises(ValueError, match="impl must be one of"):
        B.measure("cpu", B.Settings(32, 48, 2, 1, "pallas3"))


def test_the_reference_net_runs_in_chunks_of_whole_frames(monkeypatch):
    p = synth_engine_params(37)
    run = B.build(p, "reference", "cpu", (24, 40), 3)
    assert run.func is B.plain_restore
    calls = []

    def ref(x):
        calls.append(x.shape[0])
        return run.args[0](x)

    monkeypatch.setattr(B, "REF_PIXELS", 2 * 24 * 40 + 1)
    x = torch.from_numpy(synth_frames(3, 24, 40, seed=1))
    assert torch.equal(B.plain_restore(ref, x), runner.make_forward(p, "cpu")(x))
    assert calls == [2, 1]


# ---- the sections ------------------------------------------------------------

def _cheap(x):
    """A program a transport can carry exactly: each pixel's low bit flipped."""
    return x ^ 1


def test_host_section_duplex_packs_on_a_static_camera():
    base = synth_frames(2, 96, 128, seed=1)
    s = B.Settings(96, 128, 2, 1, "auto", 3, 1, 60.0)
    d = B.host_section(_cheap, base, 23.6, 1, 60.0, 1e9, s, "cpu")
    assert d["pool"] == "video"
    assert d["packed_exact"] is True and d["duplex_exact"] is True
    assert d["fps_duplex_transport"] == max(d["windows_duplex"]) > 0
    assert d["fps_incl_host_transfers"] == max(
        d["fps_full_transport"], d["fps_packed_transport"], d["fps_duplex_transport"])
    assert d["duplex_h2d_bytes_per_frame_measured"] < d["full_bytes_per_frame"] // 2


def test_host_section_records_the_packed_capacity_overflow():
    base = synth_frames(2, 48, 64, seed=1)
    s = B.Settings(48, 64, 2, 1, "auto", 3, 1, 60.0)
    d = B.host_section(lambda x: x ^ 64, base, 23.6, 1, 60.0, 1e9, s, "cpu")
    assert d["packed_exact"] == "error: OverflowError"
    assert d["fps_packed_transport"] is None and "windows_packed" not in d
    assert d["duplex_exact"] is True


def test_host_section_raises_on_an_inexact_wire(monkeypatch):
    import qcnn_gpu_tpu_torch.engine.packed as P

    base = synth_frames(2, 48, 64, seed=1)
    s = B.Settings(48, 64, 2, 1, "auto", 3, 1, 60.0)

    def decode(x_host, fetched):
        rec = P._decode_residual(x_host, fetched).copy()
        rec[0, 0, 0] ^= 1
        return rec

    monkeypatch.setattr(B, "make_packed_restore",
                        lambda run: (P.make_packed_restore(run)[0], decode))
    with pytest.raises(B.InexactError, match="packed D2H"):
        B.host_section(_cheap, base, 23.6, 1, 60.0, 1e9, s, "cpu")


@pytest.fixture
def batch1_table(tmp_path, monkeypatch):
    """A table whose batch-1 tile (24x40) differs from its tile (24x32)."""
    path = tmp_path / "t.json"
    path.write_text(json.dumps(
        {"per_geometry": {"32x48": {"th": 24, "tw": 32, "batch1": {"tw": 40}}}}))
    monkeypatch.setenv("QCNN_TORCH_KERNEL_CONFIG", str(path))
    return path


def test_batch1_section_serves_the_batch1_tile_once_equal(batch1_table, monkeypatch):
    p = synth_engine_params(37)
    run = runner.build_program(p, "kernel3", "cpu", (32, 48), 2)
    assert run.tile == (24, 32)
    built = []
    real = runner.build_program

    def build(*a):
        built.append(real(*a))
        return built[-1]

    monkeypatch.setattr(B, "build_program", build)
    base = synth_frames(2, 32, 48, seed=1)
    d = B.batch1_section(p, "kernel3", run, base, 23.6, B.Settings(32, 48, 2), "cpu")
    assert [b.tile for b in built] == [(24, 40)]
    assert set(d) == {"ms_per_frame_device_batch1", "fps_incl_host_transfers_batch1",
                      "fps_incl_host_transfers_batch1_vs_baseline"}
    monkeypatch.setattr(B, "build_program", lambda *a: _flip(real(*a)))
    with pytest.raises(B.InexactError, match="batch-1 program"):
        B.batch1_section(p, "kernel3", run, base, 23.6, B.Settings(32, 48, 2), "cpu")


# ---- tools/bench_layer -------------------------------------------------------

@pytest.mark.parametrize("route", ["plain", "gemm"])
@pytest.mark.parametrize("idx", range(6), ids=L.LAYER_NAMES)
def test_bench_layer_conv_equals_the_jax_scripts_expression(idx, route):
    import jax.numpy as jnp
    from jax import lax

    from qcnn_gpu_tpu.models.topology import QVRCNN_LAYERS
    from qcnn_gpu_tpu.testing import synth_engine_params as jax_params
    from qcnn_gpu_tpu_torch.ops.int8_conv import conv_int8

    layer = QVRCNN_LAYERS[idx]
    p = jax_params(37)
    w = jnp.asarray(p.weights[idx], jnp.bfloat16)
    b = jnp.asarray(p.biases[idx], jnp.int32)
    rng = np.random.default_rng(0)
    x = jnp.asarray(rng.integers(0, 128, (2, 16, 24, layer.in_ch)), jnp.bfloat16)
    u = lax.conv_general_dilated(x, w, (1, 1), "SAME",
                                 dimension_numbers=("NHWC", "HWIO", "NHWC"),
                                 preferred_element_type=jnp.float32)
    want = np.asarray(u.astype(jnp.int32) + b)
    xt, wop, bt = L.layer_inputs(idx, 2, 16, 24, "cpu")
    got = conv_int8(xt, wop, bt, route=route)
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), want)


def test_bench_layer_bound_and_argv():
    t, by = L.bound_s(L.LAYER_NAMES.index("C2_2"), 720, 1280)
    px = 720 * 1280
    ops_s = 2 * 25 * 64 * 16 * px / 1979e12
    bytes_s = (64 * px + 25 * 64 * 16 + 4 * 16 + 4 * 16 * px) / 3.35e12
    assert t == max(ops_s, bytes_s) and by == ("operations" if ops_s >= bytes_s else "bytes")
    with pytest.raises(SystemExit):
        L.main(["--layer", "C5"])
    if not torch.cuda.is_available():
        with pytest.raises(SystemExit, match="no CUDA device"):
            L.main(["--layer", "C1"])


# ---- tools/bench_matrix ------------------------------------------------------

def test_bench_matrix_batch_rule_is_the_scripts():
    for h, w, _ in M.GEOMETRIES:
        batch = max(2, min(8, (1 << 21) // (h * w // 512)))  # bench_matrix.py:50-51
        batch += batch % 2
        assert M.batch_for(h, w) == batch == 8


def test_bench_matrix_rows_on_tiny_geometries(monkeypatch, tmp_path):
    monkeypatch.setattr(M, "GEOMETRIES", [(24, 40, 12.0), (32, 48, 20.0)])
    monkeypatch.setattr(M, "CURVE_GEOMETRY", (24, 40))
    monkeypatch.setattr(M, "CURVE_BATCHES", (1, 2))
    timed = []
    monkeypatch.setattr(M, "device_fps", lambda run, x, n: timed.append((x.shape, n)) or 250.0)
    monkeypatch.delenv("BENCH_IMPLS", raising=False)
    out = tmp_path / "m.json"
    rep = M.main([str(out), "--device", "cpu"])
    assert json.loads(out.read_text())["device_ms_per_frame"] == json.loads(
        json.dumps(rep["device_ms_per_frame"]))
    assert (rep["backend"], rep["card"]) == ("cpu", "cpu")
    assert list(rep["device_ms_per_frame"]) == ["kernel3", "kernel2", "reference"]
    tiles = {"kernel3": "24x32", "kernel2": "24x40", "reference": None}
    for name, rows in rep["device_ms_per_frame"].items():
        assert list(rows) == ["40x24", "48x32"]
        for (key, row), ref_ms in zip(rows.items(), (12.0, 20.0)):
            assert row == {"ms_per_frame": 4.0, "fps": 250.0, "ref_best_ms": ref_ms,
                           "speedup_vs_ref": round(ref_ms / 4.0, 2), "batch": 8,
                           "tile": tiles[name]}
    assert rep["batch_scaling_1080p"] == {
        b: {"ms_per_frame": 4.0, "fps": 250.0, "tile": "24x32"} for b in (1, 2)}
    assert [(tuple(s), n) for s, n in timed][-2:] == [((1, 24, 40), 16), ((2, 24, 40), 8)]
    assert os.path.normpath(M.DEFAULT_OUT).split(os.sep) == ["chiprun_out", "bench_matrix.json"]


def test_bench_matrix_checks_before_it_times(monkeypatch):
    monkeypatch.setattr(M, "build", lambda *a: _flip(B.build(*a)))
    monkeypatch.setattr(M, "device_fps", lambda *a: pytest.fail("timed an unchecked program"))
    p = synth_engine_params(37)
    with pytest.raises(B.InexactError, match="kernel2 8x24x40"):
        M.rows_for(p, "kernel2", "cpu", [(24, 40, 12.0)], {})


def test_bench_matrix_refuses_an_unknown_program(monkeypatch):
    monkeypatch.setenv("BENCH_IMPLS", "kernel3,pallas2")
    with pytest.raises(SystemExit, match="pallas2"):
        M.main(["--device", "cpu"])
