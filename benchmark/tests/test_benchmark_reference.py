"""The benchmark's plain references against the port, bit for bit, on the
CPU at small sizes; what a run may import; the control's reading.

    python -m pytest benchmark/tests -q
"""

import ast
import glob
import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from benchmark import harness, run
from benchmark.reference import qvrcnn as RQ
from benchmark.reference import wide as RW

ROOT = harness.ROOT
BENCH = os.path.join(ROOT, "benchmark")


def _config(name):
    with open(os.path.join(BENCH, "configs", f"{name}.json")) as fp:
        return json.load(fp)


def _frames(n, h, w, seed):
    return torch.from_numpy(np.random.default_rng(seed).integers(0, 256, (n, h, w), dtype=np.uint8))


def test_vect_c_reader_matches_the_port():
    from qcnn_gpu_tpu_torch.engine.runner import read_model

    cfg = _config("qvrcnn-qp37")
    mine = RQ.load(cfg, 0, ROOT, "cpu")
    port = read_model(os.path.join(ROOT, "assets", "golden", "model_q37.data"))
    for a, b in zip(mine.weights, port.weights):
        np.testing.assert_array_equal(a, b)
    for a, b in zip(mine.biases, port.biases):
        np.testing.assert_array_equal(a, b)
    assert (mine.blu_q, mine.mul, mine.shift) == (port.blu_q, port.mul, port.shift)


def test_vect_c_reader_refuses_a_short_file(tmp_path):
    cfg = _config("qvrcnn-qp37")
    path = tmp_path / "short.data"
    path.write_bytes(open(os.path.join(ROOT, cfg["model_file"]), "rb").read()[:-1])
    with pytest.raises(ValueError, match="needs"):
        RQ.read_vect_c(str(path), cfg["layers"])


@pytest.mark.parametrize("impl", ["reference", "auto"])
def test_qvrcnn_reference_bit_equal_to_the_port(impl):
    from qcnn_gpu_tpu_torch.engine.runner import Engine
    from qcnn_gpu_tpu_torch.models.engine_params import EngineParams

    cfg = _config("qvrcnn-qp37")
    p = RQ.load(cfg, 0, ROOT, "cpu")
    x = _frames(3, 37, 53, 1)
    eng = Engine(device="cpu", impl=impl, batch_frames=2)
    eng.set_model(37, EngineParams.from_arrays(p))
    got = eng.restore_stream(x.numpy(), 37)
    want = RQ.forward(x, p).numpy()
    np.testing.assert_array_equal(got, want)
    assert (want != x.numpy()).any()  # the model restores something


@pytest.mark.parametrize("route", ["plain", "gemm"])
def test_wide_reference_bit_equal_to_the_port(route):
    from benchmark.systems import wide_stream

    t = {"batch_frames": 2, "height": 19, "width": 27, "depth": 1}
    p = RW.make_params(24, 2, 7, "cpu")
    run = wide_stream.build(p, {"route": route}, t, "cpu").run
    x = _frames(2, 19, 27, 2)
    np.testing.assert_array_equal(run(x).numpy(), RW.forward(x, p).numpy())


def test_wide_table_keeps_activations_alive():
    """The table made from the weights leaves each hidden layer with some
    zeros, some values in between and a few saturated, and a residual."""
    from benchmark.reference.conv import blu_requant, conv_same

    p = RW.make_params(64, 4, 3, "cpu")
    v = _frames(1, 24, 32, 3)[:, None].to(torch.int64) - 128
    for i in range(len(p.weights) - 1):
        v = blu_requant(conv_same(v, p.weights[i], p.biases[i]), p.blu_q[i], p.mul[i], p.shift[i])
        zero, top = (v == 0).float().mean().item(), (v == 127).float().mean().item()
        assert 0.3 < zero < 0.7 and top < 0.1 and ((v > 0) & (v < 127)).float().mean() > 0.3
        assert ((p.blu_q[i] + (1 << (p.shift[i] - 1)) // p.mul[i]) * p.mul[i]) >> p.shift[i] <= 127


def test_wide_params_repeat_for_a_seed():
    a, b, c = (RW.make_params(16, 2, s, "cpu") for s in (5, 5, 6))
    assert all(torch.equal(x, y) for x, y in zip(a.weights, b.weights))
    assert not torch.equal(a.weights[1], c.weights[1])
    assert (a.blu_q, a.mul, a.mul_last) == (b.blu_q, b.mul, b.mul_last)


@pytest.mark.parametrize("name", ["qvrcnn-qp37", "wide-c256b10"])
def test_the_control_fails_the_check(name):
    """The reference at int4 weights, in the program's place, comes out not
    correct through the harness's comparison: its gap reads above the limit
    of 0 that the port's own frames meet."""
    from benchmark import control

    traffic = {"height": 20, "width": 28, "pool_frames": 6, "check_frames": 4}
    cell = harness.Cell(name, 1, _config(name), traffic, {})
    if name == "wide-c256b10":
        cell.config.update(channels=16, blocks=2)
    r = control.control_reading(cell, 11, "cpu")
    assert not r["correct"] and r["frames"] == 4
    assert r["checks"]["max_abs_diff"]["value"] > r["checks"]["max_abs_diff"]["limit"] == 0


def test_references_import_nothing_of_the_port():
    for path in glob.glob(os.path.join(BENCH, "reference", "*.py")):
        tree = ast.parse(open(path).read())
        for node in ast.walk(tree):
            names = ([a.name for a in node.names] if isinstance(node, ast.Import) else
                     [node.module or ""] if isinstance(node, ast.ImportFrom) else [])
            for n in names:
                assert n.split(".")[0] not in ("qcnn_gpu_tpu_torch", "qcnn_gpu_tpu", "jax"), (path, n)


def test_a_run_loads_no_jax():
    """Everything `benchmark.run` loads, with jax and the JAX package made
    unimportable, and the references with the port made unimportable too."""
    metrics = sorted(os.path.basename(p)[:-3] for p in glob.glob(os.path.join(BENCH, "metrics", "*.py")))
    code = f"""
import sys
for m in ("jax", "jaxlib", "flax", "qcnn_gpu_tpu"):
    sys.modules[m] = None
sys.path.insert(0, {ROOT!r})
import benchmark.run, benchmark.harness, benchmark.control
from benchmark import harness
for w in harness.load_bench()["workloads"]:
    c = harness.load_cell(w["name"])
    harness.system_module(c.config), harness.reference_module(c.config)
for m in {metrics!r}:
    harness.reader(m)
print("ok")
"""
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True, timeout=120)
    assert out.returncode == 0 and out.stdout.strip() == "ok", out.stderr
    code = f"""
import sys
for m in ("jax", "jaxlib", "flax", "qcnn_gpu_tpu", "qcnn_gpu_tpu_torch"):
    sys.modules[m] = None
sys.path.insert(0, {ROOT!r})
import benchmark.reference.qvrcnn, benchmark.reference.wide
print("ok")
"""
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True, timeout=120)
    assert out.returncode == 0 and out.stdout.strip() == "ok", out.stderr


def test_forbidden_names_are_compared_whole():
    assert run.loaded_forbidden(["qcnn_gpu_tpu_torch.engine.runner", "jaxtyping", "numpy"]) == []
    assert run.loaded_forbidden(["qcnn_gpu_tpu.models", "flax.core", "jaxlib", "jax"]) == [
        "flax", "jax", "jaxlib", "qcnn_gpu_tpu"]
