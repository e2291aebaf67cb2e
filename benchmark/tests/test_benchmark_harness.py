"""The harness: every cell resolves by name; a new configuration, traffic
mix and metric are found as new files with no file edited; `BENCHMARK.json`
keeps the contract's shape; runs driven on the CPU with the timed path
broken underneath come out not correct; the command refuses to run
without a card. The `cuda` test runs each cell briefly on the card:

    python -m pytest -m cuda benchmark/tests/test_benchmark_harness.py
"""

import hashlib
import json
import os
import re
import shutil
import subprocess
import sys

import pytest
import torch

from benchmark import harness

ROOT = harness.ROOT
BENCH = harness.load_bench()
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
SMALL = {"height": 20, "width": 28, "pool_frames": 10, "check_frames": 12}


@pytest.fixture(autouse=True)
def _keep_threads():
    """A run sets the process's CPU threads from its mix; give them back."""
    n = torch.get_num_threads()
    yield
    torch.set_num_threads(n)


def _small(cell):
    """The cell at a size the CPU runs in a moment: 20x28 frames, the wide
    net at 16 channels and 2 blocks."""
    cell.traffic.update(SMALL)
    cell.config.update(channels=16, blocks=2)
    cell.config["layers"] = [[3, 1, 16, 1], [3, 16, 16, 2], [3, 16, 1, 1]]
    return cell


def test_every_cell_resolves_to_its_files():
    for w in BENCH["workloads"]:
        cell = harness.load_cell(w["name"])
        assert harness.system_module(cell.config).build
        ref = harness.reference_module(cell.config)
        assert ref.load and ref.forward
        for trace in (False, True):
            assert cell.metrics[trace], (w["name"], trace)
            for m in cell.metrics[trace]:
                assert callable(harness.reader(m["name"]))


def test_benchmark_json_keeps_the_contracts_shape():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs", "workloads",
                          "end_to_end", "per_layer"}
    assert BENCH["paths"] == ["benchmark"] and 1 <= BENCH["run_seconds"] <= 51
    assert all(not a.startswith("/") and ".." not in a for a in BENCH["command"])
    e2e = {m["name"]: m for m in BENCH["end_to_end"]}
    cells = {w["name"] for w in BENCH["workloads"]}
    assert "setup_s" in e2e and e2e["setup_s"]["bound"] <= 0.25
    for c in BENCH["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"} and NAME.match(c["name"])
        assert os.path.isfile(os.path.join(ROOT, c["file"])) and c["file"].startswith("benchmark/")
        assert 1 <= len(c["why"]) <= 200 and 1 <= len(c["source"]) <= 200
    for w in BENCH["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"} and NAME.match(w["name"])
        assert w["chips"] == 1 and 1 <= len(w["why"]) <= 200 and NAME.match(w["traffic"])
    for m in BENCH["end_to_end"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "bound", "source"}
        assert 0.01 <= m["bound"] <= 0.25 and m["source"] in ("host_clock", "device_trace")
    for m in BENCH["per_layer"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "source", "layer", "moves"}
        assert m["moves"] in e2e and "\n" not in m["layer"]
        if m["name"].endswith("_roofline") or "mfu" in m["name"]:
            assert m["unit"] == "%"
    for m in BENCH["end_to_end"] + BENCH["per_layer"]:
        assert NAME.match(m["name"]) and UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
        assert set(m.get("workloads", cells)) <= cells
    for w in BENCH["workloads"]:  # each cell reports setup_s, another e2e metric, a per-layer one
        cell = harness.load_cell(w["name"])
        names = {m["name"] for m in cell.metrics[False]}
        assert "setup_s" in names and len(names) >= 2 and cell.metrics[True]
        for m in cell.metrics[True]:
            assert m["moves"] in names, (w["name"], m["name"])
    names = [m["name"] for m in BENCH["end_to_end"] + BENCH["per_layer"]]
    assert len(names) == len(set(names))
    assert len(json.dumps(BENCH)) < 64 * 1024


def _digest(root):
    out = {}
    for d, _, files in os.walk(root):
        for f in files:
            p = os.path.join(d, f)
            out[os.path.relpath(p, root)] = hashlib.sha256(open(p, "rb").read()).hexdigest()
    return out


def test_a_new_config_mix_and_metric_are_found_by_name(tmp_path):
    root = tmp_path / "checkout"
    shutil.copytree(os.path.join(ROOT, "benchmark"), root / "benchmark",
                    ignore=shutil.ignore_patterns("__pycache__"))
    shutil.copy(os.path.join(ROOT, "BENCHMARK.json"), root / "BENCHMARK.json")
    before = _digest(root / "benchmark")
    bdir = root / "benchmark"
    cfg = json.load(open(bdir / "configs" / "wide-c256b10.json"))
    cfg.update(name="wide-c16b2", channels=16, blocks=2,
               layers=[[3, 1, 16, 1], [3, 16, 16, 2], [3, 16, 1, 1]])
    (bdir / "configs" / "wide-c16b2.json").write_text(json.dumps(cfg))
    mix = dict(json.load(open(bdir / "traffic" / "offline-480p.json")), **SMALL)
    (bdir / "traffic" / "tiny.json").write_text(json.dumps(mix))
    (bdir / "metrics" / "frames_returned.py").write_text("def read(ctx):\n    return ctx.frames\n")
    bench = json.load(open(root / "BENCHMARK.json"))
    bench["configs"].append({"name": "wide-c16b2", "source": "https://example.org/x",
                             "file": "benchmark/configs/wide-c16b2.json", "reduced": [],
                             "why": "a test"})
    bench["workloads"].append({"name": "wide-c16b2.tiny", "config": "wide-c16b2",
                               "traffic": "tiny", "chips": 1, "why": "a test"})
    bench["end_to_end"].append({"name": "frames_returned", "unit": "frames", "better": "higher",
                                "bound": 0.05, "source": "host_clock",
                                "workloads": ["wide-c16b2.tiny"]})
    (root / "BENCHMARK.json").write_text(json.dumps(bench))
    after = _digest(root / "benchmark")
    assert all(after[k] == v for k, v in before.items())  # nothing there was edited

    cell = harness.load_cell("wide-c16b2.tiny", str(root))
    assert cell.config["channels"] == 16 and cell.traffic["height"] == 20
    r = harness.run_cell(cell, 2**31 + 3, 0.2, False, "cpu", str(root))
    assert r["correct"] and r["metrics"]["frames_returned"]["value"] >= 4
    assert set(r["metrics"]) == {"setup_s", "frames_returned"}  # fps.wide lists its cell


def _identity(run):
    return lambda x: x.clone()


def _half_left_out(run):
    def f(x):
        y = run(x).clone()
        h = x.shape[0] // 2
        y[h:] = x[h:]
        return y
    return f


def _altered(run):
    def f(x):
        y = run(x).clone()
        y[:, 0, 0] ^= 1
        return y
    return f


FAULTS = {"none": None, "identity": _identity, "half_left_out": _half_left_out,
          "altered": _altered}
SEED = 2**31 + 21


@pytest.mark.parametrize("fault", list(FAULTS) + ["control"])
@pytest.mark.parametrize("workload", [w["name"] for w in BENCH["workloads"]])
def test_a_broken_timed_path_is_not_correct(monkeypatch, workload, fault):
    """Each fault a one-chip cell can have, planted in the program the
    window drives, and the control put in its place, come out not correct
    through `run_cell`."""
    cell = _small(harness.load_cell(workload))
    plant = FAULTS.get(fault)
    if fault == "control":  # the reference at int4 weights in the program's place
        ref = harness.reference_module(cell.config)
        params = ref.load(cell.config, SEED, ROOT, "cpu")
        plant = lambda run: (lambda x: ref.forward(x, params, int4=True))  # noqa: E731
    if plant is not None:
        system = harness.system_module(cell.config)
        make = system.make_wide_forward
        monkeypatch.setattr(system, "make_wide_forward", lambda *a, **k: plant(make(*a, **k)))
    r = harness.run_cell(cell, SEED, 0.3, trace=fault == "none", device="cpu")
    assert r["correct"] == (fault == "none"), r["checks"]
    assert r["checks"]["frames_unchecked"]["value"] == 0 and r["attempted"] > 0
    if fault != "none":
        assert r["checks"]["max_abs_diff"]["value"] > 0
    assert list(r)[-1] == "checks"


def _cli(cwd, *args):
    return subprocess.run([sys.executable, "benchmark/run.py", *args], cwd=cwd,
                          capture_output=True, text=True, timeout=300)


def test_the_command_refuses_without_a_card_or_the_port(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("checks the refusal where there is no card")
    w = BENCH["workloads"][0]["name"]
    out = _cli(ROOT, "--workload", w, "--seed", "1", "--seconds", "1", "--trace", "0")
    assert out.returncode != 0 and out.stdout == "" and "CUDA" in out.stderr
    shutil.copytree(os.path.join(ROOT, "benchmark"), tmp_path / "benchmark",
                    ignore=shutil.ignore_patterns("__pycache__"))
    shutil.copy(os.path.join(ROOT, "BENCHMARK.json"), tmp_path / "BENCHMARK.json")
    out = _cli(tmp_path, "--workload", w, "--seed", "1", "--seconds", "1", "--trace", "0")
    assert out.returncode != 0 and out.stdout == ""


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the benchmark's cells run on the card")


@pytest.mark.cuda
@pytest.mark.parametrize("trace", ["0", "1"])
@pytest.mark.parametrize("workload", [w["name"] for w in BENCH["workloads"]])
def test_each_cell_runs_correct_on_the_card(card, workload, trace):
    out = _cli(ROOT, "--workload", workload, "--seed", str(2**31 + 5), "--seconds", "2",
               "--trace", trace)
    assert out.returncode == 0, out.stderr[-3000:]
    r = json.loads(out.stdout.strip().splitlines()[-1])
    assert r["correct"] and r["device"]["platform"] == "gpu" and r["failed"] == 0
    cell = harness.load_cell(workload)
    assert set(r["metrics"]) == {m["name"] for m in cell.metrics[trace == "1"]}
    for name, m in r["metrics"].items():
        if name.endswith("_roofline") or "mfu" in name:
            assert 0 < m["value"] <= 100
