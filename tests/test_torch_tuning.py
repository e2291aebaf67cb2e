"""The port's tuned table (qcnn_gpu_tpu_torch/ops/tuning.py) and the tile
instances it picks, on the CPU.

`geometry_class` and `tuned_kwargs` held against the JAX package's
(qcnn_gpu_tpu/ops/tuning.py) on the same tables: the class chosen, the
`th` knob, the `batch1` block and the order of the tiers (the JAX
tables' `kernel`, `we`, `wc` and `s1` knobs are the TPU's and not the
port's, and the JAX package has no `tw`: the tables set it at the top
level, where the port reads it and the JAX module skips it). The cases of
tests/test_tuning.py that apply, with the port's departures: a malformed
table or variable, and a tile that is not compiled, raise ValueError
where the JAX module skips them. The TPU's table and variables never move
the port. The engine's program cache follows the geometry class and
batch 1. Every compiled tile's layout emulated (tests/torch_split_emulation.py)
bit-equal to the plain version. The sweep's rule for what lands in the
table, and the shipped table as that rule reads the shipped sweep.
Tolerance: 0."""

import json
import os

import numpy as np
import pytest
import torch

from qcnn_gpu_tpu.ops import tuning as JT
from qcnn_gpu_tpu_torch.engine.runner import Engine
from qcnn_gpu_tpu_torch.ops import fused as FU
from qcnn_gpu_tpu_torch.ops import pair as PA
from qcnn_gpu_tpu_torch.tools import sweep_kernel as SW
from qcnn_gpu_tpu_torch.ops import tuning as T

import torch_split_emulation as SE

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
MODEL = os.path.join(REPO, "assets", "golden", "model_q37.data")
ENVS = ("QCNN_KERNEL_CONFIG", "QCNN_KERNEL_TH", "QCNN_KERNEL_WE", "QCNN_KERNEL_WC",
        "QCNN_KERNEL_KERNEL", "QCNN_KERNEL_S1", T.CONFIG_ENV) + tuple(
            T.KNOB_ENV + k.upper() for k in T.KNOBS)


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """These tests run small tensors: one intra-op thread each keeps them
    off the cores the other test workers use."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture()
def env(monkeypatch, tmp_path):
    """Both packages' variables cleared; `table(d)` writes d and points
    both packages at it."""
    for k in ENVS:
        monkeypatch.delenv(k, raising=False)

    def table(data, name="tuned.json"):
        path = tmp_path / name
        path.write_text(data if isinstance(data, str) else json.dumps(data))
        monkeypatch.setenv("QCNN_KERNEL_CONFIG", str(path))
        monkeypatch.setenv(T.CONFIG_ENV, str(path))
        return str(path)

    monkeypatch.table = table
    return monkeypatch


TABLES = {
    "classes": {"th": 24, "tw": 32, "per_geometry": {
        "240x416": {"th": 32}, "1080x1920": {"th": 24, "batch1": {"th": 32}},
        "2160x3840": {}}},
    "batch1-only": {"tw": 32, "per_geometry": {"480x832": {"batch1": {"th": 32}},
                                               "720x1280": {}}},
    "flat": {"th": 32, "tw": 32},
    "empty": {},
}
GEOS = [(240, 416), (1080, 1920), (1088, 1920), (1600, 2560), (32, 48), (720, 1280), (2160, 3840)]


def _jax(table, h, w, batch):
    """JAX's knobs for (h, w, batch) plus the table's top-level `tw`,
    which only the port reads."""
    return {**JT.tuned_kwargs(h=h, w=w, batch=batch),
            **({"tw": table["tw"]} if "tw" in table else {})}


@pytest.mark.parametrize("name", TABLES)
def test_classes_and_knobs_equal_jax(env, name):
    env.table(TABLES[name])
    for h, w in GEOS:
        assert T.geometry_class(h, w) == JT.geometry_class(h, w)
        for batch in (None, 1, 4):
            assert T.tuned_kwargs(h, w, batch) == _jax(TABLES[name], h, w, batch), (h, w)


@pytest.mark.parametrize("value", ["32", "24"])
def test_environment_tier_comes_first_as_in_jax(env, value):
    env.table(TABLES["classes"])
    env.setenv("QCNN_KERNEL_TH", value)
    env.setenv(T.KNOB_ENV + "TH", value)
    for h, w in GEOS:
        for batch in (None, 1, 4):
            got = T.tuned_kwargs(h, w, batch)
            assert got == _jax(TABLES["classes"], h, w, batch)
            assert got["th"] == int(value)


def test_tier_order(env):
    """env > batch1 > the geometry's entry > the top level > defaults."""
    env.table({"tw": 32, "per_geometry": {"240x416": {"th": 32, "batch1": {"th": 24, "tw": 40}}}})
    assert T.tuned_kwargs() == {"tw": 32}
    assert T.tuned_kwargs(240, 416, 4) == {"th": 32, "tw": 32}
    assert T.tuned_kwargs(240, 416, 1) == {"th": 24, "tw": 40}
    env.setenv(T.KNOB_ENV + "TW", "32")
    assert T.tuned_kwargs(240, 416, 1) == {"th": 24, "tw": 32}


# ---- tests/test_tuning.py's cases that apply to the port

def test_empty_table_gives_the_defaults(env):
    env.table({})
    assert T.tuned_kwargs() == {} and T.tuned_kwargs(1080, 1920, 1) == {}


@pytest.mark.parametrize("case", ["roundtrip", "env_overrides", "partial"])
def test_file_tiers(env, tmp_path, case):
    path = env.table({})
    if case == "roundtrip":  # write_tuned drops non-knob keys (sweep rows carry times)
        assert T.write_tuned({"th": 32, "tw": 32, "kernel": 3, "ms_per_frame": 0.1}, path) == path
        assert T.tuned_kwargs() == {"th": 32, "tw": 32}
    elif case == "env_overrides":
        T.write_tuned({"th": 32, "tw": 32}, path)
        env.setenv(T.KNOB_ENV + "TH", "24")
        assert T.tuned_kwargs() == {"th": 24, "tw": 32}
    else:
        env.table({"tw": 32})
        assert T.tuned_kwargs() == {"tw": 32}


def test_per_geometry_selection(env, tmp_path):
    path = env.table({})
    T.write_tuned({"th": 24, "tw": 40}, path)
    T.write_tuned({"tw": 32}, path, geometry="240x416")
    T.write_tuned({"th": 32, "tw": 32}, path, geometry="2160x3840")
    assert T.tuned_kwargs() == {"th": 24, "tw": 40}  # top level kept
    assert T.tuned_kwargs(240, 416) == {"th": 24, "tw": 32}
    assert T.geometry_class(1600, 2560) == "2160x3840"  # nearest by log pixels
    assert T.tuned_kwargs(1600, 2560)["th"] == 32
    env.setenv(T.KNOB_ENV + "TH", "32")
    assert T.tuned_kwargs(240, 416) == {"th": 32, "tw": 32}


def test_geometry_class_none_without_per_geometry(env):
    env.table({"tw": 32})
    assert T.geometry_class(1080, 1920) is None
    assert T.tuned_kwargs(1080, 1920) == {"tw": 32}


def test_batch1_block(env, tmp_path):
    path = env.table({})
    T.write_tuned({"th": 24, "tw": 32}, path, geometry="1080x1920",
                  batch1={"th": 32, "kernel": 2, "x": 1})
    assert json.load(open(path))["per_geometry"]["1080x1920"] == {
        "th": 24, "tw": 32, "batch1": {"th": 32}}
    assert T.tuned_kwargs(1080, 1920, 1) == {"th": 32, "tw": 32}
    for batch in (None, 4, 16):
        assert T.tuned_kwargs(1080, 1920, batch) == {"th": 24, "tw": 32}


def test_shipped_table_path():
    assert T.TUNED_PATH == os.path.join(REPO, "qcnn_gpu_tpu_torch", "tuned_h100.json")
    T.load_table(T.TUNED_PATH)  # well-formed


# ---- the departures: every malformed input raises, naming its source

@pytest.mark.parametrize("payload,match", [
    ("{not json", "not JSON"),
    ('{"th": null}', "'th' must be an integer"),
    ("3", "expected an object"),
    ('["th"]', "expected an object"),
    ('{"th": "20"}', "'th' must be an integer"),
    ('{"th": true}', "'th' must be an integer"),
    ('{"th": 8}', r"'th' = 8 is not one of \[24, 32\]"),
    ('{"kernel": 3}', "unknown knob 'kernel'"),
    ('{"we": 256}', "unknown knob 'we'"),
    ('{"s1": "op6"}', "unknown knob 's1'"),
    ('{"th": 32}', "tile 32x40 is not a compiled instance"),
    ('{"per_geometry": []}', "per_geometry must be an object"),
    ('{"per_geometry": {"1080p": {}}}', "'1080p' is not a geometry"),
    ('{"per_geometry": {"240x416": {"th": 24, "TW": 32}}}', r"per_geometry\[240x416\]: unknown"),
    ('{"per_geometry": {"240x416": {"batch1": 20}}}', r"\[240x416\]\.batch1: expected an object"),
    ('{"per_geometry": {"240x416": {"th": 32, "tw": 32, "batch1": {"tw": 40}}}}', "tile 32x40"),
])
def test_malformed_table_raises(env, payload, match):
    path = env.table(payload)
    with pytest.raises(ValueError, match=match) as e:
        T.tuned_kwargs(240, 416, 1)
    assert path in str(e.value)


@pytest.mark.parametrize("var,value,match", [
    ("TH", "fast", "must be an integer"), ("TH", "16", "is not one of"),
    ("TW", "24", "is not one of"), ("TW", "40", "tile 32x40"),
])
def test_malformed_environment_raises(env, var, value, match):
    env.table({"per_geometry": {"240x416": {"th": 32, "tw": 32}}})
    env.setenv(T.KNOB_ENV + var, value)
    with pytest.raises(ValueError, match=match) as e:
        T.tuned_kwargs(240, 416, 4)
    assert T.KNOB_ENV + var in str(e.value)


def test_absent_table_raises(env, tmp_path):
    env.setenv(T.CONFIG_ENV, str(tmp_path / "no_such.json"))
    with pytest.raises(ValueError, match="cannot read"):
        T.tuned_kwargs()


def test_write_tuned_leaves_a_malformed_file_alone(env, tmp_path):
    path = env.table('{"th": "x"}')
    with pytest.raises(ValueError, match="must be an integer"):
        T.write_tuned({"th": 32}, path)
    assert open(path).read() == '{"th": "x"}'
    with pytest.raises(ValueError, match="not a compiled instance"):
        T.write_tuned({"th": 32}, str(tmp_path / "new.json"))
    assert not os.path.exists(tmp_path / "new.json")


@pytest.mark.parametrize("tile", [(24, 24), (32, 40), (8, 8), (20, 40), "24x40", None])
def test_unknown_tile_raises_in_the_wrappers(tile):
    fw = FU.FusedWeights.from_engine(_params(), "cpu")
    x = torch.zeros((1, 24, 40), dtype=torch.uint8)
    with pytest.raises(ValueError, match="compiled instance|a tile is a"):
        FU.fused_forward(x, fw, tile=tile)


def test_tpu_table_and_variables_never_move_the_port(env, tmp_path):
    """assets/tuned_kernel.json and the QCNN_KERNEL_* variables select
    the TPU kernel; the port reads neither."""
    env.table({"per_geometry": {"240x416": {"tw": 32}}})
    want = T.tuned_kwargs(240, 416, 1)
    env.setenv("QCNN_KERNEL_CONFIG", os.path.join(REPO, "assets", "tuned_kernel.json"))
    for var, value in (("TH", "90"), ("KERNEL", "2"), ("WE", "256"), ("S1", "op6")):
        env.setenv("QCNN_KERNEL_" + var, value)
    assert JT.tuned_kwargs(h=240, w=416, batch=1)["th"] == 90  # the TPU's knobs are set...
    assert T.tuned_kwargs(240, 416, 1) == want == {"tw": 32}  # ...and the port's unmoved


# ---- the engine and build_tuned

def _params():
    from qcnn_gpu_tpu_torch.engine.runner import read_model

    return read_model(MODEL)


def test_build_tuned_takes_the_tables_tile(env):
    env.table({"per_geometry": {"16x16": {"tw": 32}, "64x64": {"th": 32, "tw": 32}}})
    run = T.build_tuned(_params(), "cpu", 16, 16, 4)
    assert (run.func, run.tile) == (FU.fused_forward, (24, 32))
    run = T.build_tuned(_params(), "cpu", 60, 60, 1)
    assert (run.func, run.tile) == (FU.fused_forward, (32, 32))
    run = T.build_tuned(_params(), "cpu", 60, 60, 1, th=24, tw=40)
    assert (run.func, run.tile) == (FU.fused_forward, (24, 40))
    for knob in ("we", "kernel"):
        with pytest.raises(ValueError, match=f"build_tuned: unknown knob '{knob}'"):
            T.build_tuned(_params(), "cpu", 60, 60, 1, **{knob: 2})


@pytest.mark.parametrize("impl", ["kernel", "auto", "kernel3", "kernel2"])
def test_engine_cache_key_follows_class_and_batch_1(env, impl):
    """Frames of 14x19 (class 16x16) and 40x44 (class 64x64) at batch 2 and
    1: generation 3 gets one program per (class, batch == 1), at the
    table's tile; generation 2, which has one tile, gets one program."""
    env.table({"per_geometry": {"16x16": {"tw": 32, "batch1": {"th": 24, "tw": 40}},
                                "64x64": {"th": 32, "tw": 32}}})
    eng = Engine(device="cpu", impl=impl, batch_frames=2)
    eng.set_model(37, _params())
    fw = FU.FusedWeights.from_engine(_params(), "cpu")
    rng = np.random.default_rng(1)
    for h, w in ((14, 19), (40, 44)):
        for n in (2, 1):
            x = rng.integers(0, 256, (n, h, w), dtype=np.uint8)
            want = FU.fused_forward_reference(torch.from_numpy(x), fw).numpy()
            assert (eng.restore_stream(x, 37) == want).all()
    programs = {key: (run.func, getattr(run, "tile", None)) for key, run in eng._programs.items()}
    if impl == "kernel2":
        assert eng.program_name(37) == "kernel2"
        assert programs == {(37, "cpu", "kernel2"): (PA.pair_forward, None)}
        return
    assert eng.program_name(37) == "kernel3"
    assert programs == {
        (37, "cpu", "kernel3", "16x16", False): (FU.fused_forward, (24, 32)),
        (37, "cpu", "kernel3", "16x16", True): (FU.fused_forward, (24, 40)),
        (37, "cpu", "kernel3", "64x64", False): (FU.fused_forward, (32, 32)),
        (37, "cpu", "kernel3", "64x64", True): (FU.fused_forward, (32, 32)),
    }


# ---- every compiled tile's layout, emulated

@pytest.mark.parametrize("shape", ["ragged", "sub-tile"])
@pytest.mark.parametrize("tile", FU.TILES[1:], ids=lambda t: f"{t[0]}x{t[1]}")
def test_every_tile_emulates_bit_equal(tile, shape):
    """Generation 3 at each compiled tile other than 24x40 (whose
    emulation tests/test_torch_fused_split.py holds), on frames ragged in
    both axes (one larger than a tile on a grid that divides no walk
    evenly, three smaller than a tile)."""
    th, tw = tile
    fw = FU.FusedWeights.from_engine(_params(), "cpu")
    dims = (2, th + 7, tw + 5) if shape == "ragged" else (3, th - 5, tw - 3)
    x = np.random.default_rng(th + tw).integers(0, 256, dims, dtype=np.uint8)
    got = SE.emulate(x, fw, SE.Design(th, tw, 1, False), grid=3)
    assert (got == FU.fused_forward_reference(torch.from_numpy(x), fw).numpy()).all()


# ---- the sweep's rule for what lands in the table (tools/sweep_kernel.py)

def _row(h, w, b, th, tw, ratios, exact=True, kernel=3):
    return {"h": h, "w": w, "batch": b, "kernel": kernel, "th": th, "tw": tw, "exact": exact,
            "ms_per_frame": 1.0, "ratios": ratios, "ratio": float(np.median(ratios)),
            "spread": max(ratios) - min(ratios)}


def test_sweep_writes_only_tiles_faster_in_every_repeat(env, tmp_path):
    """A tile lands only where it read faster than 24x40 in every paired
    repeat: one repeat that reads even faster does not block it (1080p
    batch 1, as the H100 sweep read 32x32 there), one that reads slower
    does (720p batch 4); rows that are not exact, of generation 2, or of a
    tile no longer compiled never count; every swept geometry is a class;
    a batch-1 cell without a winner resets an entry's tile."""
    fast = [0.84, 0.835, 0.845, 0.84, 0.842]
    rows = [
        _row(240, 416, 4, 24, 32, fast), _row(240, 416, 4, 20, 40, [0.80] * 5),
        _row(240, 416, 4, 24, 32, [0.80] * 5, kernel=2),
        _row(240, 416, 4, 32, 32, [0.70] * 5, exact=False),
        _row(240, 416, 1, 24, 32, [0.97, 0.98, 0.99, 1.01, 0.98]),
        _row(720, 1280, 4, 32, 32, [0.95, 0.94, 0.95, 1.002, 0.95]),
        _row(720, 1280, 1, 32, 32, [0.90, 0.91, 0.90, 0.90, 0.90]),
        _row(1080, 1920, 4, 32, 32, [0.975, 0.97, 0.978, 0.976, 0.975]),
        _row(1080, 1920, 1, 32, 32, [0.955, 0.978, 0.978, 0.978, 0.979]),
    ]
    per = SW.table_from(rows)
    assert per == {
        "240x416": {"th": 24, "tw": 32, "batch1": {"th": 24, "tw": 40}},
        "720x1280": {"batch1": {"th": 32, "tw": 32}},
        "1080x1920": {"th": 32, "tw": 32},
    }
    path = env.table({})
    for geo, entry in per.items():
        T.write_tuned(entry, path, geometry=geo, batch1=entry.get("batch1"))
    assert T.tuned_kwargs(240, 416, 1) == {"th": 24, "tw": 40}
    assert T.tuned_kwargs(720, 1280, 4) == {} and T.tuned_kwargs(2160, 3840, 1)["th"] == 32


def test_shipped_table_is_the_rule_on_the_shipped_sweep():
    """qcnn_gpu_tpu_torch/tuned_h100.json is what `table_from` makes of
    the committed qcnn_gpu_tpu_torch/sweep_h100.jsonl (one card, every
    row exact)."""
    rows = [json.loads(line) for line in open(SW.JSONL) if line.strip()]
    assert len({r["card"] for r in rows}) == 1 and all(r["exact"] for r in rows)
    assert T.load_table(T.TUNED_PATH) == {"per_geometry": SW.table_from(rows)}
