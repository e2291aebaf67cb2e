"""The golden generators (`qcnn_gpu_tpu_torch/tools/make_golden*.py`) on
the CPU, against the JAX scripts (`scripts/make_golden*.py`) and the
committed files under `assets/golden/`. Nothing here writes under
`assets/`: every output directory is a temporary one.

Tolerances:
  * training anchors, decoded anchors, model files, `.data` pairs and
    JSON files: 0 (elements, bytes);
  * held-out PSNRs of the committed models: to 6 decimals of the JAX
    loop (`make_forward(p, impl="int")` + `yuv.psnr`), the JSON's digits;
  * the `slow` comparison of `make_golden.main` with the JAX script's
    `main` at a few steps: the trained params within
    `tests/test_torch_train.py`'s Adam rule (2 * lr * steps, median 1e-6)
    and the BLU bounds within its rtol 1e-4 (JAX sums each std in
    float32, the port in float64: at 4 frames of 416x240, 25.6M
    pre-activations in C1, the bounds part by 3.2e-5 from the same params,
    beyond the 1e-5 that holds at 2 frames of 64x96); the solver handed
    JAX's params and bounds: JAX's table, byte for byte; both sides
    solving from JAX's bounds (ROADMAP hazard 11) and their own params:
    the tables' integer columns equal, their floats (stepw from each
    side's weights) within rtol 1e-4, and every file written byte-equal."""

import hashlib
import importlib.util
import json
import os
import struct
import sys

import numpy as np
import pytest
import torch

from qcnn_gpu_tpu.data import golden as JG
from qcnn_gpu_tpu.data import yuv as JY
from qcnn_gpu_tpu.data.model_files import read_static_qfp_vect_c as j_read_vect_c
from qcnn_gpu_tpu.models.qvrcnn import make_forward as j_make_forward
from qcnn_gpu_tpu_torch.data import golden as G
from qcnn_gpu_tpu_torch.data import model_files as MF
from qcnn_gpu_tpu_torch.data import yuv
from qcnn_gpu_tpu_torch.engine.runner import Engine
from qcnn_gpu_tpu_torch.testing import dct_compress, make_clean_frames
from qcnn_gpu_tpu_torch.tools import make_golden as MG
from qcnn_gpu_tpu_torch.tools import make_golden_1080p as M1080
from qcnn_gpu_tpu_torch.tools import make_golden_classa as MA
from qcnn_gpu_tpu_torch.tools import make_golden_eval as ME

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
QPS = list(G.QP_QUALITY)


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _committed(name: str) -> bytes:
    with open(os.path.join(G.GOLDEN_DIR, name), "rb") as fp:
        return fp.read()


def _pair(name: str) -> dict:
    before, after = struct.unpack("<2d", _committed(name))
    return {"before": before, "after": after}


def _files(d) -> dict:
    return {f: open(os.path.join(d, f), "rb").read() for f in sorted(os.listdir(d))}


def test_training_anchors_equal_jax():
    """The training anchors: the installed PIL's round trip of the 12
    training frames at each QP's quality, element-equal to the JAX
    `jpeg_anchor(frames, q)` with no tag (make_golden.py:102)."""
    train, _ = G.golden_clip()
    for q in G.QP_QUALITY.values():
        got = G.jpeg_roundtrip(train, q)
        assert got.dtype == np.uint8 and got.shape == train.shape
        assert (got == JG.jpeg_anchor(train, q)).all()


def test_write_records_writes_the_committed_int8_set(tmp_path):
    """Given the committed models and their `.data` pairs, `write_records`
    writes each model and pair byte-equal to the committed ones, and the
    JSON equal to the committed `psnr_golden.json` but for the one line
    the script has added since it was committed: `"wbits": 8` (that file
    predates the key; make_golden.py:163 writes it)."""
    goldens = {qp: (MF.read_static_qfp_vect_c(os.path.join(G.GOLDEN_DIR, f"model_q{qp}.data")),
                    _pair(f"psnr_static_hopper_{qp}.data")) for qp in QPS}
    path = MG.write_records(str(tmp_path), goldens, "", 8, False)
    written = _files(tmp_path)
    assert sorted(written) == sorted([f"model_q{qp}.data" for qp in QPS]
                                     + [f"psnr_static_hopper_{qp}.data" for qp in QPS]
                                     + ["psnr_golden.json"])
    for name, data in written.items():
        if name != "psnr_golden.json":
            assert data == _committed(name), name
    text = open(path).read()
    assert '\n "wbits": 8,\n' in text
    assert text.replace('\n "wbits": 8,', "") == _committed("psnr_golden.json").decode()


def test_write_records_writes_the_committed_int4_set_qp_by_qp(tmp_path):
    """The INT4 set mixes solvers per QP: written one QP at a time with
    each QP's own `per_channel` (the merge builds the JSON), every file is
    byte-equal to the committed one."""
    committed = json.loads(_committed("psnr_golden_int4.json"))["goldens"]
    for qp in QPS:
        ep = MF.read_static_qfp_auto(os.path.join(G.GOLDEN_DIR, f"model_q{qp}_int4.data"))
        pc = committed[str(qp)]["per_channel"]
        MG.write_records(str(tmp_path), {qp: (ep, _pair(f"psnr_static_hopper_{qp}_int4.data"))},
                         "_int4", 4, pc)
    for name, data in _files(tmp_path).items():
        assert data == _committed(name), name
    assert len(os.listdir(tmp_path)) == 2 * len(QPS) + 1


def test_write_records_merges_a_partial_run(tmp_path):
    """A --qps run merges into the existing JSON as the script's does
    (make_golden.py:147-157): the QPs already there keep their place and
    the others' values, a QP run again takes its new values, a new QP is
    appended; the header is the run's."""
    ep = MF.read_static_qfp_vect_c(os.path.join(G.GOLDEN_DIR, "model_q37.data"))
    old = {"clip": "x", "goldens": {"32": {"before": 1.0, "after": 2.0},
                                    "22": {"before": 3.0, "after": 4.0}}}
    path = tmp_path / "psnr_golden_int4.json"
    path.write_text(json.dumps(old))
    new = {"before": 30.1234567, "after": 31.0000004}
    MG.write_records(str(tmp_path), {22: (ep, new), 37: (ep, new)}, "_int4", 4, True)
    got = json.loads(path.read_text())
    assert list(got) == ["clip", "frames_eval", "qp_quality", "wbits", "goldens"]
    assert got["wbits"] == 4 and got["clip"] == "grace_hopper pan 416x240"
    row = {"before": 30.123457, "after": 31.0, "per_channel": True}
    assert list(got["goldens"].items()) == [("32", old["goldens"]["32"]), ("22", row), ("37", row)]
    assert (tmp_path / "psnr_static_hopper_37_int4.data").read_bytes() == struct.pack(
        "<2d", new["before"], new["after"])


def _committed_goldens(json_name, static_prefix):
    """{qp: unrounded pair}: from the `.data` files where the set has them,
    else the JSON's rounded values."""
    if static_prefix:
        return {qp: _pair(f"{static_prefix}_{qp}.data") for qp in QPS}
    g = json.loads(_committed(json_name))["goldens"]
    return {qp: g[str(qp)] for qp in QPS}


def _anchors_digest():
    d = os.path.join(G.GOLDEN_DIR, "anchors")
    return {f: hashlib.sha256(open(os.path.join(d, f), "rb").read()).hexdigest()
            for f in sorted(os.listdir(d))}


@pytest.mark.parametrize("mod, json_name, static_prefix, tile", [
    (ME, "psnr_golden_composite.json", None, None),
    (M1080, "psnr_golden_1080p.json", "psnr_static_fullhd", (540, 960)),
    (MA, "psnr_golden_classa.json", "psnr_static_classa", (540, 960)),
], ids=["composite", "1080p", "classa"])
def test_eval_writers_write_the_committed_files(mod, json_name, static_prefix, tile, tmp_path,
                                                monkeypatch, capsys):
    """Each eval writer's `main --out-dir tmp --device cpu`, its
    `eval_goldens` handed the committed PSNRs (the committed models'
    serving is the `slow` test's), writes its JSON and `.data` pairs
    byte-equal to the committed ones and nothing else; it asks for the
    committed models at the script's tiling, on the committed anchors of
    its clip; and no writer touches `assets/golden/anchors/` (the class-A
    script rewrites them, make_golden_classa.py:41)."""
    want = _committed_goldens(json_name, static_prefix)
    tag = {ME: "composite_eval", M1080: "fullhd_eval", MA: "classa_eval"}[mod]
    seen = {}

    def eval_goldens(clean, anchors_by_qp, models_dir, *, device, tile=None):
        seen.update(clean=clean, models_dir=models_dir, device=device, tile=tile,
                    anchors=anchors_by_qp)
        return want

    before = _anchors_digest()
    monkeypatch.setattr(mod, "eval_goldens", eval_goldens)
    got = mod.main(["--out-dir", str(tmp_path), "--device", "cpu"])
    assert got == want and _anchors_digest() == before
    assert seen["models_dir"] == G.GOLDEN_DIR and seen["device"] == "cpu" and seen["tile"] == tile
    assert list(seen["anchors"]) == QPS
    for qp, q in G.QP_QUALITY.items():
        assert (seen["anchors"][qp] == G.jpeg_anchor(seen["clean"], q, tag)).all()
    names = [json_name] + ([f"{static_prefix}_{qp}.data" for qp in QPS] if static_prefix else [])
    written = _files(tmp_path)
    assert sorted(written) == sorted(names)
    for name in names:
        assert written[name] == _committed(name), name
    out = capsys.readouterr().out.splitlines()
    assert out[0].startswith("QP22") and len(out) == len(QPS) + 1


@pytest.fixture(scope="module")
def small_clip():
    clean = make_clean_frames(2, 64, 96, seed=3)
    return clean, dct_compress(clean, 28.0)


@pytest.fixture(scope="module")
def jax_small_goldens(small_clip):
    """The JAX loop (make_golden_eval.py:48-54) on the small clip."""
    clean, anchor = small_clip
    out = {}
    for qp in (22, 37):
        p = j_read_vect_c(os.path.join(JG.GOLDEN_DIR, f"model_q{qp}.data"))
        rec = np.asarray(j_make_forward(p, impl="int")(anchor))
        out[qp] = {"before": JY.psnr(anchor, clean), "after": JY.psnr(rec, clean)}
    return out


def test_eval_goldens_equal_jax(small_clip, jax_small_goldens):
    """`eval_goldens` with the committed QP22 and QP37 models on 2 seeded
    frames of 64x96: the JAX loop's PSNRs to 6 decimals; in 24x40 windows
    the restored frames are bit-equal to the whole frame's, and so the
    PSNRs to every digit."""
    clean, anchor = small_clip
    got = ME.eval_goldens(clean, {22: anchor, 37: anchor}, G.GOLDEN_DIR, device="cpu")
    assert list(got) == [22, 37]
    for qp, g in got.items():
        for k in ("before", "after"):
            assert round(g[k], 6) == round(jax_small_goldens[qp][k], 6), (qp, k)
    assert ME.eval_goldens(clean, {22: anchor, 37: anchor}, G.GOLDEN_DIR, device="cpu",
                           tile=(24, 40)) == got
    engine = Engine(device="cpu")
    engine.load_model(37, os.path.join(G.GOLDEN_DIR, "model_q37.data"))
    whole = ME.restorer(engine, 37)(anchor)
    assert (ME.restorer(engine, 37, (24, 40))(anchor) == whole).all()


def test_golden_for_qp_trains_writes_and_serves(small_clip, tmp_path):
    """`golden_for_qp` on a seeded 2-frame 64x96 clip (2 + 1 steps, 1
    fine-tune step, batch 4) on the CPU: the model it returns is the
    model file `write_records` writes, and `after` is the PSNR of
    `Engine(device="cpu")` serving that file."""
    clean, anchor = small_clip
    ep, psnrs = MG.golden_for_qp(clean, anchor, clean, anchor, 37, steps=2, decay_steps=1,
                                 finetune_steps=1, lr=1e-3, batch=4, wbits=8,
                                 per_channel=False, device="cpu")
    MG.write_records(str(tmp_path), {37: (ep, psnrs)}, "", 8, False)
    back = MF.read_static_qfp_vect_c(str(tmp_path / "model_q37.data"))
    for field in ("weights", "biases", "blu_q", "mul", "shift"):
        for a, b in zip(getattr(back, field), getattr(ep, field)):
            assert np.array_equal(np.asarray(a), np.asarray(b)), field
    engine = Engine(device="cpu")
    engine.load_model(37, str(tmp_path / "model_q37.data"))
    assert psnrs["after"] == yuv.psnr(engine.restore(anchor, 37), clean)
    assert psnrs["before"] == yuv.psnr(anchor, clean)
    assert _pair_of(tmp_path / "psnr_static_hopper_37.data") == psnrs


def _pair_of(path) -> dict:
    before, after = struct.unpack("<2d", path.read_bytes())
    return {"before": before, "after": after}


@pytest.mark.parametrize("mod", [MG, ME, M1080, MA],
                         ids=["make_golden", "eval", "1080p", "classa"])
def test_generators_run_on_the_card_by_default(mod, tmp_path):
    """Every generator's `main` runs on cuda unless told otherwise: here,
    with no card, it raises before it writes anything (nothing falls
    back to the CPU)."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default runs")
    argv = ["--out-dir", str(tmp_path)] + (["--qps", "37"] if mod is MG else [])
    with pytest.raises((RuntimeError, AssertionError, ValueError)):
        mod.main(argv)
    assert os.listdir(tmp_path) == []


# ---- slow: the whole generators, run once and quoted in CHANGES.md -----------

def _load_script(name):
    spec = importlib.util.spec_from_file_location(f"jax_{name}",
                                                  os.path.join(REPO, "scripts", f"{name}.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.mark.slow
def test_make_golden_main_equal_jax_script(tmp_path, monkeypatch):
    """The port's `make_golden.main` and the JAX script's `main` at QP37,
    3 + 2 steps, 2 fine-tune steps, batch 4, each into its own directory:
    the training and evaluation anchors element-equal; the trained params
    at calibration within the Adam rule and the BLU bounds within rtol
    1e-4; the solver handed JAX's params and bounds writes JAX's table
    byte for byte; from JAX's bounds (ROADMAP hazard 11) each side's
    table has the same integer columns and every file written is
    byte-equal."""
    from qcnn_gpu_tpu.engine import calibrate as JC
    from qcnn_gpu_tpu_torch.models import float_model as FM

    monkeypatch.chdir(tmp_path)
    seen = {side: {"bounds": [], "tables": [], "anchors": [], "params": []}
            for side in ("jax", "port")}

    def spy(side, key, fn, give=None):
        def wrapped(*a, **k):
            out = fn(*a, **k)
            seen[side][key].append(out)
            if key == "bounds":
                seen[side]["params"].append(a[0])
            return give() if give is not None else out
        return wrapped

    script = _load_script("make_golden")
    monkeypatch.setattr(JC, "calibrate_blu_bounds", spy("jax", "bounds", JC.calibrate_blu_bounds))
    monkeypatch.setattr(JC, "solve_table", spy("jax", "tables", JC.solve_table))
    monkeypatch.setattr(script, "jpeg_anchor", spy("jax", "anchors", script.jpeg_anchor))
    args = ["--qps", "37", "--steps", "3", "--decay-steps", "2", "--finetune-steps", "2",
            "--batch", "4"]
    monkeypatch.setattr(sys, "argv", ["make_golden.py", *args, "--out-dir", "jax"])
    script.main()

    monkeypatch.setattr(MG, "calibrate_blu_bounds",
                        spy("port", "bounds", MG.calibrate_blu_bounds,
                            give=lambda: seen["jax"]["bounds"][0]))
    monkeypatch.setattr(MG, "solve_table", spy("port", "tables", MG.solve_table))
    monkeypatch.setattr(MG, "jpeg_roundtrip", spy("port", "anchors", MG.jpeg_roundtrip))
    monkeypatch.setattr(MG, "jpeg_anchor", spy("port", "anchors", MG.jpeg_anchor))
    MG.main([*args, "--out-dir", "port", "--device", "cpu"])

    assert len(seen["port"]["anchors"]) == len(seen["jax"]["anchors"]) == 2
    for a, b in zip(seen["port"]["anchors"], seen["jax"]["anchors"]):
        assert (a == b).all()
    (mine,), (theirs,) = seen["port"]["params"], seen["jax"]["params"]
    diffs = np.concatenate([np.abs(mine[k] - np.asarray(theirs[k])).ravel()
                            for k in FM.PARAM_NAMES])
    assert diffs.max() <= 2 * 1e-3 * 5 and np.median(diffs) <= 1e-6
    np.testing.assert_allclose(seen["port"]["bounds"][0], seen["jax"]["bounds"][0], rtol=1e-4)
    # the solver handed JAX's params and bounds: JAX's table, byte for byte
    (t_port,), (t_jax,) = seen["port"]["tables"], seen["jax"]["tables"]
    pickles = []
    for side, table in (("port", MG.solve_table(theirs, blu_bounds=seen["jax"]["bounds"][0])),
                        ("jax", t_jax)):
        table.save_pickle(str(tmp_path / f"{side}.table"))
        pickles.append((tmp_path / f"{side}.table").read_bytes())
    assert pickles[0] == pickles[1]
    # each side's own table: the integer columns equal, the float columns
    # (stepw from each side's trained weights, and the ratios from them)
    # within the bounds' rtol
    for r, j in zip(t_port, t_jax):
        assert (r.blu_q, r.mul, r.shift) == (j.blu_q, j.mul, j.shift)
        np.testing.assert_allclose([r.stepw, r.ratio, r.blu_adj], [j.stepw, j.ratio, j.blu_adj],
                                   rtol=1e-4)
    assert _files("port") == _files("jax")
    assert sorted(_files("port")) == ["model_q37.data", "psnr_golden.json",
                                      "psnr_static_hopper_37.data"]


@pytest.mark.slow
@pytest.mark.parametrize("mod, names", [
    (ME, ["psnr_golden_composite.json"]),
    (M1080, ["psnr_golden_1080p.json"] + [f"psnr_static_fullhd_{qp}.data" for qp in QPS]),
    (MA, ["psnr_golden_classa.json"] + [f"psnr_static_classa_{qp}.data" for qp in QPS]),
], ids=["composite", "1080p", "classa"])
def test_eval_writers_reproduce_the_committed_goldens(mod, names, tmp_path):
    """Each eval writer at full size on the CPU (the committed models
    served by `Engine(device="cpu")`, the plain versions, on 4 torch
    threads): its JSON and `.data` pairs byte-equal to the committed
    files, the anchors untouched. The JAX eval scripts' `main` is never
    called: it writes into `assets/golden/` (and the class-A script
    rewrites the anchors)."""
    n = torch.get_num_threads()
    torch.set_num_threads(4)
    before = _anchors_digest()
    try:
        mod.main(["--out-dir", str(tmp_path), "--device", "cpu"])
    finally:
        torch.set_num_threads(n)
    assert _anchors_digest() == before
    written = _files(tmp_path)
    assert sorted(written) == sorted(names)
    for name in names:
        assert written[name] == _committed(name), name
