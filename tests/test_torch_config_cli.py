"""The port's Config (qcnn_gpu_tpu_torch.config) and the CLI's `run
--mesh`, `run --config` and `convert`, against the JAX package's: config
files load across the two packages with equal contents, a sharded `cli
run` reconstructs what the unsharded one does (tolerance 0) and logs its
mesh, and `convert` writes the JAX command's bytes and text."""

import dataclasses
import json
import os

import numpy as np
import pytest

from qcnn_gpu_tpu import cli as jax_cli
from qcnn_gpu_tpu import config as JC
from qcnn_gpu_tpu.data import model_files as JMF
from qcnn_gpu_tpu.testing import synth_dynamic_params as jax_synth_dynamic
from qcnn_gpu_tpu.testing import synth_engine_params as jax_synth_params
from qcnn_gpu_tpu.testing import synth_float_weights as jax_synth_float
from qcnn_gpu_tpu_torch import cli
from qcnn_gpu_tpu_torch import config as PC
from qcnn_gpu_tpu_torch.config import Config, EngineConfig
from qcnn_gpu_tpu_torch.data import model_files, yuv
from qcnn_gpu_tpu_torch.testing import synth_engine_params, synth_frames

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
GOLDEN = os.path.join(REPO, "assets", "golden")
N, H, W = 7, 48, 64  # batches of 4: a full one and a ragged tail of 3


def _custom(module):
    """A config with every engine setting the port reads off its default."""
    c = module.Config()
    c.engine = dataclasses.replace(c.engine, impl="reference", batch_frames=8, mesh_dp=2,
                                   mesh_sp=2, mesh_sw=2, out_dir="out")
    return c


def _flat(d, prefix=""):
    """{"engine": {"impl": ..}, "data_root": ..} -> {"engine.impl": .., "data_root": ..}"""
    out = {}
    for k, v in d.items():
        out.update(_flat(v, f"{prefix}{k}.") if isinstance(v, dict) else {prefix + k: v})
    return out


def test_config_defaults_equal_jax():
    """The port's settings have the JAX defaults, and UNREAD holds the JAX
    defaults of every other JAX key."""
    port, jax = _flat(dataclasses.asdict(Config())), _flat(dataclasses.asdict(JC.Config()))
    assert {k: jax[k] for k in port} == port
    assert {k: v for k, v in jax.items() if k not in port} == PC.UNREAD


@pytest.mark.parametrize("writer", ["port", "jax"])
def test_config_files_load_across_packages(tmp_path, writer):
    path = str(tmp_path / "c.json")
    _custom(JC if writer == "jax" else PC).save(path)
    port, jax = Config.load(path), JC.Config.load(path)
    assert dataclasses.asdict(jax) == dataclasses.asdict(_custom(JC))
    assert dataclasses.asdict(port) == dataclasses.asdict(_custom(PC))
    assert _flat(dataclasses.asdict(port)).items() <= _flat(dataclasses.asdict(jax)).items()


@pytest.mark.parametrize("key,value", [("engine.model_format", "hwcn"), ("engine.qps", [37]),
                                       ("engine.wbits", 4), ("train.lr", 3e-4),
                                       ("data_root", "/data"), ("engine.unknown", 1)])
def test_config_refuses_settings_the_port_does_not_read(tmp_path, key, value):
    """A JAX file whose other keys are off their defaults (or a key neither
    package knows) raises, naming the key, instead of loading silently."""
    path = str(tmp_path / "c.json")
    JC.Config().save(path)
    raw = json.load(open(path))
    *head, last = key.split(".")
    (raw[head[0]] if head else raw)[last] = value
    json.dump(raw, open(path, "w"))
    with pytest.raises(ValueError, match=key):
        Config.load(path)


def test_config_make_engine(tmp_path):
    c = Config(engine=EngineConfig(mesh_dp=2, mesh_sp=2, batch_frames=4, out_dir=str(tmp_path)))
    eng = c.make_engine(device="cpu")
    assert eng.mesh.label() == "2x2" and eng.batch_frames == 4 and str(eng.device) == "cpu"
    assert Config().make_engine(device="cpu").mesh is None
    with pytest.raises(ValueError, match="impl must be one of"):  # a JAX-only name
        Config(engine=EngineConfig(impl="pallas")).make_engine(device="cpu")


@pytest.fixture(scope="module")
def sequence(tmp_path_factory):
    d = tmp_path_factory.mktemp("seq")
    ori = synth_frames(N, H, W, seed=7)
    anchor = np.clip(ori.astype(int) + np.random.default_rng(0).integers(-4, 5, ori.shape),
                     0, 255).astype(np.uint8)
    files = {k: str(d / f"{k}.yuv") for k in ("ori", "anchor")}
    yuv.write_y_as_420(files["ori"], ori)
    yuv.write_y_as_420(files["anchor"], anchor)
    files["model"] = str(d / "model_q37.data")
    model_files.write_static_qfp_vect_c(files["model"], synth_engine_params(37))
    files["dir"] = d
    return files


def _run(files, out, *extra):
    """cli run on the CPU; -> (recon, the runs.jsonl record)."""
    recon = str(files["dir"] / f"{out}.yuv")
    rc = cli.main(["run", "--ori", files["ori"], "--anchor", files["anchor"], "--height", str(H),
                   "--width", str(W), "--frames", str(N), "--model", files["model"], "--qp", "37",
                   "--device", "cpu", "--out-dir", str(files["dir"] / out), "--recon", recon,
                   *extra])
    assert rc == 0
    with open(files["dir"] / out / "runs.jsonl") as fp:
        return yuv.read_y(recon, H, W, N), json.loads(fp.readline())


@pytest.mark.parametrize("mesh,transport", [("2x2", "raw"), ("1x2x2", "duplex"),
                                            ("2", "raw"), ("1x2", "auto")])
def test_cli_run_mesh_equals_unsharded(sequence, mesh, transport):
    want, rec0 = _run(sequence, "unsharded")
    got, rec = _run(sequence, f"mesh{mesh}-{transport}", "--mesh", mesh, "--transport", transport)
    assert (got == want).all()
    assert rec0["mesh"] == "" and rec["mesh"] == {"2": "2x1"}.get(mesh, mesh)
    served = rec["transport"]["served"]
    assert transport in (served, "auto") and (transport != "auto" or "auto" in rec["transport"])
    assert rec["impl"] == "kernel3" + ("+duplex" if served == "duplex" else "")
    assert rec["psnr_after"] == rec0["psnr_after"]


def test_cli_run_config_overrides_flags(sequence):
    cfg = str(sequence["dir"] / "engine.json")
    Config(engine=EngineConfig(mesh_dp=2, mesh_sp=2, impl="reference",
                               out_dir=str(sequence["dir"] / "from-config"))).save(cfg)
    want, _ = _run(sequence, "unsharded-cfg")
    recon = str(sequence["dir"] / "config.yuv")
    rc = cli.main(["run", "--ori", sequence["ori"], "--anchor", sequence["anchor"], "--height",
                   str(H), "--width", str(W), "--frames", str(N), "--model", sequence["model"],
                   "--qp", "37", "--device", "cpu", "--impl", "kernel1", "--mesh", "1x4",
                   "--out-dir", str(sequence["dir"] / "ignored"), "--recon", recon,
                   "--config", cfg])
    assert rc == 0
    assert (yuv.read_y(recon, H, W, N) == want).all()
    assert not os.path.exists(sequence["dir"] / "ignored")
    with open(sequence["dir"] / "from-config" / "runs.jsonl") as fp:
        rec = json.loads(fp.readline())
    assert rec["mesh"] == "2x2" and rec["impl"] == "reference"


def test_cli_run_mesh_refusals(sequence, capsys):
    """kernel2 under a mesh exits 1 naming --impl reference (the mesh path
    runs generations 3 and 1 only); a mesh spec of four dims exits with the
    JAX command's message."""
    rc = cli.main(["run", "--ori", sequence["ori"], "--anchor", sequence["anchor"], "--height",
                   str(H), "--width", str(W), "--model", sequence["model"], "--qp", "37",
                   "--device", "cpu", "--impl", "kernel2", "--mesh", "1x2",
                   "--out-dir", str(sequence["dir"] / "refused")])
    assert rc == 1 and "--impl reference" in capsys.readouterr().err
    with pytest.raises(SystemExit, match="expected DPxSP\\[xSW\\] with 1-3 'x'-separated dims"):
        cli.main(["run", "--ori", sequence["ori"], "--anchor", sequence["anchor"], "--height",
                  str(H), "--width", str(W), "--model", sequence["model"], "--qp", "37",
                  "--device", "cpu", "--mesh", "1x2x2x2"])


def test_cli_run_mesh_kernel1(sequence):
    """--impl kernel1 under a mesh: generation 1 per block under its frame
    bounds, the ragged tail padded and cropped, equal to the unsharded run."""
    want, _ = _run(sequence, "unsharded-k1")
    got, rec = _run(sequence, "mesh-k1", "--impl", "kernel1", "--mesh", "2x2")
    assert (got == want).all()
    assert rec["mesh"] == "2x2" and rec["impl"] == "kernel1"


# (family, label, the format its file starts in)
SOURCES = [
    ("static", "golden-q37", "vect_c"),
    ("static", "golden-q22-int4", "pc"),  # per-channel rows: pc only
    ("static", "synth-q27", "hwcn"),
    ("dynamic", "synth-q37", "dyn_hwcn"),
    ("float", "synth-seed3", "float_nchw"),
]
CASES = [(label, fin, fout) for fam, label, fmt in SOURCES
         for fin in cli.CONVERT_FORMATS[fam] for fout in cli.CONVERT_FORMATS[fam]
         if fin == fmt or label != "golden-q22-int4"]


def _write_source(label, path):
    """The source's file in its first format, written by the JAX package."""
    if label == "golden-q37":
        JMF.write_static_qfp_vect_c(path, JMF.read_static_qfp_vect_c(
            os.path.join(GOLDEN, "model_q37.data")))
    elif label == "golden-q22-int4":
        JMF.write_static_qfp_pc(path, JMF.read_static_qfp_pc(
            os.path.join(GOLDEN, "model_q22_int4.data")))
    elif label == "synth-q27":
        JMF.write_static_qfp_hwcn(path, jax_synth_params(27))
    elif label == "synth-q37":
        JMF.write_dynamic_hwcn(path, jax_synth_dynamic(37))
    else:
        JMF.write_float_nchw(path, *jax_synth_float(seed=3))


@pytest.fixture(scope="module")
def sources(tmp_path_factory):
    """Each source in every format of its family, written by the JAX CLI."""
    d = tmp_path_factory.mktemp("convert")
    files = {}
    for fam, label, fmt in SOURCES:
        first = str(d / f"{label}.{fmt}")
        _write_source(label, first)
        for other in cli.CONVERT_FORMATS[fam]:
            path = str(d / f"{label}.{other}")
            if other != fmt:
                try:
                    jax_cli.main(["convert", "--infile", first, "--informat", fmt,
                                  "--outfile", path, "--outformat", other])
                except TypeError:  # per-channel rows in a scalar format
                    continue
            files[label, other] = path
    return d, files


@pytest.mark.parametrize("label,fin,fout", CASES, ids=["-".join(c) for c in CASES])
def test_convert_equals_jax(sources, label, fin, fout, capsys):
    """Every ordered pair within a family: the port writes the JAX command's
    bytes and prints its text. A per-channel table into a scalar format:
    the JAX command fails with an incidental TypeError and leaves a partial
    file; the port exits 1 with a ValueError and writes nothing."""
    d, files = sources
    src = files[label, fin]
    out = {k: str(d / f"{label}-{fin}-{fout}.{k}") for k in ("jax", "port")}
    try:
        rc_jax = jax_cli.main(["convert", "--infile", src, "--informat", fin,
                               "--outfile", out["jax"], "--outformat", fout])
    except TypeError:
        rc_jax = None
    text_jax = capsys.readouterr().out
    rc = cli.main(["convert", "--infile", src, "--informat", fin, "--outfile", out["port"],
                   "--outformat", fout])
    captured = capsys.readouterr()
    if rc_jax is None:
        assert rc == 1 and "write the table as pc" in captured.err
        assert not os.path.exists(out["port"])
        return
    assert rc == rc_jax == 0
    assert captured.out == text_jax.replace(out["jax"], out["port"])
    with open(out["jax"], "rb") as a, open(out["port"], "rb") as b:
        assert a.read() == b.read()


@pytest.mark.parametrize("fin,fout", [("vect_c", "dyn_hwcn"), ("dyn_vect_c", "float_nchw"),
                                      ("float_hwcn", "pc")])
def test_convert_across_families_exits_2_like_jax(tmp_path, capsys, fin, fout):
    args = ["convert", "--infile", str(tmp_path / "in"), "--informat", fin,
            "--outfile", str(tmp_path / "out"), "--outformat", fout]
    assert jax_cli.main(args) == 2
    text_jax = capsys.readouterr().out
    assert cli.main(args) == 2
    assert capsys.readouterr().out == text_jax and "pick formats from one family" in text_jax
    assert not os.path.exists(tmp_path / "out")
