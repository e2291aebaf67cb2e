"""The port's dynamic (calibration) path and its validation tools on the
CPU, against the JAX package on the same seeded inputs: the dynamic and
hybrid forwards against JAX's `make_dynamic_forward` / `make_hybrid_forward`
and the numpy oracle's `forward_calibrate` / `forward_dynamic_hybrid`, the
dynamic model files and the b_adj telemetry file against the JAX writers,
the viewmem report and feature dump against JAX's, and `cli
calibrate-dynamic` / `cli validate` against the JAX CLI's text and files.
Tolerance: 0 everywhere (integers, bytes and text)."""

import dataclasses
import io
import os

import numpy as np
import pytest
import torch

from qcnn_gpu_tpu.data import model_files as JMF
from qcnn_gpu_tpu.data import yuv
from qcnn_gpu_tpu.data.golden import GOLDEN_DIR
from qcnn_gpu_tpu.engine import calibrate as JC
from qcnn_gpu_tpu.engine import validate as JV
from qcnn_gpu_tpu.models import oracle as O
from qcnn_gpu_tpu.models import qvrcnn_dynamic as JD
from qcnn_gpu_tpu.testing import synth_dynamic_params, synth_engine_params, synth_frames
from qcnn_gpu_tpu_torch import cli
from qcnn_gpu_tpu_torch import testing as T
from qcnn_gpu_tpu_torch.data import model_files as MF
from qcnn_gpu_tpu_torch.engine import calibrate as C
from qcnn_gpu_tpu_torch.engine import validate as V
from qcnn_gpu_tpu_torch.models import qvrcnn_dynamic as D
from qcnn_gpu_tpu_torch.models.engine_params import DynamicParams, EngineParams

INT4_PC = os.path.join(GOLDEN_DIR, "model_q22_int4.data")


def _big_bias(jp):
    """C1's bias past 2^24 (odd: float32 rounds it in the b_adj file) and
    C4's large enough that its walked value passes 2^24 too."""
    b = [x.copy() for x in jp.biases]
    b[0][0] = (1 << 25) + 1
    b[5][0] = 1 << 26
    return dataclasses.replace(jp, biases=b)


def _dynamic_params(qp, seed):
    jp = synth_dynamic_params(qp, seed)
    return _big_bias(jp) if seed == 2 else jp


def _as_ints(tel):
    """JAX's telemetry scalars (device int64) as the port's ints."""
    m, s = tel["max_u"], tel["step_y"]
    return ((int(m[0]), tuple(int(v) for v in m[1]), tuple(int(v) for v in m[2])),
            (int(s[0]), tuple(int(v) for v in s[1]), tuple(int(v) for v in s[2])))


@pytest.mark.parametrize("qp", [22, 37])
@pytest.mark.parametrize("seed", [0, 1, 2])
def test_dynamic_forward_equals_jax_and_oracle(qp, seed):
    """rec, every max_u, step_y and b_adj, on a batch of 2 at 17x29; seed
    2 carries biases past 2^24."""
    jp = _dynamic_params(qp, seed)
    x = synth_frames(2, 17, 29, seed=seed)
    rec, tel = D.make_dynamic_forward(DynamicParams.from_arrays(jp), device="cpu")(x)
    jrec, jtel = JD.make_dynamic_forward(jp)(x)
    orec, otel = O.forward_calibrate(x, jp)
    assert rec.dtype == torch.uint8 and rec.shape == x.shape
    assert (rec.numpy() == np.asarray(jrec)).all() and (rec.numpy() == orec).all()
    assert (tel["max_u"], tel["step_y"]) == _as_ints(jtel)
    assert list(tel["max_u"]) == otel["max_u"] and list(tel["step_y"]) == otel["step_y"]
    for mine, theirs, oracle in zip(tel["b_adj"], jtel["b_adj"], otel["b_adj"], strict=True):
        assert mine.dtype == np.int64
        assert (mine == np.asarray(theirs)).all() and (mine == oracle).all()
    if seed == 2:
        assert max(int(np.abs(b).max()) for b in tel["b_adj"]) > 1 << 24


@pytest.mark.parametrize("qp", [22, 37])
@pytest.mark.parametrize("seed", [0, 1, 2])
def test_hybrid_forward_equals_jax_and_oracle(qp, seed):
    """rec and max_u_C1 on a batch of 2 at 17x29; QP22's tables wrap C1's
    unclamped requant through int8 (checked)."""
    jp = synth_engine_params(qp, seed)
    x = synth_frames(2, 17, 29, seed=seed)
    rec, max_u = D.make_hybrid_forward(EngineParams.from_arrays(jp), device="cpu")(x)
    jrec, jmax = JD.make_hybrid_forward(jp)(x)
    assert (rec.numpy() == np.asarray(jrec)).all()
    assert (rec.numpy() == O.forward_dynamic_hybrid(x, jp)).all()
    u1 = O.conv_int(O.preprocess(x[..., None]), jp.weights[0], jp.biases[0])
    assert max_u == int(jmax) == int(np.abs(u1).max())
    if qp == 22:
        v1 = ((u1 + (1 << (jp.shift[0] - 1)) // jp.mul[0]) * jp.mul[0]) >> jp.shift[0]
        assert (v1 > 127).any()  # the wrap is exercised


def test_int8_wrap_is_twos_complement():
    t = torch.tensor([-1000, -129, -128, -1, 0, 127, 128, 255, 256, 1000, 2**40 + 130])
    assert (D._wrap_int8(t).numpy() == t.numpy().astype(np.int8)).all()


def test_hybrid_forward_refuses_per_channel_tables():
    p = MF.read_static_qfp_pc(INT4_PC)
    assert any(np.ndim(v) for v in p.mul)
    with pytest.raises(ValueError, match="per-channel"):
        D.make_hybrid_forward(p, device="cpu")
    with pytest.raises(TypeError):  # the JAX function fails by accident
        JD.make_hybrid_forward(JMF.read_static_qfp_pc(INT4_PC))


def test_dynamic_params_validate_and_carry_jax_containers():
    jp = synth_dynamic_params(37, 0)
    p = DynamicParams.from_arrays(jp)
    p.validate()
    assert p.step_w == list(jp.step_w) and all(isinstance(s, int) for s in p.step_w)
    for bad in ([0] + p.step_w[1:], p.step_w[:5]):
        with pytest.raises(ValueError, match="step_w"):
            dataclasses.replace(p, step_w=bad).validate()


@pytest.mark.parametrize("fmt", ["hwcn", "vect_c"])
def test_dynamic_model_files_equal_jax(fmt, tmp_path):
    """The port's writer gives the JAX writer's bytes; each package reads
    the other's file back to the same parameters."""
    jp = synth_dynamic_params(27, 3)
    p = DynamicParams.from_arrays(jp)
    write, read = getattr(MF, f"write_dynamic_{fmt}"), getattr(MF, f"read_dynamic_{fmt}")
    jwrite, jread = getattr(JMF, f"write_dynamic_{fmt}"), getattr(JMF, f"read_dynamic_{fmt}")
    mine, theirs = io.BytesIO(), io.BytesIO()
    write(mine, p)
    jwrite(theirs, jp)
    assert mine.getvalue() == theirs.getvalue()
    path = str(tmp_path / "m.data")
    write(path, p)
    for q in (read(path), jread(path)):
        assert list(q.step_w) == p.step_w
        for a, b in zip(q.weights + q.biases, p.weights + p.biases, strict=True):
            assert a.dtype == b.dtype and (a == b).all()


def test_b_adj_file_equals_jax(tmp_path):
    """save_b_adj appends the same float32 bytes as JAX's (values past
    2^24 round alike), and read_b_adj reads both back."""
    jp = _big_bias(synth_dynamic_params(37, 0))
    x = synth_frames(3, 17, 29, seed=5)
    run = D.make_dynamic_forward(DynamicParams.from_arrays(jp), device="cpu")
    for i in range(3):
        _, tel = run(x[i:i + 1])
        C.save_b_adj(str(tmp_path / "port.data"), tel["b_adj"])
        JC.save_b_adj(str(tmp_path / "jax.data"), tel["b_adj"])
    raw = (tmp_path / "port.data").read_bytes()
    assert raw == (tmp_path / "jax.data").read_bytes() and len(raw) == 3 * 161 * 4
    mine, theirs = C.read_b_adj(str(tmp_path / "port.data")), JC.read_b_adj(str(tmp_path / "jax.data"))
    assert len(mine) == 3
    for a, b in zip(mine, theirs, strict=True):
        assert all((u == v).all() for u, v in zip(a, b, strict=True))
    assert float(mine[0][0][0]) != (1 << 25) + 1  # float32 rounding, as the reference stores
    with pytest.raises(ValueError, match="6 layers"):
        C.save_b_adj(str(tmp_path / "x.data"), tel["b_adj"][:5])


def test_calibrate_dynamic_equals_jax():
    jp = synth_dynamic_params(22, 1)
    x = synth_frames(3, 17, 29, seed=8)
    maxima, tel = C.calibrate_dynamic(DynamicParams.from_arrays(jp), x, device="cpu")
    jmaxima, jtel = JC.calibrate_dynamic(jp, x)
    assert maxima == jmaxima and len(tel) == len(jtel) == 3
    for mine, theirs in zip(tel, jtel):
        assert list(mine["max_u"]) == theirs["max_u"] and list(mine["step_y"]) == theirs["step_y"]
        assert all((a == b).all() for a, b in zip(mine["b_adj"], theirs["b_adj"], strict=True))


@pytest.mark.parametrize("model", [37, "int4"])
def test_viewmem_report_and_feature_dump_equal_jax(model, tmp_path):
    jp = JMF.read_static_qfp_pc(INT4_PC) if model == "int4" else synth_engine_params(37)
    p = EngineParams.from_arrays(jp)
    x = synth_frames(1, 19, 23, seed=3)
    assert V.viewmem_report(p, x, device="cpu") == JV.viewmem_report(jp, x)
    feats = V.dump_features(p, x, str(tmp_path / "port.bin"), device="cpu")
    jfeats = JV.dump_features(jp, x, str(tmp_path / "jax.bin"))
    assert (tmp_path / "port.bin").read_bytes() == (tmp_path / "jax.bin").read_bytes()
    assert list(feats) == list(jfeats) == list(V.FEATURES)
    for k in feats:
        assert feats[k].shape == jfeats[k].shape and (feats[k] == jfeats[k]).all()


def test_synth_frames_equal_jax():
    assert (T.synth_frames(2, 64, 96, seed=0) == synth_frames(2, 64, 96, seed=0)).all()


def _run_both(argv, tmp_path, capsys):
    """The port's and the JAX CLI on the same arguments, each writing its
    files under its own directory ({d} in argv); -> (port out, jax out)."""
    from qcnn_gpu_tpu import cli as jcli

    out = {}
    for name, mod, extra in (("port", cli, ["--device", "cpu"]), ("jax", jcli, [])):
        d = tmp_path / name
        d.mkdir()
        assert mod.main([a.format(d=d) for a in argv] + extra) == 0
        out[name] = capsys.readouterr().out.replace(str(d), "{d}")
    return out["port"], out["jax"]


def test_cli_calibrate_dynamic_equals_jax_cli(tmp_path, capsys):
    """Both modes on the same YUV: the same text, max_u_C1.data and
    b_adj bytes."""
    x = synth_frames(3, 18, 30, seed=6)
    yuv.write_y_as_420(str(tmp_path / "a.yuv"), x)
    JMF.write_dynamic_hwcn(str(tmp_path / "dyn.data"), _big_bias(synth_dynamic_params(22, 0)))
    JMF.write_static_qfp_vect_c(str(tmp_path / "static.data"), synth_engine_params(22))
    geo = ["--anchor", str(tmp_path / "a.yuv"), "--height", "18", "--width", "30", "--frames", "3"]
    (tmp_path / "dynamic").mkdir()
    port, jax = _run_both(["calibrate-dynamic", "--model", str(tmp_path / "dyn.data"), *geo,
                           "--out", "{d}/max_u_C1.data", "--b-adj-out", "{d}/b_adj.data"],
                          tmp_path / "dynamic", capsys)
    assert port == jax and port.startswith("per-group max_u: [")
    for f in ("max_u_C1.data", "b_adj.data"):
        mine = (tmp_path / "dynamic" / "port" / f).read_bytes()
        assert mine == (tmp_path / "dynamic" / "jax" / f).read_bytes() and mine
    (tmp_path / "hybrid").mkdir()
    port, jax = _run_both(["calibrate-dynamic", "--mode", "hybrid", "--model",
                           str(tmp_path / "static.data"), *geo, "--out", "{d}/max_u_C1.data"],
                          tmp_path / "hybrid", capsys)
    assert port == jax and port.startswith("hybrid max_u_C1: ")
    mine = (tmp_path / "hybrid" / "port" / "max_u_C1.data").read_bytes()
    assert mine == (tmp_path / "hybrid" / "jax" / "max_u_C1.data").read_bytes() and len(mine) == 12


@pytest.mark.parametrize("anchor", [False, True])
def test_cli_validate_equals_jax_cli(anchor, tmp_path, capsys):
    """The report text and the dump bytes, on synthetic frames or on the
    first frame of an anchor, for the vect_c and hwcn formats."""
    jp = synth_engine_params(32)
    JMF.write_static_qfp_vect_c(str(tmp_path / "m.vect_c"), jp)
    JMF.write_static_qfp_hwcn(str(tmp_path / "m.hwcn"), jp)
    extra = []
    if anchor:
        yuv.write_y_as_420(str(tmp_path / "a.yuv"), synth_frames(2, 21, 27, seed=9))
        extra = ["--anchor", str(tmp_path / "a.yuv"), "--height", "21", "--width", "27",
                 "--frames", "2"]
    for fmt in ("vect_c", "hwcn"):
        (tmp_path / fmt).mkdir()
        port, jax = _run_both(["validate", "--model", str(tmp_path / f"m.{fmt}"),
                               "--model-format", fmt, "--dump-features", "{d}/feats.bin", *extra],
                              tmp_path / fmt, capsys)
        assert port == jax and port.startswith("== C1 ==\nmul:")
        mine = (tmp_path / fmt / "port" / "feats.bin").read_bytes()
        assert mine == (tmp_path / fmt / "jax" / "feats.bin").read_bytes() and mine


def test_cli_validate_reads_pc_models_with_the_pc_reader(tmp_path, capsys):
    """The JAX CLI reads a `pc` file with the hwcn reader; the port reads
    it as a per-channel model (the report of JAX's validate on the
    properly read model)."""
    assert cli.main(["validate", "--model", INT4_PC, "--model-format", "pc",
                     "--device", "cpu"]) == 0
    frames = synth_frames(1, 64, 96, seed=0)
    assert capsys.readouterr().out == JV.viewmem_report(JMF.read_static_qfp_pc(INT4_PC), frames) + "\n"
