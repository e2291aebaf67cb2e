"""The port's own data modules (qcnn_gpu_tpu_torch/data/) against the JAX
package's: model files, YUV IO and PSNR, sequence manifests. Tolerance: 0
(bytes and integers; PSNR compared as the same float)."""

import glob
import os
import warnings

import numpy as np
import pytest

from qcnn_gpu_tpu.data import manifest as JM
from qcnn_gpu_tpu.data import model_files as JMF
from qcnn_gpu_tpu.data import yuv as JY
from qcnn_gpu_tpu.data.golden import GOLDEN_DIR
from qcnn_gpu_tpu.testing import synth_engine_params, synth_frames
from qcnn_gpu_tpu_torch.data import manifest as M
from qcnn_gpu_tpu_torch.data import model_files as MF
from qcnn_gpu_tpu_torch.data import yuv as Y
from qcnn_gpu_tpu_torch.models.engine_params import EngineParams

pytestmark = pytest.mark.quick

GOLDEN_MODELS = sorted(
    os.path.basename(p) for p in glob.glob(os.path.join(GOLDEN_DIR, "model_q*.data"))
)


def _same_params(port, jax_p):
    assert isinstance(port, EngineParams)
    for a, b in zip(port.weights + port.biases, jax_p.weights + jax_p.biases, strict=True):
        assert a.dtype == b.dtype and a.shape == b.shape and (a == b).all()
    for name in ("blu_q", "mul", "shift"):
        for a, b in zip(getattr(port, name), getattr(jax_p, name), strict=True):
            assert np.ndim(a) == np.ndim(b) and (np.asarray(a) == np.asarray(b)).all(), name


def test_every_golden_model_is_committed():
    assert len(GOLDEN_MODELS) == 8 and sum("_int4" in m for m in GOLDEN_MODELS) == 4


@pytest.mark.parametrize("model", GOLDEN_MODELS)
def test_readers_equal_jax_on_committed_models(model):
    path = os.path.join(GOLDEN_DIR, model)
    _same_params(MF.read_static_qfp_auto(path), JMF.read_static_qfp_auto(path))
    with open(path, "rb") as fp:
        pc = fp.read(8) == MF.STATIC_QFP_PC_MAGIC
    reader = "read_static_qfp_pc" if pc else "read_static_qfp_vect_c"
    _same_params(getattr(MF, reader)(path), getattr(JMF, reader)(path))


@pytest.mark.parametrize("fmt,qp", [
    ("hwcn", 22), ("hwcn", 37), ("vect_c", 22), ("vect_c", 37), ("pc", 37),
    ("pc", "int4"),  # per-channel rows have only the pc format
])
def test_write_read_round_trip_and_bytes_equal_jax(tmp_path, fmt, qp):
    if qp == "int4":
        jp = JMF.read_static_qfp_pc(os.path.join(GOLDEN_DIR, "model_q22_int4.data"))
    else:
        jp = synth_engine_params(qp)
    p = EngineParams.from_arrays(jp)
    getattr(MF, f"write_static_qfp_{fmt}")(str(tmp_path / "port.data"), p)
    getattr(JMF, f"write_static_qfp_{fmt}")(str(tmp_path / "jax.data"), jp)
    assert (tmp_path / "port.data").read_bytes() == (tmp_path / "jax.data").read_bytes()
    _same_params(getattr(MF, f"read_static_qfp_{fmt}")(str(tmp_path / "port.data")), jp)


def test_pc_reader_rejects_wrong_magic_like_jax(tmp_path):
    path = str(tmp_path / "m.data")
    MF.write_static_qfp_vect_c(path, EngineParams.from_arrays(synth_engine_params(37)))
    with pytest.raises(ValueError) as port_err:
        MF.read_static_qfp_pc(path)
    with pytest.raises(ValueError) as jax_err:
        JMF.read_static_qfp_pc(path)
    assert str(port_err.value) == str(jax_err.value)


def test_residual_zeroed_warning_like_jax(tmp_path):
    jp = synth_engine_params(37)
    shift = list(jp.shift)
    shift[5] = 40  # maps every accumulator to residual 0
    path = str(tmp_path / "stale.data")
    JMF.write_static_qfp_hwcn(path, type(jp)(jp.weights, jp.biases, jp.blu_q, jp.mul, shift))
    with warnings.catch_warnings(record=True) as port_w:
        warnings.simplefilter("always")
        MF.read_static_qfp_hwcn(path)
    with warnings.catch_warnings(record=True) as jax_w:
        warnings.simplefilter("always")
        JMF.read_static_qfp_hwcn(path)
    assert [str(w.message) for w in port_w] == [str(w.message) for w in jax_w]
    assert len(port_w) == 1 and "restores nothing" in str(port_w[0].message)


def test_psnr_record_file_equal_jax(tmp_path):
    for mod, name in ((MF, "port"), (JMF, "jax")):
        for v in (31.25, float("inf"), 40.0625):
            mod.append_psnr_record(str(tmp_path / name), v)
    assert (tmp_path / "port").read_bytes() == (tmp_path / "jax").read_bytes()
    assert (MF.read_psnr_goldens(str(tmp_path / "port"))
            == JMF.read_psnr_goldens(str(tmp_path / "jax"))).all()


def test_from_arrays_keeps_scalar_and_vector_rows():
    jp = JMF.read_static_qfp_pc(os.path.join(GOLDEN_DIR, "model_q22_int4.data"))
    p = EngineParams.from_arrays(jp)
    p.validate()
    kinds = [(np.ndim(v), getattr(np.asarray(v), "dtype", None)) for v in p.mul]
    assert all(isinstance(v, int) for v in p.mul if np.ndim(v) == 0)
    assert any(n == 1 and dt == np.int64 for n, dt in kinds)


def test_yuv_io_and_psnr_equal_jax(tmp_path):
    y = synth_frames(3, 18, 26, seed=3)
    Y.write_y_as_420(str(tmp_path / "port.yuv"), y)
    JY.write_y_as_420(str(tmp_path / "jax.yuv"), y)
    assert (tmp_path / "port.yuv").read_bytes() == (tmp_path / "jax.yuv").read_bytes()
    path = str(tmp_path / "port.yuv")
    for frames, start in ((3, 0), (2, 1), (None, 0), (None, 2)):
        got = Y.read_y(path, 18, 26, frames, start)
        assert (got == JY.read_y(path, 18, 26, frames, start)).all()
    noisy = np.clip(y.astype(int) + np.random.default_rng(0).integers(-5, 6, y.shape),
                    0, 255).astype(np.uint8)
    assert Y.psnr(noisy, y) == JY.psnr(noisy, y)
    assert Y.psnr(y, y) == JY.psnr(y, y) == float("inf")
    assert (Y.psnr_per_frame(noisy, y) == JY.psnr_per_frame(noisy, y)).all()
    assert Y.frame_size_420(18, 26) == JY.frame_size_420(18, 26)


def test_yuv_eof_errors_equal_jax(tmp_path):
    path = str(tmp_path / "short.yuv")
    JY.write_y_as_420(path, synth_frames(2, 10, 12, seed=1))
    with pytest.raises(EOFError) as port_err:
        Y.read_y(path, 10, 12, 5)
    with pytest.raises(EOFError) as jax_err:
        JY.read_y(path, 10, 12, 5)
    assert str(port_err.value) == str(jax_err.value)
    empty = str(tmp_path / "empty.yuv")
    open(empty, "wb").close()
    with pytest.raises(EOFError) as port_err:
        Y.read_y(empty, 10, 12)
    with pytest.raises(EOFError) as jax_err:
        JY.read_y(empty, 10, 12)
    assert str(port_err.value) == str(jax_err.value)


def test_manifest_equal_jax(tmp_path):
    assert [vars(s) for s in M.JCTVC_SEQUENCES] == [vars(s) for s in JM.JCTVC_SEQUENCES]
    for s, js in zip(M.JCTVC_SEQUENCES, JM.JCTVC_SEQUENCES):
        assert s.ori_path("/d") == js.ori_path("/d")
        assert s.anchor_path("/d", 27) == js.anchor_path("/d", 27)
    specs = [M.SequenceSpec("Foo_64x32_30", "X", 32, 64, frames=3)]
    M.save_manifest(str(tmp_path / "port.json"), specs)
    JM.save_manifest(str(tmp_path / "jax.json"), [JM.SequenceSpec("Foo_64x32_30", "X", 32, 64, 3)])
    assert (tmp_path / "port.json").read_text() == (tmp_path / "jax.json").read_text()
    assert M.load_manifest(str(tmp_path / "jax.json")) == specs
