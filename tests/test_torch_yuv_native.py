"""The port's native Y-plane reader and writer (native/yuvio.cpp through
data/yuv.read_y and write_y_as_420) against their NumPy plain versions
(read_y_numpy, write_y_as_420_numpy) and the JAX package's data/yuv,
byte for byte, with the EOF and missing-file errors of tests/test_native.py.

The JAX side is called only where it reads with NumPy (frames=None) and
writes: its native library is built by tests/test_native.py."""

import os

import numpy as np
import pytest

from qcnn_gpu_tpu.data import yuv as jax_yuv
from qcnn_gpu_tpu_torch import native
from qcnn_gpu_tpu_torch.data import yuv
from qcnn_gpu_tpu_torch.testing import synth_frames

H, W = 24, 38


@pytest.fixture(scope="module")
def clip(tmp_path_factory):
    """(path, frames) of a 6-frame 24x38 file written by the NumPy writer."""
    y = synth_frames(6, H, W, seed=5)
    path = str(tmp_path_factory.mktemp("yuv") / "c.yuv")
    yuv.write_y_as_420_numpy(path, y)
    return path, y


@pytest.mark.parametrize("frames,start", [(6, 0), (2, 1), (1, 5), (None, 0), (None, 4)])
def test_read_equals_numpy_and_jax(clip, frames, start):
    path, y = clip
    got = yuv.read_y(path, H, W, frames, start)
    want = y[start:start + frames] if frames else y[start:]
    assert got.dtype == np.uint8 and got.shape == want.shape and (got == want).all()
    assert (yuv.read_y_numpy(path, H, W, frames, start) == got).all()
    assert (jax_yuv.read_y(path, H, W, start=start)[:frames] == got).all()


def test_read_counts_a_last_frame_whose_chroma_is_cut(clip, tmp_path):
    """frames=None reads every whole Y plane, as the NumPy reader does."""
    path, y = clip
    cut = str(tmp_path / "cut.yuv")
    fsz = yuv.frame_size_420(H, W)
    with open(path, "rb") as src, open(cut, "wb") as dst:
        dst.write(src.read(3 * fsz + H * W + 7))
    assert (yuv.read_y(cut, H, W) == y[:4]).all()
    assert (yuv.read_y_numpy(cut, H, W) == y[:4]).all()
    with open(cut, "r+b") as fp:
        fp.truncate(3 * fsz + H * W - 1)
    assert (yuv.read_y(cut, H, W) == y[:3]).all()


@pytest.mark.parametrize("read", [yuv.read_y, yuv.read_y_numpy], ids=["native", "numpy"])
def test_read_errors(clip, tmp_path, read):
    path, _ = clip
    with pytest.raises(EOFError, match=r"wanted 9 frames, got 6 \(24x38\)"):
        read(path, H, W, 9)
    with pytest.raises(EOFError, match=r"wanted 2 frames, got 1"):
        read(path, H, W, 2, start=5)
    with pytest.raises(EOFError, match="empty"):
        read(path, H, W, start=6)
    with pytest.raises(FileNotFoundError):
        read(str(tmp_path / "nope.yuv"), H, W, 1)


@pytest.mark.parametrize("shape", [(3, 24, 38), (2, 17, 23)], ids=["even", "odd"])
def test_write_bytes_equal_numpy_and_jax(tmp_path, shape):
    """An odd H*W floors the chroma plane as the NumPy writer does."""
    y = synth_frames(*shape, seed=7)
    files = {k: str(tmp_path / f"{k}.yuv") for k in ("native", "numpy", "jax")}
    yuv.write_y_as_420(files["native"], y)
    yuv.write_y_as_420_numpy(files["numpy"], y)
    jax_yuv.write_y_as_420(files["jax"], y)
    data = {k: open(v, "rb").read() for k, v in files.items()}
    assert data["native"] == data["numpy"] == data["jax"]
    assert len(data["native"]) == shape[0] * yuv.frame_size_420(*shape[1:])


def test_write_failure_and_shape_raise(tmp_path):
    with pytest.raises(OSError, match="write failed"):
        yuv.write_y_as_420(str(tmp_path / "no" / "dir.yuv"), synth_frames(1, 8, 8, seed=1))
    with pytest.raises(ValueError, match=r"\[N, H, W\]"):
        native.write_y_as_420(str(tmp_path / "a.yuv"), np.zeros((8, 8), np.uint8))


def test_the_library_is_built_in_the_build_dir_and_raises_without_gxx(monkeypatch, tmp_path):
    """Hash-named in the build directory (a temporary file, then
    os.replace); without g++ the reader raises (no NumPy fallback)."""
    native.yuvio()
    assert any(f.startswith("libyuvio-") and f.endswith(".so") for f in os.listdir(native.BUILD))
    monkeypatch.setattr(native, "_yuvio", None)
    monkeypatch.setattr(native, "BUILD", str(tmp_path))
    monkeypatch.setattr(native.shutil, "which", lambda name: None)
    with pytest.raises(RuntimeError, match="g\\+\\+ not found"):
        yuv.read_y(str(tmp_path / "x.yuv"), H, W, 1)
