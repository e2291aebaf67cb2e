"""YUV 4:2:0 8-bit luma IO and PSNR — the port's own copy.

Mirrors `qcnn_gpu_tpu/data/yuv.py` (`frame_size_420`, `read_y`,
`write_y_as_420`, `psnr`, `psnr_per_frame`), with the same EOFError
texts. `read_y` and `write_y_as_420` go through the native library
(`native/yuvio.cpp`, built at first use; without g++ they raise, there is
no silent fallback), as the JAX `read_y` does when it can
(yuv.py:29-43); `read_y_numpy` and `write_y_as_420_numpy` are the NumPy
versions that define the semantics, which the tests hold them to:

- a YUV420p frame is H*W luma bytes followed by H*W/2 chroma bytes; only
  the Y plane is read and the chroma is skipped;
- PSNR is 10*log10(65025/mse) in double precision;
- the reconstruction writer emits a zero chroma plane.
"""

from __future__ import annotations

import math
import os
from typing import Optional

import numpy as np

from qcnn_gpu_tpu_torch import native


def frame_size_420(height: int, width: int) -> int:
    return height * width * 3 // 2


def read_y(
    path: str, height: int, width: int, frames: Optional[int] = None, start: int = 0
) -> np.ndarray:
    """Read Y planes of a YUV420p file -> uint8 [frames, H, W]; `start`
    skips whole frames first, frames=None reads every frame whose Y plane
    is whole (`read_y_numpy`'s semantics, through `native.read_y`)."""
    if frames is None:
        fsz = frame_size_420(height, width)
        rest = os.path.getsize(path) - start * fsz
        frames = (rest - height * width) // fsz + 1 if rest >= height * width else 0
    if frames == 0:
        raise EOFError(f"{path}: empty")
    return native.read_y(path, height, width, frames, start)


def read_y_numpy(
    path: str, height: int, width: int, frames: Optional[int] = None, start: int = 0
) -> np.ndarray:
    """`read_y` in NumPy: the semantics (yuv.py:45-67)."""
    fsz = frame_size_420(height, width)
    ysz = height * width
    out = []
    with open(path, "rb") as fp:
        if start:
            fp.seek(start * fsz)
        n = 0
        while frames is None or n < frames:
            buf = fp.read(ysz)
            if len(buf) < ysz:
                if frames is not None:
                    raise EOFError(
                        f"{path}: wanted {frames} frames, got {n} ({height}x{width})"
                    )
                break
            out.append(np.frombuffer(buf, dtype=np.uint8).reshape(height, width))
            fp.seek(ysz // 2, 1)  # skip UV
            n += 1
    if not out:
        raise EOFError(f"{path}: empty")
    return np.stack(out)


def write_y_as_420(path: str, y: np.ndarray) -> None:
    """Write uint8 [frames, H, W] luma with a zero UV plane per frame
    (`write_y_as_420_numpy`'s bytes, through `native.write_y_as_420`)."""
    native.write_y_as_420(path, y)


def write_y_as_420_numpy(path: str, y: np.ndarray) -> None:
    """`write_y_as_420` in NumPy: the semantics (yuv.py:70-77)."""
    frames, h, w = y.shape
    uv = np.zeros(h * w // 2, dtype=np.uint8)
    with open(path, "wb") as fp:
        for i in range(frames):
            fp.write(np.ascontiguousarray(y[i], dtype=np.uint8).tobytes())
            fp.write(uv.tobytes())


def psnr(a: np.ndarray, ref: np.ndarray) -> float:
    """10*log10(65025/mse) over all pixels, double accumulation; +inf for
    identical inputs."""
    diff = a.astype(np.float64) - ref.astype(np.float64)
    mse = float(np.mean(diff * diff))
    if mse == 0.0:
        return math.inf
    return 10.0 * math.log10(65025.0 / mse)


def psnr_per_frame(a: np.ndarray, ref: np.ndarray) -> np.ndarray:
    """Per-frame PSNR for [frames, H, W] stacks."""
    diff = a.astype(np.float64) - ref.astype(np.float64)
    mse = np.mean(diff * diff, axis=(1, 2))
    with np.errstate(divide="ignore"):
        return 10.0 * np.log10(65025.0 / mse)
