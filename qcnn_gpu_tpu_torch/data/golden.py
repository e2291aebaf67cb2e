"""The committed golden content — the port's own copy.

Mirrors `qcnn_gpu_tpu/data/golden.py` (the whole module but one function):
the deterministic clips the committed golden PSNRs were measured on, built
from matplotlib's sample data, and their JPEG anchors.

  * 416x240: a camera pan over grace_hopper.jpg (`golden_clip`, :41-120);
  * 832x480: a pan over a DEM + MRI + photo composite (`composite_clip`,
    :130-177, :231-242);
  * 1920x1080 and 2560x1600: pans over the composite mirror-tiled
    (`fullhd_clip`, `classa_clip`, :188-228).

`jpeg_anchor` decodes the committed anchor bytes under
`assets/golden/anchors/` and never encodes: where the JAX module falls
back to encoding with the installed PIL (:92-97), a missing file raises
FileNotFoundError here, so that a golden never rests on the encoder's
version. There is no `write_anchor_bytes`.

`jpeg_roundtrip` is the one place the port encodes: each frame through
the installed PIL's JPEG encoder and decoder, the JAX `jpeg_anchor(frames,
quality)` with no tag (:89-97). Two callers use it, for content whose
bytes the repo does not hold: `tools/make_golden`'s training anchors (the
JAX script encodes them the same way, make_golden.py:102; its evaluation
anchors are the committed bytes, decoded) and `bench.py`'s video pool. A
model trained under another PIL version may differ, as the JAX script's
would. PIL and matplotlib are imported inside the functions, as the JAX
module imports them.
"""

from __future__ import annotations

import io
import os

import numpy as np

# JPEG quality standing in for each HEVC QP (anchor PSNR on this clip:
# ~43 / ~38.5 / ~35.5 / ~33 dB — the reference's QP22..QP37 anchor range)
QP_QUALITY = {22: 93, 27: 80, 32: 60, 37: 35}
H, W = 240, 416
N_TRAIN, N_EVAL = 12, 4
H2, W2 = 480, 832
N_EVAL2 = 4
H3, W3 = 1080, 1920
N_EVAL3 = 2
H4, W4 = 1600, 2560
N_EVAL4 = 2

GOLDEN_DIR = os.path.join(
    os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__)))),
    "assets",
    "golden",
)


def _sample_data(name: str) -> str:
    import matplotlib

    return os.path.join(os.path.dirname(matplotlib.__file__), "mpl-data", "sample_data", name)


def hopper_luma() -> np.ndarray:
    """The one real photograph available offline: [600, 512] uint8 luma."""
    from PIL import Image

    return np.asarray(Image.open(_sample_data("grace_hopper.jpg")).convert("L"))


def pan_clip(img: np.ndarray, n: int, phase: float = 0.0) -> np.ndarray:
    """Deterministic camera pan: n crops of HxW along a diagonal track."""
    ih, iw = img.shape
    t = (np.arange(n) + phase) / max(n, 1)
    y0 = np.round(t * (ih - H)).astype(int)
    x0 = np.round((0.5 + 0.5 * np.sin(2 * np.pi * t)) * (iw - W)).astype(int)
    return np.stack([img[y : y + H, x : x + W] for y, x in zip(y0, x0)])


def _anchor_path(tag: str, quality: int) -> str:
    return os.path.join(GOLDEN_DIR, "anchors", f"{tag}_q{quality}.npz")


def jpeg_anchor(frames: np.ndarray, quality: int, tag: str) -> np.ndarray:
    """The committed JPEG anchors of `frames` (the HEVC-anchor stand-in),
    decoded from `assets/golden/anchors/{tag}_q{quality}.npz`. Raises
    FileNotFoundError without that file, ValueError when it holds another
    number of frames."""
    from PIL import Image

    path = _anchor_path(tag, quality)
    if not os.path.exists(path):
        raise FileNotFoundError(f"no committed anchors: {path} (the port never re-encodes)")
    with np.load(path) as z:
        blobs = [z[f"f{i}"] for i in range(len(z.files))]
    if len(blobs) != frames.shape[0]:
        raise ValueError(f"{path}: {len(blobs)} committed anchors for {frames.shape[0]} frames")
    return np.stack(
        [np.asarray(Image.open(io.BytesIO(b.tobytes())).convert("L")) for b in blobs]
    )


def jpeg_roundtrip(frames: np.ndarray, quality: int) -> np.ndarray:
    """Each uint8 frame [N, H, W] encoded as JPEG at `quality` by the
    installed PIL and decoded (module docstring)."""
    from PIL import Image

    out = []
    for f in frames:
        buf = io.BytesIO()
        Image.fromarray(f, "L").save(buf, format="JPEG", quality=quality)
        out.append(np.asarray(Image.open(buf).convert("L")))
    return np.stack(out)


def golden_clip():
    """(train_clean, eval_clean): the 416x240 pans over the photograph."""
    img = hopper_luma()
    return pan_clip(img, N_TRAIN, 0.0), pan_clip(img, N_EVAL, 0.37)


def mri_luma() -> np.ndarray:
    """s1045.ima.gz: a 256x256 MRI slice, scaled to uint8."""
    import gzip

    with gzip.open(_sample_data("s1045.ima.gz")) as fp:
        img = np.frombuffer(fp.read(), np.uint16).reshape(256, 256)
    return (img.astype(np.float64) * (255.0 / max(int(img.max()), 1))).astype(np.uint8)


def dem_luma() -> np.ndarray:
    """jacksboro_fault_dem.npz elevation (344x403) rendered as luma."""
    el = np.load(_sample_data("jacksboro_fault_dem.npz"))["elevation"].astype(np.float64)
    lo, hi = el.min(), el.max()
    return ((el - lo) * (255.0 / (hi - lo))).astype(np.uint8)


def composite_canvas() -> np.ndarray:
    """Deterministic [720, 1152] uint8 canvas: tiled DEM background with
    MRI and photo regions pasted at fixed offsets."""
    canvas = np.tile(dem_luma(), (3, 3))[:720, :1152].copy()
    mri = mri_luma()
    hop = hopper_luma()
    canvas[40:296, 60:316] = mri
    canvas[300:556, 700:956] = mri[::-1, ::-1]  # rotated copy: new phase
    canvas[120:420, 380:636] = hop[100:400, 128:384]
    return canvas


def _pan(img: np.ndarray, n: int, phase: float, h: int, w: int, wave) -> np.ndarray:
    ih, iw = img.shape
    t = (np.arange(n) + phase) / max(n, 1)
    y0 = np.round(t * (ih - h)).astype(int)
    x0 = np.round((0.5 + 0.5 * wave(2 * np.pi * t)) * (iw - w)).astype(int)
    return np.stack([img[y : y + h, x : x + w] for y, x in zip(y0, x0)])


def composite_clip(n: int = N_EVAL2, phase: float = 0.0) -> np.ndarray:
    """Camera pan over the composite at 832x480."""
    return _pan(composite_canvas(), n, phase, H2, W2, np.cos)


def fullhd_canvas() -> np.ndarray:
    """The composite mirror-tiled 2x2 (seam-free): [1440, 2304]."""
    base = composite_canvas()
    return np.block([[base, base[:, ::-1]], [base[::-1, :], base[::-1, ::-1]]])


def fullhd_clip(n: int = N_EVAL3, phase: float = 0.0) -> np.ndarray:
    """Pan over the mirror-tiled composite at 1920x1080."""
    return _pan(fullhd_canvas(), n, phase, H3, W3, np.cos)


def classa_clip(n: int = N_EVAL4, phase: float = 0.0) -> np.ndarray:
    """Pan over a 3x3 mirror-tiled composite at 2560x1600 (class A)."""
    base = composite_canvas()
    row = np.concatenate([base, base[:, ::-1], base], axis=1)
    img = np.concatenate([row, row[::-1], row], axis=0)  # [2160, 3456]
    return _pan(img, n, phase, H4, W4, np.sin)
