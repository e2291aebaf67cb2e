"""The C++ host side, built at first use: the packed wire transports and
the bulk Y-plane reader.

The port's own copy of `qcnn_gpu_tpu/native/`: `transport.cpp` here is
its `transport.cpp`, and `duplex_pack`, `residual_decode`,
`duplex_predict` and `duplex_decode8` mirror its bindings
(`qcnn_gpu_tpu/native/__init__.py:126-224`); `yuvio.cpp` is the reader and
writer of its `yuvio.cpp`, and `read_y` and `write_y_as_420` mirror their
bindings (:101-124). Each source is compiled with `g++ -O3 -shared -fPIC`
into `qcnn_gpu_tpu_torch/build/lib<name>-<hash>.so` (the hash covers the
source and the flags, so an edited source rebuilds; a temporary file
then `os.replace`, so a concurrent process never loads a partial file)
and loaded with ctypes. The JAX package falls back to NumPy without a
compiler; the port raises, as `ops/build.py` does without nvcc. The NumPy
functions in `engine/packed.py` and `data/yuv.py` define the semantics
the tests hold these to.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading

import numpy as np

_DIR = os.path.dirname(os.path.abspath(__file__))
BUILD = os.path.join(os.path.dirname(_DIR), "build")
FLAGS = ("-O3", "-shared", "-fPIC")

_P = ctypes.c_void_p
_I = ctypes.c_longlong
# library -> {function: (argtypes, restype)}
_SIGNATURES = {
    "transport": {
        "duplex_classify": ([_P, _P, _I, _P, _P], None),
        "duplex_fill": ([_P, _P, _I] + [_P] * 7, None),
        "residual_decode": ([_P, _P, _I, _I, _P, _P, _I, _P], None),
        "duplex_predict_tiles": ([_P, _P, _I, _I, _I, _P], None),
        "duplex_predict_blocks": ([_P, _I, _I, _I, _P], None),
        "duplex_decode8": ([_P, _I, _I, _P, _P, _I, _I, _P, _P, _P, _P], None),
    },
    "yuvio": {
        "read_y_planes": ([ctypes.c_char_p, _I, _I, _I, _I, _P], _I),
        "write_y_as_420": ([ctypes.c_char_p, _P, _I, _I, _I], ctypes.c_int),
    },
}
_lib = None  # the transport library, once loaded
_yuvio = None  # the Y-plane IO library, once loaded
_lock = threading.Lock()


def _load(name: str) -> ctypes.CDLL:
    """Compile `<name>.cpp` unless its library is built, and load it;
    raises without g++ or when g++ fails."""
    src = os.path.join(_DIR, f"{name}.cpp")
    with open(src, "rb") as fp:
        digest = hashlib.sha256(" ".join(FLAGS).encode() + fp.read()).hexdigest()[:16]
    so = os.path.join(BUILD, f"lib{name}-{digest}.so")
    if not os.path.exists(so):
        gxx = shutil.which("g++")
        if gxx is None:
            raise RuntimeError(f"g++ not found on $PATH: the {name} library cannot be built")
        os.makedirs(BUILD, exist_ok=True)
        tmp = f"{so}.{os.getpid()}.tmp"
        proc = subprocess.run([gxx, *FLAGS, src, "-o", tmp], capture_output=True, text=True)
        if proc.returncode != 0:
            if os.path.exists(tmp):
                os.remove(tmp)
            raise RuntimeError(f"g++ failed on {src} (rc={proc.returncode}):\n"
                               f"{proc.stdout}{proc.stderr}")
        os.replace(tmp, so)  # atomic: a concurrent process never loads a partial file
    h = ctypes.CDLL(so)
    for fn_name, (argtypes, restype) in _SIGNATURES[name].items():
        fn = getattr(h, fn_name)
        fn.argtypes = argtypes
        fn.restype = restype
    return h


def lib() -> ctypes.CDLL:
    """The transport library (transport.cpp), built at first use."""
    global _lib
    with _lock:
        if _lib is None:
            _lib = _load("transport")
        return _lib


def yuvio() -> ctypes.CDLL:
    """The Y-plane IO library (yuvio.cpp), built at first use."""
    global _yuvio
    with _lock:
        if _yuvio is None:
            _yuvio = _load("yuvio")
        return _yuvio


def _ptr(a: np.ndarray):
    return a.ctypes.data_as(ctypes.c_void_p)


def duplex_pack(x: np.ndarray, refs: np.ndarray, bucket_fn):
    """Block-sparse temporal-delta pack of x against refs (uint8 [B, H, W];
    engine/packed._pack_payload_numpy's semantics):
    ((nib_idx, nib, raw_idx, raw_val, idx, val), n_exc_total). bucket_fn
    sizes the padded buffers."""
    h = lib()
    n = x.size
    nb = -(-n // 256)
    xf = np.ascontiguousarray(x, dtype=np.uint8).reshape(-1)
    rf = np.ascontiguousarray(refs, dtype=np.uint8).reshape(-1)
    if rf.size != n:
        raise ValueError(f"refs hold {rf.size} pixels, x {n}")
    cls = np.empty(nb, np.uint8)
    counts = np.zeros(4, np.int64)
    h.duplex_classify(_ptr(xf), _ptr(rf), n, _ptr(cls), _ptr(counts))
    n_raw, n_nib, n_exc, n_exc_all = (int(v) for v in counts)
    kr, kn, ke = bucket_fn(n_raw), bucket_fn(n_nib), bucket_fn(n_exc)
    raw_idx = np.full(kr, nb, np.int32)
    raw_val = np.zeros((kr, 256), np.int8)
    nib_idx = np.full(kn, nb, np.int32)
    nib = np.zeros((kn, 128), np.uint8)
    idx = np.full(ke, nb * 256, np.int32)
    val = np.zeros(ke, np.int16)
    h.duplex_fill(
        _ptr(xf), _ptr(rf), n, _ptr(cls),
        _ptr(nib_idx), _ptr(nib), _ptr(raw_idx), _ptr(raw_val),
        _ptr(idx), _ptr(val),
    )
    return (nib_idx, nib, raw_idx, raw_val, idx, val), n_exc_all


def residual_decode(x_host: np.ndarray, nib: np.ndarray, idx: np.ndarray,
                    val: np.ndarray, n_exc: int) -> np.ndarray:
    """Packed-residual decode (engine/packed._decode_residual_numpy's
    semantics) -> uint8 like x_host."""
    h = lib()
    b, hh, w = x_host.shape
    x = np.ascontiguousarray(x_host, dtype=np.uint8)
    nibc = np.ascontiguousarray(nib, dtype=np.uint8)
    if nibc.shape != (b, hh, (w + 1) // 2):
        raise ValueError(f"nibbles {nibc.shape} for frames {x.shape}")
    idxc = np.ascontiguousarray(idx, dtype=np.int32)
    valc = np.ascontiguousarray(val, dtype=np.int16)
    if not 0 <= n_exc <= min(idxc.size, valc.size):
        raise ValueError(f"{n_exc} exceptions for {idxc.size} slots")
    out = np.empty_like(x)
    h.residual_decode(
        _ptr(x), _ptr(nibc), b * hh, w, _ptr(idxc), _ptr(valc), n_exc, _ptr(out)
    )
    return out


def duplex_predict(x: np.ndarray, refs: np.ndarray):
    """Predicted-changed-block list (engine/packed._predict_changed_blocks'
    semantics) -> (bidx int32 ascending, nb). The dilation of the 8-px tile
    mask runs in NumPy (a small grid)."""
    h = lib()
    b, hh, w = x.shape
    ht, wt = -(-hh // 8), -(-w // 8)
    xc = np.ascontiguousarray(x, dtype=np.uint8)
    rc = np.ascontiguousarray(refs, dtype=np.uint8)
    if rc.shape != xc.shape:
        raise ValueError(f"refs {rc.shape}, x {xc.shape}")
    tiles = np.zeros(b * ht * wt, np.uint8)
    h.duplex_predict_tiles(_ptr(xc), _ptr(rc), b, hh, w, _ptr(tiles))
    t = tiles.reshape(b, ht, wt).astype(bool)
    dil = t.copy()
    dil[:, 1:] |= t[:, :-1]
    dil[:, :-1] |= t[:, 1:]
    d2 = dil.copy()
    d2[:, :, 1:] |= dil[:, :, :-1]
    d2[:, :, :-1] |= dil[:, :, 1:]
    nb = -(-b * hh * w // 256)
    blk = np.zeros(nb, np.uint8)
    h.duplex_predict_blocks(
        _ptr(np.ascontiguousarray(d2.astype(np.uint8)).reshape(-1)),
        b, hh, w, _ptr(blk),
    )
    return np.nonzero(blk)[0].astype(np.int32), nb


def duplex_decode8(x: np.ndarray, rows: np.ndarray, bidx: np.ndarray,
                   nbp: int, prev_res: np.ndarray):
    """Duplex receive decode of gathered int8 residual-delta blocks
    (engine/packed._duplex_decode8_numpy's semantics) -> (rec uint8
    [B, H, W], last residual int16 [1, H, W])."""
    h = lib()
    b, hh, w = x.shape
    hw = hh * w
    xc = np.ascontiguousarray(x, dtype=np.uint8)
    rowsc = np.ascontiguousarray(rows, dtype=np.int8)
    bidxc = np.ascontiguousarray(bidx, dtype=np.int32)
    prevc = np.ascontiguousarray(prev_res.reshape(-1), dtype=np.int16)
    if rowsc.shape != (bidxc.size, 256) or prevc.size != hw:
        raise ValueError(f"rows {rowsc.shape}, {bidxc.size} block indices, "
                         f"carry of {prevc.size} pixels for frames {xc.shape}")
    rec = np.empty_like(xc)
    res_last = np.empty(hw, np.int16)
    scratch = np.empty(b * hw, np.int16)
    h.duplex_decode8(
        _ptr(xc), b, hw, _ptr(rowsc), _ptr(bidxc), rowsc.shape[0], nbp,
        _ptr(prevc), _ptr(rec), _ptr(res_last), _ptr(scratch),
    )
    return rec, res_last.reshape(1, hh, w)


def read_y(path: str, height: int, width: int, frames: int, start: int = 0) -> np.ndarray:
    """`frames` Y planes of a YUV420p file from frame `start` -> uint8
    [frames, H, W] (`yuvio.cpp` read_y_planes). Raises FileNotFoundError
    when the file does not open, EOFError (data/yuv.read_y_numpy's text)
    when it holds fewer frames."""
    out = np.empty((frames, height, width), dtype=np.uint8)
    got = yuvio().read_y_planes(os.fsencode(path), height, width, start, frames, _ptr(out))
    if got < 0:
        raise FileNotFoundError(path)
    if got < frames:
        raise EOFError(f"{path}: wanted {frames} frames, got {got} ({height}x{width})")
    return out


def write_y_as_420(path: str, y: np.ndarray) -> None:
    """uint8 [frames, H, W] -> a YUV420p file, a zero UV plane after each
    Y plane (`yuvio.cpp` write_y_as_420). Raises OSError when the write
    fails."""
    y = np.ascontiguousarray(y, dtype=np.uint8)
    if y.ndim != 3:
        raise ValueError(f"expected uint8 frames [N, H, W], got shape {y.shape}")
    if yuvio().write_y_as_420(os.fsencode(path), _ptr(y), *y.shape) != 0:
        raise OSError(f"write failed: {path}")
