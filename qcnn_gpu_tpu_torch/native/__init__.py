"""The C++ host side of the packed wire transports, built at first use.

The port's own copy of the transport half of `qcnn_gpu_tpu/native/`:
`transport.cpp` here is its `transport.cpp`, and `duplex_pack`,
`residual_decode`, `duplex_predict` and `duplex_decode8` mirror its
bindings (`qcnn_gpu_tpu/native/__init__.py:126-224`). `lib()` compiles
`transport.cpp` with `g++ -O3 -shared -fPIC` into
`qcnn_gpu_tpu_torch/build/libtransport-<hash>.so` (the hash covers the
source and the flags, so an edited source rebuilds) and loads it with
ctypes. The JAX package falls back to NumPy without a compiler; the port
raises, as `ops/build.py` does without nvcc. The NumPy functions in
`engine/packed.py` define the semantics the tests hold these to.
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
SRC = os.path.join(_DIR, "transport.cpp")
BUILD = os.path.join(os.path.dirname(_DIR), "build")
FLAGS = ("-O3", "-shared", "-fPIC")

_P = ctypes.c_void_p
_I = ctypes.c_longlong
_SIGNATURES = {
    "duplex_classify": [_P, _P, _I, _P, _P],
    "duplex_fill": [_P, _P, _I] + [_P] * 7,
    "residual_decode": [_P, _P, _I, _I, _P, _P, _I, _P],
    "duplex_predict_tiles": [_P, _P, _I, _I, _I, _P],
    "duplex_predict_blocks": [_P, _I, _I, _I, _P],
    "duplex_decode8": [_P, _I, _I, _P, _P, _I, _I, _P, _P, _P, _P],
}
_lib = None
_lock = threading.Lock()


def lib() -> ctypes.CDLL:
    """Compile (if needed) and load transport.cpp; raises without g++."""
    global _lib
    with _lock:
        if _lib is not None:
            return _lib
        with open(SRC, "rb") as fp:
            digest = hashlib.sha256(" ".join(FLAGS).encode() + fp.read()).hexdigest()[:16]
        so = os.path.join(BUILD, f"libtransport-{digest}.so")
        if not os.path.exists(so):
            gxx = shutil.which("g++")
            if gxx is None:
                raise RuntimeError("g++ not found on $PATH: the transport library cannot be built")
            os.makedirs(BUILD, exist_ok=True)
            tmp = f"{so}.{os.getpid()}.tmp"
            proc = subprocess.run([gxx, *FLAGS, SRC, "-o", tmp], capture_output=True, text=True)
            if proc.returncode != 0:
                if os.path.exists(tmp):
                    os.remove(tmp)
                raise RuntimeError(f"g++ failed on {SRC} (rc={proc.returncode}):\n"
                                   f"{proc.stdout}{proc.stderr}")
            os.replace(tmp, so)  # atomic: a concurrent process never loads a partial file
        h = ctypes.CDLL(so)
        for name, argtypes in _SIGNATURES.items():
            fn = getattr(h, name)
            fn.argtypes = argtypes
            fn.restype = None
        _lib = h
        return _lib


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
