"""Static model files and the PSNR record — the port's own copy.

Mirrors `qcnn_gpu_tpu/data/model_files.py`: `_warn_if_residual_zeroed`
(:40-60), the VECT_C layout helpers (:68-93), the static qfp readers and
writers in the HWCN, NCHW_VECT_C and per-channel layouts with
`read_static_qfp_auto` (:118-257), the dynamic formats
`read/write_dynamic_hwcn` and `read/write_dynamic_vect_c` (:265-340), and
the float formats `read/write_float_hwcn` (the TF dump, model.py:318-340)
and `read/write_float_nchw` (the FLOAT_CONFIG engine's file, cnn.cu:113-128)
with `hwcn_to_nchw` / `nchw_to_hwcn` (:96-102, :341-411), and
`append_psnr_record` / `read_psnr_goldens` (:412-420), with the same
messages and exceptions.

All integers little-endian; layer order C1, C2_1, C2_2, C3_1, C3_2, C4.
"""

from __future__ import annotations

import struct
import warnings
from typing import BinaryIO, List, Tuple, Union

import numpy as np

from qcnn_gpu_tpu_torch.models.engine_params import DynamicParams, EngineParams
from qcnn_gpu_tpu_torch.models.topology import QVRCNN_LAYERS

PathOrIO = Union[str, BinaryIO]
STATIC_QFP_PC_MAGIC = b"QFPC0001"


def _open(path_or_fp: PathOrIO, mode: str):
    if isinstance(path_or_fp, str):
        return open(path_or_fp, mode), True
    return path_or_fp, False


def _warn_if_residual_zeroed(p: EngineParams, source: PathOrIO) -> EngineParams:
    """Warn when the output layer's (mul, shift) maps even the largest
    accumulator the layer can produce (all inputs at +-127) to residual 0:
    such a model restores nothing (a stale quant table)."""
    w4 = np.abs(np.asarray(p.weights[5], dtype=np.int64))
    u_max = int(w4.sum() * 127 + np.abs(np.asarray(p.biases[5], np.int64)).max())
    if (u_max * p.mul[5]) >> p.shift[5] == 0:
        name = source if isinstance(source, str) else getattr(source, "name", "<stream>")
        warnings.warn(
            f"{name}: output-layer requant (mul={p.mul[5]}, shift={p.shift[5]})"
            f" maps even the maximum accumulator {u_max} to residual 0 — the"
            " model restores nothing (stale quant table? see"
            " QuantTable.fixed_last_row)",
            stacklevel=3,
        )
    return p


def _ceil4(c: int) -> int:
    return (c + 3) // 4 * 4


def hwcn_to_nchw_vect_c(w: np.ndarray) -> np.ndarray:
    """[H,W,C,N] -> [N, ceil(C/4), H, W, 4] with zero-padded channel tail
    (channel c in vector block c>>2, lane c&3)."""
    h, wd, c, n = w.shape
    out = np.zeros((n, _ceil4(c) // 4, h, wd, 4), dtype=w.dtype)
    wt = np.moveaxis(w, (0, 1, 2, 3), (2, 3, 1, 0))  # [N,C,H,W]
    for c0 in range(c):
        out[:, c0 // 4, :, :, c0 % 4] = wt[:, c0]
    return out


def nchw_vect_c_to_hwcn(v: np.ndarray, c: int) -> np.ndarray:
    """Inverse of hwcn_to_nchw_vect_c; `c` is the true (unpadded) channels."""
    n, cblk, h, wd, four = v.shape
    assert four == 4 and cblk * 4 >= c
    out = np.zeros((h, wd, c, n), dtype=v.dtype)
    for c0 in range(c):
        out[:, :, c0, :] = np.moveaxis(v[:, c0 // 4, :, :, c0 % 4], 0, -1)
    return out


def hwcn_to_nchw(w: np.ndarray) -> np.ndarray:
    """[H,W,C,N] -> [N,C,H,W] (mat.cu:160-176)."""
    return np.moveaxis(w, (0, 1, 2, 3), (2, 3, 1, 0)).copy()


def nchw_to_hwcn(w: np.ndarray) -> np.ndarray:
    return np.moveaxis(w, (0, 1, 2, 3), (3, 2, 0, 1)).copy()


def read_static_qfp_hwcn(path: PathOrIO) -> EngineParams:
    """Per layer: w int8[k*k*cin*cout] HWCN, b int32[cout], blu, mul, shift."""
    fp, close = _open(path, "rb")
    try:
        ws, bs, blus, muls, shifts = [], [], [], [], []
        for layer in QVRCNN_LAYERS:
            k, cin, cout = layer.ksize, layer.in_ch, layer.out_ch
            w = np.frombuffer(fp.read(k * k * cin * cout), dtype=np.int8).reshape(
                k, k, cin, cout
            )
            b = np.frombuffer(fp.read(4 * cout), dtype="<i4").astype(np.int32)
            blu, mul, shift = struct.unpack("<3i", fp.read(12))
            ws.append(w.copy())
            bs.append(b)
            blus.append(blu)
            muls.append(mul)
            shifts.append(shift)
        return _warn_if_residual_zeroed(EngineParams(ws, bs, blus, muls, shifts), path)
    finally:
        if close:
            fp.close()


def _check_scalar_rows(p: EngineParams) -> None:
    """The hwcn and vect_c formats hold one (blu, mul, shift) per layer:
    raise ValueError for a per-channel table before a byte is written (the
    JAX writers fail on struct.pack with a TypeError, leaving a partial
    file)."""
    for i, row in enumerate(zip(p.blu_q, p.mul, p.shift)):
        if any(np.ndim(v) for v in row):
            raise ValueError(
                f"layer {i} has per-channel (blu, mul, shift) rows: the hwcn and vect_c "
                "formats hold one per layer; write the table as pc")


def write_static_qfp_hwcn(path: PathOrIO, p: EngineParams) -> None:
    _check_scalar_rows(p)
    fp, close = _open(path, "wb")
    try:
        for i in range(6):
            fp.write(np.ascontiguousarray(p.weights[i], dtype=np.int8).tobytes())
            fp.write(np.asarray(p.biases[i], dtype="<i4").tobytes())
            fp.write(struct.pack("<3i", p.blu_q[i], p.mul[i], p.shift[i]))
    finally:
        if close:
            fp.close()


def read_static_qfp_vect_c(path: PathOrIO) -> EngineParams:
    """The engine-side NCHW_VECT_C static file: per layer
    w int8[k*k*ceil4(cin)*cout], b int32[cout], blu, mul, shift."""
    fp, close = _open(path, "rb")
    try:
        ws, bs, blus, muls, shifts = [], [], [], [], []
        for layer in QVRCNN_LAYERS:
            k, cin, cout = layer.ksize, layer.in_ch, layer.out_ch
            nbytes = k * k * _ceil4(cin) * cout
            v = np.frombuffer(fp.read(nbytes), dtype=np.int8).reshape(
                cout, _ceil4(cin) // 4, k, k, 4
            )
            b = np.frombuffer(fp.read(4 * cout), dtype="<i4").astype(np.int32)
            blu, mul, shift = struct.unpack("<3i", fp.read(12))
            ws.append(nchw_vect_c_to_hwcn(v, cin))
            bs.append(b)
            blus.append(blu)
            muls.append(mul)
            shifts.append(shift)
        return _warn_if_residual_zeroed(EngineParams(ws, bs, blus, muls, shifts), path)
    finally:
        if close:
            fp.close()


def write_static_qfp_vect_c(path: PathOrIO, p: EngineParams) -> None:
    _check_scalar_rows(p)
    fp, close = _open(path, "wb")
    try:
        for i in range(6):
            v = hwcn_to_nchw_vect_c(np.asarray(p.weights[i], dtype=np.int8))
            fp.write(np.ascontiguousarray(v).tobytes())
            fp.write(np.asarray(p.biases[i], dtype="<i4").tobytes())
            fp.write(struct.pack("<3i", p.blu_q[i], p.mul[i], p.shift[i]))
    finally:
        if close:
            fp.close()


def write_static_qfp_pc(path: PathOrIO, p: EngineParams) -> None:
    """Per-channel static format: 8-byte magic, then per layer w int8
    HWCN, b int32[cout], blu, mul and shift int32[cout] each (scalar rows
    are broadcast on write; single-valued rows collapse back to scalars on
    read, so scalar tables round-trip exactly)."""
    fp, close = _open(path, "wb")
    try:
        fp.write(STATIC_QFP_PC_MAGIC)
        for i, layer in enumerate(QVRCNN_LAYERS):
            cout = layer.out_ch
            fp.write(np.ascontiguousarray(p.weights[i], dtype=np.int8).tobytes())
            fp.write(np.asarray(p.biases[i], dtype="<i4").tobytes())
            for v in (p.blu_q[i], p.mul[i], p.shift[i]):
                fp.write(np.broadcast_to(np.asarray(v), (cout,)).astype("<i4").tobytes())
    finally:
        if close:
            fp.close()


def read_static_qfp_pc(path: PathOrIO) -> EngineParams:
    fp, close = _open(path, "rb")
    try:
        magic = fp.read(8)
        if magic != STATIC_QFP_PC_MAGIC:
            raise ValueError(f"{path}: not a static-qfp-pc file (magic {magic!r})")
        ws, bs, blus, muls, shifts = [], [], [], [], []
        for layer in QVRCNN_LAYERS:
            k, cin, cout = layer.ksize, layer.in_ch, layer.out_ch
            w = np.frombuffer(fp.read(k * k * cin * cout), dtype=np.int8).reshape(
                k, k, cin, cout
            )
            b = np.frombuffer(fp.read(4 * cout), dtype="<i4").astype(np.int32)
            rows = []
            for _ in range(3):
                v = np.frombuffer(fp.read(4 * cout), dtype="<i4").astype(np.int64)
                rows.append(int(v[0]) if np.all(v == v[0]) else v)
            ws.append(w.copy())
            bs.append(b)
            blus.append(rows[0])
            muls.append(rows[1])
            shifts.append(rows[2])
        return _warn_if_residual_zeroed(EngineParams(ws, bs, blus, muls, shifts), path)
    finally:
        if close:
            fp.close()


def read_static_qfp_auto(path: str) -> EngineParams:
    """Dispatch on the 8-byte magic: static-qfp-pc files vs the headerless
    NCHW_VECT_C layout."""
    with open(path, "rb") as fp:
        magic = fp.read(8)
    if magic == STATIC_QFP_PC_MAGIC:
        return read_static_qfp_pc(path)
    return read_static_qfp_vect_c(path)


# ---- dynamic model format (stepw, w, b per layer — cnn.cu:69-89) ----------


def read_dynamic_hwcn(path: PathOrIO) -> DynamicParams:
    """Per layer: stepw int32, w int8[k*k*cin*cout] HWCN, b int32[cout]."""
    fp, close = _open(path, "rb")
    try:
        steps, ws, bs = [], [], []
        for layer in QVRCNN_LAYERS:
            k, cin, cout = layer.ksize, layer.in_ch, layer.out_ch
            (stepw,) = struct.unpack("<i", fp.read(4))
            w = np.frombuffer(fp.read(k * k * cin * cout), dtype=np.int8).reshape(
                k, k, cin, cout
            )
            b = np.frombuffer(fp.read(4 * cout), dtype="<i4").astype(np.int32)
            steps.append(stepw)
            ws.append(w.copy())
            bs.append(b)
        return DynamicParams(steps, ws, bs)
    finally:
        if close:
            fp.close()


def write_dynamic_hwcn(path: PathOrIO, p: DynamicParams) -> None:
    fp, close = _open(path, "wb")
    try:
        for i in range(6):
            fp.write(struct.pack("<i", p.step_w[i]))
            fp.write(np.ascontiguousarray(p.weights[i], dtype=np.int8).tobytes())
            fp.write(np.asarray(p.biases[i], dtype="<i4").tobytes())
    finally:
        if close:
            fp.close()


def read_dynamic_vect_c(path: PathOrIO) -> DynamicParams:
    """The engine-side dynamic NCHW_VECT_C file: per layer [stepw int32]
    [w int8 k*k*ceil4(cin)*cout NCHW_VECT_C][b int32*cout] (qvrcnn.cu:398-414,
    read back by load_para, cnn.cu:69-89)."""
    fp, close = _open(path, "rb")
    try:
        steps, ws, bs = [], [], []
        for layer in QVRCNN_LAYERS:
            k, cin, cout = layer.ksize, layer.in_ch, layer.out_ch
            (stepw,) = struct.unpack("<i", fp.read(4))
            nbytes = k * k * _ceil4(cin) * cout
            v = np.frombuffer(fp.read(nbytes), dtype=np.int8).reshape(
                cout, _ceil4(cin) // 4, k, k, 4
            )
            b = np.frombuffer(fp.read(4 * cout), dtype="<i4").astype(np.int32)
            steps.append(stepw)
            ws.append(nchw_vect_c_to_hwcn(v, cin))
            bs.append(b)
        return DynamicParams(steps, ws, bs)
    finally:
        if close:
            fp.close()


def write_dynamic_vect_c(path: PathOrIO, p: DynamicParams) -> None:
    fp, close = _open(path, "wb")
    try:
        for i in range(6):
            fp.write(struct.pack("<i", p.step_w[i]))
            v = hwcn_to_nchw_vect_c(np.asarray(p.weights[i], dtype=np.int8))
            fp.write(np.ascontiguousarray(v).tobytes())
            fp.write(np.asarray(p.biases[i], dtype="<i4").tobytes())
    finally:
        if close:
            fp.close()


def _read_float(path: PathOrIO, nchw: bool) -> Tuple[List[np.ndarray], List[np.ndarray]]:
    fp, close = _open(path, "rb")
    try:
        ws, bs = [], []
        for layer in QVRCNN_LAYERS:
            k, cin, cout = layer.ksize, layer.in_ch, layer.out_ch
            w = np.frombuffer(fp.read(4 * k * k * cin * cout), dtype="<f4")
            w = nchw_to_hwcn(w.reshape(cout, cin, k, k)) if nchw else w.reshape(k, k, cin, cout)
            ws.append(w.astype(np.float32))
            bs.append(np.frombuffer(fp.read(4 * cout), dtype="<f4").astype(np.float32))
        return ws, bs
    finally:
        if close:
            fp.close()


def _write_float(path: PathOrIO, weights, biases, nchw: bool) -> None:
    fp, close = _open(path, "wb")
    try:
        for w, b in zip(weights, biases):
            w = np.asarray(w, dtype="<f4")
            fp.write(np.ascontiguousarray(hwcn_to_nchw(w) if nchw else w).tobytes())
            fp.write(np.asarray(b, dtype="<f4").tobytes())
    finally:
        if close:
            fp.close()


def read_float_hwcn(path: PathOrIO) -> Tuple[List[np.ndarray], List[np.ndarray]]:
    """TF `dump()` order: w1,b1,w2_1,b2_1,... raw float32, HWCN/HWIO."""
    return _read_float(path, nchw=False)


def write_float_hwcn(path: PathOrIO, weights, biases) -> None:
    _write_float(path, weights, biases, nchw=False)


def read_float_nchw(path: PathOrIO) -> Tuple[List[np.ndarray], List[np.ndarray]]:
    """Plain float NCHW engine file: per layer [w f32 NCHW][b f32*cout]
    (the FLOAT_CONFIG engine's load_para, cnn.cu:113-128; produced by
    model_HWCN2NCHW, qvrcnn.cu:444-463). Returned in HWCN/HWIO."""
    return _read_float(path, nchw=True)


def write_float_nchw(path: PathOrIO, weights, biases) -> None:
    _write_float(path, weights, biases, nchw=True)


def read_psnr_goldens(path: str) -> np.ndarray:
    with open(path, "rb") as fp:
        data = fp.read()
    return np.frombuffer(data, dtype="<f8").copy()


def append_psnr_record(path: str, value: float) -> None:
    with open(path, "ab") as fp:
        fp.write(struct.pack("<d", float(value)))
