"""Build the port's CUDA sources at first use and load them with ctypes.

Each `csrc/<name>.cu` exposes a plain C interface and is compiled by
`nvcc` into `qcnn_gpu_tpu_torch/build/lib<name>-<hash>.so`, where the hash
covers the sources in `csrc/`, the flags and the preprocessor defines: an
edited source rebuilds, an unchanged one loads the library already built.
A source built with defines (generation 3's diagnostic instances) is a
library of its own, keyed `<name>[<define>,...]`. Only the sources in the
repository are used, except by a measurement that names another checkout's
`csrc` (`tools/compare_builds`: a library of its own, keyed
`<name>@<dir>`). A missing `nvcc` or a failed compile raises; there
is no other path to the kernels.
"""

from __future__ import annotations

import ctypes
import glob
import hashlib
import os
import re
import shutil
import subprocess
import time
from typing import Dict, Tuple

_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC = os.path.join(_PKG, "csrc")
BUILD = os.path.join(_PKG, "build")

NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-lineinfo",
    "-shared", "-Xcompiler", "-fPIC",
    "-Xptxas", "-v",
)

# key (`key(name, defines)`) -> {"seconds": build time (0.0 when the
# library was already built), "log": nvcc's output, incl. -Xptxas -v
# register/smem report}
build_info: Dict[str, dict] = {}
_loaded: Dict[str, ctypes.CDLL] = {}


def nvcc_path() -> str:
    """nvcc from $CUDA_HOME, $PATH or /usr/local/cuda; raises if absent."""
    cands = [
        os.path.join(os.environ[v], "bin", "nvcc")
        for v in ("CUDA_HOME", "CUDA_PATH")
        if os.environ.get(v)
    ]
    cands += [shutil.which("nvcc") or "", "/usr/local/cuda/bin/nvcc"]
    for c in cands:
        if c and os.path.isfile(c) and os.access(c, os.X_OK):
            return c
    raise RuntimeError(
        "nvcc not found (looked in $CUDA_HOME, $CUDA_PATH, $PATH and "
        "/usr/local/cuda/bin): the CUDA kernels cannot be built"
    )


def _digest(src: str, flags: Tuple[str, ...], csrc: str = CSRC) -> str:
    h = hashlib.sha256(" ".join(flags).encode())
    for path in sorted(glob.glob(os.path.join(csrc, "*.cu*"))):
        with open(path, "rb") as fp:
            h.update(os.path.basename(path).encode() + fp.read())
    h.update(src.encode())
    return h.hexdigest()[:16]


def key(name: str, defines: Tuple[str, ...] = ()) -> str:
    """The library of csrc/<name>.cu built with `defines` ("NAME=value"):
    `name` alone without defines, else `name[define,...]`."""
    return f"{name}[{','.join(defines)}]" if defines else name


def library(name: str, defines: Tuple[str, ...] = (), csrc: str = CSRC) -> ctypes.CDLL:
    """Compile (if needed) and load csrc/<name>.cu with `defines` passed
    to nvcc as -D flags; cached per process. `csrc` names another
    directory of sources (keyed `<name>@<csrc>`)."""
    k = key(name, defines) if csrc == CSRC else f"{key(name, defines)}@{csrc}"
    if k in _loaded:
        return _loaded[k]
    src = os.path.join(csrc, f"{name}.cu")
    if not os.path.isfile(src):
        raise FileNotFoundError(f"CUDA source not found: {src}")
    flags = NVCC_FLAGS + tuple(f"-D{d}" for d in defines)
    so = os.path.join(BUILD, f"lib{name}-{_digest(src, flags, csrc)}.so")
    if os.path.exists(so):
        build_info[k] = {"seconds": 0.0, "log": "already built: " + so}
    else:
        nvcc = nvcc_path()
        os.makedirs(BUILD, exist_ok=True)
        tmp = f"{so}.{os.getpid()}.tmp"
        t0 = time.perf_counter()
        proc = subprocess.run(
            [nvcc, *flags, "-o", tmp, src],
            capture_output=True, text=True,
        )
        seconds = time.perf_counter() - t0
        log = proc.stdout + proc.stderr
        if proc.returncode != 0:
            if os.path.exists(tmp):
                os.remove(tmp)
            raise RuntimeError(f"nvcc failed on {key(name, defines)} "
                               f"(rc={proc.returncode}):\n{log}")
        os.replace(tmp, so)  # atomic: a concurrent process never loads a partial file
        build_info[k] = {"seconds": seconds, "log": log}
    lib = ctypes.CDLL(so)
    _loaded[k] = lib
    return lib


def function(name: str, symbol: str, argtypes, defines: Tuple[str, ...] = ()) -> ctypes._CFuncPtr:
    """The C function `symbol` of csrc/<name>.cu (built with `defines`)
    with its argument types set and an int (cudaError_t) result."""
    lib = library(name, defines)
    fn = getattr(lib, symbol)
    if fn.argtypes is None:
        fn.argtypes = list(argtypes)
        fn.restype = ctypes.c_int
        lib.qvrcnn_error_string.argtypes = [ctypes.c_int]
        lib.qvrcnn_error_string.restype = ctypes.c_char_p
    return fn


def check(name: str, err: int, defines: Tuple[str, ...] = ()) -> None:
    """Raise RuntimeError for a nonzero cudaError_t from csrc/<name>.cu
    (built with `defines`)."""
    if err != 0:
        msg = library(name, defines).qvrcnn_error_string(err).decode()
        raise RuntimeError(f"{key(name, defines)} launch failed: CUDA error {err} ({msg})")


def ptxas_instances(log: str) -> Dict[Tuple[int, int], dict]:
    """nvcc's `-Xptxas -v` report (`build_info[...]["log"]`) per kernel
    instance of a tiled library: (th, tw), the first two integer template
    arguments of the entry's mangled name, -> {"registers",
    "spill_stores", "spill_loads"}."""
    out = {}
    for part in re.split(r"Compiling entry function ", log)[1:]:
        name = part.split("'")[1]
        tile = re.search(r"Li(\d+)ELi(\d+)E", name)
        regs = re.search(r"Used (\d+) registers", part)
        spills = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads", part)
        if tile and regs and spills:
            out[int(tile.group(1)), int(tile.group(2))] = {
                "registers": int(regs.group(1)),
                "spill_stores": int(spills.group(1)), "spill_loads": int(spills.group(2))}
    return out


def stream_of(t) -> int:
    """The current CUDA stream of tensor `t`'s device, as an int."""
    import torch

    return torch.cuda.current_stream(t.device).cuda_stream
