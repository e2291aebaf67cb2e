"""The port's tuned kernel table: the tile that serves a geometry.

Counterpart of `qcnn_gpu_tpu/ops/tuning.py`. `tools/sweep_kernel.py`
times generation 3 at every compiled tile (`ops/fused.TILES`) against
its 24x40 tile on the card, and the table records a tile only where it
read faster than 24x40 in every paired repeat; the engine builds its
generation-3 program through `build_tuned(p, device, h, w, batch)`, so
the shipped default is the measured winner. The knobs are `th` and `tw`
(together a tile of `ops/fused.TILES`). JAX's `kernel` knob has no
counterpart: no sweep has shown generation 2 faster than generation 3,
and `--impl kernel2` is the way to run it. `tuned_kwargs` takes the
knobs from, in priority order:

  1. the environment: QCNN_TORCH_KERNEL_TH, QCNN_TORCH_KERNEL_TW;
  2. for batch 1, the `batch1` block of the geometry's entry;
  3. the geometry's entry, `per_geometry["HxW"]`: an exact match, else
     the entry nearest by log pixel count (240p and 4K are classes, not
     points);
  4. the file's top level;

and `build_tuned`'s default, 24x40, stands for what none sets. The table is `tuned_h100.json` beside this package, or the file
QCNN_TORCH_KERNEL_CONFIG names. The port never reads the TPU's
`assets/tuned_kernel.json` or its `QCNN_KERNEL_*` variables: those tiles
are not tiles of this card.

A departure, on purpose: the JAX module skips a malformed file or value
without a word (tuning.py:8-12, :45-57, :109-118), so a mistyped table
serves the default silently. Here a table that is absent, unreadable or
not JSON, an unknown key, a value of the wrong type or out of range, and
a tile that is not compiled raise ValueError naming the file or variable
and the knob.
"""

from __future__ import annotations

import functools
import json
import math
import os
from typing import Dict, Optional

from qcnn_gpu_tpu_torch.ops.fused import (
    TILE_H,
    TILE_W,
    TILES,
    FusedWeights,
    check_tile,
    fused_forward,
)

KNOBS = ("th", "tw")
TUNED_PATH = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
                          "tuned_h100.json")
CONFIG_ENV = "QCNN_TORCH_KERNEL_CONFIG"
KNOB_ENV = "QCNN_TORCH_KERNEL_"
_ALLOWED = {"th": tuple(sorted({t[0] for t in TILES})),
           "tw": tuple(sorted({t[1] for t in TILES}))}


def table_path() -> str:
    """The table in use: QCNN_TORCH_KERNEL_CONFIG, else the shipped one."""
    return os.environ.get(CONFIG_ENV) or TUNED_PATH


def _knob(k: str, v, where: str) -> int:
    if k not in KNOBS:
        raise ValueError(f"{where}: unknown knob {k!r}; the knobs are {', '.join(KNOBS)}")
    if isinstance(v, bool) or not isinstance(v, int):
        raise ValueError(f"{where}: knob {k!r} must be an integer, got {v!r}")
    if v not in _ALLOWED[k]:
        raise ValueError(f"{where}: knob {k!r} = {v} is not one of {list(_ALLOWED[k])}")
    return v


def _knobs(d, where: str, extra: str = "") -> Dict[str, int]:
    """The knobs of a table level (`extra`: the one other key it may hold)."""
    if not isinstance(d, dict):
        raise ValueError(f"{where}: expected an object of knobs, got {type(d).__name__}")
    return {k: _knob(k, v, where) for k, v in d.items() if not (extra and k == extra)}


def _check_tile(cfg: Dict[str, int], where: str) -> None:
    try:
        check_tile((cfg.get("th", TILE_H), cfg.get("tw", TILE_W)))
    except ValueError as e:
        raise ValueError(f"{where}: {e}") from None


def _pixels(key, where: str) -> int:
    try:
        h, w = (int(v) for v in key.split("x"))
    except (AttributeError, ValueError):
        h = w = 0
    if h <= 0 or w <= 0 or key != f"{h}x{w}":
        raise ValueError(f"{where}: per_geometry key {key!r} is not a geometry \"HxW\"")
    return h * w


def check_table(data, where: str) -> dict:
    """`data` if it is a well-formed table, else ValueError naming
    `where` and the key: knobs at the top, `per_geometry` entries keyed
    "HxW" with knobs and an optional `batch1` block, and a compiled tile
    at every level once the levels above it apply."""
    top = _knobs(data, where, "per_geometry")
    _check_tile(top, where)
    per = data.get("per_geometry", {})
    if not isinstance(per, dict):
        raise ValueError(f"{where}: per_geometry must be an object, got {type(per).__name__}")
    for key, entry in per.items():
        at = f"{where} per_geometry[{key}]"
        _pixels(key, where)
        knobs = {**top, **_knobs(entry, at, "batch1")}
        _check_tile(knobs, at)
        if "batch1" in entry:
            _check_tile({**knobs, **_knobs(entry["batch1"], f"{at}.batch1")}, f"{at}.batch1")
    return data


def load_table(path: Optional[str] = None) -> dict:
    """The table at `path` (default `table_path()`), checked by `check_table`."""
    path = path or table_path()
    try:
        with open(path) as fp:
            data = json.load(fp)
    except OSError as e:
        raise ValueError(f"tuned table {path}: cannot read it ({e.strerror})") from None
    except ValueError as e:
        raise ValueError(f"tuned table {path}: not JSON ({e})") from None
    return check_table(data, f"tuned table {path}")


def geometry_class(h: int, w: int, data: Optional[dict] = None) -> Optional[str]:
    """The table's per_geometry key serving (h, w): an exact "HxW" match,
    else the entry with the nearest pixel count (log distance), else None
    when the table has no per_geometry entry."""
    data = load_table() if data is None else data
    per = data.get("per_geometry") or {}
    if not per:
        return None
    key = f"{h}x{w}"
    if key in per:
        return key
    return min(per, key=lambda k: abs(math.log(_pixels(k, "per_geometry") / (h * w))))


def tuned_kwargs(h: Optional[int] = None, w: Optional[int] = None,
                 batch: Optional[int] = None) -> Dict[str, int]:
    """The knobs set for frames of h x w in batches of `batch`, from the
    four tiers (module docstring), highest last; {} where none sets one
    (`build_tuned`'s defaults). A malformed table or variable, or a tile
    that is not compiled, raises ValueError naming its source."""
    path = table_path()
    data = load_table(path)
    cfg: Dict[str, int] = {}
    origin: Dict[str, str] = {}

    def put(knobs: Dict[str, int], where: str) -> None:
        cfg.update(knobs)
        origin.update(dict.fromkeys(knobs, where))

    put(_knobs(data, path, "per_geometry"), path)
    if h and w:
        cls = geometry_class(h, w, data)
        if cls is not None:
            entry = data["per_geometry"][cls]
            put(_knobs(entry, path, "batch1"), f"{path} per_geometry[{cls}]")
            if batch == 1 and "batch1" in entry:
                put(_knobs(entry["batch1"], path), f"{path} per_geometry[{cls}].batch1")
    for k in KNOBS:
        var = KNOB_ENV + k.upper()
        v = os.environ.get(var)
        if v:
            try:
                value = int(v)
            except ValueError:
                raise ValueError(f"{var}: knob {k!r} must be an integer, got {v!r}") from None
            put({k: _knob(k, value, var)}, var)
    if "th" in cfg or "tw" in cfg:
        _check_tile(cfg, " and ".join(sorted({origin[k] for k in ("th", "tw") if k in origin})))
    return cfg


def build_tuned(p, device, h: Optional[int] = None, w: Optional[int] = None,
                batch: Optional[int] = None, **overrides):
    """Generation 3's program for frames of h x w in batches of `batch`,
    at the tuned tile, on `device`: a partial of `fused_forward` over
    `FusedWeights` (which refuse a table outside the solver's saturation
    window). Keyword overrides (`th`, `tw`) beat every tier. The program
    carries its `tile`."""
    kw = tuned_kwargs(h, w, batch)
    kw.update({k: _knob(k, v, "build_tuned") for k, v in overrides.items()})
    _check_tile(kw, "build_tuned")
    tile = (kw.get("th", TILE_H), kw.get("tw", TILE_W))
    run = functools.partial(fused_forward, fw=FusedWeights.from_engine(p, device), tile=tile)
    run.tile = tile
    return run


def write_tuned(cfg: Dict[str, int], path: str = "", geometry: str = "",
                batch1: Optional[Dict[str, int]] = None) -> str:
    """Atomic write (temp + rename) of the knobs in `cfg` (other keys, such
    as a sweep row's times, are dropped). With `geometry` ("HxW") they
    become per_geometry[geometry], with `batch1`'s knobs as its batch-1
    block, and the top level and other geometries are kept; without it
    they replace the top-level knobs (per_geometry kept). An existing file
    that is malformed raises ValueError and is left as it is."""
    path = path or TUNED_PATH
    knobs = {k: cfg[k] for k in KNOBS if k in cfg}
    data = load_table(path) if os.path.exists(path) else {}
    if geometry:
        entry = dict(knobs)
        if batch1:
            entry["batch1"] = {k: batch1[k] for k in KNOBS if k in batch1}
        data.setdefault("per_geometry", {})[geometry] = entry
    else:
        data = {**knobs, "per_geometry": data.get("per_geometry", {})}
        if not data["per_geometry"]:
            del data["per_geometry"]
    check_table(data, f"write_tuned({path})")
    tmp = f"{path}.{os.getpid()}.tmp"
    with open(tmp, "w") as fp:
        json.dump(data, fp, indent=1)
        fp.write("\n")
    os.replace(tmp, path)
    return path
