"""Held-out golden PSNRs of the committed models on the 832x480 composite
clip: the port's counterpart of `scripts/make_golden_eval.py`, and what
the 1080p and class-A writers share.

    python -m qcnn_gpu_tpu_torch.tools.make_golden_eval [--device cuda]
        [--out-dir assets/golden]

`eval_goldens` serves each QP's anchors with the committed
`model_q{qp}.data` through `Engine(impl="auto")` (the kernel on the card,
its plain version on the CPU; the integer path is exact, so the PSNRs are
the same numbers either way) and gives the unrounded PSNRs before and
after; with `tile`, through `engine/tiled.restore_tiled` over
`Engine.restore`, as the 1080p and class-A scripts tile (equal to the
whole frame on every pixel). `write_goldens` writes the JSON (PSNRs
rounded to 6 decimals, `indent=1`, the scripts' keys in their order) and,
given a prefix, the `{prefix}_{qp}.data` pairs (two little-endian
doubles, unrounded).

`main` builds `composite_clip(N_EVAL2, phase=0.5)`, which needs
matplotlib's sample data and PIL (ImportError naming the one missing),
and writes `psnr_golden_composite.json` into `--out-dir` (default
`assets/golden`). Departures from the script: the anchors are the
committed `composite_eval` bytes, decoded, where the script re-encodes
(the port never re-encodes a committed anchor); the models are served by
the engine where the script runs the XLA integer graph; and `--out-dir`,
which the script lacks (it writes only into `assets/golden`), so that a
run, a test above all, need not overwrite the committed files.
"""

from __future__ import annotations

import argparse
import json
import os
import struct
from typing import Dict, Mapping, Optional, Tuple

import numpy as np

from qcnn_gpu_tpu_torch.data import yuv
from qcnn_gpu_tpu_torch.data.golden import (
    GOLDEN_DIR,
    H2,
    N_EVAL2,
    QP_QUALITY,
    W2,
    composite_clip,
    jpeg_anchor,
)
from qcnn_gpu_tpu_torch.engine.runner import Engine
from qcnn_gpu_tpu_torch.engine.tiled import restore_tiled

EVAL_PHASE = 0.5  # no overlap with any training pan
MODELS = "model_q{qp}.data (240p-hopper-trained, held out)"


def restorer(engine: Engine, qp: int, tile: Optional[Tuple[int, int]] = None):
    """uint8 frames [N, H, W] -> the engine's restoration at QP `qp`, whole
    or in `tile` = (tile_h, tile_w) windows."""
    if tile is None:
        return lambda frames: engine.restore(frames, qp)
    return lambda frames: restore_tiled(lambda w: engine.restore(w, qp), frames, *tile)


def eval_goldens(clean: np.ndarray, anchors_by_qp: Mapping[int, np.ndarray], models_dir: str,
                 *, device, tile: Optional[Tuple[int, int]] = None) -> Dict[int, Dict[str, float]]:
    """{qp: {"before", "after"}}: each QP's anchors against `clean`, as
    they are and served with `models_dir/model_q{qp}.data` on `device`."""
    engine = Engine(device=device, impl="auto")
    out = {}
    for qp, anchor in anchors_by_qp.items():
        engine.load_model(qp, os.path.join(models_dir, f"model_q{qp}.data"))
        rec = restorer(engine, qp, tile)(anchor)
        out[qp] = {"before": yuv.psnr(anchor, clean), "after": yuv.psnr(rec, clean)}
    return out


def committed_anchors(clean: np.ndarray, tag: str) -> Dict[int, np.ndarray]:
    """{qp: the committed anchors of `clean` under `tag`, decoded}."""
    return {qp: jpeg_anchor(clean, quality, tag) for qp, quality in QP_QUALITY.items()}


def rounded(goldens: Mapping[int, Mapping[str, float]]) -> Dict[str, Dict[str, float]]:
    return {str(qp): {"before": round(g["before"], 6), "after": round(g["after"], 6)}
            for qp, g in goldens.items()}


def write_goldens(path: str, header: dict, goldens: Mapping[int, Mapping[str, float]],
                  static_prefix: Optional[str] = None) -> None:
    """The JSON `{**header, "goldens": rounded}` at `path`; with
    `static_prefix`, each QP's `{static_prefix}_{qp}.data` beside it."""
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    if static_prefix is not None:
        for qp, g in goldens.items():
            with open(f"{static_prefix}_{qp}.data", "wb") as fp:
                fp.write(struct.pack("<2d", g["before"], g["after"]))
    with open(path, "w") as fp:
        json.dump({**header, "goldens": rounded(goldens)}, fp, indent=1)


def parse_args(argv, prog: str, doc: str) -> argparse.Namespace:
    ap = argparse.ArgumentParser(prog=prog, description=doc.splitlines()[0])
    ap.add_argument("--out-dir", default=GOLDEN_DIR,
                    help="where the goldens go (default: the committed assets/golden)")
    ap.add_argument("--device", default="cuda", help="torch device, e.g. cuda, cpu")
    return ap.parse_args(argv)


def print_goldens(goldens: Mapping[int, Mapping[str, float]], quality: bool = False) -> None:
    for qp, g in goldens.items():
        before, after = g["before"], g["after"]
        tag = f" (jpeg q{QP_QUALITY[qp]})" if quality else ""
        print(f"QP{qp}{tag}: {before:.3f} -> {after:.3f} dB ({after - before:+.3f})", flush=True)


def main(argv=None) -> dict:
    args = parse_args(argv, "qcnn_gpu_tpu_torch.tools.make_golden_eval", __doc__)
    clean = composite_clip(N_EVAL2, phase=EVAL_PHASE)
    goldens = eval_goldens(clean, committed_anchors(clean, "composite_eval"), GOLDEN_DIR,
                           device=args.device)
    print_goldens(goldens, quality=True)
    out = os.path.join(args.out_dir, "psnr_golden_composite.json")
    write_goldens(out, {"clip": "DEM+MRI+photo composite pan", "geometry": [H2, W2],
                        "frames_eval": N_EVAL2, "phase": EVAL_PHASE, "qp_quality": QP_QUALITY},
                  goldens)
    print("wrote", out)
    return goldens


if __name__ == "__main__":
    main()
