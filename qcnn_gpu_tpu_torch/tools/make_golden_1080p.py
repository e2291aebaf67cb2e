"""Held-out golden PSNRs of the committed models at 1920x1080: the port's
counterpart of `scripts/make_golden_1080p.py`.

    python -m qcnn_gpu_tpu_torch.tools.make_golden_1080p [--device cuda]
        [--out-dir assets/golden]

The committed per-QP models (trained on the 240p hopper clip) served over
the mirror-tiled composite pan at 1920x1080 (`data/golden.fullhd_clip`,
which needs matplotlib's sample data and PIL) in 540x960 windows, as the
script tiles (`make_golden_eval.eval_goldens`); writes
`psnr_golden_1080p.json` and `psnr_static_fullhd_{qp}.data` into
`--out-dir` (default `assets/golden`). Departures from the script, as in
`make_golden_eval`: the committed `fullhd_eval` anchor bytes, decoded
(the script re-encodes, :40); the engine in place of the XLA graph;
`--out-dir`.
"""

from __future__ import annotations

import json
import os

from qcnn_gpu_tpu_torch.data.golden import GOLDEN_DIR, QP_QUALITY, fullhd_clip
from qcnn_gpu_tpu_torch.tools.make_golden_eval import (
    MODELS,
    committed_anchors,
    eval_goldens,
    parse_args,
    print_goldens,
    rounded,
    write_goldens,
)


def main(argv=None) -> dict:
    args = parse_args(argv, "qcnn_gpu_tpu_torch.tools.make_golden_1080p", __doc__)
    clean = fullhd_clip()
    goldens = eval_goldens(clean, committed_anchors(clean, "fullhd_eval"), GOLDEN_DIR,
                           device=args.device, tile=(540, 960))
    print_goldens(goldens)
    write_goldens(os.path.join(args.out_dir, "psnr_golden_1080p.json"),
                  {"clip": "composite mirror-tiled pan 1920x1080", "frames_eval": clean.shape[0],
                   "qp_quality": QP_QUALITY, "models": MODELS},
                  goldens, os.path.join(args.out_dir, "psnr_static_fullhd"))
    print(json.dumps(rounded(goldens)))
    return goldens


if __name__ == "__main__":
    main()
