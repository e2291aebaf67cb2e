"""Held-out golden PSNRs of the committed models at 2560x1600 (class A):
the port's counterpart of `scripts/make_golden_classa.py`.

    python -m qcnn_gpu_tpu_torch.tools.make_golden_classa [--device cuda]
        [--out-dir assets/golden]

The committed per-QP models served over the mirror-tiled composite pan at
2560x1600 (`data/golden.classa_clip`, which needs matplotlib's sample
data and PIL) in 540x960 windows (`make_golden_eval.eval_goldens`);
writes `psnr_golden_classa.json` and `psnr_static_classa_{qp}.data` into
`--out-dir` (default `assets/golden`). Departures from the script: it
encodes the anchors and rewrites the committed anchor bytes
(`write_anchor_bytes`, :41); the port decodes the committed `classa_eval`
bytes and writes no anchor file. The engine serves in place of the XLA
graph, and `--out-dir` is the port's.
"""

from __future__ import annotations

import json
import os

from qcnn_gpu_tpu_torch.data.golden import GOLDEN_DIR, QP_QUALITY, classa_clip
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
    args = parse_args(argv, "qcnn_gpu_tpu_torch.tools.make_golden_classa", __doc__)
    clean = classa_clip()
    goldens = eval_goldens(clean, committed_anchors(clean, "classa_eval"), GOLDEN_DIR,
                           device=args.device, tile=(540, 960))
    print_goldens(goldens)
    write_goldens(os.path.join(args.out_dir, "psnr_golden_classa.json"),
                  {"clip": "composite mirror-tiled pan 2560x1600 (class A)",
                   "frames_eval": clean.shape[0], "qp_quality": QP_QUALITY, "models": MODELS},
                  goldens, os.path.join(args.out_dir, "psnr_static_classa"))
    print(json.dumps(rounded(goldens)))
    return goldens


if __name__ == "__main__":
    main()
