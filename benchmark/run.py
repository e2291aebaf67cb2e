"""Run one cell of the benchmark once.

    python3 benchmark/run.py --workload <name> --seed <n> --seconds <s> --trace <0|1>

from the root of a checkout. Prints, as the last line of standard output,
one JSON object: `correct`, `attempted`, `failed`, `metrics` (the cell's
end-to-end metrics with `--trace 0`, its per-layer metrics with `--trace
1`), `device`, with `--trace 1` `breakdown`, and last `checks`: each number
compared with the reference beside its limit, which standard error's last
lines repeat. Exits non-zero, printing no result, without as many CUDA
devices as the cell asks for, where the port is not in this checkout, and
where JAX or the JAX package has been loaded once the window has closed.
"""

from __future__ import annotations

import argparse
import json
import os
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FORBIDDEN = ("jax", "jaxlib", "flax", "qcnn_gpu_tpu")


def loaded_forbidden(modules=None) -> list:
    """The names of FORBIDDEN among the top-level names of `modules`
    (default: sys.modules), each compared whole: `qcnn_gpu_tpu_torch` is
    not `qcnn_gpu_tpu`."""
    names = sys.modules if modules is None else modules
    return sorted({m.split(".")[0] for m in names} & set(FORBIDDEN))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    sys.path.insert(0, ROOT)
    import torch

    from benchmark import harness

    cell = harness.load_cell(args.workload, ROOT)
    if not torch.cuda.is_available() or torch.cuda.device_count() < cell.chips:
        print(f"needs {cell.chips} CUDA device(s), found "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}", file=sys.stderr)
        return 2
    import qcnn_gpu_tpu_torch

    pkg = os.path.dirname(os.path.abspath(qcnn_gpu_tpu_torch.__file__))
    if os.path.dirname(pkg) != ROOT:
        print(f"the port loaded from {pkg}, not from this checkout {ROOT}", file=sys.stderr)
        return 2
    result = harness.run_cell(cell, args.seed, args.seconds, bool(args.trace), "cuda", ROOT)
    found = loaded_forbidden()
    if found:
        print(f"loaded in this process: {', '.join(found)}", file=sys.stderr)
        return 3
    print(f"reference check took {result.pop('check_s'):.3f} s", file=sys.stderr)
    for name, c in result["checks"].items():
        print(f"check {name}: {c['value']} (limit {c['limit']})", file=sys.stderr)
    print(json.dumps(result))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
