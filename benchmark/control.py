"""The control of the check that decides `correct`: the plain reference
put in the program's place and computed one precision below the
configuration's (int8 weights carried at 4 bits, `reference/conv.int4_weights`),
at the cell's own frame size, on as many frames as a run compares, drawn
from the seed. Its frames go through the harness's own comparison
(`harness.check`, `harness.verdict`); each seed prints one JSON line with
`correct` and the checks, `max_abs_diff` beside its limit of 0. A control
that came out correct would show the check blind.

    python3 benchmark/control.py --workload <name> --seeds <n> [<n> ...]

The benchmark's runs do not run it.
"""

from __future__ import annotations

import argparse
import json
import os
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def control_reading(cell, seed: int, device) -> dict:
    """The control's frames, judged as a run judges the program's."""
    import numpy as np
    import torch

    from benchmark import harness, traffic

    t = cell.traffic
    pool = traffic.make_pool(t, seed, device)
    ref = harness.reference_module(cell.config)
    params = ref.load(cell.config, seed, ROOT, device)
    rng = np.random.default_rng(traffic.derive(seed, "control"))
    sample = harness.Reservoir(min(t["check_frames"], t["pool_frames"]), seed)
    for i in rng.choice(t["pool_frames"], size=sample.size, replace=False):
        x = torch.from_numpy(pool[i:i + 1]).to(device)
        sample.offer(ref.forward(x, params, int4=True).cpu().numpy(), int(i))
    n = len(sample.frames)
    checks, correct = harness.verdict(harness.check(ref, params, pool, sample, device), n, n, n, n)
    return {"seed": seed, "frames": n, "correct": bool(correct), "checks": checks}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    sys.path.insert(0, ROOT)
    from benchmark import harness

    cell = harness.load_cell(args.workload, ROOT)
    for seed in args.seeds:
        print(json.dumps({"workload": args.workload, **control_reading(cell, seed, args.device)}),
              flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
