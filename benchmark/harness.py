"""One run of one cell: set-up, the measured window, the trace's reading
and the check of what the window returned against the plain reference.

Everything that belongs to one configuration, traffic mix or metric is
found by name from `BENCHMARK.json`:

    configuration  the `file` its entry names (sizes, the system and the
                   reference it uses, the precision of its peak)
    system         `systems/<config["system"]>.py`: `build(params, config,
                   traffic, device)` -> an object with `warmup()` and
                   `stream(batches, on_output)`
    reference      `reference/<config["reference"]>.py`: `load(config, seed,
                   root, device)` makes or reads the weights that both sides
                   are handed, `forward(x, params, int4=False)`
    traffic        `traffic/<name>.json`, read by `traffic.py`
    metric         `metrics/<name>.py`, or where there is none, the reader of
                   the name's part before its first "." (`fps.wide` is read
                   by `metrics/fps.py`): `read(ctx)` -> a number, or None
                   where the run has nothing to read it from

The window starts at the first batch fed. The stream is fed batches
until `seconds` have passed and then drains; the window's length runs
from its start to the last frame returned to host memory. Frames are
sampled into a reservoir (drawn from the seed) as they come back and
compared with the reference once the window has closed, the memory peak
has been read and the program has been freed.
"""

from __future__ import annotations

import contextlib
import dataclasses
import gc
import importlib
import importlib.util
import json
import os
import sys
import time
from typing import Dict, List, Optional

import numpy as np
import torch

from benchmark import roofline, traffic as traffic_mod
from benchmark.trace import Trace, from_profiler

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def process_age_s() -> float:
    """Seconds since this process started (Linux: its start time in
    /proc/self/stat, at the clock tick's resolution)."""
    with open("/proc/self/stat") as fp:
        fields = fp.read().rsplit(")", 1)[1].split()
    return time.clock_gettime(time.CLOCK_BOOTTIME) - int(fields[19]) / os.sysconf("SC_CLK_TCK")


@dataclasses.dataclass
class Cell:
    name: str
    chips: int
    config: dict
    traffic: dict
    metrics: Dict[bool, List[dict]]  # trace on -> the metrics the run reports


def load_bench(root: str = ROOT) -> dict:
    with open(os.path.join(root, "BENCHMARK.json")) as fp:
        return json.load(fp)


def load_cell(name: str, root: str = ROOT, bench: Optional[dict] = None) -> Cell:
    bench = bench if bench is not None else load_bench(root)
    cells = {w["name"]: w for w in bench["workloads"]}
    if name not in cells:
        raise KeyError(f"no workload {name!r} in BENCHMARK.json: {sorted(cells)}")
    w = cells[name]
    entry = {c["name"]: c for c in bench["configs"]}[w["config"]]
    with open(os.path.join(root, entry["file"])) as fp:
        config = json.load(fp)
    tr = traffic_mod.load(os.path.join(root, "benchmark", "traffic", f"{w['traffic']}.json"))

    def mine(ms):
        return [m for m in ms if "workloads" not in m or name in m["workloads"]]

    return Cell(name, w["chips"], config, tr,
                {False: mine(bench["end_to_end"]), True: mine(bench["per_layer"])})


def reader(metric: str, root: str = ROOT):
    """`metrics/<metric>.py`'s `read`, or where that file is missing, that of
    `metrics/<the name up to its first ".">.py`."""
    base = os.path.join(root, "benchmark", "metrics")
    path = os.path.join(base, f"{metric}.py")
    if not os.path.isfile(path):
        path = os.path.join(base, f"{metric.split('.')[0]}.py")
    spec = importlib.util.spec_from_file_location(f"benchmark_metric_{metric}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


def system_module(config: dict):
    return importlib.import_module(f"benchmark.systems.{config['system']}")


def reference_module(config: dict):
    return importlib.import_module(f"benchmark.reference.{config['reference']}")


class Reservoir:
    """A uniform sample of `size` of the frames a window returns, drawn from
    the seed: each kept with its pool index."""

    def __init__(self, size: int, seed: int):
        self.rng = np.random.default_rng(traffic_mod.derive(seed, "check"))
        self.size = size
        self.seen = 0
        self.frames: List[np.ndarray] = []
        self.index: List[int] = []

    def offer(self, out: np.ndarray, start: int) -> None:
        """`out` [n, H, W], restored from pool frames start .. start + n - 1."""
        n = out.shape[0]
        t = self.seen + np.arange(n)
        j = self.rng.integers(0, t + 1)
        for k in np.flatnonzero((t < self.size) | (j < self.size)):
            if t[k] < self.size:
                self.frames.append(out[k].copy())
                self.index.append(start + int(k))
            else:
                self.frames[j[k]] = out[k].copy()
                self.index[j[k]] = start + int(k)
        self.seen += n


@dataclasses.dataclass
class Context:
    """What a metric's reader reads: the window's counts and host-clock
    time, the set-up time, the useful work and peak, and the trace."""

    frames: int
    window_s: float
    setup_s: float
    ops_per_frame: int
    peak_ops: Optional[float]
    trace: Optional[Trace]


def _stream(system, pool, t: dict, seed: int, seconds: float, sample: Reservoir) -> dict:
    starts: List[int] = []
    got = {"frames": 0, "batches": 0, "end": 0.0}
    buf = np.empty((t["batch_frames"], t["height"], t["width"]), np.uint8)
    t0 = time.perf_counter()

    def batches():
        for start, n in traffic_mod.slices(t, seed):
            if time.perf_counter() - t0 >= seconds:
                return
            starts.append(start)
            yield pool[start:start + n]

    def on_output(a):
        out = buf[:a.shape[0]]
        np.copyto(out, a)  # the caller's copy, out of the ring's pinned slot
        sample.offer(out, starts[got["batches"]])
        got["batches"] += 1
        got["frames"] += a.shape[0]
        got["end"] = time.perf_counter()

    with torch.profiler.record_function("bench.stream"):
        system.stream(batches(), on_output)
    return {"t0": t0, "end": got["end"], "attempted": t["batch_frames"] * len(starts),
            "returned": got["frames"]}


def _sync(device) -> None:
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize(device)


def verdict(diff: int, due: int, sampled: int, attempted: int, returned: int):
    """The checks that decide `correct`, each passing where its value is at
    most its limit, and `correct`."""
    checks = {
        "max_abs_diff": {"value": diff, "limit": 0},
        "frames_unchecked": {"value": due - sampled, "limit": 0},
        "frames_missing": {"value": attempted - returned, "limit": 0},
    }
    return checks, due > 0 and all(c["value"] <= c["limit"] for c in checks.values())


def run_cell(cell: Cell, seed: int, seconds: float, trace: bool, device="cuda",
             root: str = ROOT) -> dict:
    """One run; returns the result's fields (without the check for JAX,
    which `run.py` makes in the process that prints)."""
    t, config = cell.traffic, cell.config
    torch.set_num_threads(t["host_threads"])
    dev = torch.device(device)
    cuda = dev.type == "cuda"
    phases = {"start": process_age_s()}
    pool = traffic_mod.make_pool(t, seed, dev)
    phases["pool"] = process_age_s()
    ref = reference_module(config)
    params = ref.load(config, seed, root, dev)
    if cuda:
        torch.cuda.reset_peak_memory_stats(dev)
    system = system_module(config).build(params, config, t, dev)
    phases["build"] = process_age_s()
    system.warmup()
    _sync(dev)
    phases["warmup"] = process_age_s()
    print("set-up (s from the process's start): "
          + ", ".join(f"{k} {v:.3f}" for k, v in phases.items()), file=sys.stderr)
    sample = Reservoir(t["check_frames"], seed)
    acts = [torch.profiler.ProfilerActivity.CPU] + ([torch.profiler.ProfilerActivity.CUDA] if cuda else [])
    prof = torch.profiler.profile(activities=acts) if trace else contextlib.nullcontext()
    with prof:
        setup_s = process_age_s()
        w = _stream(system, pool, t, seed, seconds, sample)
        _sync(dev)
    window_s = w["end"] - w["t0"]
    peak_bytes = torch.cuda.max_memory_allocated(dev) if cuda else 0
    tr = from_profiler(prof, window_s) if trace else None
    del system, prof
    gc.collect()
    if cuda:
        torch.cuda.empty_cache()

    device_name = torch.cuda.get_device_name(dev) if cuda else "cpu"
    ctx = Context(
        frames=w["returned"], window_s=window_s, setup_s=setup_s,
        ops_per_frame=roofline.ops_per_frame(config, t["height"], t["width"]),
        peak_ops=roofline.peak_ops(device_name, config["precision"]), trace=tr)
    metrics = {}
    for m in cell.metrics[trace]:
        v = reader(m["name"], root)(ctx)
        if v is not None:
            metrics[m["name"]] = {"value": v, "unit": m["unit"]}

    c0 = time.perf_counter()
    diff = check(ref, params, pool, sample, dev)
    checks, correct = verdict(diff, min(sample.size, sample.seen), len(sample.frames),
                              w["attempted"], w["returned"])
    dev_info = {"platform": "gpu" if cuda else dev.type, "kind": device_name,
                "count": cell.chips if cuda else 1, "memory_peak_bytes": peak_bytes}
    result = {"correct": bool(correct), "attempted": w["attempted"],
              "failed": w["attempted"] - w["returned"], "metrics": metrics, "device": dev_info}
    if tr is not None:
        dev_info["busy_s"] = tr.busy_s()
        dev_info["window_s"] = window_s
        result["breakdown"] = tr.breakdown()
    result["check_s"] = time.perf_counter() - c0
    result["checks"] = checks
    return result


def check(ref, params, pool: np.ndarray, sample: Reservoir, device) -> int:
    """The largest |restored - reference| over the sampled frames, one frame
    a call to the reference."""
    worst = 0
    for idx, out in zip(sample.index, sample.frames):
        x = torch.from_numpy(pool[idx:idx + 1]).to(device)
        want = ref.forward(x, params)[0].cpu().numpy()
        worst = max(worst, int(np.abs(out.astype(np.int16) - want.astype(np.int16)).max()))
    return worst
