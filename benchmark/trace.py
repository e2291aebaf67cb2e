"""Reading a `torch.profiler` trace of the measured window.

Device events are sorted into kinds by name: the port's network kernels
(`qvrcnn_` in the name: the split template's instances), the library
GEMMs (`GEMM`), the two copies (`Memcpy HtoD`, `Memcpy DtoH`), memsets and
other copies, and every other kernel. The span arithmetic (`union`,
`length`, `overlap`) is `qcnn_gpu_tpu_torch/tools/profile.py`'s
(`_union`, `_length`, `_overlap`), copied so that the yardstick stays as
it is when the program changes.

Times are in seconds. The host events (CPU operations and the harness's
own `record_function` spans) label the device's idle gaps.
"""

from __future__ import annotations

import collections
import dataclasses
import re
from typing import Dict, List, Tuple

PORT_KERNEL = "qvrcnn_"
# cuBLASLt's int8 GEMMs on Hopper: sm90_xmma_gemm_..., cutlass3x_sm90_..._gemm_...
GEMM = re.compile(r"gemm|xmma|cutlass", re.IGNORECASE)
KINDS = ("port", "gemm", "h2d", "d2h", "copy", "kernel")
HARNESS = "bench."  # the prefix of the harness's own `record_function` spans


def union(spans) -> List[List[float]]:
    """Merge [start, end) spans; -> sorted disjoint spans."""
    out: List[List[float]] = []
    for s, e in sorted(spans):
        if out and s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], e)
        else:
            out.append([s, e])
    return out


def length(spans) -> float:
    return sum(e - s for s, e in spans)


def overlap(a, b) -> float:
    """Total length of the intersection of two disjoint sorted span lists."""
    i = j = 0
    total = 0.0
    while i < len(a) and j < len(b):
        lo, hi = max(a[i][0], b[j][0]), min(a[i][1], b[j][1])
        total += max(0.0, hi - lo)
        if a[i][1] < b[j][1]:
            i += 1
        else:
            j += 1
    return total


def kind(name: str) -> str:
    if name.startswith("Memcpy HtoD"):
        return "h2d"
    if name.startswith("Memcpy DtoH"):
        return "d2h"
    if name.startswith(("Memcpy", "Memset")):
        return "copy"
    if PORT_KERNEL in name:
        return "port"
    if GEMM.search(name):
        return "gemm"
    return "kernel"


@dataclasses.dataclass
class Trace:
    """The device events of a window by kind, (name, start, end) each, and
    the host events (name, start, end), in seconds on one clock; `window_s`
    is the window's length on the host's clock."""

    device: Dict[str, List[Tuple[str, float, float]]]
    host: List[Tuple[str, float, float]]
    window_s: float

    @classmethod
    def from_events(cls, device_events, host_events, window_s: float) -> "Trace":
        dev: Dict[str, list] = {k: [] for k in KINDS}
        for name, s, e in device_events:
            dev[kind(name)].append((name, s, e))
        return cls(dev, list(host_events), window_s)

    def spans(self, *kinds: str) -> List[List[float]]:
        """The union of the device time of these kinds (all kinds if none)."""
        return union((s, e) for k in (kinds or KINDS) for _, s, e in self.device[k])

    def seconds(self, *kinds: str) -> float:
        return length(self.spans(*kinds))

    def busy_s(self) -> float:
        """Seconds in which some kernel or copy ran on the device."""
        return self.seconds()

    def breakdown(self, top: int = 10) -> dict:
        """The device operations that took most time (summed by name), and
        the longest idle gaps between device operations, each named by the
        host operation that overlaps it most; where none does, by the
        innermost of the harness's own spans (`HARNESS`) around it, else
        "host: no event recorded"."""
        by_name: Dict[str, float] = collections.defaultdict(float)
        for evs in self.device.values():
            for name, s, e in evs:
                by_name[name] += e - s
        ops = sorted(by_name.items(), key=lambda kv: -kv[1])[:top]
        busy = self.spans()
        gaps = sorted(((busy[i][1], busy[i + 1][0]) for i in range(len(busy) - 1)),
                      key=lambda g: g[0] - g[1])[:top]
        host = sorted(self.host, key=lambda h: h[1])
        named = []
        for lo, hi in gaps:
            best, label = (0, 0.0, 0.0), "host: no event recorded"
            for name, s, e in host:
                if s >= hi:
                    break
                o = (not name.startswith(HARNESS), min(e, hi) - max(s, lo), s - e)
                if o[1] > 0 and o > best:
                    best, label = o, name
            named.append([label, hi - lo])
        return {"device_ops": [[n, v] for n, v in ops], "idle_gaps": named}


def from_profiler(prof, window_s: float) -> Trace:
    """The Trace of a finished `torch.profiler.profile`, read from its raw
    kineto events (no tree of function events is built)."""
    import torch

    cuda = torch.autograd.DeviceType.CUDA
    dev, host = [], []
    for ev in prof.profiler.kineto_results.events():
        span = (ev.name(), ev.start_ns() * 1e-9, ev.end_ns() * 1e-9)
        if ev.device_type() != cuda:
            host.append(span)
        elif not ev.is_user_annotation():  # a `record_function` span's shadow on the device
            dev.append(span)
    return Trace.from_events(dev, host, window_s)
