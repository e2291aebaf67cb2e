"""Program spans: the parts of the port named on a `torch.profiler` trace.

`span(name)` is a `torch.profiler.record_function` range while a profiler
runs and one shared `contextlib.nullcontext()` otherwise, so a span costs
a flag test (~0.5 us) when nothing traces. There is no switch: spans are
on exactly while a profiler is. A span opened on a thread that the
profiler does not follow (the stream's fetcher, started inside the
window) is recorded only under
`experimental_config=torch._C._profiler._ExperimentalConfig(profile_all_threads=True)`.

The names below are what the readers of a trace look for; each names the
file where it opens:

  stream.*   engine/stream.py: a batch's send (producer thread) and its
             parts, the producer's wait on the full queue, the fetcher's
             receive and its parts
  conv.*     ops/int8_conv.py: the library GEMM route's parts
  wide.*     models/wide.py: the wide net's int32 epilogues
  engine.*   engine/runner.py: `Engine.restore_stream`'s output allocation

`attribute` puts each device event of a trace down to the innermost span
open on the launching thread when its kernel or copy was enqueued: a
device event and its runtime launch (`cudaLaunchKernel`,
`cuLaunchKernel`, `cudaMemcpyAsync`, ...) share a correlation id, and the
launch and the spans share the profiler's thread ids and clock.
"""

from __future__ import annotations

import collections
import contextlib
from typing import Dict, List, Optional, Sequence, Tuple

import torch
import torch.autograd.profiler as _profiler

STREAM_SEND = "stream.send"  # RawTransport.send: a batch up, its program, its download started
STREAM_STAGE_IN = "stream.stage_in"  # the host copy into the pinned slot
STREAM_UPLOAD = "stream.upload"  # the host->device copy's enqueue
STREAM_RUN = "stream.run"  # the program's enqueue on the compute stream
STREAM_DOWNLOAD = "stream.download"  # the device->host copy's enqueue
STREAM_BACKPRESSURE = "stream.backpressure"  # the producer in q.put
STREAM_RECEIVE = "stream.receive"  # RawTransport.receive (fetcher thread)
STREAM_WAIT = "stream.wait"  # the fetcher waiting on the download's event
STREAM_SINK = "stream.sink"  # the caller's sink
CONV_IM2COL = "conv.im2col"  # the pad and each band's tap copy
CONV_GEMM = "conv.gemm"  # the library GEMM
CONV_ASSEMBLE = "conv.assemble"  # a band's accumulators copied into the layer's output
CONV_BIAS = "conv.bias"
WIDE_INPUT = "wide.input"  # uint8 -> centred int8
WIDE_REQUANT = "wide.requant"  # a hidden layer's BLU requant
WIDE_RESIDUAL = "wide.residual"  # the tail's residual and its add
ENGINE_OUTPUT = "engine.output"  # restore_stream's output array
PREFIXES = ("stream.", "conv.", "wide.", "engine.")

_OFF = contextlib.nullcontext()


def span(name: str):
    """A `record_function(name)` while a profiler runs, else a shared no-op."""
    if _profiler._is_profiler_enabled:
        return torch.profiler.record_function(name)
    return _OFF


# ---- reading a trace ------------------------------------------------------

Span = Tuple[str, int, float, float]  # name, thread, start, end
Launch = Tuple[int, int, float]  # correlation id, thread, time
Device = Tuple[str, int, float, float]  # name, correlation id, start, end


def innermost(spans: Sequence[Tuple[str, float, float]],
              times: Sequence[float]) -> List[Optional[str]]:
    """For each of `times` (ascending), the name of the innermost of
    `spans` (name, start, end; properly nested, as the spans of one thread
    are) open at that time, or None."""
    order = sorted(spans, key=lambda sp: (sp[1], -sp[2]))
    out: List[Optional[str]] = []
    stack: list = []
    i = 0
    for t in times:
        while i < len(order) and order[i][1] <= t:
            while stack and stack[-1][2] < order[i][1]:
                stack.pop()
            stack.append(order[i])
            i += 1
        while stack and stack[-1][2] < t:
            stack.pop()
        out.append(stack[-1][0] if stack else None)
    return out


def attribute(spans: Sequence[Span], launches: Sequence[Launch],
              device: Sequence[Device]) -> List[Tuple[Device, Optional[str]]]:
    """Each device event with the innermost span open on its launch's
    thread at its launch, or None: no launch shares its correlation id,
    or no span was open."""
    by_thread: Dict[int, list] = collections.defaultdict(list)
    for name, tid, s, e in spans:
        by_thread[tid].append((name, s, e))
    launched: Dict[int, list] = collections.defaultdict(list)
    for corr, tid, t in launches:
        launched[tid].append((t, corr))
    owner: Dict[int, Optional[str]] = {}
    for tid, ls in launched.items():
        ls.sort()
        for (_, corr), name in zip(ls, innermost(by_thread.get(tid, []), [t for t, _ in ls])):
            owner[corr] = name
    return [(ev, owner.get(ev[1])) for ev in device]


def read_profiler(prof):
    """(spans, launches, device) of a finished `torch.profiler.profile`,
    times in seconds: the program's spans (`PREFIXES`), the CUDA runtime
    and driver calls (their correlation ids are CUPTI's, which the
    device events carry; torch's operators number theirs apart), and the
    device's kernels, copies and memsets."""
    cuda = torch.autograd.DeviceType.CUDA
    spans, launches, device = [], [], []
    for ev in prof.profiler.kineto_results.events():
        name, s, e = ev.name(), ev.start_ns() * 1e-9, ev.end_ns() * 1e-9
        if ev.device_type() == cuda:
            if not ev.is_user_annotation():
                device.append((name, ev.correlation_id(), s, e))
        elif ev.is_user_annotation():
            if name.startswith(PREFIXES):
                spans.append((name, ev.start_thread_id(), s, e))
        elif name.startswith("cu"):
            launches.append((ev.correlation_id(), ev.start_thread_id(), s))
    return spans, launches, device


def device_seconds(prof) -> Dict[Optional[str], float]:
    """Device seconds by the span that launched them (None: outside every
    span), each the union of its events' [start, end)."""
    by: Dict[Optional[str], list] = collections.defaultdict(list)
    for (_, _, s, e), name in attribute(*read_profiler(prof)):
        by[name].append((s, e))
    return {name: length(union(v)) for name, v in by.items()}


def host_seconds(spans: Sequence[Span]) -> Dict[str, Tuple[int, float]]:
    """(count, host seconds) of each span name (`read_profiler`'s first)."""
    out: Dict[str, list] = collections.defaultdict(lambda: [0, 0.0])
    for name, _, s, e in spans:
        out[name][0] += 1
        out[name][1] += e - s
    return {k: (n, t) for k, (n, t) in out.items()}


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
