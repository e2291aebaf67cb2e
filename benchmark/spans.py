"""The program's spans in a trace, and the device work each launched.

The port names its parts with `torch.profiler.record_function` spans
(`qcnn_gpu_tpu_torch/spans.py`): `stream.*` around each batch's steps,
`conv.*` around the library GEMM route's parts, `wide.*` around the wide
net's epilogues, `engine.*` around the engine's own work. A `trace.Trace`
keeps them among its host events, as (name, start, end), beside the CUDA
runtime's launches; it keeps no thread and no correlation id. So a
device event is put down to the span that launched it by order:

  * every kernel, memset and device-to-device copy of the window runs on
    the compute stream, enqueued by the producer thread, so the device
    events by start and the launches by host time are one sequence, once
    the launches of the two copy streams, which open inside
    `stream.upload` and `stream.download`, are set aside;
  * a launch belongs to the innermost program span open at its time. The
    fetcher's spans (`FETCHER`) launch nothing and are left out: the
    trace cannot tell its thread from the producer's;
  * the profiler drops a record now and then (2 kernels of 49,407 in one
    traced 20 s window of the wide cell on an H100): the two sequences
    are aligned by class, a kernel launch to a kernel, a copy or memset
    call to a copy or memset. Where the classes disagree, the record
    whose partner is missing is skipped (the choice that leaves the
    longer agreeing run after it), so a drop, of a launch or of an
    event, moves at most the kernels up to the next copy by one place.

Where fewer than `MATCHED` of the launches or of the device events find
their partner, no event is attributed. The names are this copy's, so
that the yardstick stays as it is when the program changes.
"""

from __future__ import annotations

import collections
import re
from typing import Dict, List, Optional, Tuple

from benchmark.trace import Trace, length, union

PREFIXES = ("stream.", "conv.", "wide.", "engine.")
SEND = "stream.send"
STAGE_IN = "stream.stage_in"
UPLOAD = "stream.upload"
DOWNLOAD = "stream.download"
BACKPRESSURE = "stream.backpressure"
FETCHER = ("stream.receive", "stream.wait", "stream.sink")
COPY_STREAMS = (UPLOAD, DOWNLOAD)  # launches here go to the h2d and d2h streams
COMPUTE = ("port", "gemm", "kernel", "copy")  # the trace's kinds on the compute stream
# CUDA runtime and driver calls that put work on a stream: a kernel, or a copy or memset
LAUNCH = re.compile(r"^cu(da)?(Launch\w*Kernel|Memcpy|Memset)")
MATCHED = 0.99  # the share of the launches, and of the events, that must be paired


def program_spans(trace: Trace) -> List[Tuple[str, float, float]]:
    return [h for h in trace.host if h[0].startswith(PREFIXES)]


def innermost(spans, times) -> List[Optional[str]]:
    """For each of `times` (ascending), the name of the innermost of
    `spans` (name, start, end; properly nested) open at that time, or
    None."""
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


def _agree(launches, events, i: int, j: int, n: int = 64) -> int:
    """How many of the next `n` launches from i and events from j agree
    in class."""
    k = 0
    while (k < n and i + k < len(launches) and j + k < len(events)
           and launches[i + k][0] == events[j + k][2]):
        k += 1
    return k


def align(launches, events) -> List[Tuple[Optional[str], Tuple[float, float]]]:
    """(owner, (start, end)) pairs of launches [(class, owner)] and device
    events [(start, end, class)], both in stream order, a class being
    "kernel" or "copy": the next of each is paired where their classes
    agree; where not, one record lacks its partner, and the launch or the
    event is skipped, whichever leaves the longer run of agreeing classes
    after it."""
    out = []
    i = j = 0
    while i < len(launches) and j < len(events):
        if launches[i][0] == events[j][2]:
            out.append((launches[i][1], events[j][:2]))
            i += 1
            j += 1
        elif _agree(launches, events, i + 1, j) >= _agree(launches, events, i, j + 1):
            i += 1
        else:
            j += 1
    return out


def launched(trace: Trace) -> Optional[Dict[Optional[str], List[Tuple[float, float]]]]:
    """The compute stream's device events, (start, end) each, by the span
    that launched them (None: outside every program span); None where the
    trace holds no program span or no such event, or where fewer than
    `MATCHED` of its launches or of its events find their partner."""
    own = [s for s in program_spans(trace) if s[0] not in FETCHER]
    events = sorted((s, e, "copy" if k == "copy" else "kernel")
                    for k in COMPUTE for _, s, e in trace.device[k])
    if not own or not events:
        return None
    calls = sorted((s, "kernel" if "Kernel" in name else "copy")
                   for name, s, _ in trace.host if LAUNCH.match(name))
    owners = innermost(own, [t for t, _ in calls])
    launches = [(cls, o) for (_, cls), o in zip(calls, owners) if o not in COPY_STREAMS]
    pairs = align(launches, events)
    if len(pairs) < MATCHED * max(len(launches), len(events)):
        return None
    out = collections.defaultdict(list)
    for o, ev in pairs:
        out[o].append(ev)
    return out


def device_ms_per_frame(ctx, names) -> Optional[float]:
    """Device ms per frame of the events that spans named `names`
    launched, their union."""
    by = launched(ctx.trace) if ctx.trace is not None else None
    if by is None or not ctx.frames:
        return None
    return 1e3 * length(union(ev for n in names for ev in by.get(n, ()))) / ctx.frames


def host_seconds(trace: Optional[Trace], names) -> Optional[Tuple[int, float]]:
    """(batches, host seconds in spans named `names`): batches are the
    `stream.send` spans; None where the trace has none."""
    if trace is None:
        return None
    spans = program_spans(trace)
    batches = sum(1 for name, _, _ in spans if name == SEND)
    if not batches:
        return None
    return batches, sum(e - s for name, s, e in spans if name in names)
