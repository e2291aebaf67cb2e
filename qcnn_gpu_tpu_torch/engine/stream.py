"""Pipelined host<->device frame streaming.

Counterpart of `qcnn_gpu_tpu/engine/stream.py` (`pipeline_restore` :34,
`measure_stream_fps` :103). The reference runs its timed frame loop
fully serialised, memcpy -> forward -> memcpy one frame at a time
(kernel.cu:89-101); here `depth` batches are in flight: while batch i's
restored frames come down, batch i+1 computes and batch i+2 goes up.

JAX gets the overlap from asynchronous dispatch. On a CUDA device the
port builds it from three streams and a ring of pinned host buffers
(`Staging`):

  * the producer (the caller's thread) copies each uint8 batch into a
    pinned input slot and issues the host->device copy with
    `non_blocking=True` on the h2d stream;
  * the program runs on the compute stream, which waits on that copy's
    event; it is launched from the producer's thread inside
    `torch.cuda.stream(compute)` (the current stream is per thread);
  * the device->host copy into the slot's pinned output runs on the d2h
    stream after the compute stream's event, and records an event;
  * a fetcher thread synchronises on that event, hands the pinned batch
    to the sink (which copies it into the numpy result) and frees the slot.

Each batch's steps are program spans (`qcnn_gpu_tpu_torch/spans.py`),
recorded while a `torch.profiler` runs: on the producer `stream.send`
(inside it `stream.stage_in`, `stream.upload`, `stream.run`,
`stream.download`) and `stream.backpressure` (the wait on the full
queue); on the fetcher `stream.receive` (inside it `stream.wait`,
`stream.sink`).

A tensor allocated on one stream and used on another is marked with
`record_stream`, so the caching allocator never hands its memory to a
later batch while a copy or kernel still reads it. Every pinned slot is
asserted pinned: a pageable `non_blocking` copy would be synchronous.

The loop itself, `pipeline`, runs over a transport: `RawTransport`
here, `packed.DuplexTransport` for the duplex wire. On the CPU the same
loop runs with no streams and no pinning.

The timed span keeps the reference's definition: from uint8 numpy frames
in host memory to restored uint8 frames landed in host memory, so the
host copy into the pinned ring and both device copies are inside it
(`measure_stream_fps`); the ring is built before it, and the outputs are
discarded there, as the JAX function discards them.
"""

from __future__ import annotations

import contextlib
import dataclasses
import queue
import threading
import time
from typing import Callable, Iterable, List, Optional, Sequence

import numpy as np
import torch

from qcnn_gpu_tpu_torch import spans
from qcnn_gpu_tpu_torch.spans import span


def host_copy(dst: np.ndarray, src: np.ndarray) -> None:
    """dst[...] = src, through torch where it can, which copies without
    holding the interpreter lock (the producer and the fetcher copy at
    the same time); torch does not wrap a read-only array."""
    if src.flags.writeable:
        torch.from_numpy(dst).copy_(torch.from_numpy(src))
    else:
        np.copyto(dst, src)


@dataclasses.dataclass
class Pending:
    """A batch's device->host copy in flight: its ring slot, the event
    that ends it, and the host arrays it lands in (CUDA: views of the
    slot's pinned output, valid until the slot is released; CPU: the
    device tensors themselves)."""

    slot: int
    event: Optional[torch.cuda.Event]
    host: list


class Staging:
    """The copy and compute streams of one device and a ring of `slots`
    pinned host buffers each way (CUDA); on the CPU, the same interface
    with no streams and no pinning.

    Slots are taken in turn and released in the same order. Taking a slot
    that was not released raises: a caller holds at most `slots` batches
    between `take` and `release`. The pinned buffers grow to the largest
    batch they have carried; `reserve` sizes them ahead of a timed span.
    Not for concurrent use from two producers."""

    def __init__(self, device, slots: int = 5, in_bytes: int = 0, out_bytes: int = 0):
        if slots < 1:
            raise ValueError(f"slots must be >= 1, got {slots}")
        self.device = torch.device(device)
        self.cuda = self.device.type == "cuda"
        if not self.cuda and self.device.type != "cpu":
            raise ValueError(f"no streaming for device {self.device}")
        self.slots = slots
        self._busy = [False] * slots
        self._next = 0
        self._in: List[Optional[torch.Tensor]] = [None] * slots
        self._out: List[Optional[torch.Tensor]] = [None] * slots
        if self.cuda:
            self.h2d = torch.cuda.Stream(self.device)
            self.compute = torch.cuda.Stream(self.device)
            self.d2h = torch.cuda.Stream(self.device)
        self.reserve(in_bytes, out_bytes)

    # ---- the ring ----------------------------------------------------
    def reserve(self, in_bytes: int, out_bytes: int) -> None:
        """Grow every slot's pinned buffers to at least these sizes (a
        no-op on the CPU)."""
        if self.cuda:
            for s in range(self.slots):
                self._pinned(self._in, s, in_bytes)
                self._pinned(self._out, s, out_bytes)

    @staticmethod
    def _pinned(ring, s: int, nbytes: int) -> torch.Tensor:
        if ring[s] is None or ring[s].numel() < nbytes:
            buf = torch.empty(max(nbytes, 1), dtype=torch.uint8, pin_memory=True)
            if not buf.is_pinned():
                raise RuntimeError("a staging buffer is not pinned: its copies would block")
            ring[s] = buf
        return ring[s]

    @staticmethod
    def offsets(sizes: Sequence[int]) -> List[int]:
        """Where arrays of these byte sizes start in a slot's pinned output
        (`download`), each 16-byte aligned; the last entry is the bytes the
        slot must hold."""
        offs = [0]
        for n in sizes:
            offs.append(offs[-1] + -(-n // 16) * 16)
        return offs

    def take(self) -> int:
        s = self._next % self.slots
        if self._busy[s]:
            raise RuntimeError(
                f"staging slot {s} still holds a batch: at most {self.slots} batches "
                "may be in flight"
            )
        self._busy[s] = True
        self._next += 1
        return s

    def release(self, s: int) -> None:
        self._busy[s] = False

    # ---- copies and compute ------------------------------------------
    def upload(self, s: int, segments: Sequence[np.ndarray]):
        """Copy the segments' bytes, concatenated in order, to one uint8
        device tensor. Returns (tensor, event that ends the copy)."""
        nbytes = sum(a.nbytes for a in segments)
        if not self.cuda:
            with span(spans.STREAM_STAGE_IN):  # a copy, as a device's would be
                flat = [np.ascontiguousarray(a).reshape(-1).view(np.uint8) for a in segments]
                return torch.from_numpy(np.concatenate(flat)), None
        pinned = self._pinned(self._in, s, nbytes)
        host = pinned.numpy()
        with span(spans.STREAM_STAGE_IN):
            off = 0
            for a in segments:
                n = a.nbytes
                host_copy(host[off:off + n], np.ascontiguousarray(a).reshape(-1).view(np.uint8))
                off += n
        with span(spans.STREAM_UPLOAD), torch.cuda.stream(self.h2d):
            dev = torch.empty(nbytes, dtype=torch.uint8, device=self.device)
            dev.copy_(pinned[:nbytes], non_blocking=True)
            done = torch.cuda.Event()
            done.record(self.h2d)
        dev.record_stream(self.compute)
        return dev, done

    def computing(self, after: Optional[torch.cuda.Event]):
        """Context in which the program runs: the compute stream, after
        the upload's event (a no-op on the CPU)."""
        if not self.cuda:
            return contextlib.nullcontext()
        if after is not None:
            self.compute.wait_event(after)
        return torch.cuda.stream(self.compute)

    def download(self, s: int, tensors: Sequence[torch.Tensor],
                 after: Optional[torch.cuda.Event] = None) -> Pending:
        """Start copying `tensors` to the slot's pinned output, after
        `after` (default: all work issued so far on the compute stream)."""
        if not self.cuda:
            return Pending(s, None, list(tensors))
        with span(spans.STREAM_DOWNLOAD):
            if after is None:
                after = torch.cuda.Event()
                after.record(self.compute)
            sizes = [t.numel() * t.element_size() for t in tensors]
            offs = self.offsets(sizes)
            pinned = self._pinned(self._out, s, offs[-1])
            host_np = pinned.numpy()
            self.d2h.wait_event(after)
            views = []
            with torch.cuda.stream(self.d2h):
                for t, off, n in zip(tensors, offs, sizes):
                    t = t.contiguous()
                    pinned[off:off + n].copy_(t.reshape(-1).view(torch.uint8), non_blocking=True)
                    t.record_stream(self.d2h)
                    views.append(host_np[off:off + n].view(_NP[t.dtype]).reshape(t.shape))
                done = torch.cuda.Event()
                done.record(self.d2h)
            return Pending(s, done, views)

    def fetch(self, p: Pending) -> list:
        """Wait for a download; its host arrays (valid until `release`)."""
        if not self.cuda:
            return [t.numpy() for t in p.host]
        with span(spans.STREAM_WAIT):
            p.event.synchronize()
        return p.host


def writer(out: np.ndarray) -> Callable:
    """A sink that copies each batch it is fed into the next rows of `out`."""
    pos = [0]

    def sink(a):
        host_copy(out[pos[0]:pos[0] + a.shape[0]], a)
        pos[0] += a.shape[0]

    return sink


_NP = {torch.uint8: np.uint8, torch.int8: np.int8, torch.int16: np.int16,
       torch.int32: np.int32, torch.bool: np.bool_}


class RawTransport:
    """The raw wire: each batch goes up as it is and the program's output
    comes down whole (2 B/px for a restorer). `send` (producer thread)
    uploads, launches and starts the download on `staging`'s streams;
    `receive` (fetcher thread) waits for the download and hands the host
    arrays to the sink before the slot is freed. `packed.DuplexTransport`
    is the other transport with this interface."""

    def __init__(self, run: Callable, staging: Staging):
        self._run = run
        self.staging = staging

    def send(self, x: np.ndarray):
        st = self.staging
        with span(spans.STREAM_SEND):
            s = st.take()
            try:
                xd, up = st.upload(s, [x])
                with span(spans.STREAM_RUN), st.computing(up):
                    out = self._run(xd.view(x.shape))
                single = not isinstance(out, (tuple, list))
                return st.download(s, [out] if single else list(out)), single
            except BaseException:
                st.release(s)
                raise

    def receive(self, x: np.ndarray, item, sink: Optional[Callable] = None) -> None:
        """Wait for the batch and feed its output to `sink`: on a CUDA
        device, views of pinned memory, valid only until `sink` returns."""
        pending, single = item
        with span(spans.STREAM_RECEIVE):
            try:
                host = self.staging.fetch(pending)
                if sink is not None:
                    with span(spans.STREAM_SINK):
                        sink(host[0] if single else tuple(host))
            finally:
                self.staging.release(pending.slot)


def _copied(a):
    return tuple(np.array(v) for v in a) if isinstance(a, tuple) else np.array(a)


def pipeline(transport, batches: Iterable[np.ndarray], depth: int = 3,
             on_output: Optional[Callable] = None) -> list:
    """The pipelined loop over a transport (`RawTransport` or
    `packed.DuplexTransport`): the caller's thread sends each batch
    (`transport.send(x)`: pack, upload, launch, start the download;
    nothing waits on the device), a fetcher thread receives it
    (`transport.receive(x, item, sink)`: wait, decode, feed the sink, free
    the slot), with up to `depth` batches queued between them. Returns the
    outputs (copied), or feeds them to `on_output` in order and returns []
    if given. An error in either thread is raised on the caller's thread,
    and neither thread is left waiting.

    The transport's staging needs at least depth + 2 slots: the queue
    holds `depth` batches, the fetcher one more, and the producer fills
    the next."""
    if depth < 1:
        raise ValueError(f"depth must be >= 1, got {depth}")
    slots = transport.staging.slots
    if slots < depth + 2:
        raise ValueError(f"depth {depth} needs a staging of >= {depth + 2} slots, got {slots}")
    outs: list = []
    if on_output is None:
        on_output = lambda a: outs.append(_copied(a))  # noqa: E731
    err: List[BaseException] = []
    q: "queue.Queue" = queue.Queue(maxsize=depth)
    done = object()

    def fetcher():
        failed = False
        while True:
            item = q.get()
            if item is done:
                return
            try:  # after an error, keep receiving (each frees its slot)
                # with no sink, so that the producer's q.put never blocks
                transport.receive(*item, None if failed else on_output)
            except BaseException as e:  # surfaced on the caller's thread
                err.append(e)
                failed = True

    th = threading.Thread(target=fetcher, daemon=True)
    th.start()
    try:
        for x in batches:
            if err:
                break
            item = (x, transport.send(x))
            with span(spans.STREAM_BACKPRESSURE):
                q.put(item)  # blocks only when `depth` batches are queued
    finally:
        q.put(done)
        th.join()
    if err:
        raise err[0]
    return outs


def pipeline_restore(
    run: Callable,
    batches: Iterable[np.ndarray],
    depth: int = 3,
    *,
    device,
    on_output: Optional[Callable] = None,
    staging: Optional[Staging] = None,
) -> List[np.ndarray]:
    """Stream uint8 frame batches through `run` (a function of a uint8
    tensor [B, H, W] on `device`, returning a tensor or a tuple of
    tensors) with `depth` batches in flight: `pipeline` over the raw
    transport. Returns the restored batches, or feeds them to `on_output`
    in order and returns [] if given. On a CUDA device the arrays
    `on_output` receives are views of pinned memory that stay valid until
    it returns: it copies what it keeps.

    `staging` (default: a new one) needs at least depth + 2 slots."""
    st = staging if staging is not None else Staging(device, max(depth, 1) + 2)
    if st.device != torch.device(device):
        raise ValueError(f"staging on {st.device}, pipeline on {device}")
    return pipeline(RawTransport(run, st), batches, depth, on_output)


def measure_stream_fps(
    run: Callable,
    batches: Sequence[np.ndarray],
    depth: int = 3,
    *,
    device,
) -> float:
    """Wall-clock frames/s of the pipelined loop, from the first batch in
    host memory to the last restored frame landed in host memory: the
    reference's timing definition (kernel.cu:89-101), overlapped.

    As the JAX function (stream.py:103-115), the window times the stream
    and nothing of its setup: the staging is built and its pinned ring
    sized to the largest batch before the clock starts, and the outputs
    are discarded. On a CUDA device the sink is handed each batch in the
    slot's pinned output after its device->host copy has completed, so
    the last frame has landed in host memory when the window closes; a
    `run` whose output is larger than its input grows the ring inside
    the window."""
    in_bytes = max(b.nbytes for b in batches)
    st = Staging(device, max(depth, 1) + 2, in_bytes, Staging.offsets([in_bytes])[-1])
    n_frames = sum(b.shape[0] for b in batches)
    t0 = time.perf_counter()
    pipeline_restore(run, batches, depth, device=device, on_output=lambda a: None, staging=st)
    return n_frames / (time.perf_counter() - t0)
