"""The inference engine: program cache, streaming restore, metrics.

Counterpart of `qcnn_gpu_tpu/engine/runner.py:Engine` on one torch
device. A program is the restorer for one (qp, device, program name):

  impl="kernel"     generation 3, the counterpart of the JAX engine's
                    "pallas" (no H100 table picks another generation yet)
  impl="kernel3"    the one-frame fused kernel, `ops/fused.fused_forward`
  impl="kernel2"    the frame-pair kernel, `ops/pair.pair_forward`
  impl="kernel1"    the literal-requant kernel, `ops/literal.literal_forward`
  impl="reference"  the float64-exact reference net (models/qvrcnn.py)
  impl="auto"       chosen per model by its table: generation 3 inside the
                    solver's saturation window (`ops/fused.window_refusal`),
                    else generation 1 (`ops/literal.literal_refusal`), else
                    a ValueError that names `--impl reference`

A kernel runs as its CUDA kernel on a CUDA device and as its plain
version on the CPU. The program name (`program_name(qp)`), and so the
cache key and `RunRecord.impl`, is the generation that runs ("kernel1",
"kernel2", "kernel3") or "reference"; "+duplex" is appended when the
duplex transport served. `auto` never falls back to the reference net,
which would be a silent slow path: a table no kernel computes raises.

`restore_stream` pipelines batches (engine/stream.py: pinned rings and
copy/compute streams on CUDA) over one of three transports: "raw" (2 B/px
each way), "duplex" (engine/packed.py: block-sparse temporal deltas up,
predicted residual-delta blocks down, for static-camera content), or
"auto", which measures the link and the device rate and picks.

With a `mesh` (parallel/mesh.py), every program is the sharded one
(`parallel/spatial.make_sharded_forward`): generation 3 under per-block
frame bounds ("kernel", "kernel3", and "auto" on a table inside the
saturation window) or the reference net; kernel1, kernel2 and "auto" on a
table outside the window raise (generations 1 and 2 take no frame
bounds). The engine's device is the mesh's first device, batch_frames a
multiple of the mesh's dp, and a ragged last batch is edge-replicated up
to batch_frames and cropped. `RunRecord.mesh` names the mesh.

Two departures from the JAX engine, on purpose. The device is explicit
and nothing changes it: a CUDA device without CUDA raises, a failed
kernel build or launch raises, and a failure of the duplex path raises
(the JAX engine falls back to raw, runner.py:279-288) after evicting the
transport, whose carries may be out of step. And there is no host
tiling: the JAX engine tiles when a whole-frame program fails
(runner.py:205-219; some toolchains reject XLA graphs above 1080p),
while the port compiles no graph and launches a 2160p batch whole.

Timing follows the reference's definition: wall clock around the whole
frame loop including host->device and device->host copies
(kernel.cu:89-101).
"""

from __future__ import annotations

import functools
import itertools
import os
import time
from typing import Callable, Dict, Optional, Tuple

import numpy as np
import torch

from qcnn_gpu_tpu_torch.data import yuv
from qcnn_gpu_tpu_torch.data.model_files import (
    read_static_qfp_hwcn,
    read_static_qfp_pc,
    read_static_qfp_vect_c,
)
from qcnn_gpu_tpu_torch.engine.metrics import MetricsLog, RunRecord
from qcnn_gpu_tpu_torch.engine.packed import DuplexTransport, make_duplex_restore, warm_batches
from qcnn_gpu_tpu_torch.engine.stream import Staging, pipeline, pipeline_restore, writer
from qcnn_gpu_tpu_torch.models.engine_params import EngineParams
from qcnn_gpu_tpu_torch.models.qvrcnn import MergedParams, make_forward
from qcnn_gpu_tpu_torch.ops.fused import FusedWeights, fused_forward, window_refusal
from qcnn_gpu_tpu_torch.ops.literal import LiteralWeights, literal_forward, literal_refusal
from qcnn_gpu_tpu_torch.ops.pair import pair_forward
from qcnn_gpu_tpu_torch.parallel.mesh import Mesh
from qcnn_gpu_tpu_torch.parallel.spatial import make_sharded_forward, pad_batch, sharded_impl

IMPLS = ("auto", "kernel", "kernel1", "kernel2", "kernel3", "reference")
TRANSPORTS = ("raw", "duplex", "auto")
PROBE_SAMPLES = 3  # transport="auto" takes the best of 3 (ROADMAP, reference hazards)
_READERS = {
    "vect_c": read_static_qfp_vect_c,
    "hwcn": read_static_qfp_hwcn,
    "pc": read_static_qfp_pc,  # per-channel INT4 extension
}
# generation -> (its forward, the keyword and carrier of its weights)
_GENERATIONS = {
    "kernel1": (literal_forward, "lw", LiteralWeights),
    "kernel2": (pair_forward, "fw", FusedWeights),
    "kernel3": (fused_forward, "fw", FusedWeights),
}


def read_model(path: str, fmt: str = "vect_c") -> EngineParams:
    """Read a static model file (`vect_c`, `hwcn` or `pc`) into EngineParams."""
    if not os.path.exists(path):
        raise FileNotFoundError(f"cannot open model file: {path}")
    if fmt not in _READERS:
        raise ValueError(f"unknown model format {fmt!r}")
    return _READERS[fmt](path)


def _auto_generation(p: EngineParams) -> str:
    """`auto`'s choice for a table: generation 3 where its folded epilogue
    is exact, else generation 1; neither raises ValueError with both
    reasons."""
    mp = MergedParams.from_engine(p, "cpu")
    why3 = window_refusal(mp)
    if why3 is None:
        return "kernel3"
    why1 = literal_refusal(mp)
    if why1 is None:
        return "kernel1"
    raise ValueError(
        f"no kernel computes this table: generation 3: {why3}; generation 1: {why1}. "
        "--impl reference computes it (the float64-exact reference net)"
    )


def _cropped(sink: Callable, n: int) -> Callable:
    """A sink that drops the rows past the first n it is fed (a padded tail)."""
    seen = [0]

    def crop(a):
        k = min(a.shape[0], n - seen[0])
        seen[0] += a.shape[0]
        sink(a[:k])

    return crop


class Engine:
    def __init__(
        self,
        device=None,
        impl: str = "auto",
        out_dir: str = ".",
        batch_frames: int = 4,
        mesh: Optional[Mesh] = None,
    ):
        """device: a torch device (default "cuda"); with a mesh, its first
        device, and a `device` that names another raises ValueError."""
        if impl not in IMPLS:
            raise ValueError(f"impl must be one of {IMPLS}, got {impl!r}")
        if batch_frames < 1:
            raise ValueError(f"batch_frames must be >= 1, got {batch_frames}")
        if mesh is not None:
            d = torch.device(mesh.first if device is None else device)
            if d.type != mesh.first.type or d.index not in (None, mesh.first.index):
                raise ValueError(f"device {d} is not the first device of mesh {mesh!r}")
            if batch_frames % mesh.shape["dp"]:
                raise ValueError(f"batch_frames {batch_frames} is no multiple of the mesh's "
                                 f"dp {mesh.shape['dp']}")
            device = mesh.first
        self.device = torch.device("cuda" if device is None else device)
        self.mesh = mesh
        self.impl = impl
        self.batch_frames = batch_frames
        self.metrics = MetricsLog(out_dir)
        # transport="auto": (qp, (H, W), batch) -> the probe's samples and choice
        self.transport_decisions: Dict[Tuple, dict] = {}
        self.last_stream: dict = {}  # the wire of the last restore_stream
        self._models: Dict[int, EngineParams] = {}
        self._names: Dict[int, str] = {}  # qp -> the program that serves it
        self._programs: Dict[Tuple, Callable] = {}
        self._staging: Dict[Tuple, Staging] = {}  # (H, W, batch) -> pinned ring
        self._duplex: Dict[Tuple, DuplexTransport] = {}  # (qp, (H, W), batch)

    # ---- model management (load_static_para analog, qvrcnn.cu:47-63) ----
    def load_model(self, qp: int, path: str, fmt: str = "vect_c") -> None:
        self.set_model(qp, read_model(path, fmt))

    def set_model(self, qp: int, params: EngineParams) -> None:
        self._models[qp] = params
        self._names.pop(qp, None)
        self._programs = {k: v for k, v in self._programs.items() if k[0] != qp}
        self._duplex = {k: v for k, v in self._duplex.items() if k[0] != qp}

    def _params(self, qp: int) -> EngineParams:
        if qp not in self._models:
            raise KeyError(f"no model loaded for QP{qp}")
        return self._models[qp]

    def program_name(self, qp: int) -> str:
        """The program that serves QP `qp`: "reference", or the kernel
        generation, "kernel1", "kernel2" or "kernel3". Under "auto" the
        model's table decides; a table that neither generation 3 nor
        generation 1 computes raises ValueError. Under a mesh, "kernel3"
        or "reference" (`parallel/spatial.sharded_impl`), or ValueError."""
        if qp not in self._names:
            if self.mesh is not None:
                self._names[qp] = sharded_impl(self._params(qp), self.impl)
            elif self.impl == "auto":
                self._names[qp] = _auto_generation(self._params(qp))
            else:
                self._names[qp] = "kernel3" if self.impl == "kernel" else self.impl
        return self._names[qp]

    def _program(self, qp: int) -> Callable:
        name = self.program_name(qp)
        key = (qp, str(self.device), name) + (() if self.mesh is None else (self.mesh.label(),))
        if key not in self._programs:
            p = self._params(qp)
            if self.mesh is not None:
                run = make_sharded_forward(p, self.mesh, impl=name)
            elif name == "reference":
                run = make_forward(p, device=self.device)
            else:
                forward, kw, carrier = _GENERATIONS[name]
                run = functools.partial(forward, **{kw: carrier.from_engine(p, self.device)})
            self._programs[key] = run
        return self._programs[key]

    def _stage(self, geo, depth: int) -> Staging:
        """The pinned ring and streams for batches of batch_frames at `geo`."""
        h, w = geo
        bs = self.batch_frames
        key = (h, w, bs)
        st = self._staging.get(key)
        if st is None or st.slots < depth + 2:
            st = Staging(self.device, depth + 2, bs * h * w, bs * h * w)
            self._staging[key] = st
        return st

    # ---- restoration ----
    def restore(self, frames: np.ndarray, qp: int) -> np.ndarray:
        """uint8 [N, H, W] -> restored uint8 [N, H, W] (blocking)."""
        n = frames.shape[0]
        if self.mesh is not None:  # N up to a multiple of dp
            frames = pad_batch(frames, -(-n // self.mesh.shape["dp"]) * self.mesh.shape["dp"])
        x = torch.from_numpy(np.ascontiguousarray(frames, np.uint8)).to(self.device)
        return self._program(qp)(x)[:n].cpu().numpy()

    def restore_stream(
        self, frames: np.ndarray, qp: int, depth: int = 3, transport: str = "raw"
    ) -> np.ndarray:
        """Pipelined streaming restore of uint8 [N, H, W] in batches of
        batch_frames, `depth` batches in flight (engine/stream.py), over
        `transport`: "raw", "duplex" (engine/packed.py; a ragged tail goes
        through raw) or "auto" (`_pick_transport`). `last_stream` records
        what crossed the wire."""
        if transport not in TRANSPORTS:
            raise ValueError(f"transport must be one of {TRANSPORTS}, got {transport!r}")
        if frames.dtype != np.uint8 or frames.ndim != 3:
            raise ValueError(f"expected uint8 frames [N, H, W], got {frames.dtype} {frames.shape}")
        probe = self._pick_transport(frames, qp) if transport == "auto" else None
        if probe is not None:
            transport = probe["transport"]
        if transport == "duplex":
            try:
                out, stream = self._restore_stream_duplex(frames, qp, depth)
            except BaseException:
                # the producer may have sent past the batch that failed: the
                # carries are out of step, so the next stream starts afresh
                self._evict_duplex(qp, frames.shape[-2:])
                raise
        else:
            out = np.empty_like(frames)
            self._restore_stream_raw(frames, qp, depth, out)
            stream = {"served": "raw", "h2d_bytes": frames.nbytes, "d2h_bytes": frames.nbytes}
        if probe is not None:
            stream["auto"] = probe
        self.last_stream = stream
        return out

    def _restore_stream_raw(self, frames, qp: int, depth: int, out: np.ndarray) -> None:
        bs = self.batch_frames
        n = frames.shape[0]
        cut = n - n % bs if self.mesh is not None else n
        batches = (frames[i:i + bs] for i in range(0, cut, bs))
        sink = writer(out)
        if cut < n:  # under a mesh, the ragged tail goes padded to bs
            batches = itertools.chain(batches, [pad_batch(frames[cut:], bs)])
            sink = _cropped(sink, n)
        pipeline_restore(
            self._program(qp), batches, depth, device=self.device, on_output=sink,
            staging=self._stage(frames.shape[-2:], depth),
        )

    def _pick_transport(self, frames: np.ndarray, qp: int) -> dict:
        """Measured raw-or-duplex decision for this (qp, geometry, batch).

        The link: the host clock around a round trip of one real batch
        through the raw transport's pinned ring (host copy in, H2D, D2H,
        host copy out), best of PROBE_SAMPLES after one warm-up. The
        device: the program on a device-resident batch, CUDA events on a
        CUDA device, best of PROBE_SAMPLES after one warm-up. Raw keeps up
        iff link fps >= 0.8 x device fps; otherwise the stream is
        link-bound and the duplex wire is chosen (runner.py:304-353, with
        the best of 3 samples in place of one). Returns the decision, kept
        with every sample in `transport_decisions`; a probe that fails
        raises."""
        bs = self.batch_frames if self.mesh is not None else min(self.batch_frames, frames.shape[0])
        key = (qp, tuple(frames.shape[-2:]), bs)
        if key in self.transport_decisions:
            return self.transport_decisions[key]
        x = np.ascontiguousarray(pad_batch(frames[:bs], bs))
        st = self._stage(key[1], 3)
        link_s = []
        for i in range(PROBE_SAMPLES + 1):  # the first warms the path
            t0 = time.perf_counter()
            s = st.take()
            try:
                xd, up = st.upload(s, [x])
                st.fetch(st.download(s, [xd], after=up))
            finally:
                st.release(s)
            if i:
                link_s.append(time.perf_counter() - t0)
        run = self._program(qp)
        xd = torch.from_numpy(x.copy()).to(self.device)
        run(xd)  # warm-up
        dev_s = []
        for _ in range(PROBE_SAMPLES):
            if self.device.type == "cuda":
                start, stop = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
                start.record()
                run(xd)
                stop.record()
                stop.synchronize()
                dev_s.append(start.elapsed_time(stop) / 1e3)
            else:
                t0 = time.perf_counter()
                run(xd)
                dev_s.append(time.perf_counter() - t0)
        link_fps, dev_fps = bs / min(link_s), bs / min(dev_s)
        self.transport_decisions[key] = {
            "transport": "duplex" if link_fps < 0.8 * dev_fps else "raw",
            "link_mbps": 2 * x.nbytes / min(link_s) / 1e6,
            "link_fps": link_fps,
            "device_fps": dev_fps,
            "link_seconds": link_s,
            "device_seconds": dev_s,
        }
        return self.transport_decisions[key]

    def _evict_duplex(self, qp: int, geo) -> None:
        """Drop the cached duplex transport for (qp, geometry): after a
        failure its producer and consumer state may be out of step."""
        self._duplex.pop((qp, tuple(geo), self.batch_frames), None)

    def _duplex_transport(self, qp: int, geo, depth: int) -> DuplexTransport:
        """The cached duplex transport for (qp, geometry, batch): it carries
        the stream's state (host previous frame and residual, device
        carries), so restore_stream calls continue one stream."""
        bs = self.batch_frames
        key = (qp, tuple(geo), bs)
        tr = self._duplex.get(key)
        if tr is None or tr.staging.slots < depth + 2:
            tr = make_duplex_restore(self._program(qp), self.device,
                                     staging=Staging(self.device, depth + 2))
            tr.reserve((bs,) + tuple(geo))
            self._duplex[key] = tr
        return tr

    def _restore_stream_duplex(self, frames: np.ndarray, qp: int, depth: int):
        n = frames.shape[0]
        bs = self.batch_frames
        cut = (n // bs) * bs  # the ragged tail goes through the raw transport
        tr = self._duplex_transport(qp, frames.shape[-2:], depth)
        # wire bytes, and host seconds summed over the stream's batches
        # (send, receive and their parts: DuplexTransport.stats)
        marks = {k: len(v) for k, v in tr.stats.items() if k.endswith("_bytes") or k[:2] == "t_"}
        steps = {k: tr.stats[k] for k in ("full_steps", "packed_steps", "dense_fetches")}
        out = np.empty_like(frames)
        pipeline(tr, [frames[i:i + bs] for i in range(0, cut, bs)], depth, on_output=writer(out))
        stream = {"served": "duplex"}
        for k, i0 in marks.items():
            stream[k] = sum(tr.stats[k][i0:])
        stream.update({k: tr.stats[k] - v for k, v in steps.items()})
        if cut < n:
            self._restore_stream_raw(frames[cut:], qp, depth, out[cut:])
            stream["h2d_bytes"] += frames[cut:].nbytes
            stream["d2h_bytes"] += frames[cut:].nbytes
            stream["raw_tail_frames"] = n - cut
        return out, stream

    def warmup(self, qp: int, height: int, width: int, frames: int = 1,
               transport: str = "raw", depth: int = 3) -> None:
        """Ahead of the timed span: build the program (kernel compile,
        weight upload) and stream zeros through the pipeline: depth + 2
        full batches, every slot of the pinned ring and the device memory
        of as many batches in flight, then the ragged tail's shape;
        under "auto", probe the transport; under "duplex" (or "auto"
        choosing it), warm the duplex transport with a full step and
        packed steps of every block class (`packed.warm_batches`), as
        many in flight."""
        if transport not in TRANSPORTS:
            raise ValueError(f"transport must be one of {TRANSPORTS}, got {transport!r}")
        bs = self.batch_frames
        frames = max(frames, 1)
        z = np.zeros(((depth + 2) * bs + frames % bs, height, width), np.uint8)
        self._restore_stream_raw(z, qp, depth, np.empty_like(z))
        if transport == "auto":
            transport = self._pick_transport(z[:min(bs, frames)], qp)["transport"]
        if transport == "duplex" and frames >= bs:
            tr = self._duplex_transport(qp, (height, width), depth)
            try:
                pipeline(tr, warm_batches(depth + 2, bs, height, width), depth,
                         on_output=lambda a: None)
            except BaseException:
                self._evict_duplex(qp, (height, width))
                raise

    # ---- the testqvrcnn analog (kernel.cu:74-116) ----
    def run_sequence(
        self,
        name: str,
        ori_path: str,
        anchor_path: str,
        height: int,
        width: int,
        qp: int,
        frames: int = 1,
        recon_path: Optional[str] = None,
        transport: str = "raw",
    ) -> RunRecord:
        ori = yuv.read_y(ori_path, height, width, frames)
        anchor = yuv.read_y(anchor_path, height, width, frames)
        self.warmup(qp, height, width, frames, transport=transport)

        t0 = time.perf_counter()
        recon = self.restore_stream(anchor, qp, transport=transport)
        time_us = int((time.perf_counter() - t0) * 1e6)
        served = self.last_stream["served"]

        rec = RunRecord(
            sequence=name,
            qp=qp,
            frames=frames,
            height=height,
            width=width,
            psnr_before=yuv.psnr(anchor, ori),
            psnr_after=yuv.psnr(recon, ori),
            time_us=time_us,
            impl=self.program_name(qp) + ("+duplex" if served == "duplex" else ""),
            mesh="" if self.mesh is None else self.mesh.label(),
            device=str(self.device),
            transport=dict(self.last_stream),
        )
        self.metrics.append(rec)
        if recon_path:
            yuv.write_y_as_420(recon_path, recon)
        return rec

    def run_manifest(self, specs, data_root: str, qps=(22, 27, 32, 37), **kw):
        """The run_all analog: sweep sequences x QPs (kernel.cu:117-131)."""
        records = []
        for qp in qps:
            for s in specs:
                records.append(
                    self.run_sequence(
                        s.name,
                        s.ori_path(data_root),
                        s.anchor_path(data_root, qp),
                        s.height,
                        s.width,
                        qp,
                        frames=s.frames,
                        **kw,
                    )
                )
        return records
