"""The wide INT8 net served as an offline stream: the port's
`models/wide.make_wide_forward` (route `gemm`: im2col, `torch._int_mm`,
int32 epilogues) driven by `engine/stream.pipeline_restore` over a
generator of batches, `depth` batches in flight over one pinned ring
built in set-up, each restored batch handed to the caller's sink, which
copies it into the caller's own buffer."""

from __future__ import annotations

from typing import Callable, Iterable

import numpy as np

from qcnn_gpu_tpu_torch.engine.stream import Staging, pipeline_restore
from qcnn_gpu_tpu_torch.models.wide import WideParams, make_wide_forward


class Streamer:
    def __init__(self, run: Callable, traffic: dict, device):
        self.run = run
        self.traffic = traffic
        self.device = device
        nbytes = traffic["batch_frames"] * traffic["height"] * traffic["width"]
        self.staging = Staging(device, traffic["depth"] + 2, nbytes, nbytes)

    def warmup(self) -> None:
        """Stream depth + 2 batches of zeros: every ring slot, the
        program's shapes and as many batches in flight as the window has."""
        t = self.traffic
        z = np.zeros((t["batch_frames"], t["height"], t["width"]), np.uint8)
        self.stream([z] * (t["depth"] + 2), lambda a: None)

    def stream(self, batches: Iterable[np.ndarray], on_output: Callable) -> None:
        pipeline_restore(self.run, batches, self.traffic["depth"], device=self.device,
                         on_output=on_output, staging=self.staging)


def build(params, config: dict, traffic: dict, device) -> Streamer:
    p = WideParams(
        weights=[w.cpu().numpy() for w in params.weights],
        biases=[b.cpu().numpy() for b in params.biases],
        blu_q=list(params.blu_q), mul=list(params.mul), shift=list(params.shift),
        mul_last=params.mul_last, shift_last=params.shift_last,
    )
    return Streamer(make_wide_forward(p, device=device, route=config["route"]), traffic, device)
