"""Structured metrics log — the three sinks of the JAX engine's log
(`qcnn_gpu_tpu/engine/metrics.py`):

  runs.jsonl        one JSON record per sequence run
  log.txt           the reference's text log (kernel.cu:108-111), same format
  recon_psnr.data   the reference's binary PSNR sink (kernel.cu:112-115)
"""

from __future__ import annotations

import dataclasses
import json
import os
import time

from qcnn_gpu_tpu_torch.data.model_files import append_psnr_record


@dataclasses.dataclass
class RunRecord:
    sequence: str
    qp: int
    frames: int
    height: int
    width: int
    psnr_before: float
    psnr_after: float
    time_us: int
    impl: str = ""
    device: str = ""
    # the stream's wire: {"served": "raw" | "duplex", "h2d_bytes", "d2h_bytes"},
    # the duplex steps, and under transport="auto" the probe that chose
    transport: dict = dataclasses.field(default_factory=dict)
    timestamp: float = dataclasses.field(default_factory=time.time)

    @property
    def delta_db(self) -> float:
        return self.psnr_after - self.psnr_before

    @property
    def fps(self) -> float:
        return self.frames / (self.time_us / 1e6) if self.time_us else float("inf")


class MetricsLog:
    def __init__(self, out_dir: str = "."):
        self.out_dir = out_dir
        os.makedirs(out_dir, exist_ok=True)

    def append(self, rec: RunRecord) -> None:
        with open(os.path.join(self.out_dir, "runs.jsonl"), "a") as fp:
            fp.write(json.dumps(dataclasses.asdict(rec)) + "\n")
        # legacy text log, field-compatible with kernel.cu:110
        with open(os.path.join(self.out_dir, "log.txt"), "a") as fp:
            fp.write(
                "\nQVRCNN test date:%s\ndata:%s\nframes:%d\nheight:%d\nwidth:%d\n"
                "before net:PSNR=%f\nafter quantized net:PSNR=%f\ntime:%dus\n"
                % (
                    time.ctime(rec.timestamp),
                    rec.sequence,
                    rec.frames,
                    rec.height,
                    rec.width,
                    rec.psnr_before,
                    rec.psnr_after,
                    rec.time_us,
                )
            )
        append_psnr_record(os.path.join(self.out_dir, "recon_psnr.data"), rec.psnr_after)
