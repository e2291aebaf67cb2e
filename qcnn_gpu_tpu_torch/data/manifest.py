"""Sequence manifests — the port's own copy.

Mirrors `qcnn_gpu_tpu/data/manifest.py`: the JCT-VC common-test-condition
set (18 sequences, classes A-E, in the order of the reference's run_all
script and of the 18 doubles of its PSNR files) and JSON manifests of
{name, cls, height, width, frames}. Paths resolve against a data root at
run time; the repository ships no video data.
"""

from __future__ import annotations

import dataclasses
import json
import os
from typing import List


@dataclasses.dataclass(frozen=True)
class SequenceSpec:
    name: str
    cls: str  # JCT-VC class A..E
    height: int
    width: int
    frames: int = 1

    def ori_path(self, root: str) -> str:
        return os.path.join(root, "HEVC_Sequence", f"{self.name}.yuv")

    def anchor_path(self, root: str, qp: int) -> str:
        return os.path.join(
            root, "anchor16.0", f"{self.base_name()}_intra_main_HM16.0_anchor_Q{qp}.yuv"
        )

    def base_name(self) -> str:
        return self.name.split("_")[0]


JCTVC_SEQUENCES: List[SequenceSpec] = [
    SequenceSpec("Traffic_2560x1600_30_crop10", "A", 1600, 2560),
    SequenceSpec("PeopleOnStreet_3840x2160_30_420_08_150_crop10", "A", 2160, 3840),
    SequenceSpec("Kimono1_1920x1080_24_crop10", "B", 1080, 1920),
    SequenceSpec("ParkScene_1920x1080_24_crop10", "B", 1080, 1920),
    SequenceSpec("Cactus_1920x1080_50_crop10", "B", 1080, 1920),
    SequenceSpec("BasketballDrive_1920x1080_10", "B", 1080, 1920),
    SequenceSpec("BQTerrace_1920x1080_60_10", "B", 1080, 1920),
    SequenceSpec("BasketballDrill_832x480_50", "C", 480, 832),
    SequenceSpec("BQMall_832x480_60_crop10", "C", 480, 832),
    SequenceSpec("PartyScene_832x480_50_crop10", "C", 480, 832),
    SequenceSpec("RaceHorses_832x480_30_crop10", "C", 480, 832),
    SequenceSpec("BasketballPass_416x240_50_crop10", "D", 240, 416),
    SequenceSpec("BQSquare_416x240_60", "D", 240, 416),
    SequenceSpec("BlowingBubbles_416x240_50", "D", 240, 416),
    SequenceSpec("RaceHorses_416x240_30_crop10", "D", 240, 416),
    SequenceSpec("FourPeople_1280x720_60", "E", 720, 1280),
    SequenceSpec("Johnny_1280x720_60_crop10", "E", 720, 1280),
    SequenceSpec("KristenAndSara_1280x720_60_crop10", "E", 720, 1280),
]


def load_manifest(path: str) -> List[SequenceSpec]:
    """Load a JSON list of {name, cls, height, width, frames}."""
    with open(path) as fp:
        raw = json.load(fp)
    return [SequenceSpec(**entry) for entry in raw]


def save_manifest(path: str, specs: List[SequenceSpec]) -> None:
    with open(path, "w") as fp:
        json.dump([dataclasses.asdict(s) for s in specs], fp, indent=2)
