"""One config system: the engine settings as JSON.

Counterpart of `qcnn_gpu_tpu/config.py`, with the same JSON keys and
defaults for the settings the port reads: `engine.impl`, `batch_frames`,
`mesh_dp`, `mesh_sp`, `mesh_sw` and `out_dir`. A file the port writes
loads in the JAX package (which fills in its other keys' defaults). A file
the JAX package writes loads here; its other keys (`engine.model_format`,
`qps`, `wbits`, `train.*`, `data_root`) are settings that neither package
reads, and a value off its default raises ValueError rather than be
ignored, as does a key that neither package knows.

`engine.impl` takes the port's names (`engine/runner.IMPLS`: auto,
kernel, kernel1-3, reference); a JAX-only name ("pallas", "int", "bf16",
"xla") loads but raises ValueError in `make_engine`, through `Engine`'s
check. `make_engine` builds the mesh when `mesh_dp > 0` (config.py:63-77)
on the `device` it is given: "cuda" spreads the mesh over the visible
CUDA devices, one device ("cuda:0", "cpu") carries every shard
(`parallel/mesh.mesh_on`). The JSON has no device: the caller's flag
decides.
"""

from __future__ import annotations

import dataclasses
import json

from qcnn_gpu_tpu_torch.engine.runner import Engine
from qcnn_gpu_tpu_torch.parallel.mesh import mesh_on

# The JAX package's Config keys that neither package reads, with their
# defaults there (qcnn_gpu_tpu/config.py:18-44).
UNREAD = {
    "engine.model_format": "vect_c", "engine.qps": [22, 27, 32, 37], "engine.wbits": 8,
    "train.qp": 37, "train.blu": False, "train.lr": 1e-4, "train.batch_size": 64,
    "train.patch": 64, "train.epochs": 30, "train.seed": 0, "data_root": None,
}


@dataclasses.dataclass
class EngineConfig:
    impl: str = "auto"  # engine/runner.IMPLS
    batch_frames: int = 4
    mesh_dp: int = 0  # 0 => single device
    mesh_sp: int = 1
    mesh_sw: int = 1  # frame-column spatial axis (2-D halo sharding)
    out_dir: str = "."


@dataclasses.dataclass
class Config:
    engine: EngineConfig = dataclasses.field(default_factory=EngineConfig)

    @classmethod
    def load(cls, path: str) -> "Config":
        with open(path) as fp:
            raw = json.load(fp)
        known = {f.name for f in dataclasses.fields(EngineConfig)}
        engine = {k: v for k, v in raw.get("engine", {}).items() if k in known}
        rest = {f"engine.{k}": v for k, v in raw.get("engine", {}).items() if k not in known}
        rest.update({f"train.{k}": v for k, v in raw.get("train", {}).items()})
        rest.update({k: v for k, v in raw.items() if k not in ("engine", "train")})
        off = sorted(k for k, v in rest.items() if k not in UNREAD or v != UNREAD[k])
        if off:
            raise ValueError(f"{path}: {', '.join(off)}: set, but the port reads no such "
                             "setting (its other JAX keys must keep the JAX defaults)")
        return cls(engine=EngineConfig(**engine))

    def save(self, path: str) -> None:
        with open(path, "w") as fp:
            json.dump(dataclasses.asdict(self), fp, indent=2)

    def make_engine(self, device="cuda") -> Engine:
        """The Engine these settings describe, on `device` (or on a mesh
        built over it when mesh_dp > 0)."""
        e = self.engine
        mesh = mesh_on(device, e.mesh_dp, e.mesh_sp, e.mesh_sw) if e.mesh_dp > 0 else None
        return Engine(
            device=None if mesh is not None else device,
            impl=e.impl,
            mesh=mesh,
            out_dir=e.out_dir,
            batch_frames=e.batch_frames,
        )
