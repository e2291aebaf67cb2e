"""Fixed-point quantization tables — the port's own copy.

Mirrors `qcnn_gpu_tpu/quant/params.py` (:30-190): `LayerQuant`,
`LayerQuantVec`, `QuantTable` with the stale-output-row check
(`last_row_stale`, `fixed_last_row`, the warning on load) and both
serializations, byte-compatible with the reference toolkit
(`training/quantization.py:90-96`):
  * pickle list-of-lists            -> quant_params{QP}.data
  * packed little-endian '6d' rows  -> quant_params_cpp_{QP}.data

A quantization table holds one row per conv layer, in topology order
(C1, C2_1, C2_2, C3_1, C3_2, C4):

    stepw    float  weight quantization step (w_int = round(w_f / stepw))
    ratio    float  pixel scale at the LAYER INPUT (x_int = round(x_f * ratio));
                    255 at the network input
    blu_adj  float  BLU upper bound in the float domain, adjusted so that the
                    int8 clamp at 127 IS the activation clip
    blu_q    int    BLU bound in the accumulator (int) domain
    mul,shift int   requantization as (x * mul) >> shift fixed-point scale

A per-channel table (`LayerQuantVec` rows) has no pickle form: its rows
travel in the per-channel model file (`data/model_files.write_static_qfp_pc`).
"""

from __future__ import annotations

import dataclasses
import pickle
import struct
from typing import List, Sequence

import numpy as np


@dataclasses.dataclass(frozen=True)
class LayerQuant:
    stepw: float
    ratio: float
    blu_adj: float
    blu_q: int
    mul: int
    shift: int

    def as_list(self) -> List[float]:
        return [self.stepw, self.ratio, self.blu_adj, self.blu_q, self.mul, self.shift]

    @classmethod
    def from_seq(cls, row: Sequence[float]) -> "LayerQuant":
        return cls(
            stepw=float(row[0]),
            ratio=float(row[1]),
            blu_adj=float(row[2]),
            blu_q=int(round(row[3])),
            mul=int(round(row[4])),
            shift=int(round(row[5])),
        )


@dataclasses.dataclass(eq=False)
class LayerQuantVec:
    """Per-output-channel quantization row (the INT4 closure, round 5).

    Same contract as LayerQuant with stepw/blu_q/mul/shift as [out_ch]
    vectors: every channel carries its own weight grid and its own
    (mul, shift) requant, equalized by the solver so all channels share
    the SAME output pixel scale (ratio chains exactly as in the scalar
    table; blu_adj is the common float-domain clip). The port's reference
    nets and kernels consume per-channel requant vectors (EngineParams
    rows as [out_ch] int64 vectors), so these rows run through the
    identical integer arithmetic. No reference analog — the reference solves one
    stepw per layer (training/quantization.py:77-86); per-channel rows
    exist to recover INT4 quality on channels the layer-wide grid
    starves."""

    stepw: "np.ndarray"
    ratio: float
    blu_adj: float
    blu_q: "np.ndarray"
    mul: "np.ndarray"
    shift: "np.ndarray"


class QuantTable:
    """Per-QP table of 6 LayerQuant rows."""

    def __init__(self, rows: Sequence[LayerQuant]):
        if len(rows) != 6:
            raise ValueError(f"expected 6 rows, got {len(rows)}")
        self.rows = tuple(rows)

    def __iter__(self):
        return iter(self.rows)

    def __getitem__(self, i):
        return self.rows[i]

    def __len__(self):
        return len(self.rows)

    def __eq__(self, other):
        return isinstance(other, QuantTable) and all(
            a == b for a, b in zip(self.rows, other.rows)
        )

    # ---- stale-table hazard (the shipped QP22 pickle) ----
    def last_row_stale(self):
        """The corrected output-layer row if the stored (mul, shift) pair
        zeroes the residual, else None.

        The reference's shipped quant_params22.data carries a stale
        shift=24 in its last row: its requant scale mul/2^shift is 256x
        below the value the solver derives from the SAME row's
        ratio/stepw (training/quantization.py:50-53 solves the output
        layer against final ratio 255). An engine built from the raw row
        restores NOTHING — the residual is identically zero — while
        every load/run step looks healthy. Scales are compared rather
        than raw pairs because distinct (mul, shift) can be equivalent:
        QP27 ships (1, 12) where the solver yields (2, 13), same scale."""
        import dataclasses as _dc

        from qcnn_gpu_tpu_torch.quant.solver import solve_last

        r = self.rows[5]
        s = solve_last(r.ratio, r.stepw)
        have, want = r.mul / 2.0**r.shift, s.mul / 2.0**s.shift
        if not (want / 1.5 <= have <= want * 1.5):
            return _dc.replace(r, mul=s.mul, shift=s.shift)
        return None

    def fixed_last_row(self) -> "QuantTable":
        """This table with a stale output row replaced by the re-solved
        (mul, shift); stepw/blu stay as stored so the weight grid is
        untouched. Returns self when the stored row is healthy."""
        fix = self.last_row_stale()
        if fix is None:
            return self
        return QuantTable(list(self.rows[:5]) + [fix])

    @classmethod
    def _checked(cls, rows, source: str) -> "QuantTable":
        table = cls(rows)
        try:
            fix = table.last_row_stale()
        except Exception:
            fix = None  # a malformed row must not make loading fatal
        if fix is not None:
            import warnings

            r = table.rows[5]
            warnings.warn(
                f"{source}: output-layer requant (mul={r.mul}, shift={r.shift})"
                f" zeroes the residual (scale {r.mul / 2.0**r.shift:.3g} vs"
                f" solved {fix.mul}/2^{fix.shift}); use"
                " QuantTable.fixed_last_row() for the re-solved pair",
                stacklevel=3,
            )
        return table

    # ---- pickle format (quant_params{QP}.data) ----
    @classmethod
    def load_pickle(cls, path: str) -> "QuantTable":
        with open(path, "rb") as fp:
            raw = pickle.load(fp)
        return cls._checked([LayerQuant.from_seq(r) for r in raw], str(path))

    def save_pickle(self, path: str) -> None:
        with open(path, "wb") as fp:
            pickle.dump([r.as_list() for r in self.rows], fp)

    # ---- packed-double format (quant_params_cpp_{QP}.data) ----
    @classmethod
    def load_packed(cls, path: str) -> "QuantTable":
        rows = []
        with open(path, "rb") as fp:
            for _ in range(6):
                rows.append(LayerQuant.from_seq(struct.unpack("6d", fp.read(48))))
        return cls._checked(rows, str(path))

    def save_packed(self, path: str) -> None:
        with open(path, "wb") as fp:
            for r in self.rows:
                fp.write(struct.pack("6d", *[float(v) for v in r.as_list()]))

    # convenience column views (match quantization.loadQpara's return order)
    @property
    def stepw(self):
        return [r.stepw for r in self.rows]

    @property
    def ratio(self):
        return [r.ratio for r in self.rows]

    @property
    def blu_adj(self):
        return [r.blu_adj for r in self.rows]
