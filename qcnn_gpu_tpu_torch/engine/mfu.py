"""MFU and roofline accounting of the fused network on the card.

Counterpart of `qcnn_gpu_tpu/engine/mfu.py`, with the H100's numbers and
Hopper's pass model. Two ceilings are reported, as there:

* the card's peak (the data sheet's dense rates for the card that
  `nvidia-smi` names): the absolute roofline;
* the pass model: the `wgmma` MACs the kernels issue per output pixel at
  a tile (ops/fused.py: each stage's 64-position blocks over its input
  region, `SPLIT_CHUNKS`' widths), against the network's useful MACs.
  The halo of a tile, the wrapped columns and the K and N padding are
  what separates the two (77,210 issued against 54,512 useful at 24x40).

Useful MACs per pixel (the network as defined, models/topology.py):
    C1 5x5x1x64=1600, C2_1 3x3x64x32=18432, C2_2 5x5x64x16=25600,
    C3_1 3x3x48x16=6912, C3_2 1x1x48x32=1536, C4 3x3x48x1=432
"""

from __future__ import annotations

from typing import Dict, Optional, Tuple

from qcnn_gpu_tpu_torch.ops import fused as FU

USEFUL_MACS_PER_PX = 1600 + 18432 + 25600 + 6912 + 1536 + 432  # = 54512

# NVIDIA's data sheet, H100 SXM, dense (no sparsity), at its 700 W limit
PEAK_INT8_OPS = 1979e12
PEAK_BF16_FLOPS = 989e12

# (int8 TOP/s, bf16 TFLOP/s) by the card's name as nvidia-smi and
# torch.cuda.get_device_name give it
_PEAKS = {"NVIDIA H100 80GB HBM3": (PEAK_INT8_OPS / 1e12, PEAK_BF16_FLOPS / 1e12)}

# stage -> useful MACs per pixel
_USEFUL = {"S1": 1600, "S2": 18432 + 25600, "S3": 6912 + 1536, "S4": 432}


def chip_peaks(device_kind: str) -> Tuple[Optional[float], Optional[float]]:
    """(int8 TOP/s, bf16 TFLOP/s) of the named card, or (None, None) for
    a card (or a CPU) whose peaks the port does not carry."""
    return _PEAKS.get((device_kind or "").strip(), (None, None))


def pass_model_summary(tile: Tuple[int, int] = (FU.TILE_H, FU.TILE_W)) -> Dict:
    """Issued-against-useful MACs per output pixel, stage by stage, of the
    kernels at `tile` (generation 3's instances; generations 2 and 1, at
    24x40, issue the same chunks): each stage's `wgmma` chunks over its 64-position
    blocks, divided by the tile's th * tw output pixels."""
    th, tw = FU.check_tile(tile)
    lay = FU.layout(th, tw)
    per_position = [32 * FU.S1_N] + [sum(32 * c.n for c in s) for s in FU.SPLIT_CHUNKS]
    chunks = [1] + [len(s) for s in FU.SPLIT_CHUNKS]
    stages, issued_total = {}, 0.0
    for name, blocks, macs, n in zip(_USEFUL, lay.blocks, per_position, chunks):
        issued = blocks * 64 * macs / (th * tw)
        stages[name] = {
            "blocks": blocks,
            "wgmma_per_block": n,
            "issued_macs_per_px": round(issued, 1),
            "useful_macs_per_px": _USEFUL[name],
            "useful_frac": round(_USEFUL[name] / issued, 4),
        }
        issued_total += issued
    return {
        "tile": f"{th}x{tw}",
        "stages": stages,
        "issued_macs_per_px": round(issued_total, 1),
        "useful_macs_per_px": USEFUL_MACS_PER_PX,
        # the share of the issued tensor-core work that is useful: the
        # kernel's structural ceiling at full `wgmma` rate
        "structural_mfu_ceiling": round(USEFUL_MACS_PER_PX / issued_total, 4),
    }


def mfu_report(px_per_frame: int, ms_per_frame: float, device_kind: str,
               tile: Tuple[int, int] = (FU.TILE_H, FU.TILE_W)) -> Dict:
    """Sustained useful TOP/s against the card's peaks, with the pass
    model of the kernel at `tile`."""
    tops = 2 * USEFUL_MACS_PER_PX * px_per_frame / (ms_per_frame * 1e-3) / 1e12
    int8_peak, bf16_peak = chip_peaks(device_kind)
    pm = pass_model_summary(tile)
    return {
        "device_kind": device_kind,
        "useful_macs_per_px": USEFUL_MACS_PER_PX,
        "issued_macs_per_px": pm["issued_macs_per_px"],
        "sustained_useful_tops": round(tops, 2),
        "peak_tops_int8": int8_peak,
        "peak_tops_bf16": bf16_peak,
        "mfu_vs_int8_peak": round(tops / int8_peak, 4) if int8_peak else None,
        "mfu_vs_bf16_peak": round(tops / bf16_peak, 4) if bf16_peak else None,
        "pass_model": pm,
    }
