"""The yardstick's numbers: the card's data-sheet peaks and the useful
operations of a configuration, counted from its topology alone, so that
the count is the same whatever implements the layers.

A configuration file lists its layers as [k, cin, cout, repeat] (or
[name, k, cin, cout] for a named layer); a stride-1 SAME k x k convolution
does k * k * cin * cout multiply-accumulates per output pixel, and one
multiply-accumulate is two operations.
"""

from __future__ import annotations

from typing import Optional, Sequence

# NVIDIA's H100 SXM data sheet, dense (no sparsity), at its 700 W limit, by
# the name `torch.cuda.get_device_name()` gives the card; per precision
PEAKS = {
    "NVIDIA H100 80GB HBM3": {"int8": 1979e12, "fp8": 1979e12, "bf16": 989e12, "tf32": 495e12,
                              "fp32": 67e12, "hbm_bytes_per_s": 3.35e12},
}


def macs_per_px(layers: Sequence[Sequence]) -> int:
    total = 0
    for layer in layers:
        if isinstance(layer[0], str):
            _, k, cin, cout = layer
            repeat = 1
        else:
            k, cin, cout, repeat = layer
        total += k * k * cin * cout * repeat
    return total


def ops_per_frame(config: dict, height: int, width: int) -> int:
    """Useful operations to restore one frame of height x width."""
    return 2 * macs_per_px(config["layers"]) * height * width


def peak_ops(device_name: str, precision: str) -> Optional[float]:
    """The card's data-sheet rate at `precision`, or None for a device whose
    peaks the benchmark does not carry (no share of a peak is reported then)."""
    return PEAKS.get(device_name.strip(), {}).get(precision)
