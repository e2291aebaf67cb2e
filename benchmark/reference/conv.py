"""Exact integer SAME convolution in plain PyTorch, and the two integer
epilogues of the QVRCNN fixed-point contract.

The convolution is an im2col and a float64 matrix product. Every operand
is an integer of at most 8 bits and every partial sum of a layer here stays
below 2^27, so each product and each addition is exact in float64 (2^53),
whatever order the library sums in; the result is rounded back to int64.
The im2col runs over bands of rows so that one band's matrix stays under
`BAND_BYTES`, on the CPU and on the card alike.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

BAND_BYTES = 1 << 30


def conv_same(v: torch.Tensor, w_hwio: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """v int64 [N, C, H, W], w integer [k, k, C, Cout], b integer [Cout] ->
    int64 [N, Cout, H, W]: the zero-padded stride-1 cross-correlation plus
    the bias."""
    n, c, h, wd = v.shape
    k, _, cin, cout = w_hwio.shape
    if cin != c:
        raise ValueError(f"input has {c} channels, weights take {cin}")
    p = k // 2
    wm = w_hwio.to(torch.float64).permute(2, 0, 1, 3).reshape(c * k * k, cout)
    xp = F.pad(v.to(torch.float64), (p, p, p, p))
    rows = max(1, BAND_BYTES // (wd * c * k * k * 8))
    out = torch.empty((n, cout, h, wd), dtype=torch.int64, device=v.device)
    for i in range(n):
        for r0 in range(0, h, rows):
            r1 = min(h, r0 + rows)
            cols = F.unfold(xp[i:i + 1, :, r0:r1 + 2 * p], k)  # [1, c*k*k, (r1-r0)*wd]
            acc = cols[0].t() @ wm  # [(r1-r0)*wd, cout]
            out[i, :, r0:r1] = torch.round(acc).to(torch.int64).t().reshape(cout, r1 - r0, wd)
    return out + b.to(torch.int64).view(1, -1, 1, 1)


def blu_requant(u: torch.Tensor, blu_q: int, mul: int, shift: int) -> torch.Tensor:
    """The bounded linear unit and its requant, on int64 accumulators:
    127 above blu_q, 0 below 0, else ((u + (2^(shift-1) // mul)) * mul) >> shift."""
    bias = (1 << (shift - 1)) // mul
    mid = ((u + bias) * mul) >> shift
    return torch.where(u > blu_q, 127, torch.where(u < 0, 0, mid))


def final_residual(u: torch.Tensor, mul: int, shift: int) -> torch.Tensor:
    """The output layer's residual: (u * mul + 2^(shift-1)) >> shift, a floor shift."""
    return (u * mul + (1 << (shift - 1))) >> shift


def restored(x_u8: torch.Tensor, res: torch.Tensor) -> torch.Tensor:
    """clamp(x + res, 0, 255) as uint8."""
    return (x_u8.to(torch.int64) + res).clamp(0, 255).to(torch.uint8)


def int4_weights(w: torch.Tensor) -> torch.Tensor:
    """int8 weights carried at 4 bits: 16 * clamp(round(w / 16), -8, 7), the
    precision one step below the configuration's int8 (the control)."""
    return (torch.round(w.to(torch.float64) / 16).clamp(-8, 7) * 16).to(torch.int8)
