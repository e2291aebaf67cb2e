"""The wide INT8 restoration net's integer forward pass, plain, and the
maker of its weights and requant table from a seed.

The net: a 3x3 head conv 1->C, `blocks` 3x3 convs C->C and a 3x3 tail conv
C->1, all zero-padded at the frame's edge. Every layer but the tail ends
in QVRCNN's BLU requant; the tail gives the floor-shifted residual that is
added to the frame and clamped to [0, 255] (`conv.py`).

`make_params` draws the int8 weights and int32 biases on the device from
the seed, with one `torch.Generator`, in three calls for the weights
(head, the whole body, tail) and one for the biases, and works the table
out from the weights alone:

* a hidden layer's accumulator spread is estimated as the RMS of its
  input (`RMS_INPUT` for x - 128 on uniform frames, `RMS_HIDDEN` for a BLU
  output) times the RMS over output channels of the weights' L2 norm;
  blu_q is twice that spread, so some outputs saturate, some are cut to
  zero and most are in between;
* (mul, shift) maps blu_q onto 127 at shift `SHIFT`, with mul lowered until
  ((blu_q + 2^(shift-1) // mul) * mul) >> shift <= 127, so no value of the
  linear branch passes 127 and every product stays below 2^31;
* the tail's (mul_last, shift_last) scales its spread to `RESIDUAL_RMS`
  grey levels, with mul_last at least 64.
"""

from __future__ import annotations

import dataclasses
import math
from typing import List

import torch

from benchmark.reference.conv import blu_requant, conv_same, final_residual, int4_weights, restored
from benchmark.traffic import derive

RMS_INPUT = 73.9  # x - 128 over uniform uint8 frames
RMS_HIDDEN = 43.0  # a BLU output of a normal accumulator at blu_q = twice its spread
SHIFT = 23
RESIDUAL_RMS = 6.0
BIAS_RANGE = 4096


@dataclasses.dataclass
class Params:
    """weights int8 HWIO and biases int32, on one device, layers in order
    (head, body, tail); blu_q/mul/shift for every layer but the tail."""

    weights: List[torch.Tensor]
    biases: List[torch.Tensor]
    blu_q: List[int]
    mul: List[int]
    shift: List[int]
    mul_last: int
    shift_last: int


def _requant_row(blu_q: int, shift: int = SHIFT):
    mul = max(1, (127 << shift) // blu_q)
    while ((blu_q + (1 << (shift - 1)) // mul) * mul) >> shift > 127:
        mul -= 1
    return mul, shift


def _spread(w: torch.Tensor, rms_in: float) -> float:
    """rms_in times the RMS over output channels of the weights' L2 norm."""
    sq = w.to(torch.int64).pow(2).sum(dim=(0, 1, 2))
    return rms_in * math.sqrt(sq.sum().item() / sq.numel())


def make_params(channels: int, blocks: int, seed: int, device) -> Params:
    g = torch.Generator(device=device)
    g.manual_seed(seed)

    def draw(*shape, lo=-127, hi=128, dtype=torch.int8):
        return torch.randint(lo, hi, shape, generator=g, device=device, dtype=dtype)

    body = draw(blocks, 3, 3, channels, channels)
    weights = [draw(3, 3, 1, channels)] + list(body.unbind(0)) + [draw(3, 3, channels, 1)]
    bias_all = draw(channels * (blocks + 1) + 1, lo=-BIAS_RANGE, hi=BIAS_RANGE + 1,
                    dtype=torch.int32)
    biases = list(bias_all[:-1].view(blocks + 1, channels).unbind(0)) + [bias_all[-1:]]
    blu_q, mul, shift = [], [], []
    for i, w in enumerate(weights[:-1]):
        b = max(1, round(2 * _spread(w, RMS_INPUT if i == 0 else RMS_HIDDEN)))
        m, s = _requant_row(b)
        blu_q.append(b)
        mul.append(m)
        shift.append(s)
    tail = _spread(weights[-1], RMS_HIDDEN)
    shift_last = max(1, math.ceil(math.log2(64 * tail / RESIDUAL_RMS)))
    mul_last = round(RESIDUAL_RMS / tail * 2 ** shift_last)
    return Params(weights, biases, blu_q, mul, shift, mul_last, shift_last)


def load(config: dict, seed: int, root: str, device) -> Params:
    """The configuration's weights and table, made from the seed."""
    return make_params(config["channels"], config["blocks"], derive(seed, "weights"), device)


def forward(x_u8: torch.Tensor, p: Params, int4: bool = False) -> torch.Tensor:
    """uint8 [N, H, W] -> restored uint8 [N, H, W], on x's device. int4:
    the weights carried at 4 bits (the control)."""
    dev = x_u8.device
    ws = [w.to(dev) for w in p.weights]
    if int4:
        ws = [int4_weights(w) for w in ws]
    v = x_u8[:, None].to(torch.int64) - 128
    for i in range(len(ws) - 1):
        v = blu_requant(conv_same(v, ws[i], p.biases[i].to(dev)), p.blu_q[i], p.mul[i], p.shift[i])
    res = final_residual(conv_same(v, ws[-1], p.biases[-1].to(dev)), p.mul_last, p.shift_last)
    return restored(x_u8, res[:, 0])
