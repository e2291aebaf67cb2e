"""Low-precision SAME convolutions as library GEMMs over a hand-built
im2col: the port's counterpart of the XLA int8 convolution
`qcnn_gpu_tpu/models/qvrcnn._conv_int`, as `models/wide.py` and
`parallel/tensor.py` use it, and of the bf16-operand convolution of the
FP8 wide net (`qcnn_gpu_tpu/models/wide.py:326-358`).

The JAX package computes these with XLA convolutions, no Pallas kernel,
so the card route is a library GEMM, the counterpart of XLA's conv:

  1. im2col by hand: the input is padded, and the k*k shifted views are
     copied into one [M, k*k*Cin] byte matrix (tap-major, channel-minor:
     the HWIO weight's row order). `F.unfold` refuses int8 and fp8;
     `Tensor.unfold` is a strided view of any dtype, copied once;
  2. `torch._int_mm` (cuBLASLt int8 x int8 -> int32) or `torch._scaled_mm`
     (fp8 e4m3 x e4m3 -> float32, unit tensor-wise scales, no fast
     accumulation);
  3. the bias.

Both GEMMs take A row-major and B column-major; `_int_mm` needs M > 16 and
K and N multiples of 8, `_scaled_mm` K and N multiples of 16. The weights
are padded with zero taps (K) and zero output channels (N), the matrix
with zero rows where M is too small: zero taps add exact zeros, and the
padded columns are dropped. The GEMM runs over frames, or row bands of a
frame, so that one band's matrix and accumulators stay under `GEMM_BYTES`
(at 832x480 and 256 channels one frame's im2col is 920 MB).

On the CPU, `conv_int8` takes the plain version: the port's float64
`conv_exact`, exact since every accumulator stays far below 2^53. A
caller may still ask for the GEMM route on the CPU (`route="gemm"`):
both GEMMs run there, and the tests hold the route's band, pad and
layout logic against the plain version that way. On a CUDA tensor the
route is the GEMM; a failed GEMM raises. `conv_int8.launches` and
`conv_fp8.launches` count the GEMM calls.

The route's parts are program spans (`qcnn_gpu_tpu_torch/spans.py`),
recorded while a `torch.profiler` runs: `conv.im2col` (the pad, and each
band's tap copy), `conv.gemm`, `conv.assemble` (a band's accumulators
copied into the layer's output, where a layer takes more than one band)
and `conv.bias`. A trace's device time by span splits the real forward
by part (`tools/bench_wide.route_split`).
"""

from __future__ import annotations

import dataclasses

import torch
import torch.nn.functional as F

from qcnn_gpu_tpu_torch import spans
from qcnn_gpu_tpu_torch.models.qvrcnn import conv_exact
from qcnn_gpu_tpu_torch.spans import span

GEMM_BYTES = 1 << 31  # one band's im2col matrix and accumulators
MIN_ROWS = 32  # `_int_mm` needs M > 16; a smaller band is padded to this
WORDS = {8: torch.int64, 4: torch.int32, 2: torch.int16}  # bytes -> the im2col copy's word


def _round_up(v: int, m: int) -> int:
    return -(-v // m) * m


@dataclasses.dataclass(frozen=True)
class GemmOperand:
    """A k x k convolution's weights as the GEMM's B operand: `mat` is
    [Kp, Np], column-major (the transpose of a contiguous [Np, Kp]), rows
    (dy, dx, ci) as HWIO flattens them, zero-padded to Kp >= k*k*Cin and
    Np >= Cout. `w_hwio` is the weights as given (the plain version's)."""

    w_hwio: torch.Tensor
    mat: torch.Tensor

    @property
    def k(self) -> int:
        return self.w_hwio.shape[0]

    @property
    def cout(self) -> int:
        return self.w_hwio.shape[3]


def gemm_operand(w_hwio: torch.Tensor, align: int = 8) -> GemmOperand:
    """HWIO weights (int8, or float8_e4m3fn with align=16) -> the GEMM's
    operand on the weights' device."""
    k, _, cin, cout = w_hwio.shape
    kk = k * k * cin
    nk = torch.zeros((_round_up(cout, align), _round_up(kk, align)), dtype=torch.uint8,
                     device=w_hwio.device)
    nk[:cout, :kk] = w_hwio.reshape(kk, cout).t().view(torch.uint8)
    return GemmOperand(w_hwio, nk.view(w_hwio.dtype).t())


def im2col(xp: torch.Tensor, k: int, kp: int) -> torch.Tensor:
    """A padded NHWC block of one-byte values [n, h+k-1, w+k-1, c] -> the
    [max(M, MIN_ROWS if M <= 16), kp] matrix of its k*k taps per output
    pixel (M = n*h*w), the columns past k*k*c and the rows past M zero.
    One strided copy, of 8-, 4- or 2-byte words where c and kp allow it
    (a channel run is contiguous at both ends), else of bytes."""
    n, hp, wp, c = xp.shape
    h, w = hp - k + 1, wp - k + 1
    m, kk = n * h * w, k * k * c
    rows = m if m > 16 else MIN_ROWS
    alloc = torch.empty if (rows, kp) == (m, kk) else torch.zeros
    cols = alloc((rows, kp), dtype=xp.dtype, device=xp.device)
    size = next(s for s in (8, 4, 2, 1) if c % s == 0 and kp % s == 0)
    src, dst = (xp, cols) if size == 1 else (xp.view(WORDS[size]), cols.view(WORDS[size]))
    cw = c // size
    patches = src.unfold(1, k, 1).unfold(2, k, 1)  # [n, h, w, cw, k, k], a view
    dst[:m, :k * k * cw].unflatten(1, (k, k, cw)).unflatten(0, (n, h, w)).copy_(
        patches.permute(0, 1, 2, 4, 5, 3))
    return cols


def _bands(n: int, h: int, w: int, per_px: int, budget: int):
    """(frame slice, row slice) pairs covering [n, h] with at most `budget`
    bytes at `per_px` bytes an output pixel: whole frames where one fits,
    else row bands of one frame."""
    rows = max(1, budget // (w * per_px))
    if rows >= h:
        f = rows // h
        return [(slice(i, min(n, i + f)), slice(0, h)) for i in range(0, n, f)]
    return [(slice(i, i + 1), slice(r, min(h, r + rows)))
            for i in range(n) for r in range(0, h, rows)]


def _gemm_conv(x: torch.Tensor, w: GemmOperand, mm, out_dtype, budget: int) -> torch.Tensor:
    """The route's convolution without bias: x NHWC one-byte values ->
    [N, H, W, Cout] accumulators of `mm` (a view when Cout is padded)."""
    n, h, wd, _ = x.shape
    k = w.k
    p = k // 2
    kp, np_ = w.mat.shape
    with span(spans.CONV_IM2COL):
        xp = F.pad(x.view(torch.uint8), (0, 0, p, p, p, p))
    bands = _bands(n, h, wd, kp + 4 * np_, budget)
    out = None
    for fs, rs in bands:
        blk = xp[fs, rs.start:rs.stop + 2 * p]
        with span(spans.CONV_IM2COL):
            cols = im2col(blk, k, kp).view(x.dtype)
        with span(spans.CONV_GEMM):
            acc = mm(cols, w.mat)
        nb, hb = blk.shape[0], rs.stop - rs.start
        acc = acc[:nb * hb * wd].view(nb, hb, wd, np_)
        if len(bands) == 1:
            out = acc
        else:
            with span(spans.CONV_ASSEMBLE):
                if out is None:
                    out = torch.empty((n, h, wd, np_), dtype=out_dtype, device=x.device)
                out[fs, rs] = acc
    return out[..., :w.cout]


def _int_mm(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    conv_int8.launches += 1
    return torch._int_mm(a, b)


def conv_int8(x: torch.Tensor, w, b=None, *, route=None, budget: int = GEMM_BYTES) -> torch.Tensor:
    """Integer SAME cross-correlation + bias: x NHWC int8 (integer values
    in [-128, 127]), w int8 HWIO or its `gemm_operand`, b int32 [Cout] or
    None -> int32 NHWC accumulators. route "gemm" (the default on CUDA)
    or "plain" (the default on the CPU)."""
    op = w if isinstance(w, GemmOperand) else gemm_operand(w)
    route = route or ("gemm" if x.device.type == "cuda" else "plain")
    if route == "plain":
        bias = b if b is not None else torch.zeros(op.cout, dtype=torch.int32, device=x.device)
        u = conv_exact(x.permute(0, 3, 1, 2), op.w_hwio, bias)
        return u.permute(0, 2, 3, 1).to(torch.int32)
    if route != "gemm":
        raise ValueError(f"route {route!r}: 'gemm' or 'plain'")
    u = _gemm_conv(x, op, _int_mm, torch.int32, budget)
    if b is None:
        return u
    with span(spans.CONV_BIAS):
        return u.add_(b)


conv_int8.launches = 0


def _scaled_mm(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    conv_fp8.launches += 1
    one = torch.ones((), dtype=torch.float32, device=a.device)
    return torch._scaled_mm(a, b, one, one, out_dtype=torch.float32, use_fast_accum=False)


def conv_fp8(x: torch.Tensor, w: GemmOperand, *, budget: int = GEMM_BYTES) -> torch.Tensor:
    """SAME cross-correlation of float8_e4m3fn activations x NHWC with
    float8_e4m3fn weights (`gemm_operand(w, align=16)`) -> float32 NHWC
    sums, no bias, through `_scaled_mm` with unit scales (the GEMM route
    on any device; the FP8 net's plain version is a float32 conv of the
    whole net, `models/wide.py`)."""
    if x.dtype != torch.float8_e4m3fn or w.mat.dtype != torch.float8_e4m3fn:
        raise TypeError(f"conv_fp8 takes float8_e4m3fn operands, got {x.dtype}, {w.mat.dtype}")
    return _gemm_conv(x, w, _scaled_mm, torch.float32, budget)


conv_fp8.launches = 0
