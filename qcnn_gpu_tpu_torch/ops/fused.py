"""The fused whole-network kernel: weights, wrapper and plain version.

Counterpart of `qcnn_gpu_tpu/ops/pallas_pipeline3.py`. `fused_forward`
runs the whole QVRCNN (S1..S4 + residual add) on uint8 frames in one
launch of the hand-written CUDA kernel `csrc/qvrcnn_fused.cu`;
`fused_forward_reference` is the plain PyTorch version of the same
function, with the same folded epilogue and frame-bounds masking, that
the kernel is held against bit for bit.

The kernels' operand layout (generation 3's, which generations 2 and 1
share) is described here, in Python, so that the tests can emulate it:
`SPLIT_CHUNKS` lists, stage by stage, the 32-deep K chunks of its `wgmma`
GEMMs (which channel planes and taps each chunk's two halves read, and
which output channels it writes), `split_operand` packs the weights into
the shared-memory image those chunks read, and `layout(th, tw)` gives a
tile's activation regions (`TILE_H`, `TILE_W`, `PITCH`, `ROWS`, `BLOCKS`,
`EXPANDED` and `PLANE` are generation 3's). `csrc/qvrcnn_fused.cu` and
`csrc/qvrcnn_split.cuh` mirror every one of them.

Frame bounds `[row_lo, row_hi) x [col_lo, col_hi)` (default the whole
frame) stand in for the JAX kernel's `row_bounds`/`col_bounds`
(pallas_pipeline3.py:750-755): input pixels outside read as 0 in the
x-128 domain, and every stage output outside is zeroed — per-layer SAME
padding at a frame edge that lies inside the array, as a halo-extended
spatial shard needs.
"""

from __future__ import annotations

import ctypes
import dataclasses
from typing import Optional, Tuple

import numpy as np
import torch

from qcnn_gpu_tpu_torch.models.engine_params import EngineParams
from qcnn_gpu_tpu_torch.models.qvrcnn import MergedParams, conv_exact
from qcnn_gpu_tpu_torch.ops import build
from qcnn_gpu_tpu_torch.ops.requant import (
    apply_residual_u8,
    final_residual_i32,
    requant_fast,
)

KERNEL = "qvrcnn_fused"
MAX_TILES_PER_LAUNCH = 2**31 - 1  # the kernel counts tiles in an int


# ---- the split design (csrc/qvrcnn_fused.cu, and csrc/qvrcnn_split.cuh for
# generations 2 and 1): tile, regions, GEMM chunks
#
# A group of warpgroups computes th x tw output pixels. Its regions, each
# one row pitch wide: the input window (x-128, 6-px halo), S1 (64
# channels), S2 = Conc1 (48) and S3 = Conc2 (48). S2-S4 compute their
# outputs on their INPUT region's pitch (flat offsets: output position q
# reads input position q + dy * pitch + dx), in 64-position blocks; the
# epilogue drops the columns past the output region's width and the
# positions past its last row, and stores the rest on the output region's
# own pitch. S1 reads an expanded window built on S1's own pitch, so it
# drops nothing. Activations are channel-block-major: plane b holds
# channels 16b..16b+15 of every position, 16 bytes per position, plane[i]
# positions per plane (the region plus a tail that the last block's
# shifted reads reach).


@dataclasses.dataclass(frozen=True)
class Layout:
    """A th x tw tile's regions (csrc/qvrcnn_split.cuh `Geometry`): row
    pitches and rows of the window, S1, S2, S3; the 64-position blocks of
    S1..S4; S1's expanded positions; the plane sizes of S1..S3; and the
    bytes of the raw window and of buffers A (S1, then S3) and B (the
    expanded window, then S2, then S4's int32 shares)."""

    th: int
    tw: int
    pitch: Tuple[int, int, int, int]
    rows: Tuple[int, int, int, int]
    blocks: Tuple[int, int, int, int]
    expanded: int
    plane: Tuple[int, int, int]

    @property
    def raw(self) -> int:
        return self.rows[0] * self.pitch[0]

    @property
    def buf_a(self) -> int:
        return max(4 * self.plane[0], 3 * self.plane[2]) * 16

    @property
    def buf_b(self) -> int:
        return max(3 * self.plane[1], self.expanded) * 16

    @property
    def bytes(self) -> int:
        """One tile's buffers: the raw window (to 16 bytes), A and B."""
        return -(-self.raw // 16) * 16 + self.buf_a + self.buf_b

    @property
    def share_stride(self) -> int:
        return self.blocks[3] * 64 + 4


def layout(th: int, tw: int) -> Layout:
    pitch = (tw + 12, tw + 8, tw + 4, tw + 2)  # window, S1, S2, S3
    rows = (th + 12, th + 8, th + 4, th + 2)
    blocks = (
        -(-rows[1] * pitch[1] // 64),  # S1 on its own pitch (its A operand is built on it)
        -(-rows[2] * pitch[1] // 64),
        -(-rows[3] * pitch[2] // 64),
        -(-rows[3] * pitch[3] // 64),  # S4 over the whole S3 region (tap-major, below)
    )
    plane = (
        max(rows[1] * pitch[1], blocks[1] * 64 + 4 * pitch[1] + 4),  # S2 reads 5x5
        max(rows[2] * pitch[2], blocks[2] * 64 + 2 * pitch[2] + 3),  # S3 reads 3x3 (+1)
        max(rows[3] * pitch[3], blocks[3] * 64 + 1),  # S4 reads its blocks (+1)
    )
    return Layout(th, tw, pitch, rows, blocks, blocks[0] * 64 + 3 * pitch[1], plane)


# generation 3's tile (and generation 1's): 24 divides 1080, 40 divides 1920
TILE_H, TILE_W = 24, 40
_L3 = layout(TILE_H, TILE_W)
PITCH, ROWS, BLOCKS, EXPANDED, PLANE = _L3.pitch, _L3.rows, _L3.blocks, _L3.expanded, _L3.plane


@dataclasses.dataclass(frozen=True)
class Chunk:
    """One `wgmma ... k32` of a stage: K = two 16-channel halves, each
    (plane, dy, dx) of the input region, or None for a half whose B rows
    are zero (the A descriptor then points 16 bytes past the first half);
    it adds into output channels [col0, col0 + n)."""

    halves: Tuple[Tuple[int, int, int], Optional[Tuple[int, int, int]]]
    col0: int
    n: int


def _stage_chunks(k: int, planes: int, center, center_cols, other_cols):
    """Chunks of a k x k stage over `planes` 16-channel planes: the taps in
    `center` (raster indices) write `center_cols`, the others `other_cols`
    (col0, n). Planes 0 and 1 of a tap share a chunk; plane 2 (48-channel
    inputs) pairs with plane 2 of the next tap in the same group, the
    group's odd one out with a zero half."""
    chunks = []
    for taps, (col0, n) in ((center, center_cols), ([t for t in range(k * k)
                            if t not in center], other_cols)):
        if not taps or n == 0:
            continue
        tap = [(t // k, t % k) for t in taps]
        for dy, dx in tap:
            chunks.append(Chunk(((0, dy, dx), (1, dy, dx)), col0, n))
            if planes == 4:
                chunks.append(Chunk(((2, dy, dx), (3, dy, dx)), col0, n))
        if planes == 3:
            odd = [(2, dy, dx) for dy, dx in tap] + [None]
            chunks += [Chunk((odd[i], odd[i + 1]), col0, n) for i in range(0, len(tap), 2)]
    return tuple(chunks)


# S2 = C2_1 (3x3, Conc1 channels 0-31) + C2_2 (5x5, 32-47): the 9 centre
# taps carry both (N = 48), the 16 outer taps C2_2 alone (N = 16).
# S3 = C3_1 (3x3, Conc2 0-15) + C3_2 (1x1, 16-47): the centre tap carries
# both (N = 48), the other 8 C3_1 alone (N = 16).
# S4 = C4 (one output channel) runs tap-major: its two chunks read each
# S3 position once (planes 0+1, plane 2 + a zero half) against N = 16
# columns, column t < 9 holding tap t's weights, so acc[p, t] is tap t's
# share of the output at p - (dy_t * pitch + dx_t); the output sums its 9
# shares (`S4_TAPS`).
SPLIT_CHUNKS = (
    _stage_chunks(5, 4, [6, 7, 8, 11, 12, 13, 16, 17, 18], (0, 48), (32, 16)),
    _stage_chunks(3, 3, [4], (0, 48), (0, 16)),
    (Chunk(((0, 0, 0), (1, 0, 0)), 0, 16), Chunk(((2, 0, 0), None), 0, 16)),
)
S4_TAPS = tuple((t // 3, t % 3) for t in range(9))
S1_N = 64
SPLIT_OFFSETS = tuple(np.cumsum([0, 32 * S1_N] + [32 * c.n for s in SPLIT_CHUNKS for c in s]))
SPLIT_BYTES = int(SPLIT_OFFSETS[-1])  # 56,320


def _b_chunk(wk: np.ndarray) -> np.ndarray:
    """B [32, n] (K rows) -> wgmma's K-major core matrices without swizzle:
    byte (k, n) at (n // 8) * 256 + (k // 16) * 128 + (n % 8) * 16 + k % 16
    (leading-dimension offset 128, stride offset 256)."""
    n = wk.shape[1]
    return np.ascontiguousarray(wk.reshape(2, 16, n // 8, 8).transpose(2, 0, 3, 1)).reshape(-1)


def split_operand(w_merged) -> np.ndarray:
    """The 4 branch-merged HWIO weights (S1..S4; any integer dtype) -> the
    generation-3 kernel's shared-memory weight image, SPLIT_BYTES entries:
    S1's one chunk, then every chunk of SPLIT_CHUNKS in order. Only the
    six real layers' weights are packed; merged zero taps are not.

    S1 reads an expanded window, on S1's pitch, whose position (r, c)
    holds 15 taps, window rows r..r+2 x columns c..c+4 (byte 5*i + j = row
    r+i, column c+j; byte 15 = 0); its chunk is that position (K 0-15) and
    the one 3 rows below (K 16-31, row 5 = zero weights)."""
    w1, w2, w3, w4 = (np.asarray(w) for w in w_merged)
    out = []
    k1 = np.zeros((32, S1_N), w1.dtype)
    for h in range(2):
        for i in range(15):
            dy, dx = 3 * h + i // 5, i % 5
            if dy < 5:
                k1[16 * h + i] = w1[dy, dx, 0]
    out.append(_b_chunk(k1))
    for w, chunks in zip((w2, w3), SPLIT_CHUNKS):
        for c in chunks:
            wk = np.zeros((32, c.n), w.dtype)
            for h, half in enumerate(c.halves):
                if half is not None:
                    plane, dy, dx = half
                    wk[16 * h:16 * h + 16] = w[dy, dx, 16 * plane:16 * plane + 16,
                                               c.col0:c.col0 + c.n]
            out.append(_b_chunk(wk))
    for c in SPLIT_CHUNKS[2]:  # S4: column t = tap t
        wk = np.zeros((32, c.n), w4.dtype)
        for h, half in enumerate(c.halves):
            if half is not None:
                plane = half[0]
                for t, (dy, dx) in enumerate(S4_TAPS):
                    wk[16 * h:16 * h + 16, t] = w4[dy, dx, 16 * plane:16 * plane + 16, 0]
        out.append(_b_chunk(wk))
    packed = np.concatenate(out)
    assert packed.size == SPLIT_BYTES
    return packed


def window_refusal(mp: MergedParams) -> Optional[str]:
    """Why the folded epilogue cannot compute this table, or None: the
    first S1..S3 channel whose clip bound (blu_q + bias_pre) does not
    requantize to exactly 127. The fold equals the literal BLU only there
    (pallas_pipeline2._requant_fast): below, u > blu_q would give less than
    127; above, u <= blu_q could give more than the folded min(., 127)
    lets through."""
    for i in range(3):
        bound = mp.blu_q[i].numpy().astype(np.int64) + mp.bias_pre[i].numpy()
        mul, shift = mp.mul[i].numpy().astype(np.int64), mp.shift[i].numpy().astype(np.int64)
        top = (bound * mul) >> shift
        off = np.flatnonzero(top != 127)
        if off.size:
            c = int(off[0])
            return (
                f"stage S{i + 1} channel {c}: (blu_q + bias_pre) * mul >> shift "
                f"= {int(top[c])}, not 127 (blu_q={int(mp.blu_q[i][c])}, "
                f"mul={int(mul[c])}, shift={int(shift[c])}); the folded "
                "requant of the fused kernel is exact only inside the "
                "solver's saturation window"
            )
    return None


@dataclasses.dataclass(frozen=True)
class FusedWeights:
    """Everything the fused kernel reads, on one device (counterpart of
    PackedWeights3, pallas_pipeline3.py:75-169).

    The per-channel int32 vectors are folded as the TPU kernel folds them:
    bias b' = b + bias_pre and bound B = blu_q + bias_pre for S1..S3
    (pallas_pipeline3.py:117-131, :153-159), with mul and shift. S4 keeps
    its raw bias and the final (mul4, shift4). `from_engine` raises
    ValueError for a table whose bound does not requantize to 127, where
    the fold would differ from the literal BLU."""

    w: Tuple[torch.Tensor, ...]  # 4 merged int8 HWIO (plain version)
    split: torch.Tensor  # int8 [SPLIT_BYTES]: the kernels' weight image
    bias: Tuple[torch.Tensor, ...]  # S1..S3 folded b' [C], S4 raw b [1], int32
    bound: Tuple[torch.Tensor, ...]  # S1..S3 B [C], int32
    mul: Tuple[torch.Tensor, ...]
    shift: Tuple[torch.Tensor, ...]
    b4: int
    mul4: int
    shift4: int
    vec: torch.Tensor  # int32 [640]: per stage [b' | B | mul | shift]

    @classmethod
    def from_engine(cls, p: EngineParams, device) -> "FusedWeights":
        mp = MergedParams.from_engine(p, "cpu")
        why = window_refusal(mp)
        if why is not None:
            raise ValueError(why)
        device = torch.device(device)
        w = [x.numpy() for x in mp.w_i8]
        bias, bound, mul, shift = [], [], [], []
        for i in range(3):
            bp = mp.bias_pre[i].numpy().astype(np.int64)
            bias.append(mp.b_i32[i].numpy().astype(np.int64) + bp)
            bound.append(mp.blu_q[i].numpy().astype(np.int64) + bp)
            mul.append(mp.mul[i].numpy())
            shift.append(mp.shift[i].numpy())
        bias.append(mp.b_i32[3].numpy())
        vec = np.concatenate(
            [np.concatenate([bias[i], bound[i], mul[i], shift[i]]) for i in range(3)]
        )
        as_t = lambda a, dt: torch.as_tensor(np.asarray(a, dt), device=device)  # noqa: E731
        return cls(
            w=tuple(as_t(x, np.int8) for x in w),
            split=as_t(split_operand(w), np.int8),
            bias=tuple(as_t(x, np.int32) for x in bias),
            bound=tuple(as_t(x, np.int32) for x in bound),
            mul=tuple(as_t(x, np.int32) for x in mul),
            shift=tuple(as_t(x, np.int32) for x in shift),
            b4=int(bias[3][0]),
            mul4=mp.mul4,
            shift4=mp.shift4,
            vec=as_t(vec, np.int32),
        )


def _bounds(h: int, w: int, row_lo, row_hi, col_lo, col_hi):
    row_hi = h if row_hi is None else row_hi
    col_hi = w if col_hi is None else col_hi
    return int(row_lo), int(row_hi), int(col_lo), int(col_hi)


def check_frames(x_u8: torch.Tensor, weights_device: torch.device) -> None:
    """Raise unless x_u8 is a contiguous uint8 [B, H, W] tensor on the
    weights' device."""
    if not isinstance(x_u8, torch.Tensor):
        raise TypeError(f"expected a torch.Tensor, got {type(x_u8).__name__}")
    if x_u8.dtype != torch.uint8 or x_u8.dim() != 3:
        raise ValueError(
            f"expected uint8 frames [B, H, W], got {x_u8.dtype} {tuple(x_u8.shape)}"
        )
    if not x_u8.is_contiguous():
        raise ValueError("frames must be contiguous")
    if x_u8.device != weights_device:
        raise ValueError(f"frames on {x_u8.device} but weights on {weights_device}")


def fused_forward_reference(
    x_u8: torch.Tensor,
    fw: FusedWeights,
    row_lo: int = 0,
    row_hi: Optional[int] = None,
    col_lo: int = 0,
    col_hi: Optional[int] = None,
) -> torch.Tensor:
    """Plain PyTorch version of the kernel: uint8 [B, H, W] -> uint8."""
    check_frames(x_u8, fw.vec.device)
    b, h, w = x_u8.shape
    row_lo, row_hi, col_lo, col_hi = _bounds(h, w, row_lo, row_hi, col_lo, col_hi)
    rows = torch.arange(h, device=x_u8.device)
    cols = torch.arange(w, device=x_u8.device)
    inside = (((rows >= row_lo) & (rows < row_hi))[:, None]
              & ((cols >= col_lo) & (cols < col_hi))[None, :])

    def mask(v):
        return torch.where(inside, v, torch.zeros((), dtype=v.dtype, device=v.device))

    def ch(t):  # per-channel vector -> NCHW-broadcastable [C, 1, 1]
        return t.view(-1, 1, 1)

    v = mask(x_u8.to(torch.int64) - 128)[:, None]  # [B, 1, H, W]
    for i in range(3):
        u = conv_exact(v, fw.w[i], fw.bias[i])
        v = mask(requant_fast(u, ch(fw.bound[i]), ch(fw.mul[i]), ch(fw.shift[i])))
    u4 = conv_exact(v, fw.w[3], fw.bias[3])
    res = final_residual_i32(u4, fw.mul4, fw.shift4)[:, 0]
    return apply_residual_u8(x_u8, res)


_ARGTYPES = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 10 + [ctypes.c_void_p]


def fused_forward(
    x_u8: torch.Tensor,
    fw: FusedWeights,
    row_lo: int = 0,
    row_hi: Optional[int] = None,
    col_lo: int = 0,
    col_hi: Optional[int] = None,
) -> torch.Tensor:
    """Restore uint8 frames [B, H, W] through the fused network.

    A CUDA tensor goes through the CUDA kernel (one launch on the current
    stream; counted in `fused_forward.launches`) or raises. A CPU tensor
    goes through `fused_forward_reference`, the kernel's plain version."""
    check_frames(x_u8, fw.vec.device)
    if x_u8.device.type == "cpu":
        return fused_forward_reference(x_u8, fw, row_lo, row_hi, col_lo, col_hi)
    if x_u8.device.type != "cuda":
        raise ValueError(f"no kernel for device {x_u8.device}")
    b, h, w = x_u8.shape
    tiles = b * -(-h // TILE_H) * -(-w // TILE_W)
    if tiles > MAX_TILES_PER_LAUNCH:
        raise ValueError(f"at most {MAX_TILES_PER_LAUNCH} tiles per launch, got {tiles}")
    row_lo, row_hi, col_lo, col_hi = _bounds(h, w, row_lo, row_hi, col_lo, col_hi)
    out = torch.empty_like(x_u8)
    if x_u8.numel() == 0:
        return out
    fn = build.function(KERNEL, "qvrcnn_fused_forward", _ARGTYPES)
    with torch.cuda.device(x_u8.device):
        err = fn(
            x_u8.data_ptr(), out.data_ptr(),
            fw.split.data_ptr(), fw.vec.data_ptr(),
            b, h, w, row_lo, row_hi, col_lo, col_hi,
            fw.b4, fw.mul4, fw.shift4, build.stream_of(x_u8),
        )
    build.check(KERNEL, err)
    fused_forward.launches += 1
    return out


fused_forward.launches = 0
