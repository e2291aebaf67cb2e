"""The split design's tile kernels, emulated in numpy int64 on the CPU:
the instances of the template qcnn_gpu_tpu_torch/csrc/qvrcnn_split.cuh,
generations 3 (qvrcnn_fused.cu), 2 (qvrcnn_pair.cu) and 1
(qvrcnn_literal.cu), laid out as qcnn_gpu_tpu_torch/ops/fused.py says.

`emulate` runs a kernel's arithmetic as the kernel lays it out and
schedules it: persistent blocks walking their work items (frame group,
row tile, column tile) gridDim apart, computing each frame of an item in
turn through one set of tile buffers (raw window; A: S1, then S3; B: the
expanded window, then S2, then S4's int32 shares); in a block, 4
warpgroups that split each stage's 64-position blocks (wg, wg + 4, ...)
and every per-thread loop (tails, raw and expanded window, S4's sums) by
thread index. Each stage's `wgmma` chunks read through descriptors
(start, leading offset between the two K halves, stride 128 between
8-position core matrices) from the weight image `split_operand` packs.
Each warpgroup is a generator that yields at each of the block's
barriers; between two barriers the warpgroups run one after the other.

Every shared-memory byte read (by an MMA, the window expansion or S4's
sums) must have been written during the same tile and by the stage that
produces what the reader expects there (the buffers alias: S3 lies over
S1, S2 and S4's shares over the expanded window); the emulation raises
otherwise. So a stage that does not zero its tail and a barrier that is
dropped (the warpgroup that reaches it runs on before the others) each
fail. Every
stored activation must fit its byte type (0..127 for the folded
epilogue, whose kernels drop the min(., 127); 0..255 for the literal).
Every design takes frame bounds (the template's `Bounds`): the window
reads x - 128 inside them and 0 outside, and every stage stores 0
outside them. Generation 3's diagnostic variants (ops/fused.STAGE_VARIANTS)
are emulated too: `stages` k < 4 reads channel 0 of stage k's region
where the template's `emit_stage` reads it, and `zero_a1` writes a zero
window.
Tolerance against the plain versions and the Pallas kernels: 0.
"""

from __future__ import annotations

import dataclasses

import numpy as np

from qcnn_gpu_tpu_torch.ops import fused as FU


@dataclasses.dataclass(frozen=True)
class Design:
    """One kernel's template arguments (csrc/qvrcnn_split.cuh `Cfg`)."""

    th: int
    tw: int
    frames: int  # frames per work item
    literal: bool  # literal epilogue, uint8 activations, int16 residual out


NWG = 4  # warpgroups per block (split::NWG)
GEN3 = Design(24, 40, 1, False)  # qvrcnn_fused.cu
GEN2 = Design(24, 40, 2, False)  # qvrcnn_pair.cu
GEN1 = Design(24, 40, 1, True)  # qvrcnn_literal.cu
N_BARRIERS = 6  # per tile: raw window, expansion, S1, S2, S3, S4's shares


class Smem:
    """A block's shared-memory buffers; each byte remembers the tile and
    stage that last wrote it."""

    def __init__(self, nbytes):
        self.v = np.zeros(nbytes, np.int64)
        self.tag = np.full(nbytes, -1, np.int64)

    def write(self, idx, vals, tag):
        self.v[idx] = vals
        self.tag[idx] = tag

    def read(self, idx, tag):
        if not (self.tag[idx] == tag).all():
            raise AssertionError(
                "a shared-memory byte read that was not written this tile"
            )
        return self.v[idx]


def _gemm(buf, tag, base, plane_bytes, pitch, mbs, chunks, offsets, w_img, n_out):
    """A stage's chunks over the 64-position blocks `mbs` of an input
    region at `base` -> (positions, int64 accumulators)."""
    q = (np.asarray(list(mbs), np.int64)[:, None] * 64 + np.arange(64)).ravel()
    acc = np.zeros((q.size, n_out), np.int64)
    k = np.arange(32)
    for c, boff in zip(chunks, offsets):
        (p0, dy0, dx0), h1 = c.halves
        start = base + q * 16 + p0 * plane_bytes + (dy0 * pitch + dx0) * 16
        if h1 is None:
            lbo = 16
        else:
            lbo = (h1[0] - p0) * plane_bytes + ((h1[1] - dy0) * pitch + h1[2] - dx0) * 16
        assert lbo > 0
        a = buf.read(start[:, None] + (k // 16) * lbo + k % 16, tag)  # row m at start + m*16
        n = np.arange(c.n)
        b = w_img[boff + (n[:, None] // 8) * 256 + (k // 16) * 128 + (n[:, None] % 8) * 16
                  + k % 16]
        acc[:, c.col0:c.col0 + c.n] += a @ b.T
    return q, acc


def _requant(acc, vec, cout, literal):
    """The kernel's epilogue of S1..S3 on int64 accumulators [M, cout]."""
    if literal:
        b, blu_q, mul, bias_pre, shift = (vec[i * cout:(i + 1) * cout] for i in range(5))
        u = acc + b
        v = np.where(u > blu_q, 127, np.where(u < 0, 0, ((u + bias_pre) * mul) >> shift))
        top = 255
    else:
        b, bound, mul, shift = (vec[i * cout:(i + 1) * cout] for i in range(4))
        v = (np.clip(acc + b, 0, bound) * mul) >> shift  # no min(., 127): implied
        top = 127
    if v.size and (v.min() < 0 or v.max() > top):
        raise AssertionError(f"an activation outside 0..{top}: {v.min()}..{v.max()}")
    return v


def _walk(d, nb, h, w, grid, blk):
    """(frame, ty0, tx0) of the tiles block `blk` computes."""
    tiles_x, per_frame = -(-w // d.tw), -(-h // d.th) * -(-w // d.tw)
    items = -(-nb // d.frames) * per_frame
    for item in range(blk, items, grid):
        p, rem = divmod(item, per_frame)
        for f in range(d.frames * p, min(d.frames * p + d.frames, nb)):
            yield f, (rem // tiles_x) * d.th, (rem % tiles_x) * d.tw


def _warpgroup(d, lay, wg, tiles, buf, x, out, wts, bounds, zero_tails, stages, zero_a1):
    """One warpgroup of a block over the block's tiles; yields the index of
    each barrier it reaches."""
    nth = 128 * NWG
    th, tw = d.th, d.tw
    p, rows, plane = lay.pitch, lay.rows, lay.plane
    off_a = -(-lay.raw // 16) * 16
    off_b = off_a + lay.buf_a
    ss = lay.share_stride
    lo_r, hi_r, lo_c, hi_c = bounds
    w_img = wts.split.numpy().astype(np.int64)
    vec = wts.vec.numpy().astype(np.int64)
    vr = 5 if d.literal else 4
    vecs = (vec[:vr * 64], vec[vr * 64:vr * 112], vec[vr * 112:vr * 160])
    offs = FU.SPLIT_OFFSETS
    n2, n3 = len(FU.SPLIT_CHUNKS[0]), len(FU.SPLIT_CHUNKS[1])
    stage_offs = (offs[1:1 + n2], offs[1 + n2:1 + n2 + n3], offs[1 + n2 + n3:-1])
    s1 = FU.Chunk(((0, 0, 0), (0, 3, 0)), 0, FU.S1_N)  # halves 3 window rows apart

    def mine(n):  # the indices of a `for (i = threadIdx.x; i < n; i += NTHREADS)` loop here
        i = np.arange(n)
        return i[(i % nth) // 128 == wg]

    def inside(r, c):
        return (r >= lo_r) & (r < hi_r) & (c >= lo_c) & (c < hi_c)

    def tails(tag, base, planes, n, ps):
        if zero_tails and ps > n:
            i = mine(planes * (ps - n))
            pos = (i // (ps - n)) * ps + n + i % (ps - n)
            buf.write((base + pos[:, None] * 16 + np.arange(16)).ravel(), 0, tag)

    def store(tag, q, acc, s, ty0, tx0):  # the epilogue of S1..S3
        cout = 64 if s == 0 else 48
        pin = p[1] if s == 0 else p[s]  # S1 runs on its own pitch
        halo = (rows[s + 1] - th) // 2
        rr, cc = q // pin, q % pin
        keep = (rr < rows[s + 1]) & (cc < p[s + 1])
        ok = inside(ty0 - halo + rr[keep], tx0 - halo + cc[keep])
        v = np.where(ok[:, None], _requant(acc[keep], vecs[s], cout, d.literal), 0)
        n = np.arange(cout)
        dst = off_b if s == 1 else off_a
        addr = dst + (n // 16) * plane[s] * 16 + (rr * p[s + 1] + cc)[keep][:, None] * 16 + n % 16
        buf.write(addr.ravel(), v.ravel(), tag)

    def emit(tag, stage, f, ty0, tx0):  # a build truncated after S1..S3
        o = mine(th * tw)
        fr, fc = ty0 + o // tw, tx0 + o % tw
        keep = (fr < x.shape[1]) & (fc < x.shape[2])
        halo = (rows[stage] - th) // 2  # the region starts 4, 2, 1 positions before
        pos = ((o // tw + halo) * p[stage] + o % tw + halo)[keep]
        a = buf.read((off_b if stage == 2 else off_a) + pos * 16, tag)
        fr, fc = fr[keep], fc[keep]
        out[f, fr, fc] = np.clip(x[f, fr, fc] + a, 0, 255)

    for k, (f, ty0, tx0) in enumerate(tiles):
        def tag(stage):  # the bytes stage `stage` of this tile writes: 0 the raw window,
            return k * 8 + stage  # 1 the expanded one, 2-4 S1-S3, 5 S4's shares

        # raw window: x - 128 inside the bounds, 0 outside
        i = mine(lay.raw)
        r, c = ty0 - 6 + i // p[0], tx0 - 6 + i % p[0]
        vals = x[f, np.clip(r, 0, x.shape[1] - 1), np.clip(c, 0, x.shape[2] - 1)]
        ok = inside(r, c) & (not zero_a1)
        buf.write(i, np.where(ok, vals.astype(np.int64) - 128, 0), tag(0))
        yield 0
        # expanded window on S1's pitch: position (r, c), byte 5*i+j = window (r + i, c + j)
        e, j = mine(lay.expanded)[:, None], np.arange(16)[None]
        idx = (e // p[1] + j // 5) * p[0] + e % p[1] + j % 5
        take = (j < 15) & (idx < lay.raw)
        vals = np.zeros(idx.shape, np.int64)
        vals[take] = buf.read(idx[take], tag(0))
        buf.write((off_b + e * 16 + j).ravel(), vals.ravel(), tag(1))
        yield 1
        tails(tag(2), off_a, 4, rows[1] * p[1], plane[0])
        q, acc = _gemm(buf, tag(1), off_b, 0, p[1], range(wg, lay.blocks[0], NWG), [s1], [0],
                       w_img, 64)
        store(tag(2), q, acc, 0, ty0, tx0)
        yield 2
        if stages == 1:
            emit(tag(2), 1, f, ty0, tx0)
            continue
        tails(tag(3), off_b, 3, rows[2] * p[2], plane[1])
        q, acc = _gemm(buf, tag(2), off_a, plane[0] * 16, p[1], range(wg, lay.blocks[1], NWG),
                       FU.SPLIT_CHUNKS[0], stage_offs[0], w_img, 48)
        store(tag(3), q, acc, 1, ty0, tx0)
        yield 3
        if stages == 2:
            emit(tag(3), 2, f, ty0, tx0)
            continue
        tails(tag(4), off_a, 3, rows[3] * p[3], plane[2])
        q, acc = _gemm(buf, tag(3), off_b, plane[1] * 16, p[2], range(wg, lay.blocks[2], NWG),
                       FU.SPLIT_CHUNKS[1], stage_offs[1], w_img, 48)
        store(tag(4), q, acc, 2, ty0, tx0)
        yield 4
        if stages == 3:
            emit(tag(4), 3, f, ty0, tx0)
            continue
        # S4, tap-major: acc[p, t] is tap t's share of the output at p -
        # shift(t), stored as int32 [9][share stride] over B
        q, acc = _gemm(buf, tag(4), off_a, plane[2] * 16, p[3], range(wg, lay.blocks[3], NWG),
                       FU.SPLIT_CHUNKS[2], stage_offs[2], w_img, 16)
        for t in range(9):
            word = off_b + 4 * (t * ss + q)
            buf.write(word, acc[:, t], tag(5))
            buf.write((word[:, None] + np.arange(1, 4)).ravel(), 0, tag(5))
        yield 5
        # each output sums its 9 shares; the final requant; the residual
        o = mine(th * tw)
        fr, fc = ty0 + o // tw, tx0 + o % tw
        keep = (fr < x.shape[1]) & (fc < x.shape[2])
        base = (o // tw) * p[3] + o % tw
        s4 = sum(buf.read(off_b + 4 * (t * ss + base + dy * p[3] + dx)[:, None] + np.arange(4),
                          tag(5))[:, 0]
                 for t, (dy, dx) in enumerate(FU.S4_TAPS))
        u = s4[keep] + wts.b4
        res = (u * wts.mul4 + (1 << (wts.shift4 - 1))) >> wts.shift4
        fr, fc = fr[keep], fc[keep]
        if d.literal:
            out[f, fr, fc] = np.clip(res, -255, 255)
        else:
            out[f, fr, fc] = np.clip(x[f, fr, fc] + res, 0, 255)


def _interval(gens, drop_barrier):
    """Run each live warpgroup to its next barrier, one after the other;
    at a dropped barrier the warpgroup runs on to the next one before the
    others arrive."""
    for g in list(gens):
        try:
            if next(g) == drop_barrier:
                next(g)
        except StopIteration:
            gens.remove(g)


def emulate(x, wts, design, bounds=(), grid=3, zero_tails=True, drop_barrier=None,
            stages=4, zero_a1=False):
    """The kernel's arithmetic on uint8 frames [B, H, W]: restored uint8
    frames, or the int16 residual for the literal design. `wts` is a
    FusedWeights or LiteralWeights on the CPU; `bounds` the frame
    rectangle (row_lo, row_hi, col_lo, col_hi; default the whole frame),
    clipped to the frame as the template's `Bounds::clipped`; `stages` and
    `zero_a1` (generation 3 only) a diagnostic variant. The two mutations (no tail zeroing, barrier
    `drop_barrier` of every tile dropped) make the emulation raise where
    the kernel would read stale or unwritten bytes."""
    d = design
    nb, h, w = x.shape
    lo_r, hi_r, lo_c, hi_c = FU.frame_bounds(h, w, *(bounds or (0, None, 0, None)))
    bounds = (max(lo_r, 0), min(hi_r, h), max(lo_c, 0), min(hi_c, w))
    lay = FU.layout(d.th, d.tw)
    out = np.zeros(x.shape, np.int16 if d.literal else np.uint8)
    items = -(-nb // d.frames) * -(-h // d.th) * -(-w // d.tw)
    for blk in range(min(grid, items)):
        buf = Smem(lay.bytes)
        tiles = list(_walk(d, nb, h, w, min(grid, items), blk))
        gens = [_warpgroup(d, lay, wg, tiles, buf, x, out, wts, bounds, zero_tails, stages,
                           zero_a1)
                for wg in range(NWG)]
        while gens:
            _interval(gens, drop_barrier)
    return out
