"""Packed wire transports for link-bound streaming (bit-exact).

Counterpart of `qcnn_gpu_tpu/engine/packed.py`, with the same payloads,
wire layouts, bucket sizes and `stats` byte counts. The raw round trip
moves 2 B/px (anchor up, recon down); both directions are redundant:

* D2H (`make_packed_restore`): the residual rec - x is a low-entropy
  signal; ship 4-bit nibbles plus an exact exception list, ~0.53 B/px.
* duplex (`DuplexTransport`): successive frames of a static camera are
  bit-identical outside what moves, and the restorer is a per-frame conv
  net with a 6-px receptive radius. Ship block-sparse temporal deltas up,
  and fetch down only the residual-delta blocks the host's own input
  deltas could have changed.

Every path is lossless: content the format cannot beat ships raw,
capacity overflow raises (D2H) or takes the dense fetch (duplex). The
NumPy functions here define the semantics; the transport runs their C++
copies (`qcnn_gpu_tpu_torch/native`), which the tests hold equal.

The device side is XLA in JAX and torch operations here, issued on the
compute stream of the transport's `Staging`. None synchronises with the
host: JAX's static-shape `nonzero(size=k)` is a cumsum compaction into a
k+1 buffer whose last slot takes the fills, and `.at[].set(mode="drop")`
and `take(mode="fill")` write to and read from a sentinel row past the
last block (an out-of-range CUDA index would be a device-side assert).
"""

from __future__ import annotations

import time
from typing import Callable, Optional, Sequence, Tuple

import numpy as np
import torch

from qcnn_gpu_tpu_torch import native
from qcnn_gpu_tpu_torch.engine.stream import Staging, pipeline, pipeline_restore

BLK = 256  # flat-raster block size of the sparse delta transports
RF_RADIUS = 6  # the net's receptive radius (models/topology.RECEPTIVE_RADIUS)


# ---- D2H only: the packed residual (packed.py:33-132) --------------------

def _pack_residual(run: Callable, x: torch.Tensor, capacity_frac: float):
    """Run the restorer and ship rec - x as 4-bit nibbles plus an exact
    exception list (counterpart of `_pack_residual_traced`, :33)."""
    rec = run(x)
    diff = rec.to(torch.int16) - x.to(torch.int16)  # [-255, 255]
    b, h, w = x.shape
    npx = b * h * w
    k = max(1024, int(npx * capacity_frac))
    d4 = (diff.clamp(-8, 7) + 8).to(torch.uint8)
    if w % 2:
        d4 = torch.cat([d4, torch.full((b, h, 1), 8, dtype=torch.uint8, device=x.device)], 2)
    nib = d4[..., 0::2] | (d4[..., 1::2] << 4)
    flat = ((diff > 7) | (diff < -8)).reshape(-1)
    # the first k exception indices in order, the rest of the k slots
    # npx (past the end; `count` bounds the real ones): slot k is the sink
    pos = torch.cumsum(flat.to(torch.int32), 0, dtype=torch.int32) - 1
    slot = torch.where(flat & (pos < k), pos, torch.full_like(pos, k))
    idx = torch.full((k + 1,), npx, dtype=torch.int32, device=x.device)
    idx[slot.long()] = torch.arange(npx, dtype=torch.int32, device=x.device)
    idx = idx[:k]
    val = diff.reshape(-1)[idx.clamp(max=npx - 1).long()]
    count = flat.sum(dtype=torch.int32)
    return nib, idx, val, count


def make_packed_restore(run: Callable, capacity_frac: float = 1.0 / 256.0):
    """Wrap fn(uint8 tensor [B,H,W]) -> uint8 [B,H,W] into (packed, decode):

      packed(x) -> (nibbles u8 [B,H,ceil(W/2)], idx i32 [K], val i16 [K],
                    count i32), tensors on x's device, ~0.5 B/px
      decode(x_host, fetched) -> rec uint8 [B,H,W], equal to run(x)

    K = max(1024, B*H*W * capacity_frac) exception slots; count > K
    raises OverflowError at decode."""

    def packed(x):
        return _pack_residual(run, x, capacity_frac)

    return packed, _decode_residual


def _fetched_numpy(fetched):
    return [a.cpu().numpy() if isinstance(a, torch.Tensor) else np.asarray(a) for a in fetched]


def _decode_residual(x_host: np.ndarray, fetched) -> np.ndarray:
    """Host side of the packed-residual D2H (C++): rec = x + diff."""
    nib, idx, val, count = _fetched_numpy(fetched)
    n = int(count)
    if n > idx.size:
        raise OverflowError(
            f"{n} residual exceptions exceed capacity {idx.size}; fetch the full recon instead"
        )
    return native.residual_decode(x_host, nib, idx, val, n)


def _decode_residual_numpy(x_host: np.ndarray, fetched) -> np.ndarray:
    """The semantics of `_decode_residual` (packed.py:93-101)."""
    nib, idx, val, count = _fetched_numpy(fetched)
    b, h, w = x_host.shape
    n = int(count)
    if n > idx.size:
        raise OverflowError(f"{n} residual exceptions exceed capacity {idx.size}")
    d = np.empty((b, h, nib.shape[-1] * 2), np.int16)
    d[..., 0::2] = nib & 15
    d[..., 1::2] = nib >> 4
    d -= 8
    d = np.ascontiguousarray(d[..., :w])
    if n:  # exception indices address the unpadded [B,H,W] raster
        d.reshape(-1)[idx[:n]] = val[:n]
    return (x_host.astype(np.int16) + d).astype(np.uint8)


def measure_stream_fps_packed(
    packed: Callable,
    decode: Callable,
    batches: Sequence[np.ndarray],
    depth: int = 3,
    *,
    device,
) -> float:
    """measure_stream_fps with the packed D2H: the pipelined loop ships
    nibbles and exceptions, and the fetcher decodes each batch inside the
    timed window, so the restored frames land in host memory
    (kernel.cu:89-101)."""
    state = {"i": 0}

    def sink(fetched):
        decode(batches[state["i"] % len(batches)], fetched)
        state["i"] += 1

    n_frames = sum(b.shape[0] for b in batches)
    t0 = time.perf_counter()
    pipeline_restore(packed, batches, depth, device=device, on_output=sink)
    return n_frames / (time.perf_counter() - t0)


def packed_roundtrip_bytes(shape: Tuple[int, int, int], capacity_frac=1.0 / 256.0):
    """(h2d, d2h) bytes per BATCH for the packed transport at [B,H,W]."""
    b, h, w = shape
    k = max(1024, int(b * h * w * capacity_frac))
    return b * h * w, b * h * ((w + 1) // 2) + 6 * k + 4


# ---- duplex: host side (packed.py:148-233) -------------------------------

def _bucket(n: int, lo: int = 8) -> int:
    if n == 0:
        return 0  # empty class: zero wire bytes, zero-sized operand
    kb = lo
    while kb < n:
        kb *= 2
    return kb


def _pack_payload_numpy(x: np.ndarray, refs: np.ndarray):
    """Block-sparse delta packer, the semantics of native.duplex_pack.
    Three block classes: ALL-ZERO ships nothing; DENSE-exception blocks
    ship raw int8 deltas (260 B beats 6 B/exception past ~43/256; |d| > 127
    rides the exception list); the rest ship 4-bit nibbles plus a
    pointwise exception list."""
    d = (x.astype(np.int16) - refs).reshape(-1)
    npx = d.size
    nb_total = -(-npx // BLK)
    if npx % BLK:
        d = np.pad(d, (0, nb_total * BLK - npx))
    blocks = d.reshape(nb_total, BLK)
    exc_cnt = ((blocks > 7) | (blocks < -8)).sum(axis=1)
    nz = (blocks != 0).any(axis=1)
    raw_sel = nz & (exc_cnt * 6 >= BLK + 4)
    nib_sel = nz & ~raw_sel
    (raw_ids,) = np.nonzero(raw_sel)
    (nib_ids,) = np.nonzero(nib_sel)
    exc_flat = (((blocks > 7) | (blocks < -8)) & nib_sel[:, None]) | (
        ((blocks > 127) | (blocks < -128)) & raw_sel[:, None]
    )
    ne = int(exc_flat.sum())
    kr, kn, ke = _bucket(raw_ids.size), _bucket(nib_ids.size), _bucket(ne)
    raw_idx = np.full(kr, nb_total, np.int32)
    raw_idx[: raw_ids.size] = raw_ids
    raw_val = np.zeros((kr, BLK), np.int8)
    raw_val[: raw_ids.size] = np.clip(blocks[raw_ids], -128, 127)
    d4 = (np.clip(blocks[nib_ids], -8, 7) + 8).astype(np.uint8)
    nib = np.zeros((kn, BLK // 2), np.uint8)
    nib[: nib_ids.size] = d4[:, 0::2] | (d4[:, 1::2] << 4)
    nib_idx = np.full(kn, nb_total, np.int32)
    nib_idx[: nib_ids.size] = nib_ids
    idx = np.full(ke, nb_total * BLK, np.int32)
    val = np.zeros(ke, np.int16)
    if ne:
        ex = np.flatnonzero(exc_flat).astype(np.int32)
        idx[:ne] = ex
        val[:ne] = d[ex]
    return (nib_idx, nib, raw_idx, raw_val, idx, val), int(exc_cnt.sum())


def _predict_changed_blocks(x: np.ndarray, refs: np.ndarray):
    """Flat 256-px block indices whose RESIDUAL delta can be nonzero, the
    semantics of native.duplex_predict. A residual pixel changes between
    frames only if an input pixel within RF_RADIUS changed; dilating the
    changed set (on 8-px tiles, 8 >= 6) over-approximates it soundly.
    Returns (block_idx int32 ascending, nb_total)."""
    b, h, w = x.shape
    ht, wt = -(-h // 8), -(-w // 8)
    chp = np.zeros((b, ht * 8, wt * 8), bool)
    chp[:, :h, :w] = x != refs
    t = chp.reshape(b, ht, 8, wt, 8).any(axis=(2, 4))
    dil = t.copy()
    dil[:, 1:] |= t[:, :-1]
    dil[:, :-1] |= t[:, 1:]
    d2 = dil.copy()
    d2[:, :, 1:] |= dil[:, :, :-1]
    d2[:, :, :-1] |= dil[:, :, 1:]
    px = np.repeat(np.repeat(d2, 8, axis=1), 8, axis=2)[:, :h, :w]
    flat = px.reshape(-1)
    npx = flat.size
    nb = -(-npx // BLK)
    if npx % BLK:
        flat = np.pad(flat, (0, nb * BLK - npx))
    blk = flat.reshape(nb, BLK).any(axis=1)
    return np.nonzero(blk)[0].astype(np.int32), nb


def _duplex_decode8_numpy(x, rows, bidx_p, nbp, prev_res):
    """The semantics of native.duplex_decode8 (packed.py:521-527):
    scatter the gathered int8 residual-delta rows, integrate them over the
    batch from the carried residual, add to x. -> (rec, last residual)."""
    b, h, w = x.shape
    rdp = np.zeros((nbp, BLK), np.int16)
    valid = bidx_p < nbp
    rdp[bidx_p[valid]] = rows[valid]
    rd = rdp.reshape(-1)[: b * h * w].reshape(b, h, w)
    res = prev_res + np.cumsum(rd, axis=0, dtype=np.int16)
    return (x.astype(np.int16) + res).astype(np.uint8), res[-1:]


# ---- duplex: device side (packed.py:292-414) -----------------------------

def _h2d_layout(kn, kr, ke, kb):
    """Byte offsets of the one H2D buffer per packed batch, 4-byte
    segments first so that every view is aligned:
      [nib_idx i32 kn][raw_idx i32 kr][idx i32 ke][bidx i32 kb]
      [val i16 ke][raw_val i8 kr*256][nib u8 kn*128]"""
    o = [0]
    for nbytes in (4 * kn, 4 * kr, 4 * ke, 4 * kb, 2 * ke, 256 * kr, 128 * kn):
        o.append(o[-1] + nbytes)
    return o


def _seg(buf, lo, hi, dtype):
    """Bytes [lo, hi) of the H2D buffer as `dtype` (a view; empty segments
    are made, since torch will not view a zero-size slice as another type)."""
    if hi == lo:
        return torch.empty(0, dtype=dtype, device=buf.device)
    return buf[lo:hi].view(dtype)


def _step_full(run, x):
    rec = run(x)
    res = rec.to(torch.int16) - x.to(torch.int16)
    return (x[-1:], res[-1:]), rec


def _unpack(prev, buf, shape, kn, kr, ke, kb):
    """Anchors from the previous batch's last frame and one packed H2D
    buffer: scatter the block deltas, integrate them over the batch."""
    b, h, w = shape
    npx = b * h * w
    nb_total = -(-npx // BLK)
    o = _h2d_layout(kn, kr, ke, kb)
    nib_idx = _seg(buf, o[0], o[1], torch.int32).long()
    raw_idx = _seg(buf, o[1], o[2], torch.int32).long()
    idx = _seg(buf, o[2], o[3], torch.int32).long()
    val = _seg(buf, o[4], o[5], torch.int16)
    raw_val = _seg(buf, o[5], o[6], torch.int8).to(torch.int16).reshape(kr, BLK)
    nib = buf[o[6]:o[7]].reshape(kn, BLK // 2)
    lo_n = (nib & 15).to(torch.int16) - 8
    hi_n = (nib >> 4).to(torch.int16) - 8
    dn = torch.stack([lo_n, hi_n], dim=-1).reshape(kn, BLK)
    # row nb_total is the sentinel that padded block indices (nb_total)
    # and exception indices (nb_total * BLK) write to; it is dropped
    d = torch.zeros((nb_total + 1, BLK), dtype=torch.int16, device=buf.device)
    d[nib_idx] = dn
    d[raw_idx] = raw_val
    d.view(-1)[idx] = val
    d = d.view(-1)[:npx].view(b, h, w)
    cums = torch.cumsum(d, dim=0, dtype=torch.int16)
    return (prev.to(torch.int16) + cums).to(torch.uint8)


def _core(run, anchor, prev_res):
    """The net and the residual-delta plane, [nb + 1, BLK] int16 with a
    zero row nb that padded block indices gather."""
    rec = run(anchor)
    res = rec.to(torch.int16) - anchor.to(torch.int16)
    res_ref = torch.cat([prev_res, res[:-1]], dim=0)
    rd = (res - res_ref).reshape(-1)  # [-510, 510]
    npx = rd.numel()
    nb = -(-npx // BLK)
    rdp = torch.zeros((nb + 1, BLK), dtype=torch.int16, device=rd.device)
    rdp.view(-1)[:npx] = rd
    return (anchor[-1:], res[-1:]), rdp, rec


def _fetchpack(rdp, buf, kn, kr, ke, kb):
    """The predicted residual-delta blocks as ONE u8 buffer,
    [rows int8 kb*256][overflow u8 x4]: `overflow` is set when a gathered
    delta does not fit int8 (the host then takes the dense fetch)."""
    o = _h2d_layout(kn, kr, ke, kb)
    bidx = _seg(buf, o[3], o[4], torch.int32).long()
    rows = rdp[bidx]
    over = ((rows > 127) | (rows < -128)).any()
    rows8 = rows.clamp(-128, 127).to(torch.int8)
    tail = over.to(torch.uint8).reshape(1).expand(4)
    return torch.cat([rows8.view(torch.uint8).reshape(-1), tail])


class DuplexTransport:
    """Full-duplex block-sparse packed transport (packed.py:236).

      H2D: each batch goes up as block-sparse temporal deltas against the
        previous frame (zero / nibble+exceptions / raw int8 blocks); the
        device rebuilds the anchors exactly with an int16 cumsum over the
        batch and carries the last frame.
      D2H: the device emits the residual-delta plane (res[b] - res[b-1])
        and gathers only the blocks the host predicts can be nonzero; the
        host integrates them. Unfetched blocks are exactly zero. The full
        recon stays on the device for the dense fetch.

    `send` (producer thread) and `receive` (consumer thread) are called
    in stream order, as `stream.pipeline` calls them; all stream state
    lives here. On a CUDA device the
    copies and device operations run on `staging`'s streams and pinned
    ring (at most `staging.slots` batches between send and receive).

    Bit-exactness contract: receive(x, send(x)) == run(x) for every input
    and any interleaving of full and packed steps. The format's own
    lossless fallbacks, content too hot (a full step) and an int8
    overflow in the gathered deltas (a dense fetch), are counted in
    `stats`; any other failure raises."""

    def __init__(self, run: Callable, device, staging: Optional[Staging] = None):
        self._run = run
        self.device = torch.device(device)
        self.staging = staging if staging is not None else Staging(self.device)
        if self.staging.device != self.device:
            raise ValueError(f"staging on {self.staging.device}, transport on {self.device}")
        self.stats = {
            "exc_frac": [], "h2d_bytes": [], "d2h_bytes": [],
            # seconds per batch: producer send in all, and its pack /
            # predict / upload+dispatch; consumer receive in all (the sink
            # included), and its fetch wait / decode
            "t_send": [], "t_pack": [], "t_predict": [], "t_dispatch": [],
            "t_receive": [], "t_fetch": [], "t_decode": [],
            # steps: full (cold start or content too hot), packed, and
            # packed steps whose gathered deltas overflowed int8 (dense fetch)
            "full_steps": 0, "packed_steps": 0, "dense_fetches": 0,
        }
        self._prev: Optional[np.ndarray] = None  # host u8 [1,H,W]
        self._res: Optional[np.ndarray] = None  # host i16 [1,H,W]
        self._carry = None  # device (anchor u8 [1,H,W], res i16 [1,H,W])

    def reserve(self, shape) -> None:
        """Size the pinned ring for batches of `shape` (the largest packed
        payload is under a full batch plus its block list)."""
        b, h, w = shape
        nbk = _bucket(-(-b * h * w // BLK))
        self.staging.reserve(b * h * w + 4 * nbk, max(b * h * w, nbk * BLK + 4))

    # ---- producer side -------------------------------------------------
    def send(self, x: np.ndarray):
        """Pack and dispatch one batch (non-blocking); returns the work
        item for `receive`. Must be called in stream order."""
        t0 = time.perf_counter()
        try:
            return self._send(x)
        finally:
            self.stats["t_send"].append(time.perf_counter() - t0)

    def _send(self, x: np.ndarray):
        prev = self._prev
        # a snapshot, not a view: a caller reusing its frame buffer must
        # not move the host reference frame under the device anchor carry
        self._prev = np.array(x[-1:], copy=True)
        payload = None
        if prev is not None:
            refs = np.concatenate([prev, x[:-1]], axis=0)
            t0 = time.perf_counter()
            payload, n_exc_all = native.duplex_pack(x, refs, _bucket)
            self.stats["t_pack"].append(time.perf_counter() - t0)
            self.stats["exc_frac"].append(n_exc_all / x.size)
            wire = sum(a.nbytes for a in payload)
            if wire >= x.nbytes:  # content too hot for the format
                payload = None
            else:
                t0 = time.perf_counter()
                bidx, nbp = native.duplex_predict(x, refs)
                bidx_p = np.full(_bucket(bidx.size), nbp, np.int32)
                bidx_p[: bidx.size] = bidx
                self.stats["t_predict"].append(time.perf_counter() - t0)
        st = self.staging
        s = st.take()
        try:
            if payload is None or self._carry is None:
                self.stats["h2d_bytes"].append(x.nbytes)
                self.stats["full_steps"] += 1
                xd, up = st.upload(s, [x])
                with st.computing(up):
                    self._carry, rec = _step_full(self._run, xd.view(x.shape))
                return ("full", st.download(s, [rec]), x.shape)
            self.stats["h2d_bytes"].append(wire + bidx_p.nbytes)
            self.stats["packed_steps"] += 1
            t0 = time.perf_counter()
            nib_idx, nib, raw_idx, raw_val, idx_h, val_h = payload
            key = (nib_idx.size, raw_idx.size, idx_h.size, bidx_p.size)
            # ONE H2D buffer (layout in _h2d_layout) and ONE D2H buffer
            buf, up = st.upload(s, [nib_idx, raw_idx, idx_h, bidx_p, val_h, raw_val, nib])
            with st.computing(up):
                anchor = _unpack(self._carry[0], buf, x.shape, *key)
                self._carry, rdp, rec = _core(self._run, anchor, self._carry[1])
                gout = _fetchpack(rdp, buf, *key)
            pending = st.download(s, [gout])
            self.stats["t_dispatch"].append(time.perf_counter() - t0)
            return ("packed", pending, rec, bidx_p, nbp, x.shape)
        except BaseException:
            st.release(s)
            raise

    # ---- consumer side -------------------------------------------------
    def _receive_full(self, x, host) -> np.ndarray:
        rec = np.array(host)
        self.stats["d2h_bytes"].append(rec.nbytes)
        self._res = rec[-1:].astype(np.int16) - x[-1:].astype(np.int16)
        return rec

    def receive(self, x: np.ndarray, item, sink: Optional[Callable] = None) -> np.ndarray:
        """Fetch and decode one batch (blocking), in the order of `send`;
        feed it to `sink` if given, and return it."""
        t0 = time.perf_counter()
        try:
            rec = self._receive(x, item)
            if sink is not None:
                sink(rec)
            return rec
        finally:
            self.stats["t_receive"].append(time.perf_counter() - t0)

    def _receive(self, x: np.ndarray, item) -> np.ndarray:
        st = self.staging
        pending = item[1]
        try:
            if item[0] == "full":
                return self._receive_full(x, st.fetch(pending)[0])
            _, _, rec_dev, bidx_p, nbp, shape = item
            t0 = time.perf_counter()
            (buf,) = st.fetch(pending)  # ONE fetch: int8 rows || overflow flag
            self.stats["t_fetch"].append(time.perf_counter() - t0)
            t0 = time.perf_counter()
            if buf[-4]:  # a gathered delta exceeded int8: the dense fetch
                self.stats["dense_fetches"] += 1
                dense = st.download(pending.slot, [rec_dev], after=pending.event)
                return self._receive_full(x, st.fetch(dense)[0])
            kb = bidx_p.size
            rows = buf[: kb * BLK].view(np.int8).reshape(kb, BLK)
            self.stats["d2h_bytes"].append(buf.nbytes)
            rec, self._res = native.duplex_decode8(x, rows, bidx_p, nbp, self._res)
            self.stats["t_decode"].append(time.perf_counter() - t0)
            return rec
        finally:
            st.release(pending.slot)


def warm_batches(n: int, bs: int, h: int, w: int) -> list:
    """`n` seeded batches of `bs` frames [h, w] that take a fresh duplex
    transport through a full step and then packed steps with every block
    class and predicted blocks to fetch: a patch of uniform noise (raw
    int8 blocks, deltas past 127 on the exception list), a patch of 0/1
    noise (nibble blocks) with one pixel jumping by 100 every frame (a
    nibble exception), zeros elsewhere. Streamed ahead of a timed span, so that
    no device operation of a packed step runs (and has its code loaded)
    for the first time inside it; all-zero batches would skip the
    scatters and gathers of empty segments."""
    rng = np.random.default_rng(0)
    x = np.zeros((n * bs, h, w), np.uint8)
    ph, pw = min(h, 16), min(w, 64)
    x[:, :ph, :pw] = rng.integers(0, 256, (n * bs, ph, pw))
    x[:, h - ph:, w - pw:] = rng.integers(0, 2, (n * bs, ph, pw))
    x[:, h - 1, w - 1] = 100 * (np.arange(n * bs) % 2)
    return [x[i * bs:(i + 1) * bs] for i in range(n)]


def make_duplex_restore(run: Callable, device,
                        staging: Optional[Staging] = None) -> DuplexTransport:
    """Construct the duplex transport (see DuplexTransport). The JAX
    version's `capacity_frac` is not taken: the duplex transport has no
    exception list on the way down, and JAX's stores it unused."""
    return DuplexTransport(run, device, staging)


def measure_stream_fps_duplex(
    transport: DuplexTransport,
    batches: Sequence[np.ndarray],
    depth: int = 3,
    on_output: Optional[Callable] = None,
) -> float:
    """Wall-clock fps of `stream.pipeline` over the duplex transport: host
    pack, sparse H2D, device unpack + restore + delta pack,
    predicted-sparse D2H, host decode, all inside the timed window
    (kernel.cu:89-101 with both copies packed). The transport's staging
    needs at least depth + 2 slots."""
    t0 = time.perf_counter()
    pipeline(transport, batches, depth, on_output or (lambda a: None))
    return sum(b.shape[0] for b in batches) / (time.perf_counter() - t0)


def duplex_roundtrip_bytes(shape: Tuple[int, int, int], capacity_frac=1.0 / 256.0):
    """(h2d, d2h) bytes per BATCH for the duplex transport as UPPER bounds
    (every block active, full exception capacity); see `stats` for what a
    stream measured."""
    b, h, w = shape
    k = max(1024, int(b * h * w * capacity_frac))
    nb = -(-b * h * w // 256)
    return nb * (4 + 128), nb * 128 + 6 * k + 4
