"""Host-side halo-tiled restoration: frames larger than a tile go through
the program as fixed-shape overlapping windows.

The port's copy of `qcnn_gpu_tpu/engine/tiled.py` (`_windows`,
`restore_tiled`), under the same names. Every window has the same shape,
(tile_h + 2 * halo) x (tile_w + 2 * halo), slid to stay inside the frame,
and only its middle is kept, so the tiled result equals the whole-frame
result on every pixel (tiled.py:15-32):

  * wherever a window edge lies on the frame edge, the program's own SAME
    padding at every layer is the whole-frame program's padding;
  * everywhere else the kept pixels are at least halo >= RECEPTIVE_RADIUS
    (6) real pixels from the window edge, so their receptive field at
    every layer holds exactly the values the whole frame gives.

One departure: the JAX function sends every window of the batch to the
program in one call, 1.37x the batch's pixels at 2160p in 540x960 tiles.
Here the windows go in chunks of at most `chunk`, each chunk's windows
cut from the frames only when it is sent, so that the memory the program
holds is bounded by the chunk and not by the frames.
"""

from __future__ import annotations

from typing import Callable, List, Tuple

import numpy as np

from qcnn_gpu_tpu_torch.models.topology import RECEPTIVE_RADIUS


def _windows(size: int, tile: int, win: int) -> List[Tuple[int, int, int]]:
    """Cover [0, size) with stride-`tile` output spans, each computed from
    a `win`-sized window clamped inside [0, size). Returns per-tile
    (window_start, crop_offset_in_window, kept_len) (tiled.py:45-55)."""
    out = []
    for o0 in range(0, size, tile):
        keep = min(tile, size - o0)
        s = min(max(o0 - (win - keep) // 2, 0), size - win)
        # keep the kept span centered when possible, but always in-window
        s = min(max(s, o0 + keep - win), o0)
        out.append((s, o0 - s, keep))
    return out


def restore_tiled(
    run: Callable[[np.ndarray], np.ndarray],
    frames: np.ndarray,
    tile_h: int = 540,
    tile_w: int = 960,
    halo: int = RECEPTIVE_RADIUS,
    chunk: int = 4,
) -> np.ndarray:
    """Restore uint8 [N, H, W] frames through `run` (any whole-frame
    program: uint8 [k, h, w] array -> uint8 array of that shape) by fixed-
    shape sliding windows, at most `chunk` windows a call. Equal to `run`
    on the whole frames (module docstring). Frames no larger than one
    window go to `run` whole, in one call. Raises ValueError for a halo
    below the receptive radius or a chunk below 1, and TypeError when
    `run` returns anything but uint8."""
    if halo < RECEPTIVE_RADIUS:
        raise ValueError(f"halo {halo} < receptive radius {RECEPTIVE_RADIUS}")
    if chunk < 1:
        raise ValueError(f"chunk must be >= 1, got {chunk}")
    frames = np.asarray(frames)
    n, h, w = frames.shape
    wh, ww = min(tile_h + 2 * halo, h), min(tile_w + 2 * halo, w)
    if wh == h and ww == w:
        return _checked(run(frames))
    # an axis no larger than its window is covered by one full-span tile
    rows = [(0, 0, h)] if wh == h else _windows(h, tile_h, wh)
    cols = [(0, 0, w)] if ww == w else _windows(w, tile_w, ww)
    tiles = [(f, i, j) for f in range(n) for i in range(len(rows)) for j in range(len(cols))]
    result = np.empty((n, h, w), np.uint8)
    for c0 in range(0, len(tiles), chunk):
        part = tiles[c0:c0 + chunk]
        batch = np.empty((len(part), wh, ww), np.uint8)
        for k, (f, i, j) in enumerate(part):
            ys, xs = rows[i][0], cols[j][0]
            batch[k] = frames[f, ys:ys + wh, xs:xs + ww]
        out = _checked(run(batch))
        for k, (f, i, j) in enumerate(part):
            _, yc, yk = rows[i]
            _, xc, xk = cols[j]
            y0, x0 = i * tile_h, j * tile_w
            result[f, y0:y0 + yk, x0:x0 + xk] = out[k, yc:yc + yk, xc:xc + xk]
    return result


def _checked(out) -> np.ndarray:
    """`run`'s output as a uint8 array; anything else raises TypeError
    rather than being truncated (tiled.py:79-80)."""
    out = np.asarray(out)
    if out.dtype != np.uint8:
        raise TypeError(f"restoration program returned {out.dtype}, expected uint8")
    return out
