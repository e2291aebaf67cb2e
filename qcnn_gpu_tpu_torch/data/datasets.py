"""Training patch pipeline — the port's own copy.

Mirrors `qcnn_gpu_tpu/data/datasets.py` (:24-148), the re-design of the
reference's training/train_data.py, with the same numpy RNG use, so the
port's batches equal the JAX package's element for element:

  * PatchDataset — in-RAM (ori, anchor) frame stacks -> indexed patches,
    64x64 on a stride-32 grid, one globally shuffled index (shuffled once
    at construction and again at the first `get_batch`, since it
    reshuffles whenever its position is 0)
  * PrefetchLoader — background producer thread + bounded queue, the
    host-side half of host->device overlap (the trainer copies each batch
    to the device as it takes it)
"""

from __future__ import annotations

import queue
import threading
from typing import Iterator, Optional, Sequence, Tuple

import numpy as np

from qcnn_gpu_tpu_torch.data import yuv


class PatchDataset:
    """Patches from one or more (ori, anchor) uint8 frame stacks.

    Patch geometry matches train_data.py:31,42-44: side `patch`, stride
    patch//2, column-major piece indexing per sequence; one global shuffled
    index across all sequences, reshuffled each epoch wrap
    (train_data.py:115-116).
    """

    def __init__(
        self,
        pairs: Sequence[Tuple[np.ndarray, np.ndarray]],
        patch: int = 64,
        seed: int = 0,
    ):
        self.patch = patch
        self.stride = patch // 2
        self.pairs = []
        self.layout = []  # (pair_idx, frames, cols, rows)
        total = 0
        for ori, anchor in pairs:
            if ori.shape != anchor.shape or ori.ndim != 3:
                raise ValueError(f"expected two [frames, H, W] stacks of one shape, got "
                                 f"{ori.shape} and {anchor.shape}")
            f, h, w = ori.shape
            cols = (h - patch) // self.stride + 1
            rows = (w - patch) // self.stride + 1
            if cols <= 0 or rows <= 0:
                raise ValueError(f"frames {h}x{w} smaller than patch {patch}")
            self.pairs.append((ori, anchor))
            self.layout.append((f, cols, rows))
            total += f * cols * rows
        self.pieces = total
        self._rng = np.random.default_rng(seed)
        self._index = np.arange(total)
        self._pos = 0
        self._rng.shuffle(self._index)

    @classmethod
    def from_yuv(
        cls,
        specs: Sequence[Tuple[str, str, int, int]],
        frames: Optional[int] = None,
        patch: int = 64,
        seed: int = 0,
    ) -> "PatchDataset":
        """specs: (ori_path, anchor_path, height, width) tuples."""
        pairs = []
        for ori_path, anchor_path, h, w in specs:
            pairs.append(
                (yuv.read_y(ori_path, h, w, frames), yuv.read_y(anchor_path, h, w, frames))
            )
        return cls(pairs, patch=patch, seed=seed)

    def get_piece(self, piece_num: int) -> Tuple[np.ndarray, np.ndarray]:
        for i, (f, cols, rows) in enumerate(self.layout):
            n = f * cols * rows
            if piece_num < n:
                break
            piece_num -= n
        ori, anchor = self.pairs[i]
        _, cols, rows = self.layout[i]
        frm = piece_num // (cols * rows)
        r = (piece_num % (cols * rows)) // rows
        c = (piece_num % (cols * rows)) % rows
        s, p = self.stride, self.patch
        return (
            ori[frm, r * s : r * s + p, c * s : c * s + p],
            anchor[frm, r * s : r * s + p, c * s : c * s + p],
        )

    def get_batch(self, size: int) -> Tuple[np.ndarray, np.ndarray]:
        """-> (labels=ori, images=anchor) float32 [size, patch, patch, 1]
        (the reference feeds anchors as images, originals as labels,
        model.py:140)."""
        oris = np.empty((size, self.patch, self.patch), np.uint8)
        anchors = np.empty_like(oris)
        for i in range(size):
            if self._pos == 0:
                self._rng.shuffle(self._index)
            o, a = self.get_piece(int(self._index[self._pos]))
            oris[i], anchors[i] = o, a
            self._pos = (self._pos + 1) % self.pieces
        return (
            oris.astype(np.float32)[..., None],
            anchors.astype(np.float32)[..., None],
        )

    def batches(self, batch_size: int, steps: int) -> Iterator[Tuple[np.ndarray, np.ndarray]]:
        """Yield (images, labels) pairs ready for the train step."""
        for _ in range(steps):
            labels, images = self.get_batch(batch_size)
            yield images, labels


class PrefetchLoader:
    """Bounded-queue producer thread over any batch iterator — the modern
    twin of the reference's two-buffer lock dance (train_data.py:132-177)."""

    def __init__(self, it: Iterator, depth: int = 4):
        self._q: "queue.Queue" = queue.Queue(maxsize=depth)
        self._sentinel = object()
        self._err: Optional[BaseException] = None

        def worker():
            try:
                for item in it:
                    self._q.put(item)
            except BaseException as e:  # surfaced on next()
                self._err = e
            finally:
                self._q.put(self._sentinel)

        self._thread = threading.Thread(target=worker, daemon=True)
        self._thread.start()

    def __iter__(self):
        return self

    def __next__(self):
        item = self._q.get()
        if item is self._sentinel:
            if self._err is not None:
                raise self._err
            raise StopIteration
        return item
