"""The one traffic generator. A traffic mix is a JSON file of parameters,
`traffic/<name>.json`, for one stream fed batches until the window's
deadline:

    host_threads  the process's intra-op CPU threads (`torch.set_num_threads`),
                  which its host copies run on
    height, width frame size (uint8 luma)
    pool_frames   frames made from the seed in set-up; every batch is a
                  contiguous slice of this pool
    batch_frames  frames per batch the caller hands the program
    depth         batches in flight
    check_frames  returned frames compared with the reference after the
                  window (a reservoir sample drawn from the seed)

The pool is drawn on the device with a `torch.Generator` seeded from the
seed, in a few large calls, then copied to host memory, where a caller's
decoded frames are. Where each batch starts is drawn from the seed too;
the sizes are the same for every seed.
"""

from __future__ import annotations

import hashlib
import json
from typing import Iterator, Tuple

import numpy as np
import torch

POOL_CHUNK_BYTES = 256 << 20
KEYS = ("host_threads", "height", "width", "pool_frames", "batch_frames", "depth", "check_frames")


def derive(seed: int, tag: str) -> int:
    """A 63-bit seed of its own for each use of the run's seed."""
    return int.from_bytes(hashlib.sha256(f"{seed}:{tag}".encode()).digest()[:8], "little") >> 1


def load(path: str) -> dict:
    with open(path) as fp:
        t = json.load(fp)
    for key in KEYS:
        if not isinstance(t.get(key), int) or t[key] < 1:
            raise ValueError(f"{path}: {key} must be a positive integer")
    if t["batch_frames"] > t["pool_frames"]:
        raise ValueError(f"{path}: batch_frames exceeds pool_frames")
    return t


def make_pool(t: dict, seed: int, device) -> np.ndarray:
    """uint8 [pool_frames, height, width] in host memory, from the seed."""
    n, h, w = t["pool_frames"], t["height"], t["width"]
    g = torch.Generator(device=device)
    g.manual_seed(derive(seed, "pool"))
    pool = torch.empty((n, h, w), dtype=torch.uint8)
    step = max(1, POOL_CHUNK_BYTES // (h * w))
    for i in range(0, n, step):
        k = min(step, n - i)
        pool[i:i + k] = torch.randint(0, 256, (k, h, w), generator=g, device=device,
                                      dtype=torch.uint8).cpu()
    return pool.numpy()


def slices(t: dict, seed: int) -> Iterator[Tuple[int, int]]:
    """Endless (start, length) slices of the pool, one per batch."""
    rng = np.random.default_rng(derive(seed, "slices"))
    n = t["batch_frames"]
    while True:
        yield int(rng.integers(0, t["pool_frames"] - n + 1)), n
