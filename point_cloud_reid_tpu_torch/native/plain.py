"""Plain numpy version of the native crop loader, for the tests only.

Reproduces crop_loader.cpp's output bit for bit: each item's resample
indices are the bounded draws (Lemire's multiply-shift with rejection) of
a splitmix64 stream seeded by the item's seed, so the tests hold the built
library to it. Nothing on the training path calls this module.
"""
from __future__ import annotations

import os
from typing import List, Sequence, Tuple

import numpy as np

_MASK = 2 ** 64 - 1
_GAMMA = 0x9E3779B97F4A7C15


def _splitmix64_next(state: int) -> Tuple[int, int]:
    """(new state, output) of one SplitMix64::next()."""
    state = (state + _GAMMA) & _MASK
    z = ((state ^ (state >> 30)) * 0xBF58476D1CE4E5B9) & _MASK
    z = ((z ^ (z >> 27)) * 0x94D049BB133111EB) & _MASK
    return state, z ^ (z >> 31)


def bounded_draws(seed: int, n: int, k: int) -> List[int]:
    """k draws in [0, n) from the stream of `seed`: SplitMix64::bounded."""
    state, out = int(seed) & _MASK, []
    t = (2 ** 64 - n) % n         # (-n) % n in uint64
    while len(out) < k:
        state, z = _splitmix64_next(state)
        m = z * n
        # the C++ redraws while the low word is below t (t < n)
        if (m & _MASK) < t:
            continue
        out.append(m >> 64)
    return out


def _read(path: str):
    """Bytes of a whole file, or None when it cannot be opened."""
    try:
        with open(path, "rb") as f:
            return f.read()
    except OSError:
        return None


def load_point_batch(paths: Sequence[str], k: int, seeds: Sequence[int],
                     min_points: int = 3) -> Tuple[np.ndarray, np.ndarray]:
    """What native.load_point_batch returns for these files and seeds."""
    B = len(paths)
    out = np.zeros((B, k, 3), np.float32)
    counts = np.full((B,), -1, np.int32)
    for b, p in enumerate(paths):
        raw = _read(os.fsdecode(p))
        if raw is None:
            continue
        n = len(raw) // 12
        counts[b] = n
        if n < min_points:
            continue
        pts = np.frombuffer(raw, np.float32, count=3 * n).reshape(n, 3)
        out[b] = pts[bounded_draws(seeds[b], n, k)]
    return out, counts


def load_blob_batch(paths: Sequence[str], shape: Tuple[int, ...]
                    ) -> Tuple[np.ndarray, np.ndarray]:
    """What native.load_blob_batch returns: a blob of exactly the shape's
    size, else zeros and -1."""
    B = len(paths)
    elems = int(np.prod(shape))
    out = np.zeros((B,) + tuple(shape), np.float32)
    ok = np.full((B,), -1, np.int32)
    for b, p in enumerate(paths):
        raw = _read(p)
        if raw is not None and len(raw) == 4 * elems:
            out[b] = np.frombuffer(raw, np.float32).reshape(shape)
            ok[b] = 1
    return out, ok
