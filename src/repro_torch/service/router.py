"""Consistent-hash ring mapping sample keys to cache shards.

Classic Karger ring with virtual nodes: each shard contributes
``vnodes`` points on a 64-bit circle, a key belongs to the owner of the
first point clockwise from its hash.  Two properties the tests pin
down:

* **balance** — with enough virtual nodes each shard owns ~1/N of the
  key space (max/min load ratio bounded);
* **minimal remapping** — the points of shard ``i`` depend only on
  ``(seed, i, vnode)``, so growing N→N+1 adds points without moving any
  existing ones: a key either keeps its owner or moves to the *new*
  shard, never between old shards.  Shrinking is the mirror image.

Hashing is a splitmix64-style mixer, NOT Python's builtin ``hash`` —
the builtin is salted per process (PYTHONHASHSEED), and a router whose
mapping changed across the client and its shard subprocesses would
route every key nowhere.  The mixer is implemented twice, bit-for-bit:
masked Python ints for scalar calls, ``np.uint64`` wraparound for the
vectorized batch path (asserted equal in tests).
"""
from __future__ import annotations

from typing import Dict, List

import numpy as np

_MASK = (1 << 64) - 1
_GAMMA = 0x9E3779B97F4A7C15
_M1 = 0xBF58476D1CE4E5B9
_M2 = 0x94D049BB133111EB


def splitmix64(x: int) -> int:
    """Scalar splitmix64 finalizer (Steele et al.): a full-avalanche
    deterministic 64-bit mixer."""
    x = (x + _GAMMA) & _MASK
    x = ((x ^ (x >> 30)) * _M1) & _MASK
    x = ((x ^ (x >> 27)) * _M2) & _MASK
    return x ^ (x >> 31)


def _splitmix64_np(x: np.ndarray) -> np.ndarray:
    """Vectorized twin of :func:`splitmix64` (uint64 wraparound)."""
    x = x.astype(np.uint64) + np.uint64(_GAMMA)
    x = (x ^ (x >> np.uint64(30))) * np.uint64(_M1)
    x = (x ^ (x >> np.uint64(27))) * np.uint64(_M2)
    return x ^ (x >> np.uint64(31))


class ShardRouter:
    """Key → shard assignment via a consistent-hash ring.

    ``seed`` diversifies both the ring points and the key salt, so two
    routers with different seeds give independent assignments; the same
    ``(n_shards, vnodes, seed)`` triple always rebuilds the identical
    ring in any process.
    """

    def __init__(self, n_shards: int, vnodes: int = 64, seed: int = 0):
        if n_shards < 1:
            raise ValueError(f"n_shards must be >= 1, got {n_shards}")
        if vnodes < 1:
            raise ValueError(f"vnodes must be >= 1, got {vnodes}")
        self.n_shards = int(n_shards)
        self.vnodes = int(vnodes)
        self.seed = int(seed)
        self._key_salt = splitmix64(self.seed ^ 0xA5A5A5A5A5A5A5A5)
        points: List[int] = []
        owners: List[int] = []
        for shard in range(self.n_shards):
            for v in range(self.vnodes):
                # depends only on (seed, shard, v): adding shard N
                # leaves every existing point in place
                h = splitmix64(self.seed ^ splitmix64(
                    (shard << 20) | v))
                points.append(h)
                owners.append(shard)
        order = np.argsort(np.asarray(points, np.uint64), kind="stable")
        self._points = np.asarray(points, np.uint64)[order]
        self._owners = np.asarray(owners, np.int64)[order]

    # ------------------------------------------------------------------
    def _locate(self, hashes: np.ndarray) -> np.ndarray:
        """Ring walk: index of the first point clockwise of each hash
        (wrapping past the top back to point 0)."""
        idx = np.searchsorted(self._points, hashes, side="left")
        idx[idx == len(self._points)] = 0
        return idx

    def shard_of(self, key: int) -> int:
        """Owning shard of one sample key."""
        if self.n_shards == 1:
            return 0
        h = splitmix64((int(key) ^ self._key_salt) & _MASK)
        return int(self._owners[self._locate(
            np.asarray([h], np.uint64))[0]])

    def shard_of_many(self, keys) -> np.ndarray:
        """Vectorized :meth:`shard_of`: int64[len(keys)]."""
        keys = np.asarray(keys, np.int64)
        if self.n_shards == 1:
            return np.zeros(len(keys), np.int64)
        h = _splitmix64_np(keys.astype(np.uint64)
                           ^ np.uint64(self._key_salt))
        return self._owners[self._locate(h)]

    def group(self, keys) -> Dict[int, np.ndarray]:
        """Partition ``keys`` by owner: ``{shard: index array}`` where
        the indices point into the input sequence (order-preserving
        within each shard)."""
        owners = self.shard_of_many(keys)
        return {int(s): np.nonzero(owners == s)[0]
                for s in np.unique(owners)}

    def load(self, keys) -> np.ndarray:
        """Keys-per-shard histogram (the balance property's subject)."""
        return np.bincount(self.shard_of_many(keys),
                           minlength=self.n_shards)
