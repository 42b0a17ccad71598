"""Cache tiers: the storage engines under a form's partition.

A :class:`~repro_torch.cache.store.CachePartition` used to *be* an in-memory
``OrderedDict``; it is now a chain of tiers sharing one protocol:

* :class:`HbmTier` — device-resident store: payloads are CUDA tensors
  on an explicit device (uploaded on insert, served zero-copy into the
  training step);
* :class:`DramTier` — the original dict store, behavior-identical;
* :class:`DiskTier` — a directory of per-entry files (one file per
  cached sample, serialized by the form's
  :mod:`~repro_torch.cache.codecs` codec, ndarrays read back via
  ``np.memmap`` zero-copy).

Tiers are dumb byte-accounted stores; *chain* behavior (demote on
eviction, promote on hit) lives in ``CachePartition``, and all locking
stays with :class:`~repro_torch.cache.store.TieredCache` — tier methods are
only ever called under the cache lock.  The one exception is the
:class:`DiskTier` write-behind: ``put`` *stages* the payload in memory
under the lock, and the file write/fsync runs in
:meth:`DiskTier.flush_staged` with the lock **released** around the IO,
so a slow SSD never stalls concurrent lookups (the TieredCache flushes
before each public method returns, keeping the index↔files invariant at
op boundaries).

``put`` / ``set_capacity`` return the entries they evicted as
``(key, value, nbytes)`` triples so a chain can demote them into the
next tier; a terminal tier returns ``value=None`` (nothing consumes it).
"""
from __future__ import annotations

import heapq
import os
from collections import OrderedDict
from dataclasses import dataclass
from typing import (Any, Dict, List, Optional, Protocol, Tuple,
                    runtime_checkable)

import numpy as np
import torch

from repro_torch.cache.codecs import codec_for
from repro_torch.kernels.device import resolve_device

#: sentinel distinguishing "absent" from a legitimately stored falsy /
#: ``None`` payload (an empty encoded sample must count as a hit)
MISS = object()

#: DiskTier index meta for an entry whose file write is still staged
#: (write-behind: the payload is in ``_staged``, not yet on disk)
_PENDING = object()

Evicted = List[Tuple[int, Any, int]]


@dataclass
class PartitionStats:
    hits: int = 0
    misses: int = 0
    inserts: int = 0
    evictions: int = 0
    bytes_used: int = 0

    @classmethod
    def merged(cls, parts: "List[PartitionStats]") -> "PartitionStats":
        """Aggregate stripe-local ledgers into one view (the striped
        TieredCache keeps byte accounting per stripe so the hot path
        never contends on a shared counter; readers sum on demand)."""
        out = cls()
        for p in parts:
            out.hits += p.hits
            out.misses += p.misses
            out.inserts += p.inserts
            out.evictions += p.evictions
            out.bytes_used += p.bytes_used
        return out


@runtime_checkable
class Tier(Protocol):
    """One byte-accounted key/value level of a partition chain."""

    capacity: int
    policy: str
    stats: PartitionStats

    def __contains__(self, key: int) -> bool: ...
    def __len__(self) -> int: ...
    def keys(self) -> List[int]: ...
    def get(self, key: int, default: Any = None) -> Any: ...
    def peek(self, key: int, default: Any = None) -> Any: ...
    def put(self, key: int, value: Any, nbytes: int) -> Evicted: ...
    def set_capacity(self, capacity_bytes: int) -> Evicted: ...
    def remove(self, key: int) -> bool: ...
    def admits(self, nbytes: int) -> bool: ...
    @property
    def free_bytes(self) -> int: ...


class DramTier:
    """In-memory dict store with byte accounting + LRU order (the
    original ``CachePartition`` engine, extracted verbatim)."""

    #: policies that make room inside put() by evicting; the others
    #: ("none"/"refcount") reject inserts that do not fit immediately
    MAKES_ROOM = ("lru", "cost")

    def __init__(self, capacity_bytes: int, evict_policy: str = "none"):
        assert evict_policy in ("none", "lru", "refcount", "cost")
        self.capacity = int(capacity_bytes)
        self.policy = evict_policy
        self._data: "OrderedDict[int, Any]" = OrderedDict()
        self._sizes: Dict[int, int] = {}
        self.stats = PartitionStats()
        # "cost" (GDSF, greedy-dual-size-frequency): every entry carries
        # priority L + recompute_cost/nbytes; eviction pops the minimum
        # and raises the inflation floor L to the victim's priority, so
        # long-untouched entries age out while expensive-to-recompute
        # ones persist.  The heap is lazily invalidated: _pri holds the
        # live priority, stale heap items are skipped on pop.
        self._pri: Dict[int, float] = {}
        self._heap: List[Tuple[float, int]] = []
        self._inflation = 0.0
        #: seconds to rebuild one entry of this form from storage (the
        #: telemetry-measured t_da/t_a chain), pushed by
        #: TieredCache.set_form_costs; 1.0 until telemetry warms up
        self.recompute_cost = 1.0

    # -- "cost" (GDSF) bookkeeping -------------------------------------
    def set_cost(self, seconds: float) -> None:
        """Update the recompute cost feeding future priorities (existing
        entries re-score on their next touch)."""
        self.recompute_cost = max(float(seconds), 1e-9)

    def _touch(self, key: int, nbytes: int) -> None:
        pri = self._inflation + self.recompute_cost / max(nbytes, 1)
        self._pri[key] = pri
        heapq.heappush(self._heap, (pri, key))

    def _evict_min_cost(self) -> Tuple[int, Any, int]:
        """Pop the minimum-priority live entry (skipping stale heap
        items) and raise the inflation floor to its priority."""
        while self._heap:
            pri, k = heapq.heappop(self._heap)
            if k in self._data and self._pri.get(k) == pri:
                self._pri.pop(k, None)
                self._inflation = pri
                v = self._data.pop(k)
                nb = self._sizes.pop(k)
                return k, v, nb
        # heap drained with live entries left (shouldn't happen; the
        # heap holds at least one item per live key) — FIFO fallback
        k, v = self._data.popitem(last=False)
        self._pri.pop(k, None)
        return k, v, self._sizes.pop(k)

    def _evict_victim(self) -> Tuple[int, Any, int]:
        """Remove and return one entry in policy order: min GDSF
        priority for "cost", LRU order for "lru" (move_to_end keeps the
        OrderedDict sorted by recency), insertion/FIFO otherwise."""
        if self.policy == "cost":
            return self._evict_min_cost()
        k, v = self._data.popitem(last=False)
        return k, v, self._sizes.pop(k)

    def __contains__(self, key: int) -> bool:
        return key in self._data

    def __len__(self) -> int:
        return len(self._data)

    def keys(self) -> List[int]:
        return list(self._data.keys())

    def get(self, key: int, default: Any = None) -> Any:
        v = self._data.get(key, MISS)
        if v is MISS:
            self.stats.misses += 1
            return default
        self.stats.hits += 1
        if self.policy == "lru":
            self._data.move_to_end(key)
        elif self.policy == "cost":
            self._touch(key, self._sizes[key])
        return v

    def peek(self, key: int, default: Any = None) -> Any:
        """Stats-neutral read: no hit/miss counting, no LRU promotion."""
        v = self._data.get(key, MISS)
        return default if v is MISS else v

    def admits(self, nbytes: int) -> bool:
        """Could ``put`` accept an entry of ``nbytes`` right now?  Only
        "lru"/"cost" make room inside put(); "none"/"refcount" reject
        when full, so the entry must fit immediately."""
        if self.capacity == 0 or nbytes > self.capacity:
            return False
        return self.policy in self.MAKES_ROOM or self.free_bytes >= nbytes

    def put(self, key: int, value: Any, nbytes: int) -> Evicted:
        """Insert; returns evicted entries (never evicts under 'none' —
        the insert is rejected instead, MINIO-style).  Re-inserting an
        existing key replaces it (the old entry is dropped first, so a
        rejected oversized replacement leaves the key absent, not
        half-accounted)."""
        evicted: Evicted = []
        if key in self._data:
            del self._data[key]
            self.stats.bytes_used -= self._sizes.pop(key)
            self._pri.pop(key, None)
        while self.stats.bytes_used + nbytes > self.capacity:
            if self.policy in self.MAKES_ROOM and self._data:
                k, v, nb = self._evict_victim()
                self.stats.bytes_used -= nb
                self.stats.evictions += 1
                evicted.append((k, v, nb))
            else:
                return evicted           # rejected (no-evict policy)
        self._data[key] = value
        self._sizes[key] = nbytes
        self.stats.bytes_used += nbytes
        self.stats.inserts += 1
        if self.policy == "cost":
            self._touch(key, nbytes)
        return evicted

    def set_capacity(self, capacity_bytes: int) -> Evicted:
        """Resize live; returns the entries evicted to fit (policy order:
        LRU order for "lru", min GDSF priority for "cost",
        insertion/FIFO order otherwise)."""
        self.capacity = int(capacity_bytes)
        evicted: Evicted = []
        while self.stats.bytes_used > self.capacity and self._data:
            k, v, nb = self._evict_victim()
            self.stats.bytes_used -= nb
            self.stats.evictions += 1
            evicted.append((k, v, nb))
        return evicted

    def remove(self, key: int) -> bool:
        if key in self._data:
            del self._data[key]
            self.stats.bytes_used -= self._sizes.pop(key)
            self._pri.pop(key, None)
            self.stats.evictions += 1
            return True
        return False

    def pop_entry(self, key: int):
        """Stats-neutral removal returning ``(value, nbytes)`` or None —
        the chain's demote/promote plumbing (a migration between tiers
        is not an eviction)."""
        if key not in self._data:
            return None
        v = self._data.pop(key)
        nb = self._sizes.pop(key)
        self._pri.pop(key, None)
        self.stats.bytes_used -= nb
        return v, nb

    @property
    def free_bytes(self) -> int:
        return self.capacity - self.stats.bytes_used


class DiskTier:
    """Spill tier: one file per entry under ``root/<form>/``.

    Entries are serialized by the form's codec (encoded bytes pass
    through; decoded/augmented ndarrays become raw contiguous buffers
    read back via ``np.memmap``).  Accounting mirrors :class:`DramTier`
    — the byte ledger tracks caller-declared entry sizes, and eviction
    is LRU by default (a spill area wants recency, not MINIO
    rejection).  Metadata (sizes, dtypes/shapes) stays in memory: the
    tier is process-local scratch, not a persistent store.
    """

    def __init__(self, capacity_bytes: int, root: str, form: str,
                 evict_policy: str = "lru"):
        assert evict_policy in ("none", "lru")
        self.capacity = int(capacity_bytes)
        self.policy = evict_policy
        self.form = form
        self.dir = os.path.join(root, form)
        os.makedirs(self.dir, exist_ok=True)
        self.codec = codec_for(form)
        # key -> (nbytes, codec meta); OrderedDict gives LRU order
        self._index: "OrderedDict[int, Tuple[int, Any]]" = OrderedDict()
        # write-behind staging: key -> payload awaiting its file write
        # (index meta is _PENDING meanwhile; get/peek serve from here)
        self._staged: Dict[int, Any] = {}
        # keys whose file write a flush_staged caller has claimed and is
        # running outside the lock — other flushers must not pick them
        # up, or two threads would dump to the same path concurrently
        self._inflight: set = set()
        self.stats = PartitionStats()
        self.io_errors = 0

    # ------------------------------------------------------------------
    def _path(self, key: int) -> str:
        return os.path.join(self.dir, f"{key}.bin")

    def __contains__(self, key: int) -> bool:
        return key in self._index

    def __len__(self) -> int:
        return len(self._index)

    def keys(self) -> List[int]:
        return list(self._index.keys())

    def admits(self, nbytes: int) -> bool:
        if self.capacity == 0 or nbytes > self.capacity:
            return False
        return self.policy == "lru" or self.free_bytes >= nbytes

    def get(self, key: int, default: Any = None) -> Any:
        entry = self._index.get(key, MISS)
        if entry is MISS:
            self.stats.misses += 1
            return default
        staged = self._staged.get(key, MISS)
        if staged is not MISS:
            # write still pending: serve the in-memory payload directly
            self.stats.hits += 1
            if self.policy == "lru":
                self._index.move_to_end(key)
            return staged
        nbytes, meta = entry
        try:
            value = self.codec.load(self._path(key), meta)
        except (OSError, ValueError):
            # the file vanished or is shorter than dtype*shape claims
            # (external cleanup, or truncated mid-rewrite — np.memmap
            # raises ValueError for short files): drop the index entry
            # rather than serving a phantom hit.  Counted in io_errors
            # only — the chain's lookup counts the resulting miss at
            # lookup granularity, so counting here would double
            self.io_errors += 1
            self._drop(key)
            return default
        self.stats.hits += 1
        if self.policy == "lru":
            self._index.move_to_end(key)
        return value

    def peek(self, key: int, default: Any = None) -> Any:
        entry = self._index.get(key, MISS)
        if entry is MISS:
            return default
        staged = self._staged.get(key, MISS)
        if staged is not MISS:
            return staged
        try:
            return self.codec.load(self._path(key), entry[1])
        except (OSError, ValueError):
            self.io_errors += 1
            self._drop(key)
            return default

    def put(self, key: int, value: Any, nbytes: int) -> Evicted:
        """Insert (or demotion from the DRAM tier).  Returns the entries
        evicted to make room with ``value=None`` — a disk eviction is
        terminal, nothing downstream consumes the payload.

        Write-behind: the payload is only *staged* here (the caller
        holds the cache lock); the file write happens in
        :meth:`flush_staged` with the lock released around the IO."""
        evicted: Evicted = []
        if key in self._index:
            self._drop(key)
        if not self.admits(nbytes):
            return evicted
        while self.stats.bytes_used + nbytes > self.capacity:
            if self.policy == "lru" and self._index:
                k = next(iter(self._index))
                nb = self._index[k][0]
                self._drop(k)
                self.stats.evictions += 1
                evicted.append((k, None, nb))
            else:
                return evicted
        self._index[key] = (nbytes, _PENDING)
        self._staged[key] = value
        self.stats.bytes_used += nbytes
        self.stats.inserts += 1
        return evicted

    def flush_staged(self, lock) -> None:
        """Drain the write-behind stage: claim one staged payload under
        ``lock``, run the codec dump (write + fsync) with the lock
        *released*, then commit the codec meta back under the lock.

        Claims are marked in ``_inflight`` so concurrent flushers never
        pick the same key — two threads dumping to one path outside the
        lock would race truncate-and-rewrite against a reader.  A
        flusher finding only in-flight keys returns; their claimants
        commit them.  Concurrent drops/replacements while a write is in
        flight are reconciled at commit time: a dropped key's orphan
        file is unlinked, a replaced key stays staged (its newer payload
        is picked up by a later iteration).  TieredCache calls this
        after releasing its lock from every mutating public method, so
        at op boundaries the stage is empty and index == files on
        disk."""
        if not self._staged:
            # racy-but-benign fast path: callers flush after their own
            # mutation, so missing a concurrent stage just defers it to
            # that op's flush
            return
        while True:
            with lock:
                key = next((k for k in self._staged
                            if k not in self._inflight), MISS)
                if key is MISS:
                    # nothing unclaimed (empty, or every remaining key's
                    # write is owned by another flusher)
                    return
                value = self._staged[key]
                self._inflight.add(key)
            path = self._path(key)
            err = False
            try:
                _written, meta = self.codec.dump(value, path)
            except OSError:
                err = True
            with lock:
                self._inflight.discard(key)
                if self._staged.get(key, MISS) is not value:
                    # dropped or replaced mid-write; if nothing current
                    # claims the key, the file we just wrote is an orphan
                    if key not in self._index:
                        try:
                            os.unlink(path)
                        except OSError:
                            pass
                    continue
                del self._staged[key]
                entry = self._index.get(key)
                if entry is None:
                    continue
                if err:
                    # a failed spill write is a rejected insert, not a
                    # crash on the serving path; leave no partial file
                    self.io_errors += 1
                    nbytes, _m = self._index.pop(key)
                    self.stats.bytes_used -= nbytes
                    try:
                        os.unlink(path)
                    except OSError:
                        pass
                else:
                    self._index[key] = (entry[0], meta)

    def set_capacity(self, capacity_bytes: int) -> Evicted:
        self.capacity = int(capacity_bytes)
        evicted: Evicted = []
        while self.stats.bytes_used > self.capacity and self._index:
            k = next(iter(self._index))
            nb = self._index[k][0]
            self._drop(k)
            self.stats.evictions += 1
            evicted.append((k, None, nb))
        return evicted

    def remove(self, key: int) -> bool:
        if key in self._index:
            self._drop(key)
            self.stats.evictions += 1
            return True
        return False

    def size_of(self, key: int) -> Optional[int]:
        entry = self._index.get(key)
        return entry[0] if entry is not None else None

    def discard(self, key: int) -> bool:
        """Stats-neutral drop (promotions and replacements are tier
        migrations, not evictions)."""
        if key in self._index:
            self._drop(key)
            return True
        return False

    def _drop(self, key: int) -> None:
        nbytes, _meta = self._index.pop(key)
        self._staged.pop(key, None)
        self.stats.bytes_used -= nbytes
        try:
            os.unlink(self._path(key))
        except OSError:
            pass

    @property
    def free_bytes(self) -> int:
        return self.capacity - self.stats.bytes_used

    # ------------------------------------------------------------------
    def clear(self) -> None:
        """Drop every entry and its file, then the form directory (the
        no-leaked-files teardown contract: ``server.close()`` leaves
        the spill dir empty)."""
        for key in list(self._index):
            self._drop(key)
        try:
            os.rmdir(self.dir)
        except OSError:
            pass


class HbmTier(DramTier):
    """Device-resident tier at the head of a partition chain.

    Payloads are held as tensors on ``device`` (``None`` -> CUDA;
    ``"cpu"`` for tests) — uploaded on insert, so a hit serves the
    card-side buffer zero-copy into the training step.  Accounting,
    eviction policies and the chain protocol are inherited from
    :class:`DramTier`; byte sizes stay caller-declared (host-side nbytes
    — the MDP's currency), so callers admit tensors that own exactly
    their bytes (a row view would pin its whole batch).

    Only array payloads are admitted (:meth:`wants_value`): raw encoded
    ``bytes`` gain nothing from device residency and would force a
    host copy on every decode, so the chain routes them to DRAM.
    ``put`` may run on the pipeline's refill worker threads; the upload
    is a plain blocking copy with no tier state outside the cache lock.
    """

    def __init__(self, capacity_bytes: int, evict_policy: str = "none",
                 device=None):
        super().__init__(capacity_bytes, evict_policy)
        self.device = resolve_device(device)

    @staticmethod
    def wants_value(value: Any) -> bool:
        """Device-residency eligibility: ndarray-like payloads only."""
        return hasattr(value, "__array__") or hasattr(value, "dtype")

    def to_device(self, value: Any) -> torch.Tensor:
        """Host payload -> tensor on the tier's device (no-op for a
        tensor already there).  A read-only array (a memmap of a spill
        or exchange file) is copied on the way, never aliased."""
        if isinstance(value, np.ndarray) and not value.flags.writeable:
            return torch.tensor(value, device=self.device)
        return torch.as_tensor(value).to(self.device)

    def put(self, key: int, value: Any, nbytes: int) -> Evicted:
        return super().put(key, self.to_device(value), nbytes)
