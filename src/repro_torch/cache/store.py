"""Three-form cache with pluggable storage tiers (the Redis analogue,
DESIGN.md §2, plus the SSD spill production systems bolt on).

Byte-accounted partitions for encoded / decoded / augmented samples with
pluggable eviction.  Each partition is a *tier chain*
(:mod:`repro_torch.cache.tiers`): an optional device-resident
:class:`HbmTier` at the head, a :class:`DramTier` (the original dict
store), and an optional :class:`DiskTier` spill area.  Eviction demotes
entries down the chain instead of dropping them (HBM→DRAM on overflow,
DRAM→disk), hits promote back up (disk hits re-enter DRAM; hot DRAM
hits of array payloads earn device residency), and inserts that DRAM
rejects overflow onto disk — so a DRAM-constrained cache degrades to
disk bandwidth instead of storage bandwidth, and a hot augmented set
serves zero-copy from device memory.

Thread-safe: the real data pipeline hits this store from fetch worker
threads while the trainer consumes batches.  All chain behavior runs
under the cache's locks; tiers themselves are lock-free.  With the
default ``n_stripes=1`` every operation serializes on one lock exactly
as the engine always did.  ``n_stripes>1`` hash-stripes the key space:
each stripe owns its own per-form partition chains, byte ledgers and
lock, so per-key hot-path operations (lookup / insert / contains /
evict) on different stripes no longer contend.  Whole-cache operations
(resize, close, ``cache.lock``) take every stripe lock in ascending
index order — one fixed global order, so they can never deadlock
against each other — and aggregate views (``stats`` / ``status_array``
/ ``hit_rate``) sum the stripe-local ledgers on read.
Spill-tier file *writes* are write-behind: ``DiskTier.put`` stages the
payload under the lock, and each mutating public method drains the
stage via :meth:`DiskTier.flush_staged` — write + fsync running with
the stripe's lock released — before returning, so a slow SSD no longer
stalls every concurrent lookup.  Codec
*reads* on disk hits still run under the lock.
"""
from __future__ import annotations

import os
import threading
from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch

from repro_torch.cache.tiers import (MISS, DiskTier, DramTier, HbmTier,
                               PartitionStats, Tier)

__all__ = ["FORMS", "PartitionStats", "CachePartition", "TieredCache",
           "Tier", "DramTier", "DiskTier", "HbmTier"]

FORMS = ("encoded", "decoded", "augmented")

#: residency levels reported by :meth:`TieredCache.residency_array`
RESIDENCY_NONE, RESIDENCY_DISK, RESIDENCY_DRAM = 0, 1, 2
RESIDENCY_HBM = 3


def _host(value: Any) -> np.ndarray:
    """Host array for the DRAM and disk tiers: a tensor (CUDA memory
    included, which ``np.asarray`` cannot read) comes down with
    ``.cpu().numpy()``."""
    if isinstance(value, torch.Tensor):
        return value.cpu().numpy()
    return np.asarray(value)


class CachePartition:
    """One form's partition: an optional device (HBM) tier, a DRAM tier
    and an optional disk spill tier, chained with byte accounting + LRU
    order per tier.

    The public surface (and the DRAM-only behavior) is identical to the
    pre-chain ``CachePartition``; ``stats``/``_data``/``_sizes`` keep
    addressing the DRAM tier so existing accounting assertions hold
    unchanged.  Keys evicted *out of the chain entirely* (spill
    overflow, promotion backfill) are recorded in ``pending_evicted``
    for the service to reconcile ODS metadata with.

    HBM chain rules: array payloads whose insert the HBM tier admits go
    device-resident immediately (uploaded); others land in DRAM as host
    arrays (a tensor is copied down),
    and a DRAM entry that takes ``HBM_PROMOTE_HITS`` lookup hits is
    promoted up.  HBM overflow/resize demotes down into DRAM (host
    copies), cascading into the spill tier like any DRAM eviction.
    """

    #: DRAM lookup hits (of an HBM-eligible payload) before promotion
    HBM_PROMOTE_HITS = 2

    def __init__(self, capacity_bytes: int, evict_policy: str = "none",
                 spill: Optional[DiskTier] = None,
                 hbm: Optional[HbmTier] = None):
        self.dram = DramTier(capacity_bytes, evict_policy)
        self.spill = spill
        self.hbm = hbm
        # keys no longer resident anywhere in the chain, awaiting a
        # metadata patch (drained via TieredCache.take_evicted)
        self.pending_evicted: List[int] = []
        # chain traffic counters (how the spill is actually behaving)
        self.demotions = 0
        self.promotions = 0
        # device-tier traffic + DRAM hit-heat driving promotion
        self.hbm_promotions = 0
        self.hbm_demotions = 0
        self._heat: Dict[int, int] = {}

    # -- compat surface over the DRAM tier -----------------------------
    @property
    def capacity(self) -> int:
        return self.dram.capacity

    @capacity.setter
    def capacity(self, value: int) -> None:
        self.dram.capacity = int(value)

    @property
    def policy(self) -> str:
        return self.dram.policy

    @property
    def stats(self) -> PartitionStats:
        return self.dram.stats

    @property
    def _data(self):
        return self.dram._data

    @property
    def _sizes(self):
        return self.dram._sizes

    @property
    def free_bytes(self) -> int:
        return self.dram.free_bytes

    @property
    def total_capacity(self) -> int:
        return (self.dram.capacity
                + (self.spill.capacity if self.spill else 0)
                + (self.hbm.capacity if self.hbm else 0))

    # -- chain-aggregate stats -----------------------------------------
    @property
    def total_hits(self) -> int:
        return (self.dram.stats.hits
                + (self.spill.stats.hits if self.spill else 0)
                + (self.hbm.stats.hits if self.hbm else 0))

    @property
    def total_misses(self) -> int:
        return self.dram.stats.misses + (self.spill.stats.misses
                                         if self.spill else 0)

    # ------------------------------------------------------------------
    def __contains__(self, key: int) -> bool:
        return (key in self.dram
                or (self.spill is not None and key in self.spill)
                or (self.hbm is not None and key in self.hbm))

    def __len__(self) -> int:
        return (len(self.dram) + (len(self.spill) if self.spill else 0)
                + (len(self.hbm) if self.hbm else 0))

    def keys(self) -> List[int]:
        ks = self.dram.keys()
        if self.spill is not None:
            ks += self.spill.keys()
        if self.hbm is not None:
            ks += self.hbm.keys()
        return ks

    def tier_of(self, key: int) -> Optional[str]:
        if self.hbm is not None and key in self.hbm:
            return "hbm"
        if key in self.dram:
            return "dram"
        if self.spill is not None and key in self.spill:
            return "disk"
        return None

    # ------------------------------------------------------------------
    def get(self, key: int, default: Any = None) -> Any:
        return self.get_tiered(key, default)[0]

    def get_tiered(self, key: int, default: Any = None
                   ) -> Tuple[Any, Optional[str]]:
        """Chain lookup counting exactly one hit or miss; disk hits
        promote back to DRAM when it has (or can make) room, hot DRAM
        hits promote up to the device tier.  Returns ``(value, tier)``
        with tier in ("hbm", "dram", "disk", None) — an "hbm" hit
        serves the device-resident tensor zero-copy."""
        if self.hbm is not None:
            v = self.hbm.peek(key, MISS)
            if v is not MISS:
                return self.hbm.get(key, default), "hbm"
        v = self.dram.peek(key, MISS)
        if v is not MISS:
            value = self.dram.get(key, default)
            self._maybe_promote_hbm(key, value)
            return value, "dram"
        if self.spill is not None and key in self.spill:
            v = self.spill.get(key, MISS)   # counts the disk hit
            if v is not MISS:
                self._promote(key, v)
                return v, "disk"
            return default, None            # file vanished: disk miss
        self.dram.stats.misses += 1
        return default, None

    def peek(self, key: int, default: Any = None) -> Any:
        """Stats-neutral read: no hit/miss counting, no LRU promotion.
        For controller/refill scans that inspect residency without being
        part of the serving path."""
        if self.hbm is not None:
            v = self.hbm.peek(key, MISS)
            if v is not MISS:
                return v
        v = self.dram.peek(key, MISS)
        if v is not MISS:
            return v
        if self.spill is not None:
            return self.spill.peek(key, default)
        return default

    def _promote(self, key: int, value: Any) -> None:
        """Move a disk hit up to DRAM (LRU partitions make room by
        demoting their coldest entries back down; no-evict partitions
        promote only into free space — otherwise the entry stays on
        disk and keeps serving from there)."""
        nbytes = self.spill.size_of(key)
        if nbytes is None or not self.dram.admits(nbytes):
            return
        demoted = self.dram.put(key, value, nbytes)
        if key in self.dram:
            self.spill.discard(key)
            self.promotions += 1
        self._demote(demoted)

    def _demote(self, entries) -> None:
        """Push DRAM-evicted entries down into the spill tier; entries
        the spill cannot hold (and entries the spill evicts to make
        room) leave the chain and are queued for metadata patching.
        Without a spill tier nothing queues — chain-leavers are exactly
        the caller-visible eviction lists the pre-chain code returned,
        so no reconcile pass exists (or is needed) to drain them."""
        for k, _v, _nb in entries:
            # every entry here left DRAM: its promotion heat is stale
            # (a later re-entry must re-earn device residency) and the
            # map must not grow toward n_total over long runs
            self._heat.pop(k, None)
        if self.spill is None:
            return
        for k, v, nb in entries:
            placed = False
            if self.spill.admits(nb):
                for ek, _ev, _enb in self.spill.put(k, v, nb):
                    self.pending_evicted.append(ek)
                placed = k in self.spill
                if placed:
                    self.demotions += 1
            if not placed:
                self.pending_evicted.append(k)

    def _maybe_promote_hbm(self, key: int, value: Any) -> None:
        """Count a DRAM hit toward device promotion; on the
        ``HBM_PROMOTE_HITS``-th hit of an HBM-eligible payload, move it
        up (uploaded) and cascade any HBM evictions back down."""
        if self.hbm is None or not HbmTier.wants_value(value):
            return
        heat = self._heat.get(key, 0) + 1
        if heat < self.HBM_PROMOTE_HITS:
            self._heat[key] = heat
            return
        self._heat.pop(key, None)
        entry = self.dram.pop_entry(key)
        if entry is None:
            return
        _v, nbytes = entry
        if not self.hbm.admits(nbytes):
            # oversized for the device tier: put it straight back (the
            # slot it just vacated is still free, so this cannot evict)
            self.dram.put(key, value, nbytes)
            return
        demoted = self.hbm.put(key, value, nbytes)
        if key in self.hbm:
            self.hbm_promotions += 1
        self._demote_hbm(demoted)

    def _demote_hbm(self, entries) -> None:
        """Push HBM-evicted entries down into DRAM as host copies,
        cascading DRAM overflow into the spill tier; entries nothing
        below can hold leave the chain (queued for metadata patching —
        unlike :meth:`_demote`, chain-leavers queue even without a
        spill tier, because HBM demotion happens during *lookups* where
        the caller sees no eviction list)."""
        for k, v, nb in entries:
            host = _host(v)
            placed = False
            if self.dram.admits(nb):
                dram_evicted = self.dram.put(k, host, nb)
                placed = k in self.dram
                if placed:
                    self.hbm_demotions += 1
                if self.spill is None:
                    for ek, _ev, _enb in dram_evicted:
                        self._heat.pop(ek, None)
                        self.pending_evicted.append(ek)
                else:
                    self._demote(dram_evicted)
            if not placed:
                if self.spill is not None and self.spill.admits(nb):
                    for ek, _ev, _enb in self.spill.put(k, host, nb):
                        self.pending_evicted.append(ek)
                    placed = k in self.spill
                    if placed:
                        self.hbm_demotions += 1
                if not placed:
                    self.pending_evicted.append(k)

    # ------------------------------------------------------------------
    def admits(self, nbytes: int) -> bool:
        """Could an insert of ``nbytes`` land anywhere in the chain?"""
        if self.hbm is not None and self.hbm.admits(nbytes):
            return True
        if self.dram.admits(nbytes):
            return True
        return self.spill is not None and self.spill.admits(nbytes)

    def put(self, key: int, value: Any, nbytes: int) -> List[int]:
        """Insert; returns the keys evicted *out of the chain* (never
        evicts under 'none' — the insert overflows to the spill tier
        when one exists, or is rejected, MINIO-style).  Re-inserting an
        existing key replaces it.  Array payloads the device tier
        admits go HBM-resident immediately; HBM evictions cascade down
        the chain like any demotion."""
        if (self.hbm is not None and HbmTier.wants_value(value)
                and self.hbm.admits(nbytes)):
            demoted = self.hbm.put(key, value, nbytes)
            evicted: List[int] = []
            if key in self.hbm:
                # single-residence invariant across all three tiers
                self.dram.pop_entry(key)
                if self.spill is not None:
                    self.spill.discard(key)
                self._heat.pop(key, None)
                self._demote_hbm(demoted)
                evicted.extend(k for k, _v, _nb in demoted
                               if k not in self)
                return evicted
            # no-evict HBM rejected after all: fall through to DRAM
        if isinstance(value, torch.Tensor):
            value = _host(value)     # DRAM and disk hold host arrays
        demoted = self.dram.put(key, value, nbytes)
        evicted = []
        if key in self.dram:
            # single-residence invariant: a fresh DRAM copy supersedes
            # any stale spill (or device) copy from earlier demotions
            if self.spill is not None:
                self.spill.discard(key)
            if self.hbm is not None:
                self.hbm.remove(key)
        elif self.spill is not None:
            # DRAM rejected (no-evict policy full / oversized): spill
            # admission keeps the entry cached at disk speed
            for ek, _ev, _enb in self.spill.put(key, value, nbytes):
                self.pending_evicted.append(ek)
                evicted.append(ek)
        self._demote(demoted)
        evicted.extend(k for k, _v, _nb in demoted
                       if k not in self)
        return evicted

    def set_capacity(self, capacity_bytes: int) -> List[int]:
        """Resize the DRAM level live; returns the keys evicted out of
        the chain.  Shrinking demotes through the partition's own policy
        order — LRU order for "lru", insertion (FIFO) order for
        "none"/"refcount" — into the spill tier when one exists, rather
        than dropping.  Byte accounting stays exact per tier (asserted
        by tests/test_cache_properties.py)."""
        demoted = self.dram.set_capacity(capacity_bytes)
        self._demote(demoted)
        return [k for k, _v, _nb in demoted if k not in self]

    def set_spill_capacity(self, capacity_bytes: int) -> List[int]:
        """Resize the disk level live; spill shrink evictions are
        terminal."""
        if self.spill is None:
            return []
        evicted = [k for k, _v, _nb in
                   self.spill.set_capacity(capacity_bytes)]
        self.pending_evicted.extend(evicted)
        return evicted

    def set_hbm_capacity(self, capacity_bytes: int) -> List[int]:
        """Resize the device level live; shrink demotions cascade down
        the chain (host copies into DRAM, overflowing to disk) and the
        keys evicted out of the chain entirely are returned."""
        if self.hbm is None:
            return []
        demoted = self.hbm.set_capacity(capacity_bytes)
        self._demote_hbm(demoted)
        return [k for k, _v, _nb in demoted if k not in self]

    def remove(self, key: int) -> bool:
        """Drop ``key`` from every tier (refcount eviction consumes the
        sample entirely — a spilled or device copy must not resurrect
        it)."""
        dropped = self.dram.remove(key)
        if self.spill is not None and self.spill.remove(key):
            dropped = True
        if self.hbm is not None and self.hbm.remove(key):
            dropped = True
        self._heat.pop(key, None)
        return dropped

    def take_pending_evicted(self) -> List[int]:
        out = self.pending_evicted
        self.pending_evicted = []
        return out


class _StripeLockSet:
    """``cache.lock`` for a striped cache: acquiring it takes every
    stripe lock in ascending index order — the single global order all
    whole-cache operations use, so two whole-cache ops can never
    deadlock against each other — and holding it excludes all per-key
    traffic on every stripe."""

    def __init__(self, locks: List[threading.Lock]):
        self._locks = locks

    def acquire(self) -> None:
        for lk in self._locks:
            lk.acquire()

    def release(self) -> None:
        for lk in reversed(self._locks):
            lk.release()

    def __enter__(self) -> "_StripeLockSet":
        self.acquire()
        return self

    def __exit__(self, *exc) -> None:
        self.release()


class _StripedFormView:
    """Read-mostly aggregate over one form's per-stripe partitions —
    what ``cache.parts[form]`` returns when ``n_stripes > 1``, so
    telemetry/diagnostic readers (shard ``_op_stats``, tests, notebook
    pokes) keep working against the striped layout.

    Point reads route by key hash; ledger/stat properties merge the
    stripe-local counters on read (unlocked, like the single-stripe
    counter reads they replace).  Callers that need a cross-stripe
    consistent view must hold ``cache.lock`` (all stripes)."""

    def __init__(self, form: str,
                 stripes: List[Dict[str, CachePartition]]):
        self.form = form
        self._parts = [s[form] for s in stripes]

    def _of(self, key: int) -> CachePartition:
        return self._parts[int(key) % len(self._parts)]

    # -- point reads (route to the owning stripe) ----------------------
    def __contains__(self, key: int) -> bool:
        return key in self._of(key)

    def peek(self, key: int, default: Any = None) -> Any:
        return self._of(key).peek(key, default)

    def tier_of(self, key: int) -> Optional[str]:
        return self._of(key).tier_of(key)

    # -- merged ledgers / stats ----------------------------------------
    def __len__(self) -> int:
        return sum(len(p) for p in self._parts)

    def keys(self) -> List[int]:
        ks: List[int] = []
        for p in self._parts:
            ks += p.keys()
        return ks

    @property
    def capacity(self) -> int:
        return sum(p.capacity for p in self._parts)

    @property
    def total_capacity(self) -> int:
        return sum(p.total_capacity for p in self._parts)

    @property
    def free_bytes(self) -> int:
        return sum(p.free_bytes for p in self._parts)

    @property
    def policy(self) -> str:
        return self._parts[0].policy

    @property
    def stats(self) -> PartitionStats:
        return PartitionStats.merged([p.stats for p in self._parts])

    @property
    def total_hits(self) -> int:
        return sum(p.total_hits for p in self._parts)

    @property
    def total_misses(self) -> int:
        return sum(p.total_misses for p in self._parts)

    @property
    def promotions(self) -> int:
        return sum(p.promotions for p in self._parts)

    @property
    def demotions(self) -> int:
        return sum(p.demotions for p in self._parts)

    @property
    def hbm_promotions(self) -> int:
        return sum(p.hbm_promotions for p in self._parts)

    @property
    def hbm_demotions(self) -> int:
        return sum(p.hbm_demotions for p in self._parts)

    @property
    def pending_evicted(self) -> List[int]:
        out: List[int] = []
        for p in self._parts:
            out.extend(p.pending_evicted)
        return out

    @property
    def _data(self) -> Dict[int, Any]:
        out: Dict[int, Any] = {}
        for p in self._parts:
            out.update(p._data)
        return out

    @property
    def _sizes(self) -> Dict[int, int]:
        out: Dict[int, int] = {}
        for p in self._parts:
            out.update(p._sizes)
        return out


class TieredCache:
    """The Seneca cache: three partitions sized by an MDP split, each an
    optional HBM→DRAM→disk tier chain sized by the form×tier MDP, with
    the key space optionally hash-striped over ``n_stripes``
    independent lock domains (module doc)."""

    def __init__(self, capacity_bytes: int,
                 split: Tuple[float, float, float],
                 evict_policies: Optional[Dict[str, str]] = None,
                 spill_bytes: int = 0,
                 spill_dir: Optional[str] = None,
                 spill_split: Optional[Tuple[float, float, float]] = None,
                 hbm_bytes: int = 0,
                 hbm_split: Optional[Tuple[float, float, float]] = None,
                 n_stripes: int = 1, device=None):
        x_e, x_d, x_a = split
        assert abs(x_e + x_d + x_a - 1.0) < 1e-6, split
        pol = evict_policies or {"encoded": "none", "decoded": "none",
                                 "augmented": "refcount"}
        self.capacity = capacity_bytes
        self.split = split
        self.n_stripes = max(1, int(n_stripes))
        self.spill_bytes = int(spill_bytes) if spill_dir else 0
        self.spill_dir = spill_dir if self.spill_bytes > 0 else None
        if self.spill_dir is not None:
            self.spill_split = tuple(spill_split) if spill_split \
                else tuple(split)
            y_e, y_d, y_a = self.spill_split
            assert abs(y_e + y_d + y_a - 1.0) < 1e-6, self.spill_split
        else:
            self.spill_split = None
        self.hbm_bytes = int(hbm_bytes)
        # the HBM tier's device (None -> CUDA), resolved by HbmTier
        self.device = device
        if self.hbm_bytes > 0:
            self.hbm_split = tuple(hbm_split) if hbm_split \
                else tuple(split)
            z_e, z_d, z_a = self.hbm_split
            assert abs(z_e + z_d + z_a - 1.0) < 1e-6, self.hbm_split
        else:
            self.hbm_split = None
        self._stripes: List[Dict[str, CachePartition]] = [
            self._build_stripe(i, pol) for i in range(self.n_stripes)]
        self._locks: List[threading.Lock] = [
            threading.Lock() for _ in range(self.n_stripes)]
        if self.n_stripes == 1:
            # exact legacy surface: `parts` IS the partition dict and
            # `lock` IS the one hot-path lock, so every existing direct
            # poke (tests, notebooks) behaves byte-identically
            self.parts: Dict[str, CachePartition] = self._stripes[0]
            self.lock = self._locks[0]
        else:
            self.parts = {form: _StripedFormView(form, self._stripes)
                          for form in FORMS}
            self.lock = _StripeLockSet(self._locks)
        self._closed = False
        # stripe-local ledgers aggregated on read (the `lookup_misses`
        # / `version` properties) so the hot path never shares a
        # counter cache line across stripes.
        # misses counted at lookup granularity: a key absent from every
        # partition is ONE miss, not zero and not three
        self._lookup_misses: List[int] = [0] * self.n_stripes
        # bumped on every mutation that can change residency (insert,
        # evict, resize, disk-hit promotion) so the service can skip
        # rebuilding the O(N) residency array when nothing moved
        self._versions: List[int] = [0] * self.n_stripes

    # -- striped construction ------------------------------------------
    def _stripe_share(self, total: int, i: int) -> int:
        """Stripe ``i``'s byte share of ``total`` (remainder to stripe
        0; with one stripe this is ``total`` exactly)."""
        base, rem = divmod(int(total), self.n_stripes)
        return base + (rem if i == 0 else 0)

    def _stripe_spill_root(self, i: int) -> Optional[str]:
        """Stripe 0 spills into ``spill_dir`` itself (the legacy
        layout); stripe ``i>0`` into ``spill_dir/s<i>``."""
        if self.spill_dir is None:
            return None
        return self.spill_dir if i == 0 \
            else os.path.join(self.spill_dir, f"s{i}")

    def _build_stripe(self, i: int,
                      pol: Dict[str, str]) -> Dict[str, CachePartition]:
        if self.spill_dir is not None:
            spill_cap = self._stripe_share(self.spill_bytes, i)
            root = self._stripe_spill_root(i)
            spills = {form: DiskTier(int(y * spill_cap), root, form)
                      for form, y in zip(FORMS, self.spill_split)}
        else:
            spills = {form: None for form in FORMS}
        if self.hbm_bytes > 0:
            hbm_cap = self._stripe_share(self.hbm_bytes, i)
            # LRU on device: HBM is small and hot — coldest array falls
            # back to DRAM rather than blocking new promotions
            hbms = {form: HbmTier(int(z * hbm_cap), "lru", self.device)
                    for form, z in zip(FORMS, self.hbm_split)}
        else:
            hbms = {form: None for form in FORMS}
        cap = self._stripe_share(self.capacity, i)
        return {form: CachePartition(int(x * cap), pol[form],
                                     spills[form], hbms[form])
                for form, x in zip(FORMS, self.split)}

    def _stripe_of(self, key: int) -> int:
        return int(key) % self.n_stripes

    def _group_by_stripe(self, keys) -> List[Tuple[int, List[int]]]:
        """Bucket positions of ``keys`` by owning stripe, ascending
        stripe order (one bucket — original iteration order — when
        unstriped), so batch ops lock each stripe exactly once."""
        if self.n_stripes == 1:
            return [(0, list(range(len(keys))))]
        by: Dict[int, List[int]] = {}
        for i, k in enumerate(keys):
            by.setdefault(int(k) % self.n_stripes, []).append(i)
        return sorted(by.items())

    # ------------------------------------------------------------------
    @property
    def has_spill(self) -> bool:
        return self.spill_dir is not None

    @property
    def has_hbm(self) -> bool:
        return self.hbm_bytes > 0

    @property
    def lookup_misses(self) -> int:
        return sum(self._lookup_misses)

    @property
    def version(self) -> int:
        return sum(self._versions)

    def _flush_spill(self, stripe: Optional[int] = None) -> None:
        """Drain staged write-behind spill payloads, releasing the
        stripe's lock around each file write
        (:meth:`DiskTier.flush_staged`).  Called *after* the lock is
        dropped by every mutating public method, so op boundaries
        observe index == files-on-disk.  Per-key ops pass their stripe;
        whole-cache ops drain every stripe."""
        if not self.has_spill:
            return
        stripes = range(self.n_stripes) if stripe is None else (stripe,)
        for s in stripes:
            lock = self._locks[s]
            for part in self._stripes[s].values():
                part.spill.flush_staged(lock)

    def lookup(self, key: int) -> Tuple[Optional[str], Any]:
        """Most-processed form first (augmented > decoded > encoded)."""
        form, value, _tier = self.lookup_tiered(key)
        return form, value

    def lookup_tiered(self, key: int
                      ) -> Tuple[Optional[str], Any, Optional[str]]:
        """Like :meth:`lookup` but also names the tier that answered
        ("hbm" | "dram" | "disk" | None) so telemetry can track
        per-tier serve bandwidths."""
        s = self._stripe_of(key)
        try:
            with self._locks[s]:
                parts = self._stripes[s]
                for form in ("augmented", "decoded", "encoded"):
                    part = parts[form]
                    if key in part:
                        promos = part.promotions + part.hbm_promotions
                        value, tier = part.get_tiered(key, MISS)
                        if value is not MISS:
                            # only an actual promotion changes residency;
                            # a disk hit that stays on disk must not
                            # defeat the version-gated residency rebuild
                            if (part.promotions
                                    + part.hbm_promotions != promos):
                                self._versions[s] += 1
                            return form, value, tier
                self._lookup_misses[s] += 1
                return None, None, None
        finally:
            # promotions can cascade demotions into the spill stage
            self._flush_spill(s)

    def insert(self, key: int, form: str, value: Any, nbytes: int) -> bool:
        """Insert; True when the key is resident afterwards."""
        s = self._stripe_of(key)
        with self._locks[s]:
            self._versions[s] += 1
            part = self._stripes[s][form]
            part.put(key, value, nbytes)
            resident = key in part
        self._flush_spill(s)
        return resident

    def insert_gated(self, key: int, form: str, value: Any, nbytes: int,
                     policy) -> bool:
        """Insert with the admission policy's capacity vote evaluated under
        the stripe lock, atomically with the put — concurrent workers cannot
        both pass a stale free-bytes check."""
        s = self._stripe_of(key)
        with self._locks[s]:
            part = self._stripes[s][form]
            if not policy.fits(part, nbytes):
                return False
            self._versions[s] += 1
            part.put(key, value, nbytes)
            resident = key in part
        self._flush_spill(s)
        return resident

    def insert_batch_gated(self, form: str, entries, policy) -> List[bool]:
        """Batch-granular admission: ``entries`` is a sequence of
        ``(key, value, nbytes)``; the capacity vote + insert for each
        stripe's slice of the batch runs under ONE acquisition of that
        stripe's lock (the stage-parallel pipeline's per-batch admission
        — vs one acquisition per sample).

        Per-entry semantics are identical to :meth:`insert_gated`: each
        entry is voted with the partition state the previous entries
        left behind — a rejected entry does NOT reject the rest, so a
        later, smaller entry may still fit (same results as N looped
        ``insert_gated`` calls).  Returns one bool per entry.
        """
        entries = list(entries)
        out: List[bool] = [False] * len(entries)
        for s, idxs in self._group_by_stripe([e[0] for e in entries]):
            with self._locks[s]:
                part = self._stripes[s][form]
                for i in idxs:
                    key, value, nbytes = entries[i]
                    if not policy.fits(part, nbytes):
                        continue
                    self._versions[s] += 1
                    part.put(key, value, nbytes)
                    out[i] = key in part
            self._flush_spill(s)
        return out

    def evict(self, key: int, form: str) -> bool:
        s = self._stripe_of(key)
        with self._locks[s]:
            self._versions[s] += 1
            return self._stripes[s][form].remove(key)

    def peek(self, key: int) -> Tuple[Optional[str], Any]:
        """Stats-neutral lookup (same tier order), for controller/refill
        scans — ``lookup`` would inflate miss counts.  Loads spilled
        payloads from disk; callers that only need the *form* should use
        :meth:`form_of` (containment-only, no IO under the lock)."""
        s = self._stripe_of(key)
        with self._locks[s]:
            for form in ("augmented", "decoded", "encoded"):
                part = self._stripes[s][form]
                if key in part:
                    return form, part.peek(key)
            return None, None

    def form_of(self, key: int) -> Optional[str]:
        """The form a lookup would serve (most-processed resident), by
        containment only — no payload read, no stats, no promotion."""
        s = self._stripe_of(key)
        with self._locks[s]:
            for form in ("augmented", "decoded", "encoded"):
                if key in self._stripes[s][form]:
                    return form
            return None

    # -- containment / capacity queries --------------------------------
    # The service layer's window onto the cache.  These (not `parts` /
    # `lock` pokes) are the contract a drop-in cache implementation —
    # e.g. the sharded service client — must satisfy.

    def contains(self, form: str, key: int) -> bool:
        """Is ``key`` resident (any tier) in ``form``'s partition?"""
        s = self._stripe_of(key)
        with self._locks[s]:
            return key in self._stripes[s][form]

    def contains_many(self, form: str, keys) -> List[bool]:
        """Batch :meth:`contains`, one lock acquisition per touched
        stripe."""
        keys = list(keys)
        out: List[bool] = [False] * len(keys)
        for s, idxs in self._group_by_stripe(keys):
            with self._locks[s]:
                part = self._stripes[s][form]
                for i in idxs:
                    out[i] = keys[i] in part
        return out

    def serving_forms(self, keys) -> List[Optional[str]]:
        """Batch :meth:`form_of`, one lock acquisition per touched
        stripe: per key, the most-processed resident form (or None)."""
        keys = list(keys)
        out: List[Optional[str]] = [None] * len(keys)
        for s, idxs in self._group_by_stripe(keys):
            with self._locks[s]:
                parts = self._stripes[s]
                for i in idxs:
                    for form in ("augmented", "decoded", "encoded"):
                        if keys[i] in parts[form]:
                            out[i] = form
                            break
        return out

    def total_capacity(self, form: str) -> int:
        """DRAM + spill capacity of ``form``'s tier chain (bytes)."""
        return sum(s[form].total_capacity for s in self._stripes)

    def chain_free_bytes(self, form: str) -> int:
        """Free bytes across ``form``'s whole tier chain."""
        free = 0
        for s in range(self.n_stripes):
            with self._locks[s]:
                part = self._stripes[s][form]
                free += part.free_bytes
                if part.spill is not None:
                    free += part.spill.free_bytes
                if part.hbm is not None:
                    free += part.hbm.free_bytes
        return free

    def set_form_costs(self, costs: Dict[str, float]) -> None:
        """Push telemetry-measured recompute costs (seconds per entry)
        into each form's "cost"-policy DRAM tier; no-op for other
        policies (the GDSF eviction satellite's feedback path)."""
        with self.lock:
            for form, cost in costs.items():
                for stripe in self._stripes:
                    dram = stripe[form].dram
                    if dram.policy == "cost" and cost and cost > 0:
                        dram.set_cost(float(cost))

    def take_evicted(self) -> List[int]:
        """Drain the keys the chains evicted as a side effect (spill
        overflow, promotion backfill) since the last drain — the service
        patches ODS metadata with them (reconcile_evictions)."""
        with self.lock:
            out: List[int] = []
            for stripe in self._stripes:
                for part in stripe.values():
                    out.extend(part.take_pending_evicted())
            return out

    def has_pending_evicted(self) -> bool:
        with self.lock:
            return any(part.pending_evicted
                       for stripe in self._stripes
                       for part in stripe.values())

    def resize(self, split: Tuple[float, float, float],
               spill_split: Optional[Tuple[float, float, float]] = None,
               hbm_split: Optional[Tuple[float, float, float]] = None
               ) -> Dict[str, List[int]]:
        """Re-partition the same total capacity live, under every
        stripe lock (ascending order — a whole-cache op).

        Shrinking partitions evict (policy order) down to their new
        capacity; growing ones just gain headroom.  Shrinks are applied
        before grows so the instantaneous sum of partition capacities
        never exceeds the total.  With a spill tier, DRAM shrink
        evictions demote to disk, and ``spill_split`` (defaulting to
        ``split``) resizes the disk level the same way — disk grows
        first so demotion traffic lands in the enlarged tiers, disk
        shrinks last.  With a device tier, ``hbm_split`` resizes the
        HBM level: HBM shrinks before the DRAM pass (demotions land in
        the still-sized DRAM/disk tiers) and grows after it.  Returns
        ``{form: [keys evicted out of the chain]}`` so the caller can
        demote/patch ODS metadata.
        """
        x_e, x_d, x_a = split
        if abs(x_e + x_d + x_a - 1.0) >= 1e-6:
            raise ValueError(f"split must sum to 1: {split}")
        evicted: Dict[str, List[int]] = {}

        def add(form: str, keys: List[int]) -> None:
            if keys:
                evicted.setdefault(form, []).extend(keys)

        with self.lock:
            ys = zs = None
            if self.has_spill:
                ys = tuple(spill_split) if spill_split is not None \
                    else (float(x_e), float(x_d), float(x_a))
                if abs(sum(ys) - 1.0) >= 1e-6:
                    raise ValueError(
                        f"spill_split must sum to 1: {ys}")
            if self.has_hbm:
                zs = tuple(hbm_split) if hbm_split is not None \
                    else (float(x_e), float(x_d), float(x_a))
                if abs(sum(zs) - 1.0) >= 1e-6:
                    raise ValueError(
                        f"hbm_split must sum to 1: {zs}")
            for s, parts in enumerate(self._stripes):
                cap = self._stripe_share(self.capacity, s)
                targets = {form: int(x * cap)
                           for form, x in zip(FORMS, (x_e, x_d, x_a))}
                disk_targets = None
                if ys is not None:
                    spill_cap = self._stripe_share(self.spill_bytes, s)
                    disk_targets = {f: int(y * spill_cap)
                                    for f, y in zip(FORMS, ys)}
                    # disk grows first: DRAM-shrink demotions flow into
                    # the enlarged spill tiers instead of being dropped
                    for form in FORMS:
                        part = parts[form]
                        if disk_targets[form] >= part.spill.capacity:
                            add(form, part.set_spill_capacity(
                                disk_targets[form]))
                hbm_targets = None
                if zs is not None:
                    hbm_cap = self._stripe_share(self.hbm_bytes, s)
                    hbm_targets = {f: int(z * hbm_cap)
                                   for f, z in zip(FORMS, zs)}
                    # HBM shrinks before the DRAM pass so device
                    # demotions land in tiers with their old headroom
                    for form in FORMS:
                        part = parts[form]
                        if hbm_targets[form] < part.hbm.capacity:
                            add(form, part.set_hbm_capacity(
                                hbm_targets[form]))
                order = sorted(
                    FORMS, key=lambda f: targets[f] - parts[f].capacity)
                for form in order:        # shrinks first, then grows
                    add(form, parts[form].set_capacity(targets[form]))
                if hbm_targets is not None:  # HBM grows after DRAM pass
                    for form in FORMS:
                        part = parts[form]
                        if hbm_targets[form] >= part.hbm.capacity:
                            add(form, part.set_hbm_capacity(
                                hbm_targets[form]))
                if disk_targets is not None:  # disk shrinks last
                    for form in FORMS:
                        part = parts[form]
                        if disk_targets[form] < part.spill.capacity:
                            add(form, part.set_spill_capacity(
                                disk_targets[form]))
            if ys is not None:
                self.spill_split = tuple(float(y) for y in ys)
            if zs is not None:
                self.hbm_split = tuple(float(z) for z in zs)
            self.split = (float(x_e), float(x_d), float(x_a))
            self._versions[0] += 1
        self._flush_spill()
        return evicted

    def status_array(self, n: int) -> np.ndarray:
        """uint8[N] of ODS status codes (0 storage / 1 enc / 2 dec / 3
        aug); disk-resident entries keep their form's code — residency
        *level* is :meth:`residency_array`'s job.

        Key lists are snapshotted under each stripe lock; the O(N)
        scatter runs with the locks released, so this scan no longer
        stalls concurrent serving threads."""
        snaps: List[Tuple[int, List[int]]] = []
        for s in range(self.n_stripes):
            with self._locks[s]:
                parts = self._stripes[s]
                for code, form in ((1, "encoded"), (2, "decoded"),
                                   (3, "augmented")):
                    ks = parts[form].keys()
                    if ks:
                        snaps.append((code, ks))
        out = np.zeros(n, np.uint8)
        for code, ks in snaps:
            out[np.asarray(ks, int)] = code
        return out

    def residency_array(self, n: int) -> np.ndarray:
        """uint8[N] residency levels: 0 = storage only, 1 = disk,
        2 = DRAM, 3 = HBM — of the form a lookup would actually serve
        (the most-processed resident form), not the best tier over all
        forms: a sample whose augmented copy spilled to disk serves at
        disk latency even if its encoded copy sits in DRAM.  Feeds the
        ODS substitution preference (device hits beat DRAM hits beat
        disk hits beat storage misses).

        Like :meth:`status_array`, snapshots key lists under the stripe
        locks and builds the array outside them (keys live on exactly
        one stripe, so the out-of-lock scatter cannot interleave two
        stripes' claims to one slot)."""
        snaps: List[Tuple[int, List[int]]] = []
        for s in range(self.n_stripes):
            with self._locks[s]:
                # lowest serving priority first; higher-priority forms
                # overwrite, so each sample ends at its serving form's
                # tier (within a form the tiers are disjoint)
                for form in ("encoded", "decoded", "augmented"):
                    part = self._stripes[s][form]
                    if part.spill is not None:
                        ks = part.spill.keys()
                        if ks:
                            snaps.append((RESIDENCY_DISK, ks))
                    ks = part.dram.keys()
                    if ks:
                        snaps.append((RESIDENCY_DRAM, ks))
                    if part.hbm is not None:
                        ks = part.hbm.keys()
                        if ks:
                            snaps.append((RESIDENCY_HBM, ks))
        out = np.zeros(n, np.uint8)
        for level, ks in snaps:
            out[np.asarray(ks, int)] = level
        return out

    # -- unlocked aggregate reads --------------------------------------
    def _all_parts(self):
        for stripe in self._stripes:
            for part in stripe.values():
                yield part

    def hit_rate(self) -> float:
        h = sum(p.total_hits for p in self._all_parts())
        m = sum(p.total_misses
                for p in self._all_parts()) + self.lookup_misses
        return h / (h + m) if h + m else 0.0

    def bytes_used(self) -> int:
        return sum(p.stats.bytes_used for p in self._all_parts())

    def disk_bytes_used(self) -> int:
        return sum(p.spill.stats.bytes_used for p in self._all_parts()
                   if p.spill is not None)

    def hbm_bytes_used(self) -> int:
        return sum(p.hbm.stats.bytes_used for p in self._all_parts()
                   if p.hbm is not None)

    def hbm_stats(self) -> Dict[str, Dict[str, int]]:
        """Per-form device-tier traffic, summed over stripes
        (JSON-friendly; empty without an HBM tier)."""
        if not self.has_hbm:
            return {}
        agg = {form: {"hbm_bytes_used": 0, "hbm_capacity": 0,
                      "hbm_entries": 0, "hbm_hits": 0,
                      "hbm_promotions": 0, "hbm_demotions": 0}
               for form in FORMS}
        for s in range(self.n_stripes):
            with self._locks[s]:
                for form, part in self._stripes[s].items():
                    d = agg[form]
                    d["hbm_bytes_used"] += part.hbm.stats.bytes_used
                    d["hbm_capacity"] += part.hbm.capacity
                    d["hbm_entries"] += len(part.hbm)
                    d["hbm_hits"] += part.hbm.stats.hits
                    d["hbm_promotions"] += part.hbm_promotions
                    d["hbm_demotions"] += part.hbm_demotions
        return agg

    def spill_stats(self) -> Dict[str, Dict[str, int]]:
        """Per-form chain traffic, summed over stripes (JSON-friendly;
        empty without spill)."""
        if not self.has_spill:
            return {}
        agg = {form: {"disk_bytes_used": 0, "disk_capacity": 0,
                      "disk_entries": 0, "disk_hits": 0,
                      "demotions": 0, "promotions": 0, "io_errors": 0}
               for form in FORMS}
        for s in range(self.n_stripes):
            with self._locks[s]:
                for form, part in self._stripes[s].items():
                    d = agg[form]
                    d["disk_bytes_used"] += part.spill.stats.bytes_used
                    d["disk_capacity"] += part.spill.capacity
                    d["disk_entries"] += len(part.spill)
                    d["disk_hits"] += part.spill.stats.hits
                    d["demotions"] += part.demotions
                    d["promotions"] += part.promotions
                    d["io_errors"] += part.spill.io_errors
        return agg

    def close(self) -> None:
        """Tear down the spill area: every entry file is unlinked, the
        per-form directories removed, and (striped) the per-stripe
        subroots removed (the no-leaked-files contract asserted by the
        tiered-cache benchmark and CI).

        Idempotent and exception-safe: shard teardown reaches here from
        several paths (transport close, failed server construction,
        ``with`` exits), so a second call is a no-op and an OSError
        from one form's cleanup doesn't abort the others."""
        with self.lock:
            if self._closed:
                return
            failed = False
            for part in self._all_parts():
                if part.spill is not None:
                    try:
                        part.spill.clear()
                    except OSError:
                        part.spill.io_errors += 1
                        failed = True
            if not failed and self.has_spill and self.n_stripes > 1:
                for s in range(1, self.n_stripes):
                    try:
                        os.rmdir(self._stripe_spill_root(s))
                    except OSError:
                        failed = True
            # only latch closed once every spill dir actually emptied,
            # so a transient IO failure can be retried by a later close
            self._closed = not failed
