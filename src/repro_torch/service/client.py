"""The sharded data plane's client: a drop-in ``TieredCache``.

:class:`ShardedCache` implements the full cache surface
``api/server.py`` consumes (lookup/insert/evict/resize/residency/stats)
by routing every key through a
:class:`~repro_torch.service.router.ShardRouter` to one of N
:class:`~repro_torch.service.shard.CacheShard` instances behind a
transport.  ``SenecaService`` therefore works unchanged over 1 process
or N — ``Session`` / ``DSIPipeline`` / ``WorkloadRunner`` cannot tell
the difference.

Cross-shard bookkeeping lives here:

* **evictions** — every shard response piggybacks the keys its tier
  chains dropped; the client accumulates them so ``take_evicted`` /
  ``has_pending_evicted`` behave exactly like the local cache's.
* **version** — the composite residency version is the sum of the
  latest per-shard versions (each shard's counter is monotone, shards
  are disjoint, so the sum is monotone and changes iff some shard's
  residency may have).
* **residency/status gathers** — each shard reports its full array
  (nonzero only on the keys it owns) and the client merges them with
  :func:`repro_torch.core.ods.merge_residency`.

Device values: over the sim transport they pass through untouched, so a
CUDA row admitted into a shard's HBM tier is stored without a copy and
``lookup_tiered`` gives back that same tensor.  Over the process
transport every payload crosses as a :class:`~repro_torch.cache.codecs.
PayloadRef` file (a tensor brought down with ``.cpu().numpy()`` first),
never as a pickled tensor; what comes back is a read-only host memmap,
still labelled with the shard-side tier.
"""
from __future__ import annotations

import itertools
import os
import shutil
import tempfile
import threading
from concurrent.futures import ThreadPoolExecutor
from typing import Any, Dict, List, Optional, Tuple

import numpy as np

from repro_torch.cache.codecs import (PayloadRef, receive_payload,
                                      ship_payload)
from repro_torch.cache.store import FORMS, _host
from repro_torch.core.ods import merge_residency
from repro_torch.faults.liveness import LivenessRegistry
from repro_torch.service import proto
from repro_torch.service.router import ShardRouter
from repro_torch.service.shard import ShardConfig
from repro_torch.service.transport import ShardDownError, make_transport


class ShardedCache:
    """N-shard cache behind the ``TieredCache`` surface.

    Capacity (and any spill budget) divides evenly across shards; each
    shard either reuses the pinned ``split`` or — with
    ``solve_per_shard`` and the profiles provided — runs its own
    form×tier MDP solve over its 1/N view
    (:func:`repro_torch.core.mdp.optimize_shard`).  ``device`` is where
    every shard's HBM tier lives (``None`` -> CUDA, raising where it is
    missing), in the shard's own process over the process transport.
    """

    def __init__(self, capacity_bytes: int,
                 split: Optional[Tuple[float, float, float]],
                 evict_policies: Optional[Dict[str, str]] = None,
                 spill_bytes: int = 0,
                 spill_dir: Optional[str] = None,
                 spill_split: Optional[Tuple[float, float, float]] = None,
                 hbm_bytes: int = 0,
                 hbm_split: Optional[Tuple[float, float, float]] = None,
                 *,
                 shards: int = 1,
                 transport: str = "sim",
                 vnodes: int = 64,
                 seed: int = 0,
                 admission: Any = None,
                 hardware: Any = None,
                 dataset_profile: Any = None,
                 job: Any = None,
                 partition_step: float = 0.01,
                 solve_per_shard: bool = False,
                 dataset: Any = None,
                 storage_bandwidth: Optional[float] = None,
                 start_method: str = "spawn",
                 device=None):
        n = int(shards)
        if n < 1:
            raise ValueError(f"shards must be >= 1, got {shards}")
        self.capacity = int(capacity_bytes)
        self.n_shards = n
        self.transport_name = transport
        self.router = ShardRouter(n, vnodes=vnodes, seed=seed)
        self._lock = threading.Lock()
        self._pending: List[int] = []
        self._shard_versions = [0] * n
        self._seq = itertools.count()
        self._closed = False
        #: shard liveness: a shard explicitly marked dead (fault
        #: injection, broken transport) has its key range failed over to
        #: storage until restart_shard brings it back
        self.liveness = LivenessRegistry()
        self.failovers = 0           # per-op fallbacks taken on dead shards
        self._generation = 0         # bumps on kill/restart: residency epoch
        solve_per_shard = (solve_per_shard and hardware is not None
                           and dataset_profile is not None)
        if split is None and not solve_per_shard:
            raise ValueError("need a split or profiles to solve one")

        per_cap = self.capacity // n
        per_spill = int(spill_bytes) // n if spill_dir else 0
        has_spill = spill_dir is not None and per_spill > 0
        self.spill_bytes = per_spill * n if has_spill else 0
        self.spill_dir = spill_dir if has_spill else None
        per_hbm = int(hbm_bytes) // n
        self.hbm_bytes = per_hbm * n
        self._xchg = (tempfile.mkdtemp(prefix="seneca-xchg-")
                      if transport == "process" else None)
        configs = [ShardConfig(
            shard_id=i, n_shards=n, cache_bytes=per_cap,
            split=None if solve_per_shard else tuple(split),
            evict_policies=(dict(evict_policies)
                            if evict_policies else None),
            admission=admission,
            spill_dir=(os.path.join(spill_dir, f"shard-{i}")
                       if has_spill else None),
            spill_bytes=per_spill if has_spill else 0,
            spill_split=(tuple(spill_split) if spill_split is not None
                         else None),
            hbm_bytes=per_hbm,
            hbm_split=(tuple(hbm_split) if hbm_split is not None
                       else None),
            hardware=hardware, dataset_profile=dataset_profile, job=job,
            partition_step=partition_step,
            dataset=dataset,
            storage_bandwidth=(storage_bandwidth / n
                               if storage_bandwidth else None),
            seed=seed + 7919 * i,
            exchange_dir=self._xchg,
            device=None if device is None else str(device),
        ) for i in range(n)]
        kwargs = {"start_method": start_method} \
            if transport == "process" else {}
        try:
            self.transport = make_transport(transport, configs, **kwargs)
            hello = [self._call(i, proto.OP_PING) for i in range(n)]
        except BaseException:
            self._cleanup_dirs()
            raise
        self._caps = {form: sum(h["caps"][form] for h in hello)
                      for form in FORMS}
        self.split = tuple(hello[0]["split"])
        self.spill_split = (tuple(spill_split)
                            if spill_split is not None else None)
        self.hbm_split = (tuple(hbm_split)
                          if hbm_split is not None else None)
        #: per-shard MDP labels (None entries when the split was pinned)
        self.shard_partitions = [h["partition"] for h in hello]

    # -- plumbing -------------------------------------------------------
    def _call(self, shard_id: int, op: str, *args) -> Any:
        resp = self.transport.call(shard_id, proto.Request(op, args))
        self.liveness.beat(shard_id)
        with self._lock:
            self._shard_versions[shard_id] = max(
                self._shard_versions[shard_id], resp.version)
            if resp.evicted:
                self._pending.extend(resp.evicted)
        if not resp.ok:
            raise RuntimeError(
                f"shard {shard_id} {op} failed: {resp.error}")
        return resp.value

    def _call_failover(self, shard_id: int, op: str, fallback: Any,
                       *args) -> Any:
        """Per-op degradation: a dead shard's ops return ``fallback``
        (miss / drop / zeros) instead of raising — its key range is
        effectively served by storage until the shard restarts."""
        if self.liveness.is_dead(shard_id):
            with self._lock:
                self.failovers += 1
            return fallback
        try:
            return self._call(shard_id, op, *args)
        except ShardDownError:
            self.mark_shard_down(shard_id)
            with self._lock:
                self.failovers += 1
            return fallback

    # -- shard lifecycle ------------------------------------------------
    def mark_shard_down(self, shard_id: int) -> None:
        """Record a shard as dead (detected broken transport or told by
        fault injection); bumps the residency generation so the sampler
        layer rebuilds its view of what is cached."""
        self.liveness.mark_dead(shard_id)
        with self._lock:
            self._generation += 1

    def kill_shard(self, shard_id: int) -> None:
        """Kill a shard outright (fault injection): tear down its
        process/object through the transport, then fail its range over."""
        kill = getattr(self.transport, "kill", None)
        if kill is not None:
            kill(shard_id)
        self.mark_shard_down(shard_id)

    def restart_shard(self, shard_id: int) -> None:
        """Cold-restart a dead shard and re-expand the ring onto it.
        The new shard's version counter starts over, so the old high
        count is dropped (not max-merged) or its early inserts would be
        invisible to the version-gated residency rebuild."""
        restart = getattr(self.transport, "restart", None)
        if restart is None:
            raise RuntimeError(
                f"transport {self.transport_name!r} cannot restart shards")
        restart(shard_id)
        with self._lock:
            self._shard_versions[shard_id] = 0
            self._generation += 1
        self.liveness.mark_alive(shard_id)

    def _shard_of(self, key: int) -> int:
        return self.router.shard_of(int(key))

    def _ship(self, form: str, value: Any) -> Any:
        """Outbound payload: file + ref over the process transport,
        pass-through over sim."""
        if not getattr(self.transport, "wants_refs", False) \
                or value is None:
            return value
        if not isinstance(value, (bytes, np.ndarray)):
            # device tensors (CUDA memory, which np.asarray cannot read)
            # cross processes as host copies; the receiving shard
            # uploads again on admission into its own HBM tier
            value = _host(value)
        path = os.path.join(
            self._xchg, f"c{os.getpid()}-{next(self._seq)}.bin")
        return ship_payload(form, value, path)

    @staticmethod
    def _recv(value: Any) -> Any:
        return (receive_payload(value)
                if isinstance(value, PayloadRef) else value)

    # -- the TieredCache surface ---------------------------------------
    @property
    def version(self) -> int:
        # the generation term makes kill/restart bump the composite even
        # though a cold shard's own counter restarts at zero
        with self._lock:
            return (sum(self._shard_versions)
                    + (1 << 32) * self._generation)

    @property
    def has_spill(self) -> bool:
        return self.spill_dir is not None

    @property
    def has_hbm(self) -> bool:
        return self.hbm_bytes > 0

    def lookup(self, key: int) -> Tuple[Optional[str], Any]:
        form, value, _tier = self.lookup_tiered(key)
        return form, value

    def lookup_tiered(self, key: int
                      ) -> Tuple[Optional[str], Any, Optional[str]]:
        form, value, tier = self._call_failover(
            self._shard_of(key), proto.OP_LOOKUP, (None, None, None),
            int(key))
        return form, self._recv(value), tier

    def insert(self, key: int, form: str, value: Any,
               nbytes: int) -> bool:
        return self._call_failover(
            self._shard_of(key), proto.OP_INSERT, False,
            int(key), form, self._ship(form, value), int(nbytes), False)

    def insert_gated(self, key: int, form: str, value: Any, nbytes: int,
                     policy=None) -> bool:
        """The capacity vote runs shard-side with the shard's configured
        admission policy (``policy`` is accepted for signature parity
        but the shard's instance decides — it is the one that can be
        atomic with the put)."""
        return self._call_failover(
            self._shard_of(key), proto.OP_INSERT, False,
            int(key), form, self._ship(form, value), int(nbytes), True)

    def insert_batch_gated(self, form: str, entries,
                           policy=None) -> List[bool]:
        entries = list(entries)
        out = [False] * len(entries)
        if not entries:
            return out
        groups = self.router.group([int(k) for k, _v, _nb in entries])
        for sid in sorted(groups):
            idxs = groups[sid]
            payload = [(int(entries[i][0]),
                        self._ship(form, entries[i][1]),
                        int(entries[i][2])) for i in idxs]
            res = self._call_failover(sid, proto.OP_INSERT_BATCH,
                                      [False] * len(idxs), form, payload)
            for i, ok in zip(idxs, res):
                out[int(i)] = bool(ok)
        return out

    def evict(self, key: int, form: str) -> bool:
        return self._call_failover(self._shard_of(key), proto.OP_EVICT,
                                   False, int(key), form)

    def form_of(self, key: int) -> Optional[str]:
        return self._call_failover(self._shard_of(key), proto.OP_FORM_OF,
                                   None, int(key))

    def contains(self, form: str, key: int) -> bool:
        return self.contains_many(form, [key])[0]

    def contains_many(self, form: str, keys) -> List[bool]:
        keys = [int(k) for k in keys]
        out = [False] * len(keys)
        for sid, idxs in self.router.group(keys).items():
            res = self._call_failover(sid, proto.OP_CONTAINS,
                                      [False] * len(idxs), form,
                                      [keys[int(i)] for i in idxs])
            for i, ok in zip(idxs, res):
                out[int(i)] = bool(ok)
        return out

    def serving_forms(self, keys) -> List[Optional[str]]:
        keys = [int(k) for k in keys]
        out: List[Optional[str]] = [None] * len(keys)
        for sid, idxs in self.router.group(keys).items():
            res = self._call_failover(sid, proto.OP_SERVING_FORMS,
                                      [None] * len(idxs),
                                      [keys[int(i)] for i in idxs])
            for i, form in zip(idxs, res):
                out[int(i)] = form
        return out

    def total_capacity(self, form: str) -> int:
        return self._caps[form]

    def chain_free_bytes(self, form: str) -> int:
        return sum(self._call_failover(i, proto.OP_FREE_BYTES, 0, form)
                   for i in range(self.n_shards))

    def take_evicted(self) -> List[int]:
        with self._lock:
            out = self._pending
            self._pending = []
            return out

    def has_pending_evicted(self) -> bool:
        with self._lock:
            return bool(self._pending)

    def resize(self, split: Tuple[float, float, float],
               spill_split: Optional[Tuple[float, float, float]] = None,
               hbm_split: Optional[Tuple[float, float, float]] = None
               ) -> Dict[str, List[int]]:
        """Broadcast the new split to every shard; merge the per-shard
        evicted-key maps (disjoint keys — a plain extend)."""
        merged: Dict[str, List[int]] = {}
        for sid in range(self.n_shards):
            ev = self._call_failover(
                sid, proto.OP_RESIZE, {}, tuple(split),
                tuple(spill_split) if spill_split else None,
                tuple(hbm_split) if hbm_split else None)
            for form, keys in ev.items():
                if keys:
                    merged.setdefault(form, []).extend(keys)
        self.split = tuple(float(x) for x in split)
        if spill_split is not None:
            self.spill_split = tuple(float(y) for y in spill_split)
        if hbm_split is not None:
            self.hbm_split = tuple(float(z) for z in hbm_split)
        return merged

    def set_form_costs(self, costs: Dict[str, float]) -> None:
        for sid in range(self.n_shards):
            self._call_failover(sid, proto.OP_SET_COSTS, None,
                                dict(costs))

    def status_array(self, n: int) -> np.ndarray:
        # a dead shard's keys report 0 (IN_STORAGE) — exactly the
        # failed-over truth: its range is served by storage
        return merge_residency(
            [self._call_failover(i, proto.OP_STATUS,
                                 np.zeros(int(n), np.uint8), int(n))
             for i in range(self.n_shards)])

    def residency_array(self, n: int) -> np.ndarray:
        return merge_residency(
            [self._call_failover(i, proto.OP_RESIDENCY,
                                 np.zeros(int(n), np.uint8), int(n))
             for i in range(self.n_shards)])

    # -- stats ----------------------------------------------------------
    def shard_stats(self) -> List[Dict[str, Any]]:
        """Raw per-shard stats dicts (hit rates, bytes, telemetry) —
        surfaced through ``SenecaService.stats()["shards"]``.  A dead
        shard reports a zeroed marker entry with ``"dead": True``."""
        return [self._call_failover(
                    i, proto.OP_STATS,
                    {"shard": i, "dead": True, "hits": 0, "misses": 0,
                     "bytes_used": 0, "disk_bytes_used": 0})
                for i in range(self.n_shards)]

    def hit_rate(self) -> float:
        ss = self.shard_stats()
        h = sum(s["hits"] for s in ss)
        m = sum(s["misses"] for s in ss)
        return h / (h + m) if h + m else 0.0

    def bytes_used(self) -> int:
        return sum(s["bytes_used"] for s in self.shard_stats())

    def disk_bytes_used(self) -> int:
        return sum(s["disk_bytes_used"] for s in self.shard_stats())

    def hbm_bytes_used(self) -> int:
        return sum(s.get("hbm_bytes_used", 0) for s in self.shard_stats())

    def production_stats(self) -> Dict[str, float]:
        """Single-flight production counters summed across shards.
        Shard tables run in observe mode, so ``duplicates`` counts
        concurrent same-key productions that client-side coalescing
        did not absorb — the residual duplicate work reaching shards."""
        out: Dict[str, float] = {"led": 0, "coalesced": 0,
                                 "coalesce_wait_s": 0.0, "duplicates": 0,
                                 "in_flight": 0}
        for s in self.shard_stats():
            p = s.get("production") or {}
            for k in out:
                out[k] += p.get(k, 0)
        return out

    def spill_stats(self) -> Dict[str, Dict[str, int]]:
        if not self.has_spill:
            return {}
        return self._merge_form_stats("spill")

    def hbm_stats(self) -> Dict[str, Dict[str, int]]:
        if not self.has_hbm:
            return {}
        return self._merge_form_stats("hbm")

    def _merge_form_stats(self, key: str) -> Dict[str, Dict[str, int]]:
        """Sum the per-form counter dicts every shard reports under
        ``key`` (capacities and byte counters add across disjoint
        shards)."""
        merged: Dict[str, Dict[str, int]] = {}
        for s in self.shard_stats():
            for form, d in (s.get(key) or {}).items():
                agg = merged.setdefault(form, dict.fromkeys(d, 0))
                for k, v in d.items():
                    agg[k] += v
        return merged

    # -- data plane ------------------------------------------------------
    def produce(self, sid: int, epoch_tag: int = 0,
                want_payload: bool = True):
        """Serve one augmented sample from its owning shard (shard-side
        fetch/decode/augment)."""
        value = self._call_failover(
            self._shard_of(sid), proto.OP_PRODUCE, None,
            int(sid), int(epoch_tag), bool(want_payload))
        return self._recv(value) if want_payload else value

    def ingest(self, ids, epoch_tag: int = 0, chunk: int = 64) -> int:
        """Drive the produce path for many ids: keys group by owning
        shard, and each shard's stream runs on its own client thread —
        over the process transport the N shard processes fetch/decode
        concurrently (the disaggregation benchmark's inner loop)."""
        ids = np.asarray(ids, np.int64)
        groups = self.router.group(ids)

        def drive(sid: int, sids: np.ndarray) -> int:
            done = 0
            for off in range(0, len(sids), chunk):
                done += self._call_failover(
                    sid, proto.OP_PRODUCE_MANY, 0,
                    [int(x) for x in sids[off:off + chunk]],
                    int(epoch_tag))
            return done

        items = [(sid, ids[idx]) for sid, idx in groups.items()]
        if len(items) <= 1:
            return sum(drive(sid, sids) for sid, sids in items)
        with ThreadPoolExecutor(max_workers=len(items)) as pool:
            return sum(pool.map(lambda it: drive(*it), items))

    # ------------------------------------------------------------------
    def _cleanup_dirs(self) -> None:
        if self._xchg is not None:
            shutil.rmtree(self._xchg, ignore_errors=True)
        if self.spill_dir is not None:
            # shards cleared their own files; drop the empty per-shard
            # subdirs (rmdir: anything unexpectedly left stays visible)
            for i in range(self.n_shards):
                try:
                    os.rmdir(os.path.join(self.spill_dir, f"shard-{i}"))
                except OSError:
                    pass

    def close(self) -> None:
        """Idempotent: CLOSE every shard through the transport (each
        clears its own spill files), then drop the exchange dir."""
        with self._lock:
            if self._closed:
                return
            self._closed = True
        try:
            self.transport.close()
        finally:
            self._cleanup_dirs()
