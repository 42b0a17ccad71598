"""One shard of the disaggregated data plane.

A :class:`CacheShard` owns 1/N of the key space: its own
:class:`~repro_torch.cache.store.TieredCache` (sized to 1/N of the
global budget, split by a shard-local form×tier MDP solve unless a split
is pinned), its own telemetry aggregator, and — when configured with a
dataset — the full produce path (storage fetch → decode → augment),
which is what makes process-transport shards useful on a multi-core
host: the CPU-heavy decode runs in the shard process, outside the
client's GIL.

The shard's HBM tier lives on ``ShardConfig.device`` (``None`` means
CUDA, which must then be available: a shard never drops to the CPU on
its own).  Over the process transport that is a CUDA context of the
shard's own; a device value leaving the shard is brought down with
``.cpu().numpy()`` into an exchange file, and its tier label ("hbm")
travels with it, so a client must not take a shipped host copy for a
tensor on its own device.

The shard is transport-agnostic: ``handle(Request) -> Response`` is the
entire surface.  The sim transport calls it directly on the job thread
(synchronous, deterministic under the VirtualClock turn discipline);
the process transport calls it from a pipe-reading loop in a child
process.  Exceptions never escape ``handle`` — they come back as
``Response(ok=False, error=...)`` so a poisoned request cannot kill a
shard.

Import discipline: this module must not import ``repro_torch.api`` at
module level (``repro_torch.api.__init__`` pulls in ``api/server.py``,
which lazily constructs the sharded client — a top-level import here
would close the cycle).  ``TelemetryAggregator`` is imported inside
``__init__``.
"""
from __future__ import annotations

import itertools
import os
import time
from dataclasses import dataclass
from typing import Any, Dict, Optional, Tuple

import numpy as np

from repro_torch.cache.codecs import (PayloadRef, receive_payload,
                                      ship_payload)
from repro_torch.cache.coalesce import ProductionTable
from repro_torch.cache.store import FORMS, TieredCache, _host
from repro_torch.data.augment import augment_np
from repro_torch.kernels.device import concrete_device
from repro_torch.service import proto


def produce_seed(epoch_tag: int, sid: int) -> int:
    """The augment RNG seed for (epoch, sample) — the same derivation
    as the in-process pipeline's ``_aug_seed``
    (repro_torch/data/pipeline.py), duplicated here so shard processes
    need no pipeline import; the parity is pinned by
    tests/test_torch_service.py."""
    return (epoch_tag * 1_000_003 + sid) & 0x7FFFFFFF


class _FitsGate:
    """Capacity-only admission for shards configured without a policy
    instance (the metadata-plane ``wants`` vote already happened client
    side; the shard re-checks only what must be atomic with the put)."""

    name = "fits"

    def fits(self, part, nbytes: int) -> bool:
        return part.admits(nbytes)


@dataclass
class ShardConfig:
    """Everything a shard needs to build itself — picklable, because the
    process transport ships it as the spawn argument (the dataset must
    therefore be a picklable profile like ``SyntheticDataset``, not a
    live handle)."""

    shard_id: int
    n_shards: int
    cache_bytes: int
    #: DRAM split; None -> shard-local MDP solve from the profiles below
    split: Optional[Tuple[float, float, float]] = None
    evict_policies: Optional[Dict[str, str]] = None
    #: admission policy instance (duck-typed ``.fits``); None -> capacity
    admission: Any = None
    spill_dir: Optional[str] = None
    spill_bytes: int = 0
    spill_split: Optional[Tuple[float, float, float]] = None
    #: device-resident tier budget (this shard's 1/N slice) + split
    hbm_bytes: int = 0
    hbm_split: Optional[Tuple[float, float, float]] = None
    #: profiles feeding the per-shard MDP solve (used when split=None)
    hardware: Any = None
    dataset_profile: Any = None
    job: Any = None
    partition_step: float = 0.01
    #: dataset + per-shard ingest bandwidth for the produce data plane
    dataset: Any = None
    storage_bandwidth: Optional[float] = None
    seed: int = 0
    #: payload exchange directory; None -> values travel in-band (sim)
    exchange_dir: Optional[str] = None
    #: the HBM tier's device as a string (it pickles into a spawned
    #: shard); None -> CUDA, raising where CUDA is missing
    device: Optional[str] = None


class CacheShard:
    """The server half of the protocol: one tiered cache + telemetry +
    produce path behind :meth:`handle`."""

    def __init__(self, cfg: ShardConfig):
        from repro_torch.api.telemetry import \
            TelemetryAggregator  # lazy: cycle

        self.cfg = cfg
        split = tuple(cfg.split) if cfg.split is not None else None
        spill_split = (tuple(cfg.spill_split)
                       if cfg.spill_split is not None else None)
        has_spill = cfg.spill_dir is not None and cfg.spill_bytes > 0
        has_hbm = cfg.hbm_bytes > 0
        hbm_split = (tuple(cfg.hbm_split)
                     if cfg.hbm_split is not None else None)
        self.partition_label = None
        if split is None:
            if cfg.hardware is None or cfg.dataset_profile is None:
                raise ValueError(
                    f"shard {cfg.shard_id}: no split pinned and no "
                    "hardware/dataset profiles to solve one from")
            from repro_torch.core import mdp
            solved = mdp.optimize_shard(
                cfg.hardware, cfg.dataset_profile, cfg.job,
                n_shards=cfg.n_shards, step=cfg.partition_step,
                tiered=has_spill or has_hbm)
            if has_spill or has_hbm:
                split = (solved.dram.x_e, solved.dram.x_d, solved.dram.x_a)
                if has_spill and spill_split is None:
                    spill_split = (solved.disk.x_e, solved.disk.x_d,
                                   solved.disk.x_a)
                if has_hbm and hbm_split is None and solved.hbm is not None:
                    hbm_split = (solved.hbm.x_e, solved.hbm.x_d,
                                 solved.hbm.x_a)
            else:
                split = (solved.x_e, solved.x_d, solved.x_a)
            self.partition_label = solved.label
        self.split = split
        self.cache = TieredCache(
            cfg.cache_bytes, split,
            evict_policies=cfg.evict_policies,
            spill_bytes=cfg.spill_bytes if has_spill else 0,
            spill_dir=cfg.spill_dir if has_spill else None,
            spill_split=spill_split,
            hbm_bytes=cfg.hbm_bytes if has_hbm else 0,
            hbm_split=hbm_split if has_hbm else None,
            device=cfg.device)
        self.admission = cfg.admission or _FitsGate()
        self.telemetry = TelemetryAggregator()
        self.dataset = cfg.dataset
        self.storage = None
        if cfg.dataset is not None:
            from repro_torch.data.storage import RemoteStorage
            self.storage = RemoteStorage(cfg.dataset,
                                         bandwidth=cfg.storage_bandwidth)
        self._seq = itertools.count()
        self.produced = 0
        # observe-mode single-flight table: shards must never block a
        # request on another request's production (the sim transport
        # may carry a virtual clock whose turn discipline a wall wait
        # would wedge), so concurrent same-key productions proceed and
        # are *counted* as duplicates instead of coalesced here —
        # cross-job dedup happens client-side in DSIPipeline
        self.production = ProductionTable(enabled=False)
        self._closed = False

    # -- payload marshalling -------------------------------------------
    def _ship(self, form: Optional[str], value: Any) -> Any:
        """Outbound payload: park it in the exchange dir and send the
        ref (process transport) or pass the object through (sim)."""
        if self.cfg.exchange_dir is None or form is None or value is None:
            return value
        if not isinstance(value, (bytes, np.ndarray)):
            # device-resident (HBM-tier) tensors leave the shard as host
            # copies (``np.asarray`` cannot read CUDA memory); the
            # client side receives a plain ndarray
            value = _host(value)
        path = os.path.join(
            self.cfg.exchange_dir,
            f"s{self.cfg.shard_id}-{os.getpid()}-{next(self._seq)}.bin")
        return ship_payload(form, value, path)

    @staticmethod
    def _recv(value: Any) -> Any:
        return (receive_payload(value)
                if isinstance(value, PayloadRef) else value)

    # -- dispatch -------------------------------------------------------
    def handle(self, req: proto.Request) -> proto.Response:
        fn = self._OPS.get(req.op)
        if fn is None:
            return proto.Response(
                False, error=f"unknown op {req.op!r}",
                version=self.cache.version)
        try:
            value = fn(self, *req.args)
        except Exception as e:  # shards survive poisoned requests
            return proto.Response(
                False, error=f"{type(e).__name__}: {e}",
                evicted=tuple(self.cache.take_evicted()),
                version=self.cache.version)
        return proto.Response(
            True, value,
            evicted=tuple(self.cache.take_evicted()),
            version=self.cache.version)

    # -- control-plane ops ---------------------------------------------
    def _op_ping(self):
        return {"shard": self.cfg.shard_id,
                "split": tuple(self.split),
                "partition": self.partition_label,
                "caps": {form: self.cache.total_capacity(form)
                         for form in FORMS}}

    def _op_lookup(self, key: int):
        t0 = time.monotonic()
        form, value, tier = self.cache.lookup_tiered(key)
        self.telemetry.record_serve(form)
        if form is not None:
            nbytes = (value.nbytes if hasattr(value, "nbytes")
                      else len(value))
            self.telemetry.record_bytes(
                "disk" if tier == "disk" else "cache",
                nbytes, time.monotonic() - t0)
        return form, self._ship(form, value), tier

    def _op_insert(self, key, form, value, nbytes, gated):
        value = self._recv(value)
        if gated:
            return self.cache.insert_gated(key, form, value, nbytes,
                                           self.admission)
        return self.cache.insert(key, form, value, nbytes)

    def _op_insert_batch(self, form, entries):
        entries = [(k, self._recv(v), nb) for k, v, nb in entries]
        return self.cache.insert_batch_gated(form, entries,
                                             self.admission)

    def _op_evict(self, key, form):
        return self.cache.evict(key, form)

    def _op_contains(self, form, keys):
        return self.cache.contains_many(form, keys)

    def _op_serving_forms(self, keys):
        return self.cache.serving_forms(keys)

    def _op_form_of(self, key):
        return self.cache.form_of(key)

    def _op_free_bytes(self, form):
        return self.cache.chain_free_bytes(form)

    def _op_status(self, n):
        return self.cache.status_array(n)

    def _op_residency(self, n):
        return self.cache.residency_array(n)

    def _op_resize(self, split, spill_split, hbm_split=None):
        out = self.cache.resize(tuple(split),
                                tuple(spill_split) if spill_split else None,
                                tuple(hbm_split) if hbm_split else None)
        self.split = tuple(float(x) for x in split)
        return out

    def _op_set_costs(self, costs):
        self.cache.set_form_costs(dict(costs))
        return True

    def _op_stats(self):
        parts = self.cache.parts
        return {
            "shard": self.cfg.shard_id,
            "partition": self.partition_label,
            "split": tuple(self.split),
            "hits": sum(p.total_hits for p in parts.values()),
            "misses": (sum(p.total_misses for p in parts.values())
                       + self.cache.lookup_misses),
            "hit_rate": self.cache.hit_rate(),
            "bytes_used": self.cache.bytes_used(),
            "disk_bytes_used": self.cache.disk_bytes_used(),
            "hbm_bytes_used": self.cache.hbm_bytes_used(),
            "entries": sum(len(p) for p in parts.values()),
            "produced": self.produced,
            "production": self.production.stats(),
            "spill": self.cache.spill_stats(),
            "hbm": self.cache.hbm_stats(),
            "hbm_device": self._hbm_device(),
            "telemetry": self.telemetry.as_dict(),
        }

    def _hbm_device(self) -> Optional[str]:
        """Where this shard's HBM tier holds its tensors (None without
        one): the device resolved in the shard's own process."""
        if not self.cache.has_hbm:
            return None
        return str(concrete_device(self.cache.parts[FORMS[0]].hbm.device))

    def _op_close(self):
        self.close()
        return True

    # -- data-plane ops (the shard-side produce path) ------------------
    def _op_produce(self, sid, epoch_tag, want_payload):
        value = self._produce(int(sid), int(epoch_tag))
        self.produced += 1
        return (self._ship("augmented", value) if want_payload
                else int(value.nbytes))

    def _op_produce_many(self, sids, epoch_tag):
        tag = int(epoch_tag)
        for sid in sids:
            self._produce(int(sid), tag)
            self.produced += 1
        return len(sids)

    def _produce(self, sid: int, epoch_tag: int) -> np.ndarray:
        """Serve one augmented sample shard-locally, mirroring the
        pipeline's per-sample stage chain (cache short-circuits at the
        most-processed resident form; intermediate forms are offered to
        the cache through the shard's admission gate)."""
        if self.dataset is None:
            raise RuntimeError(
                f"shard {self.cfg.shard_id} has no dataset configured "
                "for produce")
        form, value, _tier = self.cache.lookup_tiered(sid)
        self.telemetry.record_serve(form)
        if form == "augmented":
            return value
        _leader, flight = self.production.begin(sid, "augmented")
        try:
            out = self._produce_miss(sid, epoch_tag, form, value)
        except BaseException as e:
            self.production.abort(flight, e)
            raise
        self.production.finish(flight, out)
        return out

    def _produce_miss(self, sid: int, epoch_tag: int,
                      form: Optional[str], value) -> np.ndarray:
        if form == "decoded":
            img = _host(value)       # an HBM hit is a tensor
        else:
            if form == "encoded":
                enc = value
            else:
                t0 = time.monotonic()
                enc = self.storage.fetch(sid)
                dt = time.monotonic() - t0
                self.telemetry.record_stage("fetch_storage", dt)
                self.telemetry.record_bytes("storage", len(enc), dt)
                self.cache.insert_gated(sid, "encoded", enc, len(enc),
                                        self.admission)
            t1 = time.monotonic()
            img = self.dataset.decode(enc, sid)
            self.telemetry.record_stage("decode", time.monotonic() - t1)
            self.cache.insert_gated(sid, "decoded", img, img.nbytes,
                                    self.admission)
        t2 = time.monotonic()
        out = augment_np(img, self.dataset.crop_hw,
                         np.random.default_rng(produce_seed(epoch_tag,
                                                            sid)))
        self.telemetry.record_stage("augment", time.monotonic() - t2)
        self.cache.insert_gated(sid, "augmented", out, out.nbytes,
                                self.admission)
        return out

    # ------------------------------------------------------------------
    def close(self) -> None:
        """Tear the cache down and free the HBM tier's tensors at once
        (not when the shard object is collected): each process shard
        holds a CUDA context and an allocator of its own on the card."""
        if self._closed:
            return
        self._closed = True
        self.cache.close()
        if self.cache.has_hbm:
            with self.cache.lock:
                for part in self.cache.parts.values():
                    for key in part.hbm.keys():
                        part.hbm.remove(key)

    _OPS = {
        proto.OP_PING: _op_ping,
        proto.OP_LOOKUP: _op_lookup,
        proto.OP_INSERT: _op_insert,
        proto.OP_INSERT_BATCH: _op_insert_batch,
        proto.OP_EVICT: _op_evict,
        proto.OP_CONTAINS: _op_contains,
        proto.OP_SERVING_FORMS: _op_serving_forms,
        proto.OP_FORM_OF: _op_form_of,
        proto.OP_FREE_BYTES: _op_free_bytes,
        proto.OP_STATUS: _op_status,
        proto.OP_RESIDENCY: _op_residency,
        proto.OP_RESIZE: _op_resize,
        proto.OP_SET_COSTS: _op_set_costs,
        proto.OP_STATS: _op_stats,
        proto.OP_PRODUCE: _op_produce,
        proto.OP_PRODUCE_MANY: _op_produce_many,
        proto.OP_CLOSE: _op_close,
    }
