"""Pluggable Seneca policies: sampling, admission, eviction.

The paper hard-wires three decisions into the service loop — which sample
fills each batch slot (ODS substitution, §5.2), whether a produced form is
worth a cache slot (the all-seen rejection), and when a cached augmented
tensor dies (refcount threshold = number of jobs).  This module extracts
each as a small strategy object so `repro_torch.api.SenecaServer` can mix the
paper's behaviors with baselines (naive sampling, plain LRU) or with
user-registered experiments, CoorDL-style: policy separated from loader
mechanics.

Policies are registered by name; `resolve_policy("sampler", "ods")` is how
string knobs on :class:`repro_torch.api.SenecaConfig` become objects.  Custom
policies register with :func:`register_policy` and are then addressable by
name from configs.

Locking contract (see cache/store.py): ``AdmissionPolicy.wants`` runs under
the service metadata lock, ``AdmissionPolicy.fits`` runs under the *cache*
lock (so the capacity check and the insert are atomic — the seed's
check-then-act race is structurally gone).  The two locks are never held
together in that order, which keeps the service's lock ordering
(metadata -> cache) deadlock-free.
"""
from __future__ import annotations

from typing import Dict, Optional, Protocol, Tuple, runtime_checkable

import numpy as np

from repro_torch.cache.store import CachePartition

__all__ = [
    "SamplerPolicy", "AdmissionPolicy", "EvictionPolicy",
    "OdsSampler", "NaiveSampler",
    "UnseenOnlyAdmission", "CapacityAdmission", "FrequencyAdmission",
    "RefcountEviction", "LruEviction", "CostAwareEviction",
    "register_policy", "resolve_policy", "policy_names",
]


# ----------------------------------------------------------------------
# protocols
@runtime_checkable
class SamplerPolicy(Protocol):
    """Decides the final batch composition for one request."""

    name: str

    def sample(self, backend, job_id: int, requested: np.ndarray,
               evict_threshold: Optional[int]
               ) -> Tuple[np.ndarray, np.ndarray]:
        """Return (batch ids, augmented ids to evict). Runs under the
        service metadata lock."""
        ...


@runtime_checkable
class AdmissionPolicy(Protocol):
    """Two-phase admission: a metadata vote and a capacity vote."""

    name: str

    def wants(self, backend, sample_id: int, form: str) -> bool:
        """Metadata-level decision (under the service lock)."""
        ...

    def fits(self, part: CachePartition, nbytes: int) -> bool:
        """Capacity decision, called under the cache lock immediately
        before the insert."""
        ...


@runtime_checkable
class EvictionPolicy(Protocol):
    """Controls both the per-partition store policy and the ODS step-5
    refcount threshold."""

    name: str

    def partition_policies(self) -> Dict[str, str]:
        """Per-form store policy ("none" | "lru" | "refcount")."""
        ...

    def threshold(self, backend) -> Optional[int]:
        """Refcount at which a served augmented sample is evicted;
        None disables refcount eviction entirely."""
        ...


# ----------------------------------------------------------------------
# sampler implementations
class OdsSampler:
    """The paper's Opportunistic Data Sampling (Fig. 6 steps 1-5)."""

    name = "ods"

    def sample(self, backend, job_id, requested, evict_threshold):
        return backend.sample_batch(job_id, requested,
                                    evict_threshold=evict_threshold)


class NaiveSampler:
    """Serve exactly what the epoch permutation asked for (the paper's
    MDP-only bar); still counts hits/misses for stats."""

    name = "naive"

    def sample(self, backend, job_id, requested, evict_threshold):
        requested = np.asarray(requested)
        backend.count_serve(requested)
        return requested, np.empty(0, np.int64)


# ----------------------------------------------------------------------
# admission implementations
class _CapacityGate:
    def fits(self, part: CachePartition, nbytes: int) -> bool:
        # only "lru" partitions make room inside put(); "none" and
        # "refcount" reject when full, so the entry must fit now — in
        # the DRAM tier or, when the partition has a spill chain, in
        # the disk tier it would overflow to (CachePartition.admits)
        return part.admits(nbytes)


class UnseenOnlyAdmission(_CapacityGate):
    """Reject augmented admissions no registered job could still consume
    this epoch (they would pin a slot until rollover without serving
    anyone — the seed's `admission_value == 0` rule)."""

    name = "unseen-only"

    def wants(self, backend, sample_id, form):
        return form != "augmented" or backend.admission_value(sample_id) > 0


class CapacityAdmission(_CapacityGate):
    """Admit anything that fits (MINIO-style baseline)."""

    name = "capacity"

    def wants(self, backend, sample_id, form):
        return True


class FrequencyAdmission(_CapacityGate):
    """Count-min-sketch doorkeeper (TinyLFU-style): a produced form only
    earns a cache slot once its sample has been produced ``threshold``
    times within the current aging window.  One scan-heavy job streaming
    the dataset once cannot flush the shared cache — its one-touch keys
    never pass the doorkeeper — while any key two jobs touch (or one job
    revisits) is admitted immediately.

    The sketch is ``depth`` rows of ``width`` counters (uint32, a few
    KiB total, zero per-key metadata); over-estimates are possible
    (hash collisions), under-estimates are not, so the filter can only
    err toward admitting — never toward starving a genuinely hot key.
    Counters age by periodic halving every ``window`` observations,
    so long-dead hotness decays instead of accumulating forever.
    ``wants`` runs under the service metadata lock (the standard
    admission contract), which also serializes sketch updates.
    """

    name = "frequency"

    def __init__(self, threshold: int = 2, width: int = 4096,
                 depth: int = 4, window: int = 65536):
        if threshold < 1:
            raise ValueError(f"threshold must be >= 1, got {threshold}")
        self.threshold = int(threshold)
        self.width = int(width)
        self.depth = int(depth)
        self.window = int(window)
        self._table = np.zeros((self.depth, self.width), np.uint32)
        self._seen = 0
        # fixed odd multipliers (splitmix-style) — one hash per row
        self._salts = np.array(
            [0x9E3779B1, 0x85EBCA77, 0xC2B2AE3D, 0x27D4EB2F,
             0x165667B1, 0xD3A2646D, 0xFD7046C5, 0xB55A4F09][:self.depth],
            np.uint64)

    def _rows(self, sample_id: int) -> np.ndarray:
        h = (np.uint64(sample_id * 2 + 1) * self._salts) >> np.uint64(32)
        return (h % np.uint64(self.width)).astype(np.int64)

    def wants(self, backend, sample_id, form):
        cols = self._rows(int(sample_id))
        rows = np.arange(self.depth)
        self._table[rows, cols] += 1
        estimate = int(self._table[rows, cols].min())
        self._seen += 1
        if self._seen >= self.window:
            # age: halve every counter so stale hotness decays
            self._table >>= 1
            self._seen = 0
        return estimate >= self.threshold


# ----------------------------------------------------------------------
# eviction implementations
class RefcountEviction:
    """Paper §5.2: augmented entries die once every registered job has
    consumed them (threshold tracks the live job count)."""

    name = "refcount"

    def partition_policies(self):
        return {"encoded": "none", "decoded": "none",
                "augmented": "refcount"}

    def threshold(self, backend):
        return backend.n_jobs


class LruEviction:
    """Plain LRU on every tier, no refcount churn (page-cache-like
    baseline)."""

    name = "lru"

    def partition_policies(self):
        return {"encoded": "lru", "decoded": "lru", "augmented": "lru"}

    def threshold(self, backend):
        return None


class CostAwareEviction:
    """Recompute-cost-aware eviction (GDSF, greedy-dual-size-frequency).

    Each DRAM tier under this policy scores entries by
    ``inflation + recompute_cost / nbytes`` and evicts the minimum —
    cheap-to-rebuild bytes (an encoded sample is one storage fetch) make
    way for expensive ones (an augmented tensor embodies fetch + decode +
    augment).  The per-form costs are the telemetry-measured stage
    chains (the paper's t_a / t_da terms): the service pushes fresh
    snapshots through :meth:`refresh` as training warms up, so the
    policy tracks the live pipeline instead of a static size heuristic.
    """

    name = "cost"

    #: pre-telemetry defaults: relative stage weights, not wall seconds
    #: (only the ratio between forms matters before the first refresh)
    DEFAULT_COSTS = {"encoded": 1.0, "decoded": 3.0, "augmented": 4.0}

    def partition_policies(self):
        return {"encoded": "cost", "decoded": "cost", "augmented": "cost"}

    def threshold(self, backend):
        return None

    def refresh(self, cache, snapshot) -> Dict[str, float]:
        """Recompute per-form costs from a telemetry snapshot and push
        them into the cache's "cost" tiers.  A form's cost is the
        latency chain a miss at that form re-pays: fetch for encoded,
        fetch+decode for decoded, fetch+decode+augment for augmented.
        Stages telemetry has not seen yet keep their default weight."""
        lat = snapshot.stage_latency
        # unseen stages read as None from the EWMA map, not 0.0
        fetch = lat.get("fetch_storage") or 0.0
        dec = lat.get("decode") or 0.0
        aug = lat.get("augment") or 0.0
        costs = dict(self.DEFAULT_COSTS)
        if fetch > 0:
            costs["encoded"] = fetch
            if dec > 0:
                costs["decoded"] = fetch + dec
                if aug > 0:
                    costs["augmented"] = fetch + dec + aug
        cache.set_form_costs(costs)
        return costs


# ----------------------------------------------------------------------
# registry
_REGISTRY: Dict[str, Dict[str, type]] = {
    "sampler": {"ods": OdsSampler, "naive": NaiveSampler},
    "admission": {"unseen-only": UnseenOnlyAdmission,
                  "capacity": CapacityAdmission,
                  "frequency": FrequencyAdmission},
    "eviction": {"refcount": RefcountEviction, "lru": LruEviction,
                 "cost": CostAwareEviction},
}

_PROTOCOLS = {"sampler": SamplerPolicy, "admission": AdmissionPolicy,
              "eviction": EvictionPolicy}


def register_policy(kind: str, name: str, factory: type) -> None:
    """Make a policy class addressable by name from SenecaConfig knobs."""
    if kind not in _REGISTRY:
        raise ValueError(f"unknown policy kind {kind!r}; "
                         f"expected one of {sorted(_REGISTRY)}")
    _REGISTRY[kind][name] = factory


def policy_names(kind: str) -> Tuple[str, ...]:
    return tuple(sorted(_REGISTRY[kind]))


def resolve_policy(kind: str, spec):
    """Turn a config knob (name string or ready instance) into a policy."""
    if isinstance(spec, str):
        try:
            return _REGISTRY[kind][spec]()
        except KeyError:
            raise ValueError(
                f"unknown {kind} policy {spec!r}; registered: "
                f"{policy_names(kind)}") from None
    if not isinstance(spec, _PROTOCOLS[kind]):
        raise TypeError(f"{spec!r} does not implement the {kind} protocol")
    return spec
