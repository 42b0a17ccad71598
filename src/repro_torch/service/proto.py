"""Request/response protocol between the sharded-cache client and its
:class:`~repro_torch.service.shard.CacheShard` fleet.

One tiny verb set covers everything the single-process
:class:`~repro_torch.cache.store.TieredCache` surface needs (lookup /
admit / stats / resize / residency gathers) plus the data-plane
``produce`` ops the sharded benchmark drives.  The same :class:`Request` /
:class:`Response` pair travels over both transports — called directly on
in-process shard objects (sim) or pickled over a pipe (process) — so a
test that drives the sim transport exercises byte-identical protocol
paths to production.

Substitution note: ODS *sampling* substitution (which sample fills a
batch slot) is a metadata-plane decision and stays in the central
service — shards only answer the *serving-form* half (``OP_LOOKUP`` /
``OP_SERVING_FORMS`` report the most-processed resident form, exactly
like ``TieredCache.lookup``).

Every :class:`Response` piggybacks two bookkeeping fields so the client
needs no polling RPCs:

* ``evicted`` — keys this shard's tier chains dropped as a side effect
  since the last response (spill overflow, promotion backfill); the
  client accumulates them for the service's ODS reconcile pass.
* ``version`` — the shard cache's residency version counter; the client
  sums shard versions into the composite version gating the O(N)
  residency-array rebuild.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Optional, Tuple

OP_PING = "ping"                   # -> shard hello (id, split, capacities)
OP_LOOKUP = "lookup"               # (key) -> (form, value|ref, tier)
OP_INSERT = "insert"               # (key, form, value, nbytes, gated)
OP_INSERT_BATCH = "insert_batch"   # (form, [(key, value, nbytes)])
OP_EVICT = "evict"                 # (key, form) -> bool
OP_CONTAINS = "contains"           # (form, [keys]) -> [bool]
OP_SERVING_FORMS = "serving_forms"  # ([keys]) -> [form|None]
OP_FORM_OF = "form_of"             # (key) -> form|None
OP_FREE_BYTES = "free_bytes"       # (form) -> chain free bytes
OP_STATUS = "status"               # (n) -> uint8[n] ODS status codes
OP_RESIDENCY = "residency"         # (n) -> uint8[n] residency levels
OP_RESIZE = "resize"               # (split, spill_split) -> {form: keys}
OP_SET_COSTS = "set_costs"         # ({form: seconds}) -> True
OP_STATS = "stats"                 # -> per-shard stats dict
OP_PRODUCE = "produce"             # (sid, epoch_tag, want_payload)
OP_PRODUCE_MANY = "produce_many"   # ([sids], epoch_tag) -> count
OP_CLOSE = "close"                 # -> True; shard tears down after reply


@dataclass(frozen=True)
class Request:
    """One shard call: a verb plus positional arguments."""

    op: str
    args: Tuple[Any, ...] = ()


@dataclass(frozen=True)
class Response:
    """The reply: ``value`` on success, ``error`` (a formatted
    exception, never a live traceback object) on failure, and the
    piggybacked eviction/version bookkeeping either way."""

    ok: bool
    value: Any = None
    error: Optional[str] = None
    evicted: Tuple[int, ...] = ()
    version: int = 0
