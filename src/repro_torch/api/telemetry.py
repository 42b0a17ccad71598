"""Runtime telemetry for the DSI pipeline (the measurement half of
adaptive repartitioning).

The MDP's performance model (Seneca §5.1) is parameterized by Table-3
hardware rates; on any real deployment the observed rates drift — CPU
contention from concurrent jobs, storage throttling, differently sized
samples.  :class:`TelemetryAggregator` is the shared sink every
:class:`~repro_torch.data.pipeline.DSIPipeline` worker reports into:

* per-stage latency EWMAs (``fetch_storage`` / ``fetch_cache`` /
  ``decode`` / ``augment`` / ``collate``), per *sample*;
* per-transfer effective bandwidth EWMAs for the storage and cache
  channels (bytes/s, stall time included);
* per-form serve counts (which tier answered each lookup);
* bounded-queue depth/occupancy gauges from the stage-parallel executor
  (ingestion backpressure: a queue pinned at 1.0 occupancy names the
  stage the repartition controller should be feeding);
* error counters (``refill`` / ``prefetch`` / ...) so background-thread
  failures surface in ``stats()`` instead of vanishing.

:meth:`snapshot` folds these into a :class:`TelemetrySnapshot` whose
``t_da`` / ``t_a`` / ``b_storage`` / ``b_cache`` fields line up with the
:class:`~repro_torch.core.perf_model.HardwareProfile` fields of the same name —
:func:`repro_torch.core.perf_model.calibrate` swaps them in, and the
:class:`~repro_torch.api.server.RepartitionController` re-runs MDP on the
calibrated profile.

Thread-safety: one lock around all mutation; every reporter (pipeline
fetch/decode/augment workers, refill threads) shares one aggregator per
:class:`~repro_torch.api.server.SenecaService`.

Notes on estimator semantics:

* CPU rates are *node-aggregate* samples/s: per-sample latency EWMAs are
  scaled by the registered worker concurrency (``add_concurrency`` /
  ``remove_concurrency``, called by pipelines on start/stop), mirroring
  how Table 3 measures t_DA with all cores busy.  A stage can report its
  own worker count (``record_stage(..., workers=)``) when not every
  registered worker runs it — the stage-parallel executor's augment
  stage is a single thread, its decode group is elastically sized — and
  the aggregate rate then uses the per-stage counts (pipelined:
  ``t_da = min(w_dec/dec, w_aug/aug)``) instead of the global scale.
* Bandwidths are per-transfer effective rates.  Under a shared
  token-bucket (``RemoteStorage``) each transfer already observes its
  contended share, so the EWMA approximates the per-stream bandwidth and
  is deliberately *not* multiplied by concurrency.
"""
from __future__ import annotations

import math
import threading
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Sequence

STAGES = ("fetch_storage", "fetch_cache", "decode", "augment", "collate")
#: "h2d" is the host→device transfer channel: its EWMA calibrates the
#: device tier's ``b_hbm`` and its cumulative byte counter is the
#: zero-copy assertion surface (an all-HBM-hit epoch moves no h2d bytes)
CHANNELS = ("storage", "cache", "disk", "h2d")

#: open-loop per-request phase breakdown (queue wait + data-path stages)
REQUEST_PHASES = ("queue", "fetch", "decode", "augment")
#: request outcomes: "served" (full quality), "degraded" (augment
#: skipped, decoded form), "encoded" (decode+augment skipped), "shed"
#: (rejected at admission — counted, never silently dropped)
REQUEST_OUTCOMES = ("served", "degraded", "encoded", "shed")


def quantile(samples: Sequence[float], q: float) -> float:
    """Exact nearest-rank quantile: the smallest sample x such that at
    least ``ceil(q * n)`` samples are <= x.  No interpolation — p99 of a
    latency set is always a latency that actually occurred, and the
    result is bit-reproducible across runs (the property the
    VirtualClock determinism tests assert on)."""
    if not 0.0 <= q <= 1.0:
        raise ValueError(f"quantile q must be in [0, 1], got {q}")
    if len(samples) == 0:
        raise ValueError("quantile of an empty sample set")
    xs = sorted(samples)
    k = max(math.ceil(q * len(xs)), 1)
    return xs[min(k, len(xs)) - 1]


class Ewma:
    """Exponentially weighted moving average with an observation count."""

    def __init__(self, alpha: float = 0.2):
        self.alpha = float(alpha)
        self.value: Optional[float] = None
        self.n = 0

    def update(self, x: float) -> None:
        x = float(x)
        self.value = x if self.value is None \
            else self.alpha * x + (1.0 - self.alpha) * self.value
        self.n += 1

    def __repr__(self) -> str:
        return f"Ewma(value={self.value}, n={self.n})"


@dataclass(frozen=True)
class TelemetrySnapshot:
    """Point-in-time read of the aggregator (all derived values pure).

    ``t_da`` / ``t_a`` / ``b_storage`` / ``b_cache`` are ``None`` until the
    underlying signals exist; counts let :func:`perf_model.calibrate`
    apply a min-samples floor per field.
    """
    stage_latency: Dict[str, Optional[float]]   # EWMA seconds/sample
    stage_n: Dict[str, int]
    bandwidth: Dict[str, Optional[float]]       # EWMA bytes/s per channel
    bandwidth_n: Dict[str, int]
    serve_counts: Dict[str, int]                # per-form + "storage"
    concurrency: int
    queue_depth: Dict[str, float] = field(default_factory=dict)
    queue_occupancy: Dict[str, float] = field(default_factory=dict)
    errors: Dict[str, int] = field(default_factory=dict)
    t_da: Optional[float] = None                # samples/s, decode+augment
    t_a: Optional[float] = None                 # samples/s, augment-only
    b_storage: Optional[float] = None           # bytes/s
    b_cache: Optional[float] = None             # bytes/s (DRAM hits)
    b_disk: Optional[float] = None              # bytes/s (spill-tier hits)
    b_hbm: Optional[float] = None               # bytes/s (h2d transfers)
    counts: Dict[str, int] = field(default_factory=dict)  # per calibration field
    channel_bytes: Dict[str, int] = field(default_factory=dict)  # cumulative

    @property
    def n_serves(self) -> int:
        return sum(self.serve_counts.values())

    def hit_rates(self) -> Dict[str, float]:
        """Fraction of lookups answered by each tier ('storage' = miss)."""
        total = self.n_serves
        if not total:
            return {k: 0.0 for k in self.serve_counts}
        return {k: v / total for k, v in self.serve_counts.items()}


class TelemetryAggregator:
    """Thread-safe sink for pipeline stage timings, transfer bandwidths
    and per-form serve counts; snapshots feed ``perf_model.calibrate``."""

    def __init__(self, alpha: float = 0.2):
        self._lock = threading.Lock()
        self._alpha = float(alpha)
        self._stages: Dict[str, Ewma] = {s: Ewma(alpha) for s in STAGES}
        self._bw: Dict[str, Ewma] = {c: Ewma(alpha) for c in CHANNELS}
        self._channel_bytes: Dict[str, int] = {c: 0 for c in CHANNELS}
        self._serves: Dict[str, int] = {
            "encoded": 0, "decoded": 0, "augmented": 0, "storage": 0}
        self._concurrency = 0
        self._queue_depth: Dict[str, Ewma] = {}
        self._queue_occ: Dict[str, Ewma] = {}
        self._errors: Dict[str, int] = {}
        self._stage_workers: Dict[str, int] = {}
        # open-loop request accounting: outcome counters + raw latency
        # samples (exact percentiles need the full set, not an EWMA).
        # Bounded so an unbounded serve run cannot grow memory without
        # limit; drops beyond the cap are counted, not silent.
        self._req_counts: Dict[str, int] = {o: 0 for o in REQUEST_OUTCOMES}
        self._req_total: List[float] = []
        self._req_phase: Dict[str, List[float]] = {
            p: [] for p in REQUEST_PHASES}
        self._req_cap = 200_000
        self._req_dropped = 0
        # single-flight coalescing: productions avoided by joining
        # another job's in-flight production, and the time spent waiting
        self._coalesced = 0
        self._coalesce_wait_s = 0.0

    # -- reporting (pipeline side) -------------------------------------
    def add_concurrency(self, n: int) -> None:
        with self._lock:
            self._concurrency += int(n)

    def remove_concurrency(self, n: int) -> None:
        with self._lock:
            self._concurrency = max(0, self._concurrency - int(n))

    def record_stage(self, stage: str, seconds: float, n: int = 1,
                     workers: Optional[int] = None) -> None:
        """Record ``n`` samples taking ``seconds`` total in ``stage``.

        ``workers`` declares how many threads run this stage when that
        differs from the registered global concurrency (the per-sample
        executor's pool runs every stage on every worker; the
        stage-parallel executor's stages have their own group sizes).
        Last writer wins — an approximation when executors mix on one
        service.
        """
        if n <= 0 or stage not in self._stages:
            return
        with self._lock:
            self._stages[stage].update(seconds / n)
            if workers is not None:
                self._stage_workers[stage] = max(int(workers), 1)

    def record_bytes(self, channel: str, nbytes: int,
                     seconds: float) -> None:
        """Record one transfer: ``nbytes`` moved in ``seconds``.  Also
        accumulates the channel's total byte counter (the "h2d" total is
        how the device pipeline proves an all-HBM-hit epoch shipped zero
        per-batch host→device bytes)."""
        if channel not in self._bw or nbytes <= 0:
            return
        with self._lock:
            # floor on the denominator: an in-memory hit can measure ~0s
            self._bw[channel].update(nbytes / max(seconds, 1e-9))
            self._channel_bytes[channel] += int(nbytes)

    def channel_total_bytes(self, channel: str) -> int:
        """Cumulative bytes recorded on ``channel`` since construction."""
        with self._lock:
            return self._channel_bytes.get(channel, 0)

    def record_serve(self, form: Optional[str]) -> None:
        """Which tier answered a lookup (None = storage fetch)."""
        key = form if form in self._serves else "storage"
        with self._lock:
            self._serves[key] += 1

    def record_queue(self, name: str, depth: int, capacity: int) -> None:
        """Gauge one bounded pipeline queue: current depth + occupancy
        (depth/capacity).  Occupancy ~1.0 means the downstream stage is
        the bottleneck (ingestion backpressure)."""
        with self._lock:
            if name not in self._queue_depth:
                self._queue_depth[name] = Ewma(self._alpha)
                self._queue_occ[name] = Ewma(self._alpha)
            self._queue_depth[name].update(depth)
            self._queue_occ[name].update(depth / max(capacity, 1))

    def clear_stage_workers(self, *stages: str) -> None:
        """Forget per-stage worker counts (a stopped stage-parallel
        executor must not leave its group sizes scaling latencies that a
        per-sample pipeline reports afterwards)."""
        with self._lock:
            for stage in stages or tuple(self._stage_workers):
                self._stage_workers.pop(stage, None)

    def record_coalesced(self, wait_s: float) -> None:
        """Count one production avoided by joining an in-flight one
        (single-flight coalescing), with the wall/virtual seconds the
        joiner spent waiting for the leader's hand-off."""
        with self._lock:
            self._coalesced += 1
            self._coalesce_wait_s += max(float(wait_s), 0.0)

    def record_error(self, kind: str) -> int:
        """Count one background failure; returns the new total for
        ``kind`` (callers log the first occurrence only)."""
        with self._lock:
            self._errors[kind] = self._errors.get(kind, 0) + 1
            return self._errors[kind]

    def error_count(self, kind: str) -> int:
        with self._lock:
            return self._errors.get(kind, 0)

    # -- open-loop request accounting ----------------------------------
    def record_request(self, outcome: str, total_s: Optional[float] = None,
                       phases: Optional[Dict[str, float]] = None) -> None:
        """Account one open-loop request.  ``outcome`` is one of
        :data:`REQUEST_OUTCOMES`; shed requests carry no latency.
        ``phases`` maps :data:`REQUEST_PHASES` names to seconds spent in
        each (missing phases — e.g. no decode on an augmented hit — are
        simply absent from that request's breakdown)."""
        if outcome not in self._req_counts:
            raise ValueError(f"unknown request outcome {outcome!r}; "
                             f"expected one of {REQUEST_OUTCOMES}")
        with self._lock:
            self._req_counts[outcome] += 1
            if total_s is None:
                return
            if len(self._req_total) >= self._req_cap:
                self._req_dropped += 1
                return
            self._req_total.append(float(total_s))
            if phases:
                for p, dt in phases.items():
                    if p in self._req_phase:
                        self._req_phase[p].append(float(dt))

    def request_summary(self) -> Dict[str, object]:
        """Outcome counters + exact latency percentiles (p50/p99/p999,
        per-phase p50/p99).  Empty-latency runs report counters only."""
        with self._lock:
            counts = dict(self._req_counts)
            total = list(self._req_total)
            phases = {p: list(v) for p, v in self._req_phase.items() if v}
            dropped = self._req_dropped
        out: Dict[str, object] = {
            "outcomes": counts,
            "completed": sum(v for k, v in counts.items() if k != "shed"),
            "latency_samples": len(total),
            "latency_samples_dropped": dropped,
        }
        if total:
            out["latency_s"] = {"p50": quantile(total, 0.50),
                                "p99": quantile(total, 0.99),
                                "p999": quantile(total, 0.999),
                                "mean": sum(total) / len(total),
                                "max": max(total)}
            out["phase_latency_s"] = {
                p: {"p50": quantile(v, 0.50), "p99": quantile(v, 0.99)}
                for p, v in phases.items()}
        return out

    # -- reading (controller side) -------------------------------------
    def snapshot(self) -> TelemetrySnapshot:
        with self._lock:
            lat = {s: e.value for s, e in self._stages.items()}
            lat_n = {s: e.n for s, e in self._stages.items()}
            bw = {c: e.value for c, e in self._bw.items()}
            bw_n = {c: e.n for c, e in self._bw.items()}
            serves = dict(self._serves)
            conc = max(self._concurrency, 1)
            q_depth = {k: e.value for k, e in self._queue_depth.items()
                       if e.value is not None}
            q_occ = {k: e.value for k, e in self._queue_occ.items()
                     if e.value is not None}
            errors = dict(self._errors)
            sw = dict(self._stage_workers)
            ch_bytes = dict(self._channel_bytes)

        def rate(total_latency: Optional[float]) -> Optional[float]:
            if not total_latency or total_latency <= 0:
                return None
            return conc / total_latency

        dec, aug = lat["decode"], lat["augment"]
        w_dec, w_aug = sw.get("decode"), sw.get("augment")
        if dec and aug and (w_dec or w_aug):
            # stage-parallel reporters: decode and augment run on their
            # own worker groups, pipelined — the chain rate is the
            # slower stage's, not conc/(dec+aug)
            t_da = min((w_dec or conc) / dec, (w_aug or conc) / aug)
        else:
            t_da = rate((dec + aug) if dec is not None and aug is not None
                        else None)
        t_a = (w_aug / aug) if aug and w_aug else rate(aug)
        counts = {
            "t_da": min(lat_n["decode"], lat_n["augment"]),
            "t_a": lat_n["augment"],
            "b_storage": bw_n["storage"],
            "b_cache": bw_n["cache"],
            "b_disk": bw_n["disk"],
            "b_hbm": bw_n["h2d"],
        }
        return TelemetrySnapshot(
            stage_latency=lat, stage_n=lat_n, bandwidth=bw,
            bandwidth_n=bw_n, serve_counts=serves, concurrency=conc,
            queue_depth=q_depth, queue_occupancy=q_occ, errors=errors,
            t_da=t_da, t_a=t_a,
            b_storage=bw["storage"], b_cache=bw["cache"],
            b_disk=bw["disk"], b_hbm=bw["h2d"], counts=counts,
            channel_bytes=ch_bytes)

    def as_dict(self) -> Dict[str, object]:
        """JSON-friendly summary for ``stats()`` surfaces.  The
        ``"requests"`` key is additive: present only once open-loop
        requests have been recorded, so closed-loop stats payloads are
        unchanged."""
        snap = self.snapshot()
        with self._lock:
            any_requests = any(self._req_counts.values())
            coalesced = self._coalesced
            coalesce_wait_s = self._coalesce_wait_s
        out = {
            "stage_latency_s": {k: v for k, v in snap.stage_latency.items()
                                if v is not None},
            "bandwidth_bps": {k: v for k, v in snap.bandwidth.items()
                              if v is not None},
            "serve_counts": dict(snap.serve_counts),
            "hit_rates": snap.hit_rates(),
            "concurrency": snap.concurrency,
            "queue_depth": dict(snap.queue_depth),
            "queue_occupancy": dict(snap.queue_occupancy),
            "errors": dict(snap.errors),
            "t_da": snap.t_da, "t_a": snap.t_a,
            "b_storage": snap.b_storage, "b_cache": snap.b_cache,
            "b_disk": snap.b_disk, "b_hbm": snap.b_hbm,
            "channel_bytes": dict(snap.channel_bytes),
        }
        if any_requests:
            out["requests"] = self.request_summary()
        # additive like "requests": present only once coalescing has
        # actually deduped a production, so existing payloads and their
        # consumers are unchanged
        if coalesced:
            out["coalesced"] = coalesced
            out["coalesce_wait_s"] = coalesce_wait_s
        return out
