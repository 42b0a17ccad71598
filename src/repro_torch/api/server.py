"""SenecaServer + Session: the public face of the cache/sampler service.

The seed exposed the paper's Figure-7 loop as :class:`SenecaService` with
raw ``job_id`` ints threaded through every call and pipelines poking
``svc.cache.parts[...]`` for admission.  This module keeps that engine
(same name, now policy-driven) and wraps it in a session facade::

    server = SenecaServer.for_dataset(ds, cache_frac=0.35)
    with server.open_session(batch_size=32) as sess:
        ids, forms = sess.next_batch_ids()
        ...
    print(server.stats())

Sessions own job registration/unregistration — opening one bumps the ODS
job count (and with it the refcount-eviction threshold), closing it drops
both — so the paper's headline many-jobs-one-cache scenario is just N
``open_session`` calls against one server.

Construction knobs (``SenecaConfig`` fields or ``SenecaServer`` kwargs):
``backend`` selects the ODS metadata engine ("numpy" on the host, or
"torch": the batch substitution of :mod:`repro_torch.core.ods_torch`
on the service's device), and ``sampler`` / ``admission`` /
``eviction`` select policies by registered name (see
:mod:`repro_torch.api.policies`).  ``device`` (``SenecaServer``/
``SenecaService`` kwarg) is where the HBM tier, the device executor and
the "torch" ODS engine run: ``None`` means CUDA, and ``"cpu"`` is how
tests opt out of the card.  ``shards`` / ``shard_transport`` split the
cache over the sharded data plane (:mod:`repro_torch.service`), whose
shards keep their HBM tiers on the same device.
:func:`state_from_reference` converts a job snapshot taken from the
reference package's service into this package's format.

``repartition`` selects how the cache split tracks the workload:
``"static"`` (construction-time MDP, the default), ``"on-change"``
(re-solve when sessions open/close) or ``"adaptive"`` (additionally
re-solve on telemetry-calibrated drift and resize the TieredCache live
— see :class:`RepartitionController` and docs/API.md).
"""
from __future__ import annotations

import copy
import itertools
import threading
import time
from dataclasses import dataclass, field, replace
from typing import Dict, Optional, Tuple

import numpy as np

from repro_torch.api.backends import (NO_REFCOUNT_EVICT, resolve_augment_backend,
                                resolve_backend)
from repro_torch.api.policies import resolve_policy
from repro_torch.api.telemetry import TelemetryAggregator
from repro_torch.cache.coalesce import ProductionTable
from repro_torch.cache.store import FORMS, TieredCache
from repro_torch.core import mdp
from repro_torch.core.ods import (AUGMENTED, DECODED, ENCODED, IN_STORAGE,
                            EpochSampler)
from repro_torch.core.perf_model import (AZURE_NC96, DEFAULT_DISK_BW,
                                         DEFAULT_HBM_BW, DatasetProfile,
                                         HardwareProfile, JobProfile,
                                         calibrate)
from repro_torch.kernels.device import resolve_device

__all__ = ["SenecaConfig", "SenecaService", "SenecaServer", "Session",
           "SessionClosed", "RepartitionController", "SLO", "FORM_CODE",
           "CODE_FORM", "state_from_reference"]


@dataclass(frozen=True)
class SLO:
    """Tail-latency service-level objective for open-loop serving.

    The open-loop admission controller
    (:class:`~repro_torch.workload.openloop.OpenLoopGenerator`) estimates
    each arriving request's queue wait as ``backlog x service-time EWMA /
    workers`` and compares it against ``p99_target_s``:

    * estimated wait > ``degrade_frac`` x target — skip augmentation
      (serve the decoded form);
    * estimated wait > ``encode_frac`` x target — serve the encoded
      form (skip decode *and* augment);
    * estimated wait > ``shed_frac`` x target, or the queue is at
      ``max_queue`` — shed the request outright.

    Degrading caps the *work* a request may buy, never the served
    quality of an already-cached form: a request degraded to encoded is
    still answered from the augmented cache partition when it hits.
    Every decision is counted (``shed`` / ``degraded``) and surfaced in
    ``stats()["telemetry"]["requests"]``.
    """

    p99_target_s: float
    max_queue: int = 256          # hard backlog bound (shed beyond it)
    degrade_frac: float = 0.5     # skip augment past this fraction
    encode_frac: float = 0.75     # serve encoded past this fraction
    shed_frac: float = 1.0        # shed past this fraction

    def __post_init__(self) -> None:
        if not self.p99_target_s > 0:
            raise ValueError(f"p99_target_s must be > 0, got "
                             f"{self.p99_target_s}")
        if self.max_queue < 1:
            raise ValueError(f"max_queue must be >= 1, got "
                             f"{self.max_queue}")
        if not (0 < self.degrade_frac <= self.encode_frac
                <= self.shed_frac):
            raise ValueError(
                f"expected 0 < degrade_frac <= encode_frac <= shed_frac, "
                f"got {self.degrade_frac}/{self.encode_frac}/"
                f"{self.shed_frac}")


REPARTITION_MODES = ("static", "on-change", "adaptive")

FORM_CODE = {"encoded": ENCODED, "decoded": DECODED, "augmented": AUGMENTED}
CODE_FORM = {v: k for k, v in FORM_CODE.items()}


class SessionClosed(RuntimeError):
    """Raised when a closed Session is asked to sample."""


@dataclass
class SenecaConfig:
    cache_bytes: int
    hardware: HardwareProfile
    dataset: DatasetProfile
    job: JobProfile = field(default_factory=JobProfile)
    partition_step: float = 0.01
    seed: int = 0
    use_ods: bool = True          # False -> MDP-only (paper's "MDP" bar)
    # manual override (x_e, x_d, x_a); None -> run MDP
    split: Optional[Tuple[float, float, float]] = None
    # facade knobs: ODS metadata engine + policies by registered name
    backend: str = "numpy"
    # batched augmentation engine for the stage-parallel pipeline executor
    # ("numpy" loop fallback | "cuda" hand-written kernel); the
    # per-sample executor keeps its inline augment_np path either way
    augment_backend: str = "numpy"
    sampler: Optional[str] = None      # None -> "ods" / "naive" per use_ods
    admission: Optional[str] = None    # None -> "unseen-only" / "capacity"
    eviction: Optional[str] = None     # None -> "refcount"
    # SSD spill tier: a directory + byte budget turn every partition
    # into a DRAM→disk chain (evictions demote, disk hits promote, the
    # MDP partitions form×tier).  Default off = single-tier behavior,
    # byte-identical to the pre-spill engine.
    spill_dir: Optional[str] = None
    spill_bytes: int = 0
    # manual disk split (y_e, y_d, y_a); None -> form×tier MDP (or the
    # DRAM split when that is manual too)
    spill_split: Optional[Tuple[float, float, float]] = None
    # device-resident cache tier: >0 puts an HBM level at the head of
    # every partition chain (array payloads device_put on insert, hot
    # DRAM hits promoted up, served zero-copy).  Default off =
    # two-level behavior, byte-identical to the pre-HBM engine.
    device_cache_bytes: int = 0
    # manual HBM split (z_e, z_d, z_a); None -> three-level MDP (or the
    # DRAM split when that is manual too)
    hbm_split: Optional[Tuple[float, float, float]] = None
    # live repartitioning (RepartitionController):
    #   "static"    — solve the MDP once at construction (seed behavior)
    #   "on-change" — re-solve when sessions open/close
    #   "adaptive"  — "on-change" + telemetry-calibrated drift ticks
    repartition: str = "static"
    repartition_drift: float = 0.15    # re-solve when calibrated prediction
    #                                    of the live split drifts this much
    repartition_gain: float = 0.05     # apply only if predicted gain clears
    repartition_cooldown: float = 1.0  # min seconds between adaptive ticks
    repartition_period: float = 0.0    # >0: background tick thread period
    telemetry_min_samples: int = 32    # per-signal floor for calibrate()
    # sharded data plane (src/repro_torch/service/): >1 splits the cache
    # across N shards behind a consistent-hash router.  "sim" keeps the
    # shards in-process (deterministic, VirtualClock-safe); "process"
    # gives each shard its own OS process (payloads move zero-copy via
    # codec files + np.memmap; its HBM tier in a CUDA context of its
    # own).  shards=1 + "sim" keeps the classic single TieredCache.
    shards: int = 1
    shard_transport: str = "sim"
    # tail-latency SLO for open-loop serving (docs/API.md "Open-loop
    # serving & SLOs"): None disables admission control — requests
    # queue unboundedly like the closed-loop path.  The
    # OpenLoopGenerator defaults to this when not given its own.
    slo: Optional[SLO] = None
    # concurrency layer (docs/API.md "Concurrency: coalescing & lock
    # striping").  lock_stripes>1 hash-stripes the TieredCache key
    # space over that many independent locks (single-process cache
    # only; shards already partition the key space).  coalesce=True
    # single-flights concurrent productions of the same (sample, form)
    # across every session of this service; coalesce_timeout_s bounds
    # a joiner's wall-clock wait before it falls back to producing.
    lock_stripes: int = 1
    coalesce: bool = True
    coalesce_timeout_s: float = 5.0


class RepartitionController:
    """Closes the loop between telemetry and the MDP split (§5.1/§5.3).

    The static pipeline is: solve the MDP once at construction and never
    look back.  This controller re-solves with a telemetry-**calibrated**
    hardware profile and resizes the live :class:`TieredCache` when it is
    predicted to pay off, with two layers of hysteresis against churn:

    * **re-solve gate** — adaptive ticks only re-run the (cached-grid)
      simplex pass when the calibrated model's prediction for the *live*
      split has drifted more than ``repartition_drift`` from the
      prediction recorded when that split was chosen (plus a
      ``repartition_cooldown`` floor between ticks).  Session open/close
      always re-solves ("on-change" + "adaptive" modes): that is the
      paper's concurrent-jobs trigger and costs <1s.
    * **apply gate** — a re-solved split is applied only when it differs
      from the live one and its predicted throughput clears
      ``repartition_gain`` over the live split's (both under the same
      calibrated profile).

    Steady telemetry therefore converges: the first qualifying re-solve
    re-baselines the drift reference, and subsequent ticks no-op.
    """

    MAX_EVENTS = 64

    def __init__(self, service: "SenecaService"):
        self.service = service
        cfg = service.cfg
        self.mode = cfg.repartition
        self._lock = threading.Lock()
        self._solver: Optional[mdp.IncrementalSolver] = None
        self._baseline: Optional[float] = None   # model view of live split
        self._last_tick = float("-inf")
        self.resolves = 0
        self.applied = 0
        self.skipped = 0
        self.events: list = []
        self._last_applied: Optional[dict] = None
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None
        if self.mode == "adaptive" and cfg.repartition_period > 0:
            self._thread = threading.Thread(
                target=self._run, name="seneca-repartition", daemon=True)
            self._thread.start()

    # -- plumbing ------------------------------------------------------
    @property
    def active(self) -> bool:
        return self.mode != "static" and not self._stop.is_set()

    def _run(self) -> None:
        period = self.service.cfg.repartition_period
        while not self._stop.wait(period):
            try:
                self.tick()
            except Exception:        # pragma: no cover - must never kill
                pass                 # the host process from a daemon tick

    def stop(self) -> None:
        """Deactivate: no further re-solves fire (session churn during
        server teardown must not resize a cache about to be dropped)."""
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=2.0)

    def _get_solver(self) -> mdp.IncrementalSolver:
        if self._solver is None:
            cfg = self.service.cfg
            self._solver = mdp.IncrementalSolver(cfg.dataset, cfg.job,
                                                 cfg.partition_step)
        return self._solver

    def _calibrated(self):
        return calibrate(self.service.hardware,
                         self.service.telemetry.snapshot(),
                         self.service.cfg.telemetry_min_samples)

    def _live_split(self):
        p = self.service.partition
        return (p.x_e, p.x_d, p.x_a)

    def _live_disk_split(self):
        p = self.service.disk_partition
        return (p.x_e, p.x_d, p.x_a) if p is not None else None

    def _live_hbm_split(self):
        p = self.service.hbm_partition
        return (p.x_e, p.x_d, p.x_a) if p is not None else None

    def _tiered(self) -> bool:
        return (self.service.disk_partition is not None
                or self.service.hbm_partition is not None)

    def _predict_live(self, solver, hw) -> float:
        if self._tiered():
            return solver.predict_tiered(hw, self._live_split(),
                                         self._live_disk_split()
                                         or (1.0, 0.0, 0.0),
                                         self._live_hbm_split())
        return solver.predict(hw, self._live_split())

    # -- triggers ------------------------------------------------------
    def on_sessions_changed(self) -> bool:
        """Session open/close: unconditional re-solve (apply still gated)."""
        if not self.active:
            return False
        with self._lock:
            return self._resolve_locked(self._calibrated(), "sessions")

    def _now(self) -> float:
        """Cooldown time source: the server's pluggable clock when one
        is configured (``SenecaService.set_clock``), else wall time.
        Gating the adaptive cadence on ``time.monotonic`` under a
        VirtualClock made the repartition rhythm depend on host CPU
        speed instead of trace time — a determinism leak."""
        clock = self.service.clock
        return time.monotonic() if clock is None else clock.now()

    def tick(self) -> bool:
        """Adaptive drift check; returns True when a resize was applied."""
        if self.mode != "adaptive" or self._stop.is_set():
            return False
        with self._lock:
            now = self._now()
            if now - self._last_tick < self.service.cfg.repartition_cooldown:
                return False
            self._last_tick = now
            hw = self._calibrated()
            solver = self._get_solver()
            pred_live = self._predict_live(solver, hw)
            if self._baseline is None or not np.isfinite(self._baseline):
                # manual-split servers carry throughput=NaN; anchor the
                # drift reference on the uncalibrated model's view
                base = self.service.partition.throughput
                self._baseline = base if np.isfinite(base) else \
                    self._predict_live(solver, self.service.hardware)
            drift = abs(pred_live - self._baseline) / max(self._baseline,
                                                          1e-12)
            if drift <= self.service.cfg.repartition_drift:
                return False
            return self._resolve_locked(hw, "drift", pred_live=pred_live)

    # -- the re-solve + hysteresis-gated apply -------------------------
    def _resolve_locked(self, hw, trigger: str,
                        pred_live: Optional[float] = None) -> bool:
        solver = self._get_solver()
        live = self._live_split()
        if pred_live is None:
            pred_live = self._predict_live(solver, hw)
        best_disk = best_hbm = None
        if self._tiered():
            # form×tier re-solve: all configured levels move together,
            # and the gain gate compares combined multi-level predictions
            tiered = solver.solve_tiered(hw)
            best, best_disk = tiered.dram, tiered.disk
            best_hbm = tiered.hbm
            best_thr, to_label = tiered.throughput, tiered.label
            changed = live != (best.x_e, best.x_d, best.x_a)
            if self.service.disk_partition is not None:
                changed = changed or (self._live_disk_split()
                                      != (best_disk.x_e, best_disk.x_d,
                                          best_disk.x_a))
            if best_hbm is not None:
                changed = changed or (self._live_hbm_split()
                                      != (best_hbm.x_e, best_hbm.x_d,
                                          best_hbm.x_a))
            parts = [self.service.partition.label]
            if self.service.hbm_partition is not None:
                parts.insert(0, self.service.hbm_partition.label)
            if self.service.disk_partition is not None:
                parts.append(self.service.disk_partition.label)
            from_label = "|".join(parts)
        else:
            best = solver.solve(hw)
            best_thr, to_label = best.throughput, best.label
            changed = (best.x_e, best.x_d, best.x_a) != live
            from_label = self.service.partition.label
        self.resolves += 1
        gain = (best_thr - pred_live) / max(pred_live, 1e-12)
        apply = changed and gain > self.service.cfg.repartition_gain
        event = {"trigger": trigger, "profile": hw.name,
                 "from": from_label, "to": to_label,
                 "predicted_gain": round(float(gain), 4),
                 "applied": bool(apply)}
        if apply:
            event["demoted"] = self.service.apply_partition(best, best_disk,
                                                            best_hbm)
            self.applied += 1
            self._baseline = best_thr
            self._last_applied = event
        else:
            self.skipped += 1
            self._baseline = pred_live
        self.events.append(event)
        del self.events[:-self.MAX_EVENTS]
        return apply

    def summary(self) -> Dict[str, object]:
        with self._lock:
            return {"mode": self.mode, "resolves": self.resolves,
                    "applied": self.applied, "skipped": self.skipped,
                    "partition": self.service.partition.label,
                    "last": dict(self.events[-1]) if self.events else None,
                    "last_applied": dict(self._last_applied)
                    if self._last_applied else None}


class SenecaService:
    """One shared dataset's cache + sampler engine (policy-driven).

    Prefer :class:`SenecaServer` / :class:`Session`; this class remains the
    synchronous engine underneath and the back-compat surface for the old
    ``register_job``/``job_id`` call style.
    """

    def __init__(self, cfg: SenecaConfig, *, backend=None, sampler=None,
                 admission=None, eviction=None, augment_backend=None,
                 device=None):
        self.cfg = cfg
        # where the HBM tier lives and the device executor runs
        self.device = resolve_device(device)
        if cfg.repartition not in REPARTITION_MODES:
            raise ValueError(f"unknown repartition mode "
                             f"{cfg.repartition!r}; expected one of "
                             f"{REPARTITION_MODES}")
        if cfg.shards < 1:
            raise ValueError(f"shards must be >= 1, got {cfg.shards}")
        # base profile with the *configured* cache size: the static solve,
        # and later every calibrated re-solve, all run against this
        self.hardware = cfg.hardware
        if self.hardware.s_cache != cfg.cache_bytes:
            self.hardware = replace(self.hardware,
                                    s_cache=float(cfg.cache_bytes))
        self.has_spill = bool(cfg.spill_dir) and cfg.spill_bytes > 0
        if self.has_spill:
            hw_over = {"s_disk": float(cfg.spill_bytes)}
            if self.hardware.b_disk <= 0:
                # local-SSD read-bandwidth prior until telemetry
                # calibrates the real rate (CALIBRATABLE includes b_disk)
                hw_over["b_disk"] = DEFAULT_DISK_BW
            self.hardware = replace(self.hardware, **hw_over)
        self.has_hbm = cfg.device_cache_bytes > 0
        if self.has_hbm:
            hw_over = {"s_hbm": float(cfg.device_cache_bytes)}
            if self.hardware.b_hbm <= 0:
                # host→device link-rate prior until the "h2d" telemetry
                # channel calibrates it (CALIBRATABLE includes b_hbm)
                hw_over["b_hbm"] = DEFAULT_HBM_BW
            self.hardware = replace(self.hardware, **hw_over)
        self.disk_partition: Optional[mdp.Partition] = None
        self.hbm_partition: Optional[mdp.Partition] = None
        if cfg.split is not None:
            self.partition = mdp.Partition(*cfg.split, throughput=float("nan"))
            if self.has_spill:
                self.disk_partition = mdp.Partition(
                    *(cfg.spill_split or cfg.split),
                    throughput=float("nan"))
            if self.has_hbm:
                self.hbm_partition = mdp.Partition(
                    *(cfg.hbm_split or cfg.split),
                    throughput=float("nan"))
        elif self.has_spill or self.has_hbm:
            tiered = mdp.optimize_tiered(self.hardware, cfg.dataset,
                                         cfg.job, cfg.partition_step)
            self.partition = tiered.dram
            if self.has_spill:
                self.disk_partition = mdp.Partition(
                    *(cfg.spill_split or (tiered.disk.x_e, tiered.disk.x_d,
                                          tiered.disk.x_a)),
                    throughput=tiered.throughput)
            if self.has_hbm:
                solved_hbm = tiered.hbm or tiered.dram
                self.hbm_partition = mdp.Partition(
                    *(cfg.hbm_split or (solved_hbm.x_e, solved_hbm.x_d,
                                        solved_hbm.x_a)),
                    throughput=tiered.throughput)
        else:
            self.partition = mdp.optimize(self.hardware, cfg.dataset,
                                          cfg.job, cfg.partition_step)
        self.sampler = resolve_policy(
            "sampler", sampler or cfg.sampler
            or ("ods" if cfg.use_ods else "naive"))
        self.admission = resolve_policy(
            "admission", admission or cfg.admission
            or ("unseen-only" if cfg.use_ods else "capacity"))
        self.eviction = resolve_policy(
            "eviction", eviction or cfg.eviction or "refcount")
        split_t = (self.partition.x_e, self.partition.x_d,
                   self.partition.x_a)
        spill_t = ((self.disk_partition.x_e, self.disk_partition.x_d,
                    self.disk_partition.x_a)
                   if self.disk_partition else None)
        hbm_t = ((self.hbm_partition.x_e, self.hbm_partition.x_d,
                  self.hbm_partition.x_a)
                 if self.hbm_partition else None)
        if cfg.shards > 1 or cfg.shard_transport != "sim":
            # lazy import: repro_torch.service must stay importable
            # without repro_torch.api (its shard module imports telemetry
            # lazily for the same reason) — a top-level import here
            # would cycle
            from repro_torch.service.client import ShardedCache
            self.cache = ShardedCache(
                cfg.cache_bytes, split_t,
                evict_policies=self.eviction.partition_policies(),
                spill_bytes=cfg.spill_bytes if self.has_spill else 0,
                spill_dir=cfg.spill_dir if self.has_spill else None,
                spill_split=spill_t,
                hbm_bytes=cfg.device_cache_bytes if self.has_hbm else 0,
                hbm_split=hbm_t,
                shards=cfg.shards, transport=cfg.shard_transport,
                seed=cfg.seed, admission=self.admission,
                hardware=self.hardware, dataset_profile=cfg.dataset,
                job=cfg.job, partition_step=cfg.partition_step,
                # a pinned split stays pinned on every shard; an MDP
                # split re-solves per shard over the 1/N view
                solve_per_shard=cfg.split is None,
                device=self.device)
        else:
            self.cache = TieredCache(
                cfg.cache_bytes, split_t,
                evict_policies=self.eviction.partition_policies(),
                spill_bytes=cfg.spill_bytes if self.has_spill else 0,
                spill_dir=cfg.spill_dir if self.has_spill else None,
                spill_split=spill_t,
                hbm_bytes=cfg.device_cache_bytes if self.has_hbm else 0,
                hbm_split=hbm_t,
                n_stripes=cfg.lock_stripes, device=self.device)
        try:
            self.backend = resolve_backend(backend or cfg.backend,
                                           cfg.dataset.n_total,
                                           seed=cfg.seed,
                                           device=self.device)
            self.augment = resolve_augment_backend(
                augment_backend or cfg.augment_backend)
            self.rng = np.random.default_rng(cfg.seed + 1)
            self._residency_version = -1     # force the first push
            self._samplers: Dict[int, EpochSampler] = {}
            self._lock = threading.Lock()
            self._refill_pending: list = []
            self._batch_counter = itertools.count()
            self.telemetry = TelemetryAggregator()
            # shared across every session/pipeline of this service —
            # that sharing IS the cross-job coalescing (the first
            # misser of a (sample, form) produces, the others join)
            self.production = ProductionTable(
                enabled=cfg.coalesce, timeout_s=cfg.coalesce_timeout_s)
            # pluggable time source (duck-typed Clock: .now()) for every
            # component that paces itself against trace time — the
            # adaptive repartition cooldown reads it, the WorkloadRunner
            # and OpenLoopGenerator install theirs (None = wall time)
            self.clock = None
            self.controller = RepartitionController(self)
        except BaseException:
            # close-after-failed-start: a half-built service must not
            # leak spill files or shard processes
            self.cache.close()
            raise

    # legacy alias: the engine's ODS metadata
    @property
    def ods(self):
        return getattr(self.backend, "state", self.backend)

    # ------------------------------------------------------------------
    def register_job(self, job_id: int, batch_size: int,
                     sampler=None) -> None:
        """Register a job.  ``sampler`` selects the request stream: None
        keeps the historical uniform :class:`EpochSampler`; a name from
        :data:`repro_torch.workload.samplers.REQUEST_SAMPLERS` ("zipfian",
        "phase-shift") or a ``(n, bs, seed) -> sampler`` callable swaps
        in skewed/shifting traffic for this job only."""
        seed = self.cfg.seed + 97 * (job_id + 1)
        if sampler is None:
            smp = EpochSampler(self.cfg.dataset.n_total, batch_size, seed)
        else:
            # lazy import: repro_torch.api must stay importable without
            # repro_torch.workload (which imports the pipeline layer)
            from repro_torch.workload.samplers import make_request_sampler
            smp = make_request_sampler(sampler, self.cfg.dataset.n_total,
                                       batch_size, seed)
        with self._lock:
            self.backend.register_job(job_id)
            self._samplers[job_id] = smp
        # outside the metadata lock: the controller's apply path takes it
        self.controller.on_sessions_changed()

    def unregister_job(self, job_id: int) -> None:
        with self._lock:
            self.backend.unregister_job(job_id)
            self._samplers.pop(job_id, None)
        self.controller.on_sessions_changed()

    # ------------------------------------------------------------------
    def next_batch_ids(self, job_id: int) -> Tuple[np.ndarray, np.ndarray]:
        """Sample a batch for ``job_id``.

        Returns (ids, forms): forms is the uint8 status of each id, i.e.
        which tier will serve it (0 = storage fetch).
        """
        # cost-aware eviction feedback: periodically push the latest
        # telemetry-measured per-form recompute costs into the cache's
        # "cost" tiers (no-op for policies without a refresh hook)
        refresh = getattr(self.eviction, "refresh", None)
        if refresh is not None and next(self._batch_counter) % 32 == 0:
            refresh(self.cache, self.telemetry.snapshot())
        with self._lock:
            if self.has_spill or self.has_hbm:
                # patch metadata for any keys the chains shed since the
                # last batch (spill overflow / promotion backfill / HBM
                # demotion), then give the sampler the current tier
                # levels so it can prefer device hits over DRAM hits
                # over disk hits over storage misses.  The O(N)
                # residency rebuild is version-gated: skipped whenever
                # no insert/evict/resize/promotion touched the cache
                # since the last push
                self._reconcile_evictions_locked()
                version = self.cache.version
                if version != self._residency_version:
                    self.backend.set_residency(
                        self.cache.residency_array(
                            self.cfg.dataset.n_total))
                    self._residency_version = version
            # deprioritize in-flight productions: when the coalescing
            # table has live flights, tell the sampler so substitution
            # and uncached fills prefer ids nobody is producing yet.
            # inflight_mask() is None whenever the table is idle — the
            # common case, and always with coalescing off — which keeps
            # the sampler on its byte-identical mask-free path
            set_inflight = getattr(self.backend, "set_inflight", None)
            if set_inflight is not None:
                set_inflight(self.production.inflight_mask(
                    self.cfg.dataset.n_total)
                    if self.production.enabled else None)
            requested = self._samplers[job_id].next_request()
            thr = self.eviction.threshold(self.backend)
            batch, evicted = self.sampler.sample(
                self.backend, job_id, requested,
                NO_REFCOUNT_EVICT if thr is None else thr)
            if len(evicted):
                for k in evicted:
                    self.cache.evict(int(k), "augmented")
                self._refill_pending.extend(int(k) for k in evicted)
            forms = self.backend.status_of(batch)
            return batch, forms

    # ------------------------------------------------------------------
    def admit(self, sample_id: int, form: str, value, nbytes: int) -> bool:
        """Policy-gated insert; updates ODS status on success.

        The metadata vote (``AdmissionPolicy.wants``) runs under the
        service lock, the capacity vote + insert run atomically under the
        cache lock (no check-then-act window between them).
        """
        # fast path for tiers the current split zeroes out (pipeline
        # workers admit every produced form on the hot path).  The
        # unlocked capacity read is safe: under "static" repartitioning
        # capacities never change, and a concurrent resize() at worst
        # costs this one admission — the next call re-reads.  With a
        # spill chain the disk level counts: a zero-DRAM form can still
        # cache on disk.
        if self.cache.total_capacity(form) == 0:
            return False
        with self._lock:
            if not self.admission.wants(self.backend, sample_id, form):
                return False
        ok = self.cache.insert_gated(sample_id, form, value, nbytes,
                                     self.admission)
        if ok:
            with self._lock:
                # under live repartitioning a resize may have evicted the
                # entry between the insert and this deferred mark; marking
                # anyway would leave phantom CACHED metadata.  Re-validate
                # residency inside the metadata lock (same metadata->cache
                # nesting as apply_partition's scan, so the two serialize).
                if self.controller.active:
                    ok = self.cache.contains(form, sample_id)
                if ok:
                    self.backend.mark_cached(np.asarray([sample_id]),
                                             FORM_CODE[form])
        if (self.has_spill or self.has_hbm) \
                and self.cache.has_pending_evicted():
            self.reconcile_evictions()
        return ok

    def admission_votes(self, form: str, ids) -> np.ndarray:
        """The metadata half of admission for many ids under one lock
        acquisition.  Lets producers skip building expensive values
        (e.g. copying augmented rows out of a batch array) for entries
        the policy would reject anyway; :meth:`admit_batch` re-votes, so
        a stale True here only costs the discarded value, never a wrong
        insert."""
        with self._lock:
            return np.asarray([self.admission.wants(self.backend, int(s),
                                                    form) for s in ids])

    def admit_batch(self, form: str, entries) -> np.ndarray:
        """Batch-granular :meth:`admit`: ``entries`` is a sequence of
        ``(sample_id, value, nbytes)``.

        Same two-phase policy gating and the same per-entry semantics as
        N ``admit`` calls, but with three lock acquisitions per batch
        instead of three per sample: one metadata acquisition for the
        ``wants`` votes, one cache acquisition for the capacity votes +
        inserts (:meth:`TieredCache.insert_batch_gated`), one metadata
        acquisition for the vectorized ``mark_cached``.  Returns one bool
        per entry (True = resident + marked).
        """
        entries = list(entries)
        ok = np.zeros(len(entries), bool)
        if not entries or self.cache.total_capacity(form) == 0:
            return ok
        with self._lock:
            wants = [self.admission.wants(self.backend, sid, form)
                     for sid, _, _ in entries]
        idx = [i for i, w in enumerate(wants) if w]
        if not idx:
            return ok
        inserted = self.cache.insert_batch_gated(
            form, [entries[i] for i in idx], self.admission)
        live = [i for i, ins in zip(idx, inserted) if ins]
        if not live:
            return ok
        with self._lock:
            if self.controller.active:
                # same residency re-validation as admit(): a concurrent
                # resize may have evicted entries between the insert and
                # this deferred mark (metadata->cache lock order)
                resident = self.cache.contains_many(
                    form, [entries[i][0] for i in live])
                live = [i for i, r in zip(live, resident) if r]
            if live:
                self.backend.mark_cached(
                    np.asarray([entries[i][0] for i in live]),
                    FORM_CODE[form])
        ok[live] = True
        if (self.has_spill or self.has_hbm) \
                and self.cache.has_pending_evicted():
            self.reconcile_evictions()
        return ok

    def refill_candidates(self, k: int) -> np.ndarray:
        """Background-refill picks: random storage-resident samples
        (paper step 5: evicted slots repopulate pseudo-randomly)."""
        with self._lock:
            pool = self.backend.storage_pool()
            if not len(pool):
                return pool
            return self.rng.choice(pool, size=min(k, len(pool)),
                                   replace=False)

    def take_refill_work(self, max_n: int = 64) -> np.ndarray:
        """Claim pending eviction slots and return fresh random samples to
        preprocess into them (the paper's background-refill thread body)."""
        with self._lock:
            n = min(len(self._refill_pending), max_n)
            if not n:
                return np.empty(0, np.int64)
            del self._refill_pending[:n]
        return self.refill_candidates(n)

    def lookup(self, sample_id: int):
        return self.cache.lookup(sample_id)

    def lookup_tiered(self, sample_id: int):
        """(form, value, tier) — tier is "hbm" | "dram" | "disk" |
        None, so the pipeline can report per-tier serve bandwidths (an
        "hbm" value is a device-resident tensor)."""
        return self.cache.lookup_tiered(sample_id)

    # ------------------------------------------------------------------
    def _remark_keys_locked(self, keys) -> Dict[str, int]:
        """Re-derive ODS status for ``keys`` from actual chain residency
        (most-processed form still holding a copy, or IN_STORAGE).
        Caller holds the metadata lock; the scan takes the cache lock
        nested inside (the service's standard metadata->cache order)."""
        remarked: Dict[str, int] = {}
        regrouped: Dict[Optional[str], list] = {}
        for k, form in zip(keys, self.cache.serving_forms(keys)):
            regrouped.setdefault(form, []).append(k)
        for form, ids in regrouped.items():
            arr = np.asarray(ids, np.int64)
            if form is None:
                self.backend.mark_evicted(arr)
            else:
                self.backend.mark_cached(arr, FORM_CODE[form])
            remarked[form or "storage"] = len(ids)
        return remarked

    def _reconcile_evictions_locked(self) -> Dict[str, int]:
        keys = self.cache.take_evicted()
        if not keys:
            return {}
        return self._remark_keys_locked(sorted(set(keys)))

    def reconcile_evictions(self) -> Dict[str, int]:
        """Patch ODS metadata for keys the tier chains evicted as a side
        effect of serving (spill overflow making room, promotions
        backfilling DRAM, device demotions).  Runs automatically per
        batch and per admit; public for tests and direct-engine
        users."""
        if not (self.has_spill or self.has_hbm):
            return {}
        with self._lock:
            return self._reconcile_evictions_locked()

    def apply_partition(self, partition: mdp.Partition,
                        disk_partition: Optional[mdp.Partition] = None,
                        hbm_partition: Optional[mdp.Partition] = None
                        ) -> Dict[str, int]:
        """Resize the live cache to ``partition`` (and, when configured,
        its disk level to ``disk_partition`` and device level to
        ``hbm_partition``) and patch ODS metadata.

        Keys evicted by shrinking partitions are *demoted*: DRAM
        shrink evictions spill to disk where one exists, and each
        key's status falls back to the most-processed form still
        resident anywhere in its chain, or to IN_STORAGE when nothing
        remains.  The residency scan + metadata patch run under the
        metadata lock (cache lock nested inside, the same
        metadata->cache order ``next_batch_ids`` uses): a concurrent
        ``admit`` marks its status under this lock *after* its insert,
        so the scan either sees the insert or is serialized before the
        re-mark — no stale IN_STORAGE can overwrite a live admission.
        """
        spill_split = None
        if disk_partition is not None and self.has_spill:
            spill_split = (disk_partition.x_e, disk_partition.x_d,
                           disk_partition.x_a)
        elif self.has_spill and self.disk_partition is not None:
            spill_split = (self.disk_partition.x_e,
                           self.disk_partition.x_d,
                           self.disk_partition.x_a)
        hbm_split = None
        if hbm_partition is not None and self.has_hbm:
            hbm_split = (hbm_partition.x_e, hbm_partition.x_d,
                         hbm_partition.x_a)
        elif self.has_hbm and self.hbm_partition is not None:
            hbm_split = (self.hbm_partition.x_e, self.hbm_partition.x_d,
                         self.hbm_partition.x_a)
        evicted = self.cache.resize(
            (partition.x_e, partition.x_d, partition.x_a),
            spill_split=spill_split, hbm_split=hbm_split)
        self.partition = partition
        if disk_partition is not None and self.has_spill:
            self.disk_partition = disk_partition
        if hbm_partition is not None and self.has_hbm:
            self.hbm_partition = hbm_partition
        keys = set().union(*evicted.values()) if evicted else set()
        keys.update(self.cache.take_evicted())
        if not keys:
            return {}
        with self._lock:
            return self._remark_keys_locked(sorted(keys))

    def set_clock(self, clock) -> None:
        """Install a pluggable time source (anything with ``.now()``;
        ``None`` restores wall time).  Under a
        :class:`~repro_torch.workload.clock.VirtualClock` this makes the
        adaptive repartition cooldown count *trace* seconds, so the
        repartition cadence is deterministic instead of tracking host
        CPU speed."""
        self.clock = clock

    def maybe_repartition(self) -> bool:
        """Adaptive-mode tick: cheap no-op unless telemetry-calibrated
        drift warrants a re-solve AND the predicted gain clears the
        hysteresis threshold.  Safe to call from pipeline threads."""
        return self.controller.tick()

    def tier_capacity(self, form: str) -> int:
        """Whole-chain capacity for ``form`` (DRAM + spill): the gate
        pipelines use to decide whether producing/refilling a form can
        possibly land anywhere — must match ``admit``'s own
        total_capacity fast path, or a disk-only form never refills."""
        return self.cache.total_capacity(form)

    def tier_free_bytes(self, form: str) -> int:
        """Whole-chain free bytes for ``form`` (refill top-up sizing)."""
        return self.cache.chain_free_bytes(form)

    # ------------------------------------------------------------------
    def checkpoint_job(self, job_id: int) -> Dict:
        """Epoch-consistent snapshot of one job's sampling state: the
        backend's seen-mask/epoch/served plus the job's EpochSampler
        position (permutation, offset, RNG).  Restoring into a fresh
        session continues exactly-once-per-epoch coverage with zero
        re-preprocessing of already-consumed samples."""
        with self._lock:
            if job_id not in self._samplers:
                raise KeyError(f"job {job_id} is not registered")
            return {
                "format": 1,
                "n_samples": self.cfg.dataset.n_total,
                "batch_size": self._samplers[job_id].bs,
                "backend": self.backend.checkpoint_job(job_id),
                "sampler": self._samplers[job_id].state_dict(),
            }

    def restore_job(self, job_id: int, snap: Dict) -> None:
        """Install a :meth:`checkpoint_job` snapshot on ``job_id`` (a
        re-admitted job's fresh session id is fine — the snapshot fully
        overwrites the new registration's sampler and seen state)."""
        if snap.get("format") != 1:
            raise ValueError(f"unknown snapshot format "
                             f"{snap.get('format')!r}")
        if int(snap["n_samples"]) != self.cfg.dataset.n_total:
            raise ValueError(
                f"snapshot is for a {snap['n_samples']}-sample dataset, "
                f"this service has {self.cfg.dataset.n_total}")
        with self._lock:
            if job_id not in self._samplers:
                raise KeyError(f"job {job_id} is not registered")
            if int(snap["batch_size"]) != self._samplers[job_id].bs:
                raise ValueError(
                    f"snapshot batch_size {snap['batch_size']} != session "
                    f"batch_size {self._samplers[job_id].bs}")
            self._samplers[job_id].load_state_dict(snap["sampler"])
            self.backend.restore_job(job_id, snap["backend"])

    # ------------------------------------------------------------------
    def fail_shard(self, shard: int) -> None:
        """A cache shard died: fail its key range over to storage.

        The shard transport is killed (subsequent per-shard ops degrade
        to misses/drops in the client), and every sample the ring maps
        to the dead shard is re-marked IN_STORAGE so the sampler stops
        treating it as cached; the residency push is invalidated so the
        next batch sees the shrunk ring."""
        kill = getattr(self.cache, "kill_shard", None)
        if kill is None:
            raise ValueError("fail_shard needs a sharded data plane "
                             "(SenecaConfig(shards=N))")
        kill(shard)
        with self._lock:
            n = self.cfg.dataset.n_total
            owned = np.flatnonzero(
                self.cache.router.shard_of_many(np.arange(n)) == shard)
            if len(owned):
                self.backend.mark_evicted(owned)
            self._residency_version = -1
        self.telemetry.record_error("fault.shard-kill")

    def restore_shard(self, shard: int) -> None:
        """Bring a killed shard back (cold: its cache is empty); the
        ring re-expands and admissions repopulate it organically."""
        restart = getattr(self.cache, "restart_shard", None)
        if restart is None:
            raise ValueError("restore_shard needs a sharded data plane "
                             "(SenecaConfig(shards=N))")
        restart(shard)
        with self._lock:
            self._residency_version = -1
        self.telemetry.record_error("recovery.shard-restart")

    # ------------------------------------------------------------------
    def close(self) -> None:
        """Tear down the engine's storage: drops every spill-tier file
        (idempotent; serving after close() re-creates nothing)."""
        self.cache.close()

    def stats(self) -> Dict[str, float]:
        tiers = np.bincount(
            self.cache.status_array(self.cfg.dataset.n_total), minlength=4)
        out = self._spill_stats()
        out.update({
            "partition": self.partition.label,
            "predicted_throughput": self.partition.throughput,
            "backend": self.backend.name,
            "augment_backend": self.augment.name,
            "refill_errors": self.telemetry.error_count("refill"),
            "policies": {"sampler": self.sampler.name,
                         "admission": self.admission.name,
                         "eviction": self.eviction.name},
            "ods_hit_rate": self.backend.hit_rate(),
            "hits": self.backend.hits,
            "misses": self.backend.misses,
            "substitutions": self.backend.substitutions,
            "cache_bytes_used": self.cache.bytes_used(),
            "cache_lookup_hit_rate": self.cache.hit_rate(),
            "tier_counts": {form: int(tiers[FORM_CODE[form]])
                            for form in FORMS},
            "metadata_bytes": self.backend.metadata_bytes(),
            "repartitions": self.controller.summary(),
            "telemetry": self.telemetry.as_dict(),
        })
        shard_stats = getattr(self.cache, "shard_stats", None)
        if shard_stats is not None:
            out["shards"] = shard_stats()
            prod_stats = getattr(self.cache, "production_stats", None)
            if prod_stats is not None:
                sp = prod_stats()
                if sp["led"] or sp["duplicates"]:
                    out["shard_production"] = sp
        # additive: the single-flight table's counters appear only once
        # it has seen traffic, so idle payloads keep their shape
        prod = self.production.stats()
        if prod["led"] or prod["duplicates"]:
            out["production"] = prod
        errors = self.telemetry.as_dict().get("errors", {})
        fault_counts = {k: v for k, v in errors.items()
                        if k.startswith(("fault.", "recovery."))}
        if fault_counts or getattr(self.cache, "failovers", 0):
            out["faults"] = {
                "counts": fault_counts,
                "injected": sum(v for k, v in fault_counts.items()
                                if k.startswith("fault.")),
                "recovered": sum(v for k, v in fault_counts.items()
                                 if k.startswith("recovery.")),
                "shard_failovers": int(getattr(self.cache,
                                               "failovers", 0)),
            }
        return out

    def _spill_stats(self) -> Dict[str, object]:
        """Additive spill/device-tier keys (empty dict without either
        tier so single-tier stats() payloads stay byte-identical; the
        "hbm" residency count and the hbm block only appear when a
        device tier is configured, so spill-only payloads keep their
        historical shape too)."""
        if not (self.has_spill or self.has_hbm):
            return {}
        res = self.cache.residency_array(self.cfg.dataset.n_total)
        counts = np.bincount(res, minlength=4)
        residency = {"storage": int(counts[0]), "disk": int(counts[1]),
                     "dram": int(counts[2])}
        if self.has_hbm:
            residency["hbm"] = int(counts[3])
        out: Dict[str, object] = {}
        if self.has_spill:
            out.update({
                "disk_partition": self.disk_partition.label
                if self.disk_partition else None,
                "disk_bytes_used": self.cache.disk_bytes_used(),
                "spill": self.cache.spill_stats(),
            })
        out["residency_counts"] = residency
        if self.has_hbm:
            out["hbm_partition"] = (self.hbm_partition.label
                                    if self.hbm_partition else None)
            out["hbm_bytes_used"] = self.cache.hbm_bytes_used()
            out["hbm"] = self.cache.hbm_stats()
        return out


class Session:
    """One training job's handle on a shared SenecaServer.

    Owns the job registration: constructing (via ``open_session``) bumps
    the server's ODS job count, ``close()`` (or leaving the ``with`` block)
    drops it — which also lowers the refcount-eviction threshold for the
    remaining sessions.
    """

    def __init__(self, service: SenecaService, job_id: int,
                 batch_size: int, on_close=None):
        self.service = service
        self.job_id = job_id
        self.batch_size = batch_size
        self._on_close = on_close
        self._closed = False

    # ------------------------------------------------------------------
    @property
    def closed(self) -> bool:
        return self._closed

    @property
    def epoch(self) -> int:
        return self.service.backend.epoch_of(self.job_id)

    def next_batch_ids(self) -> Tuple[np.ndarray, np.ndarray]:
        if self._closed:
            raise SessionClosed(
                f"session {self.job_id} is closed; open a new one with "
                f"SenecaServer.open_session()")
        return self.service.next_batch_ids(self.job_id)

    def admit(self, sample_id: int, form: str, value, nbytes: int) -> bool:
        # in-flight pipeline workers may race a close(); drop their
        # admissions instead of corrupting the unregistered job's metadata
        if self._closed:
            return False
        return self.service.admit(sample_id, form, value, nbytes)

    def admit_batch(self, form: str, entries) -> np.ndarray:
        """Batch-granular admit (see :meth:`SenecaService.admit_batch`);
        closed sessions drop the whole batch, mirroring :meth:`admit`."""
        if self._closed:
            return np.zeros(len(list(entries)), bool)
        return self.service.admit_batch(form, entries)

    def lookup(self, sample_id: int):
        return self.service.lookup(sample_id)

    def lookup_tiered(self, sample_id: int):
        return self.service.lookup_tiered(sample_id)

    def checkpoint_state(self) -> Dict:
        """Snapshot this job's sampler state (seen-mask, epoch, served
        count, permutation + RNG position).  A preempted job restores it
        into a *new* session via :meth:`restore_state` and keeps
        exactly-once-per-epoch coverage with zero re-preprocessing."""
        if self._closed:
            raise SessionClosed(
                f"session {self.job_id} is closed; snapshot before close")
        return self.service.checkpoint_job(self.job_id)

    def restore_state(self, state: Dict) -> None:
        """Install a :meth:`checkpoint_state` snapshot (same dataset and
        batch size required; the session id may differ)."""
        if self._closed:
            raise SessionClosed(
                f"session {self.job_id} is closed; open a new one with "
                f"SenecaServer.open_session()")
        self.service.restore_job(self.job_id, state)

    def stats(self) -> Dict[str, float]:
        out = self.service.stats()
        out["session"] = {"job_id": self.job_id, "epoch": self.epoch,
                          "batch_size": self.batch_size,
                          "closed": self._closed}
        return out

    def close(self) -> None:
        if self._closed:
            return
        self._closed = True
        self.service.unregister_job(self.job_id)
        if self._on_close is not None:
            self._on_close(self)

    # ------------------------------------------------------------------
    def __enter__(self) -> "Session":
        return self

    def __exit__(self, *exc) -> None:
        self.close()


class SenecaServer:
    """Facade handing out Sessions over one shared cache+sampler service."""

    def __init__(self, cfg: SenecaConfig = None, *, backend=None,
                 sampler=None, admission=None, eviction=None,
                 augment_backend=None,
                 service: Optional[SenecaService] = None, device=None):
        if service is None:
            if cfg is None:
                raise ValueError("SenecaServer needs a SenecaConfig "
                                 "(or an existing service=)")
            service = SenecaService(cfg, backend=backend, sampler=sampler,
                                    admission=admission, eviction=eviction,
                                    augment_backend=augment_backend,
                                    device=device)
        self.service = service
        self._ids = itertools.count()
        self._sessions: Dict[int, Session] = {}
        self._lock = threading.Lock()
        self._closed = False

    # ------------------------------------------------------------------
    @classmethod
    def for_dataset(cls, ds, cache_bytes: Optional[int] = None,
                    cache_frac: float = 0.4,
                    hardware: HardwareProfile = AZURE_NC96, device=None,
                    **cfg_kwargs) -> "SenecaServer":
        """Build a server for a :mod:`repro_torch.data.synthetic`-style
        dataset (anything with n_samples / mean_encoded_bytes /
        decoded_bytes() / augmented_bytes()), sizing the cache as a
        fraction of the fully-augmented dataset unless ``cache_bytes`` is
        given.  ``device`` as for :class:`SenecaServer`."""
        profile = DatasetProfile(ds.name, ds.n_samples,
                                 ds.mean_encoded_bytes,
                                 decoded_bytes=ds.decoded_bytes(),
                                 augmented_bytes=ds.augmented_bytes())
        if cache_bytes is None:
            cache_bytes = int(cache_frac * ds.n_samples
                              * ds.augmented_bytes())
        return cls(SenecaConfig(cache_bytes=cache_bytes, hardware=hardware,
                                dataset=profile, **cfg_kwargs),
                   device=device)

    # ------------------------------------------------------------------
    def open_session(self, batch_size: int, sampler=None) -> Session:
        """Open a job session.  ``sampler`` (None | "zipfian" |
        "phase-shift" | callable) picks this job's request stream — see
        :meth:`SenecaService.register_job`."""
        with self._lock:
            job_id = next(self._ids)
            self.service.register_job(job_id, batch_size,
                                      sampler=sampler)
            sess = Session(self.service, job_id, batch_size,
                           on_close=self._forget)
            self._sessions[job_id] = sess
            return sess

    def _forget(self, sess: Session) -> None:
        with self._lock:
            self._sessions.pop(sess.job_id, None)

    @property
    def n_sessions(self) -> int:
        with self._lock:
            return len(self._sessions)

    @property
    def partition(self):
        return self.service.partition

    def maybe_repartition(self) -> bool:
        """Explicit adaptive tick (see :class:`RepartitionController`);
        the alternative to the ``repartition_period`` background thread."""
        return self.service.maybe_repartition()

    def run_workload(self, trace, storage, *, clock=None,
                     timeout: Optional[float] = None,
                     raise_on_error: bool = True, **runner_kwargs):
        """Run a multi-job trace against this server's shared cache and
        return the :class:`~repro_torch.workload.runner.WorkloadResult`.

        Convenience over
        :class:`~repro_torch.workload.runner.WorkloadRunner` (which see
        for ``clock=``/``record_ids=``/``seed=`` knobs and the
        deterministic VirtualClock contract); ``timeout`` /
        ``raise_on_error`` are forwarded to
        :meth:`~repro_torch.workload.runner.WorkloadRunner.run`.  Each
        job in ``trace`` opens its own session, so arrivals/departures
        drive the :class:`RepartitionController` exactly like
        hand-opened ones.
        """
        from repro_torch.workload.runner import WorkloadRunner
        runner = WorkloadRunner(self, storage, clock=clock,
                                **runner_kwargs)
        return runner.run(trace, timeout=timeout,
                          raise_on_error=raise_on_error)

    def stats(self) -> Dict[str, float]:
        out = self.service.stats()
        out["n_sessions"] = self.n_sessions
        return out

    def close(self) -> None:
        with self._lock:
            if self._closed:
                return
            self._closed = True
        # stop the controller first: the session-close cascade must not
        # trigger re-solves/resizes of a cache that is being torn down
        self.service.controller.stop()
        with self._lock:
            live = list(self._sessions.values())
        try:
            for sess in live:
                sess.close()
        finally:
            # last: drop the spill tier's files (no-leaked-files contract)
            self.service.close()

    # ------------------------------------------------------------------
    def __enter__(self) -> "SenecaServer":
        return self

    def __exit__(self, *exc) -> None:
        self.close()


def state_from_reference(snap: Dict) -> Dict:
    """A job snapshot from the reference package's
    ``SenecaService.checkpoint_job`` (numpy ODS backend) -> this
    package's format, for :meth:`Session.restore_state`.

    The snapshot is plain numpy arrays, ints and the numpy bit
    generators' state dicts (seen mask, epoch, served count, sampler
    permutation, position and RNG), so the conversion copies each field
    into fresh objects and checks that nothing is missing; the restored
    session then continues with the same next-batch ids.  A snapshot of
    the reference's JAX ODS backend carries a JAX PRNG key instead and
    is refused.
    """
    if snap.get("format") != 1:
        raise ValueError(f"unknown snapshot format {snap.get('format')!r}")
    backend, sampler = snap["backend"], snap["sampler"]
    missing = ({"n_samples", "seen", "epoch", "served"} - set(backend)) \
        | ({"n", "bs", "perm", "pos", "rng_state"} - set(sampler))
    if missing:
        raise ValueError(f"snapshot lacks {sorted(missing)}; only the "
                         f"numpy ODS backend's snapshots convert")
    return {
        "format": 1,
        "n_samples": int(snap["n_samples"]),
        "batch_size": int(snap["batch_size"]),
        "backend": {
            "n_samples": int(backend["n_samples"]),
            "seen": np.array(backend["seen"], np.uint8),
            "epoch": int(backend["epoch"]),
            "served": int(backend["served"]),
        },
        "sampler": {
            "n": int(sampler["n"]),
            "bs": int(sampler["bs"]),
            "perm": np.array(sampler["perm"]),
            "pos": int(sampler["pos"]),
            "rng_state": copy.deepcopy(sampler["rng_state"]),
        },
    }
