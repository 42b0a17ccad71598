"""Live multi-job workload runner over one (or many) SenecaServer(s).

The paper's headline result — concurrent jobs sharing one Seneca cache
finish *faster* than jobs on private caches — is what this module runs,
live (the port's twin of ``repro.workload.runner``): a
:class:`WorkloadRunner` admits a trace of :class:`JobSpec`\\ s (arrival
time, epochs, batch size, GPU ingest rate) against a live
:class:`~repro_torch.api.server.SenecaServer`, running each job's
:class:`~repro_torch.data.pipeline.DSIPipeline` on its own thread with a
rate-limited consumer emulating GPU ingest (the pipeline's
``consume_hook``), per-job epoch/makespan accounting and graceful
join/cancel.  Session arrival/departure flows through
``SenecaServer.open_session`` / ``Session.close`` and therefore triggers
the :class:`~repro_torch.api.server.RepartitionController` exactly as any
other client would.

Determinism: pass ``clock=VirtualClock()`` and the runner serializes the
job threads through the clock's turn discipline (one participant runs at
a time, released in ``(wake_time, ticket)`` order) and pins each job to
the per-sample executor with one worker and synchronous refills — two
runs of the same trace then produce byte-identical per-job sample-id
sequences and identical makespans, which is what keeps the concurrency
tests non-flaky.  The runner installs its clock on the shared service
(adaptive-repartition cooldowns tick in trace time) and binds each job
thread's participant ticket on the clock, so a clock-aware
``RemoteStorage(ds, bandwidth, clock=clock)`` charges storage stalls as
*virtual* time on the job's own turn — bandwidth then shapes virtual
makespans exactly as it would wall ones.

Shared vs private: construct with ``server=`` for the paper's
many-jobs-one-cache scenario, or ``server_factory=`` to give every job
its own private server (the baseline side of the reference's
``benchmarks/fig_live_makespan.py``).

Devices: with ``JobSpec(executor="device")`` each job's pipeline runs
the fused decode+augment kernel on the server's device; such jobs need a
real clock (the VirtualClock rule below admits only the per-sample
executor).
"""
from __future__ import annotations

import logging
import math
import threading
from dataclasses import dataclass, field
from typing import (TYPE_CHECKING, Callable, Dict, List, Optional,
                    Sequence)

from repro_torch.data.pipeline import DSIPipeline, EXECUTORS
from repro_torch.data.storage import RemoteStorage
from repro_torch.faults.injector import FaultInjector
from repro_torch.faults.spec import FaultSpec
from repro_torch.workload.clock import Clock, RealClock, VirtualClock

if TYPE_CHECKING:                      # runtime import is deferred: the
    from repro_torch.api.server import SenecaServer   # api package re-exports
                                       # workload names, so a module-level
                                       # import here would be circular

log = logging.getLogger(__name__)

__all__ = ["JobSpec", "JobResult", "WorkloadResult", "WorkloadRunner"]


@dataclass(frozen=True)
class JobSpec:
    """One training job in a workload trace."""

    name: str
    arrival_s: float = 0.0       # trace time the job enters the system
    epochs: int = 1              # full dataset passes to consume
    batch_size: int = 32
    gpu_rate: float = math.inf   # samples/s the emulated GPU ingests
    executor: str = "per-sample"  # DSIPipeline executor
    n_workers: int = 2           # pipeline workers (1 under VirtualClock)
    max_batches: Optional[int] = None   # optional cap below epochs*N/B
    # request-stream shape: None = uniform epoch permutation (the
    # historical default); "zipfian" / "phase-shift" (or any name in
    # repro_torch.workload.samplers.REQUEST_SAMPLERS) = skewed/shifting
    # traffic for this job only
    sampler: Optional[str] = None

    def __post_init__(self) -> None:
        if self.epochs < 1:
            raise ValueError(f"job {self.name!r}: epochs must be >= 1")
        if self.batch_size < 1:
            raise ValueError(f"job {self.name!r}: batch_size must be >= 1")
        if not self.gpu_rate > 0:
            raise ValueError(f"job {self.name!r}: gpu_rate must be > 0")
        if self.arrival_s < 0:
            raise ValueError(f"job {self.name!r}: arrival_s must be >= 0")
        if self.executor not in EXECUTORS:
            # fail at spec construction, not inside a job thread after
            # the session has already been opened on the shared server
            raise ValueError(f"job {self.name!r}: unknown executor "
                             f"{self.executor!r}; expected one of "
                             f"{EXECUTORS}")
        if self.sampler is not None:
            from repro_torch.workload.samplers import REQUEST_SAMPLERS
            if self.sampler not in REQUEST_SAMPLERS:
                raise ValueError(
                    f"job {self.name!r}: unknown sampler "
                    f"{self.sampler!r}; expected one of "
                    f"{tuple(sorted(REQUEST_SAMPLERS))}")


@dataclass
class JobResult:
    """Per-job accounting (all times relative to the run's t0)."""

    spec: JobSpec
    job_id: Optional[int] = None     # session job id (shared-server runs)
    start_s: float = 0.0             # first moment the job ran (>= arrival)
    end_s: float = 0.0               # after its last batch's ingest pacing
    samples: int = 0
    batches: int = 0
    epoch_ends: List[float] = field(default_factory=list)
    sample_ids: List[int] = field(default_factory=list)  # slot order
    error: Optional[str] = None
    cancelled: bool = False
    stats: Optional[Dict] = None     # private-server runs: stats at close
    preemptions: int = 0             # injected preempt + re-admission count
    worker_restarts: int = 0         # injected worker-crash recoveries

    @property
    def duration_s(self) -> float:
        return self.end_s - self.start_s

    @property
    def epochs_completed(self) -> int:
        return len(self.epoch_ends)

    @property
    def ok(self) -> bool:
        return self.error is None and not self.cancelled


@dataclass
class WorkloadResult:
    """Outcome of one :meth:`WorkloadRunner.run` call."""

    jobs: List[JobResult]
    makespan: float                  # max job end (trace time, from t0)
    clock: str                       # clock name ("real" | "virtual")
    wall_s: float                    # host seconds the run() call took
    stats: Optional[Dict] = None     # shared server stats at quiesce
    timed_out: bool = False          # run(timeout=) expired, jobs cut short

    @property
    def shard_stats(self) -> Optional[List[Dict]]:
        """Per-shard cache stats when the server ran a sharded data
        plane (``SenecaConfig(shards=N)``), else None."""
        return (self.stats or {}).get("shards")

    @property
    def total_samples(self) -> int:
        return sum(j.samples for j in self.jobs)

    @property
    def ok(self) -> bool:
        return all(j.ok for j in self.jobs)

    def job(self, name: str) -> JobResult:
        for j in self.jobs:
            if j.spec.name == name:
                return j
        raise KeyError(name)


class _IngestPacer:
    """Rate-limited consumer emulating GPU ingest, installed as the
    pipeline's ``consume_hook``: every produced batch charges
    ``batch_size / gpu_rate`` seconds on the workload clock before the
    job asks for the next one.  Under a :class:`VirtualClock` this is
    also the job's scheduling point — even an infinite-rate job yields
    its turn here once per batch."""

    def __init__(self, clock: Clock, ticket: int, rate: float,
                 start_at: float, interrupt: threading.Event):
        self.clock = clock
        self.ticket = ticket
        self.rate = rate
        self.now = start_at          # the job's own clock position
        self._interrupt = interrupt

    def __call__(self, batch) -> None:
        dt = len(batch["ids"]) / self.rate if math.isfinite(self.rate) \
            else 0.0
        self.now = self.clock.sleep_until(self.ticket, self.now + dt,
                                          interrupt=self._interrupt)


class WorkloadRunner:
    """Admit a trace of jobs against live Seneca server(s) and account
    per-job epochs + workload makespan.

    Exactly one of ``server`` (shared cache — the paper's scenario) or
    ``server_factory`` (a private server per job — the baseline) must be
    given.  ``storage`` is shared by every job either way, so both modes
    contend for the same token-bucket bandwidth.
    """

    def __init__(self, server: Optional[SenecaServer] = None,
                 storage: Optional[RemoteStorage] = None, *,
                 server_factory: Optional[
                     Callable[[JobSpec], SenecaServer]] = None,
                 clock: Optional[Clock] = None,
                 record_ids: bool = True,
                 seed: int = 0,
                 faults: Optional[Sequence[FaultSpec]] = None,
                 fault_policy: str = "checkpoint"):
        if (server is None) == (server_factory is None):
            raise ValueError("WorkloadRunner needs exactly one of server= "
                             "(shared cache) or server_factory= (private "
                             "per-job caches)")
        if storage is None:
            raise TypeError("WorkloadRunner needs a shared RemoteStorage")
        if fault_policy not in ("checkpoint", "restart"):
            raise ValueError("fault_policy must be 'checkpoint' (snapshot "
                             "sampler state, restore on re-admission) or "
                             "'restart' (naive: lose all progress), got "
                             f"{fault_policy!r}")
        self.server = server
        self.server_factory = server_factory
        self.storage = storage
        self.clock = clock or RealClock()
        self.record_ids = record_ids
        self.seed = seed
        self.faults = list(faults) if faults else []
        self.fault_policy = fault_policy
        self._injector: Optional[FaultInjector] = None
        self._stop = threading.Event()
        if isinstance(self.clock, VirtualClock) and server is not None:
            # determinism only holds for in-process shards: the sim
            # transport runs shard calls synchronously on the calling
            # job's turn, while process shards answer on OS scheduling
            transport = getattr(server.service.cache, "transport_name", "sim")
            if transport != "sim":
                raise ValueError(
                    "deterministic VirtualClock runs require the 'sim' "
                    f"shard transport, not {transport!r} (process shards "
                    "reply on wall-clock OS scheduling)")

    # ------------------------------------------------------------------
    def cancel(self) -> None:
        """Ask every job thread to stop after its current batch; virtual
        clock sleeps are interrupted too, so ``run()`` unblocks."""
        self._stop.set()

    # ------------------------------------------------------------------
    def run(self, trace: Sequence[JobSpec], *,
            timeout: Optional[float] = None,
            raise_on_error: bool = True) -> WorkloadResult:
        """Run the trace to completion (or cancellation) and join.

        ``timeout`` bounds the host-time wait for the whole workload;
        on expiry the remaining jobs are cancelled and joined.  With
        ``raise_on_error`` (default) a job-thread failure raises after
        every thread has been joined; otherwise it is reported in the
        corresponding :class:`JobResult.error`.
        """
        trace = list(trace)
        if not trace:
            raise ValueError("empty workload trace")
        names = [s.name for s in trace]
        if len(set(names)) != len(names):
            raise ValueError(f"duplicate job names in trace: {names}")
        deterministic = self.clock.deterministic
        if deterministic:
            bad = [s.name for s in trace if s.executor != "per-sample"]
            if bad:
                raise ValueError(
                    f"virtual-clock runs require executor='per-sample' "
                    f"(jobs {bad} use the stage-parallel executor, whose "
                    f"free-running stage threads would race past the "
                    f"clock's turn discipline)")
        if self.faults:
            bad_jobs = [f.job for f in self.faults
                        if f.job is not None and f.job not in names]
            if bad_jobs:
                raise ValueError(f"fault trace targets unknown jobs "
                                 f"{bad_jobs}; trace has {names}")
            if any(f.shard is not None for f in self.faults) and (
                    self.server is None
                    or not hasattr(self.server.service, "fail_shard")
                    or not hasattr(self.server.service.cache,
                                   "kill_shard")):
                raise ValueError("shard faults need a shared sharded "
                                 "server (SenecaConfig(shards=N))")
        self._stop.clear()

        import time as _time
        wall0 = _time.monotonic()
        if self.server is not None:
            # clock-correct control plane: the adaptive repartition
            # cooldown ticks in trace time, not host CPU time
            self.server.service.set_clock(self.clock)
        t0 = self.clock.now()
        results = [JobResult(spec=s) for s in trace]
        # register every participant BEFORE any thread starts: the
        # virtual clock must know the full roster or it would dispatch
        # the first sleeper alone
        tickets = [self.clock.register() for _ in trace]
        # the fault injector registers as one more participant, so its
        # events fire at exact virtual times between job turns
        self._injector = None
        if self.faults:
            self._injector = FaultInjector(
                self.faults, self.clock,
                server=self.server, storage=self.storage)
            self._injector.start(t0)
        threads = []
        for spec, ticket, res in zip(trace, tickets, results):
            t = threading.Thread(
                target=self._run_job, args=(spec, ticket, res, t0),
                name=f"workload-{spec.name}", daemon=True)
            threads.append(t)
        for t in threads:
            t.start()

        deadline = None if timeout is None else wall0 + timeout
        for t in threads:
            t.join(None if deadline is None
                   else max(deadline - _time.monotonic(), 0.0))
        timed_out = any(t.is_alive() for t in threads)
        if timed_out:
            self.cancel()
            for t in threads:
                t.join(timeout=10.0)
        still = [t.name for t in threads if t.is_alive()]
        if still:       # pragma: no cover - join() hanging is a bug
            raise RuntimeError(f"workload threads failed to join: {still}")
        if self._injector is not None:
            self._injector.stop()   # every job joined: drain + unregister

        out = WorkloadResult(
            jobs=results,
            makespan=max(r.end_s for r in results),
            clock=self.clock.name,
            wall_s=_time.monotonic() - wall0,
            stats=self.server.stats() if self.server is not None else None,
            timed_out=timed_out)
        errors = [(r.spec.name, r.error) for r in results if r.error]
        if errors and raise_on_error:
            raise RuntimeError(f"workload jobs failed: {errors}")
        if timed_out and raise_on_error:
            # a truncated run must not masquerade as a complete one:
            # callers consuming makespans (benchmarks) would otherwise
            # compare numbers capped at the timeout
            cut = [r.spec.name for r in results if r.cancelled]
            raise RuntimeError(
                f"workload timed out after {timeout}s; cancelled jobs "
                f"{cut} (pass raise_on_error=False to inspect the "
                f"truncated WorkloadResult)")
        return out

    # ------------------------------------------------------------------
    def _run_job(self, spec: JobSpec, ticket: int, res: JobResult,
                 t0: float) -> None:
        """One job's thread body: wait for arrival, open a session, pump
        batches through a rate-limited consumer, account epochs."""
        from repro_torch.api.server import SessionClosed   # deferred: cycle
        pipe = None
        sess = None
        private_server = None
        # bind this thread to its participant ticket so components deep
        # in the data path (the storage token bucket) can charge stalls
        # on the clock without a ticket threaded through their signatures
        self.clock.bind(ticket)
        try:
            now = self.clock.sleep_until(ticket, t0 + spec.arrival_s,
                                         interrupt=self._stop)
            res.start_s = now - t0
            if self._stop.is_set():
                res.cancelled = True
                res.end_s = res.start_s
                return
            if self.server_factory is not None:
                private_server = self.server_factory(spec)
                server = private_server
                server.service.set_clock(self.clock)
            else:
                server = self.server
            sess = server.open_session(batch_size=spec.batch_size,
                                       sampler=spec.sampler)
            res.job_id = sess.job_id
            pacer = _IngestPacer(self.clock, ticket, spec.gpu_rate,
                                 start_at=now, interrupt=self._stop)
            deterministic = self.clock.deterministic

            def build_pipe() -> DSIPipeline:
                return DSIPipeline(
                    sess, self.storage,
                    n_workers=1 if deterministic else spec.n_workers,
                    executor=spec.executor, seed=self.seed,
                    consume_hook=pacer, sync_refills=deterministic,
                    clock=self.clock)

            pipe = build_pipe()
            n = self.storage.dataset.n_samples
            # the samplers serve whole batches and re-permute early when
            # the batch size does not divide the dataset, so one "epoch"
            # is the largest whole-batch pass — targeting that keeps
            # sample counts exact (no final-batch overshoot) and epoch
            # accounting aligned with what the sampler actually does
            epoch_size = (n // spec.batch_size) * spec.batch_size
            if epoch_size == 0:
                raise ValueError(
                    f"job {spec.name!r}: batch_size {spec.batch_size} "
                    f"exceeds the dataset ({n} samples)")
            target = spec.epochs * epoch_size
            if spec.max_batches is not None:
                target = min(target, spec.max_batches * spec.batch_size)
            injector = self._injector
            while res.samples < target and not self._stop.is_set():
                fault = injector.take_job_fault(spec.name) \
                    if injector is not None else None
                if fault is not None:
                    if fault.kind == "worker-crash":
                        # pipeline workers died: in-flight batches are
                        # lost but the session (sampler state) survives —
                        # rebuild the pipeline on the same session
                        pipe.stop(close_session=False)
                        pipe = build_pipe()
                        res.worker_restarts += 1
                        injector.record_recovery("worker-restart")
                    elif fault.kind == "preempt":
                        snap = sess.checkpoint_state() \
                            if self.fault_policy == "checkpoint" else None
                        pipe.stop(close_session=False)
                        sess.close()   # the job leaves the system
                        now = self.clock.sleep_until(
                            ticket, pacer.now + fault.duration_s,
                            interrupt=self._stop)
                        if self._stop.is_set():
                            res.cancelled = True
                            res.end_s = now - t0
                            return
                        # re-admission: fresh session; under the
                        # checkpoint policy the sampler resumes exactly
                        # where it left off, under the naive-restart
                        # baseline all progress is lost
                        sess = server.open_session(
                            batch_size=spec.batch_size,
                            sampler=spec.sampler)
                        res.job_id = sess.job_id
                        if snap is not None:
                            sess.restore_state(snap)
                        else:
                            res.samples = 0
                            res.batches = 0
                            res.sample_ids.clear()
                            res.epoch_ends.clear()
                        pacer.now = now
                        pipe = build_pipe()
                        res.preemptions += 1
                        injector.record_recovery("preempt-readmit")
                    continue
                try:
                    batch = pipe.next_batch()   # pacer sleeps inside
                except SessionClosed:
                    break
                res.samples += len(batch["ids"])
                res.batches += 1
                if self.record_ids:
                    res.sample_ids.extend(int(x) for x in batch["ids"])
                while res.samples >= epoch_size * (len(res.epoch_ends)
                                                   + 1):
                    res.epoch_ends.append(pacer.now - t0)
            res.cancelled = self._stop.is_set() and res.samples < target
            res.end_s = pacer.now - t0
        except Exception as e:      # noqa: BLE001 - reported, not lost
            res.error = repr(e)
            res.end_s = self.clock.now() - t0
            log.warning("workload job %s failed", spec.name, exc_info=True)
        finally:
            try:
                if pipe is not None:
                    pipe.stop()     # closes the session too
                elif sess is not None:
                    # pipeline construction failed after the session was
                    # opened: close it or the shared server carries a
                    # phantom job forever (inflated eviction threshold,
                    # ghost session in the repartition trigger)
                    sess.close()
                if private_server is not None:
                    res.stats = private_server.stats()
                    private_server.close()
            except Exception:       # noqa: BLE001 - teardown best-effort
                log.warning("workload job %s teardown failed", spec.name,
                            exc_info=True)
            finally:
                # ALWAYS release the clock turn or peers deadlock
                self.clock.unbind()
                self.clock.unregister(ticket)


# re-exported convenience: a short way to say "the deterministic setup"
def deterministic_runner(server: SenecaServer, storage: RemoteStorage,
                         **kw) -> WorkloadRunner:
    """A :class:`WorkloadRunner` on a fresh :class:`VirtualClock` (the
    reproducible-concurrency configuration used by the tests)."""
    return WorkloadRunner(server, storage, clock=VirtualClock(), **kw)
