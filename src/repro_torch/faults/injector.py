"""Clock-driven fault injection over a live Seneca stack.

:class:`FaultInjector` turns a declarative
:class:`~repro_torch.faults.spec.FaultSpec` trace into scheduled actions
against a running :class:`~repro_torch.api.server.SenecaServer` +
:class:`~repro_torch.data.storage.RemoteStorage` +
:class:`~repro_torch.workload.runner.WorkloadRunner`:

* it registers as one more participant on the workload clock, so under a
  ``VirtualClock`` every fault fires at an exact virtual time while all
  job threads are parked — the whole scenario, recovery included, is
  byte-for-byte reproducible;
* service/cache/storage faults (shard kill, spill corruption, bandwidth
  collapse) are applied directly on the injector's turn;
* job faults (worker crash, preemption) are *posted*: the owning job
  thread picks them up at its next batch boundary via
  :meth:`take_job_fault` and performs its own teardown/recovery —
  shared-state mutation stays on the registered thread that owns it.

Every injection and recovery increments a ``fault.<kind>`` /
``recovery.<kind>`` counter on the server's
:class:`~repro_torch.api.telemetry.TelemetryAggregator`, which surfaces them
in ``stats()["faults"]``.
"""
from __future__ import annotations

import os
import threading
from typing import Any, Dict, List, Optional, Sequence, Tuple

from repro_torch.faults.spec import FaultSpec

__all__ = ["FaultInjector", "corrupt_spill_files"]


def corrupt_spill_files(spill_dir: str, n_files: int) -> List[str]:
    """Truncate up to ``n_files`` spill files under ``spill_dir`` to a
    single byte (shorter than any codec's dtype×shape claim, so the next
    read raises inside the tier and degrades to a counted miss).

    Files are chosen in sorted path order — deterministic given the same
    cache state, which the VirtualClock turn discipline guarantees.
    """
    victims: List[str] = []
    for root, _dirs, files in sorted(os.walk(spill_dir)):
        for name in sorted(files):
            victims.append(os.path.join(root, name))
    victims = victims[:n_files]
    hit = []
    for path in victims:
        try:
            with open(path, "r+b") as f:
                f.truncate(1)
            hit.append(path)
        except OSError:
            continue
    return hit


class FaultInjector:
    """Replay a :class:`FaultSpec` trace on the workload clock.

    ``clock`` is duck-typed (``register``/``sleep_until``/``unregister``
    /``now``); ``None`` defaults to a fresh
    :class:`~repro_torch.workload.clock.RealClock`.  ``server`` and
    ``storage`` may each be ``None`` when the trace contains no fault
    that needs them.
    """

    def __init__(self, specs: Sequence[FaultSpec], clock: Any = None,
                 *, server: Any = None, storage: Any = None):
        self.specs = list(specs)
        for s in self.specs:
            if not isinstance(s, FaultSpec):
                raise TypeError(f"expected FaultSpec, got {type(s).__name__}")
        if clock is None:
            from repro_torch.workload.clock import RealClock
            clock = RealClock()
        self.clock = clock
        self.server = server
        self.storage = storage
        self._service = getattr(server, "service", server)
        needs_server = [s.kind for s in self.specs
                        if s.kind in ("shard-kill", "shard-restart",
                                      "spill-corrupt")]
        if needs_server and self._service is None:
            raise ValueError(f"faults {needs_server} need a shared server")
        if any(s.kind == "bandwidth-collapse" for s in self.specs) \
                and storage is None:
            raise ValueError("bandwidth-collapse needs the RemoteStorage")
        # timeline: the trace events plus derived auto-recovery events
        # (shard restart / bandwidth restore after duration_s), ordered
        # by (time, insertion sequence) for a deterministic tie-break
        timeline: List[Tuple[float, int, str, FaultSpec]] = []
        seq = 0
        for s in self.specs:
            timeline.append((s.at_s, seq, s.kind, s))
            seq += 1
            if s.duration_s > 0 and s.kind == "shard-kill":
                timeline.append((s.at_s + s.duration_s, seq,
                                 "shard-restart", s))
                seq += 1
            if s.duration_s > 0 and s.kind == "bandwidth-collapse":
                timeline.append((s.at_s + s.duration_s, seq,
                                 "bandwidth-restore", s))
                seq += 1
        self._timeline = sorted(timeline, key=lambda e: (e[0], e[1]))
        self._lock = threading.Lock()
        self._job_faults: Dict[str, List[FaultSpec]] = {}
        self._interrupt = threading.Event()
        self._thread: Optional[threading.Thread] = None
        self._ticket: Optional[int] = None
        self._t0 = 0.0
        self.counts: Dict[str, int] = {}
        self.events: List[Dict] = []     # applied-event log (time-ordered)

    # ------------------------------------------------------------------
    def _count(self, channel: str, kind: str,
               telemetry: bool = True) -> None:
        key = f"{channel}.{kind}"
        with self._lock:
            self.counts[key] = self.counts.get(key, 0) + 1
        if not telemetry:        # the service layer already recorded it
            return
        agg = getattr(self._service, "telemetry", None)
        if agg is not None:
            agg.record_error(key)

    def record_recovery(self, kind: str) -> None:
        """Called by whoever performed a recovery the injector only
        posted (the runner, after a worker rebuild or re-admission)."""
        self._count("recovery", kind)

    # ------------------------------------------------------------------
    def start(self, t0: Optional[float] = None) -> None:
        """Register with the clock and begin replaying the trace.

        Under a VirtualClock, call this after every other participant
        has registered but before their threads block — exactly where
        the WorkloadRunner calls it.
        """
        if self._thread is not None:
            raise RuntimeError("injector already started")
        self._t0 = self.clock.now() if t0 is None else t0
        self._ticket = self.clock.register()
        self._thread = threading.Thread(target=self._run,
                                        name="fault-injector", daemon=True)
        self._thread.start()

    def stop(self) -> None:
        """Interrupt any remaining sleep and join (idempotent).  Only
        call once the job outcomes no longer depend on pending events —
        the runner calls it after every job thread has been joined."""
        self._interrupt.set()
        if self._thread is not None:
            self._thread.join(timeout=10.0)

    def _run(self) -> None:
        try:
            for at, _seq, kind, spec in self._timeline:
                self.clock.sleep_until(self._ticket, self._t0 + at,
                                       interrupt=self._interrupt)
                if self._interrupt.is_set():
                    return
                try:
                    detail = self._apply(kind, spec)
                except Exception as e:      # noqa: BLE001 - logged, not fatal
                    detail = {"error": repr(e)}
                self.events.append({"t": self.clock.now() - self._t0,
                                    "kind": kind, **(detail or {})})
        finally:
            self.clock.unregister(self._ticket)

    # ------------------------------------------------------------------
    def take_job_fault(self, job: str) -> Optional[FaultSpec]:
        """Pop the earliest pending fault posted for ``job`` (runner
        polls this at each batch boundary)."""
        with self._lock:
            pending = self._job_faults.get(job)
            return pending.pop(0) if pending else None

    def _apply(self, kind: str, spec: FaultSpec) -> Dict:
        if kind in ("worker-crash", "preempt"):
            with self._lock:
                self._job_faults.setdefault(spec.job, []).append(spec)
            self._count("fault", kind)
            return {"job": spec.job}
        if kind == "shard-kill":
            self._service.fail_shard(spec.shard)
            self._count("fault", kind, telemetry=False)
            return {"shard": spec.shard}
        if kind == "shard-restart":
            self._service.restore_shard(spec.shard)
            self._count("recovery", kind, telemetry=False)
            return {"shard": spec.shard}
        if kind == "spill-corrupt":
            root = getattr(self._service.cache, "spill_dir", None) \
                or getattr(getattr(self._service, "cfg", None),
                           "spill_dir", None)
            hit = corrupt_spill_files(root, spec.n_files) if root else []
            self._count("fault", kind)
            return {"files": len(hit)}
        if kind == "bandwidth-collapse":
            self.storage.degrade(spec.factor)
            self._count("fault", kind)
            return {"factor": spec.factor}
        if kind == "bandwidth-restore":
            self.storage.restore_bandwidth()
            self._count("recovery", kind)
            return {}
        raise ValueError(f"unhandled fault kind {kind!r}")
