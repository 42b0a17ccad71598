"""Declarative fault traces: what breaks, when, for how long.

A fault scenario is a list of :class:`FaultSpec` events scheduled on the
workload clock by :class:`~repro_torch.faults.injector.FaultInjector`.  Under a
:class:`~repro_torch.workload.clock.VirtualClock` the injector is one more
registered participant, so every fault fires at an exact virtual time
between job turns and the whole scenario — including recovery — is
byte-for-byte reproducible.

Kinds
-----
``worker-crash``
    The target job's pipeline workers die mid-run.  The runner tears the
    pipeline down (in-flight state lost) and rebuilds it on the same
    session — no sample is re-served, the session's sampler state was
    never lost.
``spill-corrupt``
    Truncate up to ``n_files`` spill-tier files on disk (deterministic:
    lexicographic order).  Subsequent reads degrade to misses and count
    ``io_errors``; nothing crashes.
``bandwidth-collapse``
    Scale the shared storage token-bucket rate by ``factor``; restored
    after ``duration_s`` (0 = permanent).
``shard-kill``
    Kill cache shard ``shard``: its key range fails over to storage
    (lookups miss, inserts drop) until the shard is restarted — after
    ``duration_s`` when > 0, or by an explicit ``shard-restart`` event.
``shard-restart``
    Restart a previously killed shard (cold: empty cache).
``preempt``
    Preempt the target job for ``duration_s`` seconds.  Under the
    runner's ``fault_policy="checkpoint"`` the session's sampler state
    is snapshotted and restored on re-admission (exactly-once-per-epoch
    coverage continues, nothing is re-preprocessed); under ``"restart"``
    the job loses all progress — the kill-and-restart-from-scratch
    baseline.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Optional

__all__ = ["FaultSpec", "FAULT_KINDS"]

FAULT_KINDS = ("worker-crash", "spill-corrupt", "bandwidth-collapse",
               "shard-kill", "shard-restart", "preempt")

_JOB_KINDS = ("worker-crash", "preempt")
_SHARD_KINDS = ("shard-kill", "shard-restart")


@dataclass(frozen=True)
class FaultSpec:
    """One scheduled fault event (times are trace-relative seconds)."""

    kind: str
    at_s: float
    job: Optional[str] = None        # target job name (worker-crash/preempt)
    shard: Optional[int] = None      # target shard id (shard-kill/-restart)
    duration_s: float = 0.0          # preempt dwell / auto-recovery window
    factor: float = 0.1              # bandwidth-collapse rate multiplier
    n_files: int = 2                 # spill files to corrupt

    def __post_init__(self) -> None:
        if self.kind not in FAULT_KINDS:
            raise ValueError(f"unknown fault kind {self.kind!r}; expected "
                             f"one of {FAULT_KINDS}")
        if self.at_s < 0:
            raise ValueError(f"{self.kind}: at_s must be >= 0")
        if self.duration_s < 0:
            raise ValueError(f"{self.kind}: duration_s must be >= 0")
        if self.kind in _JOB_KINDS and not self.job:
            raise ValueError(f"{self.kind} needs a target job name")
        if self.kind in _SHARD_KINDS and self.shard is None:
            raise ValueError(f"{self.kind} needs a target shard id")
        if self.kind == "bandwidth-collapse" and not self.factor > 0:
            raise ValueError("bandwidth-collapse: factor must be > 0")
        if self.kind == "spill-corrupt" and self.n_files < 1:
            raise ValueError("spill-corrupt: n_files must be >= 1")
