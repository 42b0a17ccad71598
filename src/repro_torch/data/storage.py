"""Simulated remote storage with a shared bandwidth budget.

A token-bucket limiter shared by all fetch threads reproduces the paper's
NFS bottleneck; with ``bandwidth=None`` the store is rate-unlimited (unit
tests).  Fetches return the dataset's encoded payload — the PRNG-backed
:class:`~repro_torch.data.synthetic.SyntheticDataset` or the sharded on-disk
:class:`~repro_torch.data.synthetic.FileDataset` (real file IO through the
same token bucket).

Counter discipline: ``BandwidthBudget.bytes_served`` and
``RemoteStorage.fetches`` are only ever mutated under the budget lock —
concurrent fetch workers previously raced the bare ``+=`` and dropped
increments, so benchmark fetch tallies undercounted under load.

Fault injection (the reference's ``repro.faults``, not ported yet):
:meth:`RemoteStorage.degrade` scales
the token-bucket rate (a storage-bandwidth collapse) and
:meth:`restore_bandwidth` undoes it; transient dataset IO errors are
retried a few times before propagating, with both degradations counted
for ``stats()``.

Clock correctness: the token bucket takes an optional pluggable
``clock`` (anything with ``now()``/``stall()``, as the reference's
``repro.workload.clock.Clock``).  Without one the
historical behavior is byte-identical (``time.monotonic`` +
``time.sleep``) — but that bypasses a :class:`VirtualClock` entirely:
storage stalls then burn *wall* time on the calling job's turn and cost
zero *virtual* time, so virtual makespans and injected
bandwidth-collapse faults never shape the simulated timeline.  With a
clock, ``_available_at`` lives on the clock's timeline and the stall is
charged through :meth:`Clock.stall` on the calling thread's bound
participant ticket — :meth:`degrade`/:meth:`restore_bandwidth` then
take effect at the exact (virtual) instant they are applied, because
every subsequent ``consume`` prices its transfer off the clock's ``now``
and the post-change ``rate``.
"""
from __future__ import annotations

import threading
import time
from typing import Optional


class BandwidthBudget:
    def __init__(self, bytes_per_s: Optional[float], clock=None):
        self.rate = bytes_per_s
        self.base_rate = bytes_per_s     # pre-degradation rate
        self.clock = clock               # None -> wall time (historical)
        self.lock = threading.Lock()
        self._available_at = self._now()
        self.bytes_served = 0

    def _now(self) -> float:
        return time.monotonic() if self.clock is None else self.clock.now()

    def consume(self, nbytes: int) -> float:
        """Blocks until the transfer 'completes'; returns the stall time."""
        if self.rate is None:
            with self.lock:
                self.bytes_served += nbytes
            return 0.0
        with self.lock:
            now = self._now()
            start = max(now, self._available_at)
            self._available_at = start + nbytes / self.rate
            wait = self._available_at - now
            self.bytes_served += nbytes
        if wait > 0:
            if self.clock is None:
                time.sleep(wait)
            else:
                # charge the stall on the caller's clock participant:
                # under a VirtualClock this advances virtual time (and
                # yields the turn) instead of burning wall time
                self.clock.stall(wait)
        return max(wait, 0.0)


class RemoteStorage:
    def __init__(self, dataset, bandwidth: Optional[float] = None,
                 clock=None):
        self.dataset = dataset
        self.budget = BandwidthBudget(bandwidth, clock=clock)
        self.fetches = 0
        self.degraded = False
        self.degraded_fetches = 0        # fetches served while degraded
        self.io_retries = 0              # transient read errors retried

    # -- fault injection -------------------------------------------------
    def degrade(self, factor: float = 0.1) -> None:
        """Collapse the shared bandwidth to ``factor`` of the configured
        rate (an injected storage brownout).  No-op on unlimited
        stores beyond flipping the flag — there is no rate to scale."""
        if not factor > 0:
            raise ValueError(f"degrade factor must be > 0, got {factor}")
        with self.budget.lock:
            if self.budget.base_rate is not None:
                self.budget.rate = max(self.budget.base_rate * factor, 1.0)
            self.degraded = True

    def restore_bandwidth(self) -> None:
        with self.budget.lock:
            self.budget.rate = self.budget.base_rate
            self.degraded = False

    # -- data path ---------------------------------------------------------
    def fetch(self, sample_id: int) -> bytes:
        data = None
        for attempt in range(3):
            try:
                data = self.dataset.encoded(sample_id)
                break
            except OSError:
                # transient read failure (FileDataset under churn):
                # bounded retry before the pipeline sees the error
                with self.budget.lock:
                    self.io_retries += 1
                if attempt == 2:
                    raise
        self.budget.consume(len(data))
        with self.budget.lock:
            self.fetches += 1
            if self.degraded:
                self.degraded_fetches += 1
        return data
