"""Cross-job production coalescing (single-flight, CoorDL-style).

K concurrent jobs with overlapping working sets run the same
fetch+decode+augment chain up to K times for the same ``(sample_id,
form)`` — coordinated prep that dedups that work is the largest
multi-job win in the data-stall literature.  A :class:`ProductionTable`
tracks in-flight productions: the first misser becomes the *leader*
(produces and admits as usual), concurrent missers *join* the flight
and receive the leader's result zero-copy instead of re-running the
chain.

VirtualClock safety: a joiner under a deterministic clock must not
block on a :class:`threading.Event` — the leader may itself be parked
in the clock's turn discipline (e.g. a token-bucket storage stall), and
a wall-blocked waiter would freeze the whole dispatch loop.  Joiners
with a bound ticket instead poll the flight through ``Clock.stall``
micro-sleeps, which parks them as regular participants and charges the
wait as (deterministic) virtual time.  Threads that cannot wait safely
— deterministic clock but no bound ticket — decline to join and
produce the sample themselves, trading a duplicate production for
liveness.

The table never stores payloads beyond the hand-off: a flight is
removed the moment its leader finishes (or aborts), so the memory cost
is O(in-flight keys), not O(cache).
"""
from __future__ import annotations

import threading
import time
from typing import Dict, List, Optional, Tuple

import numpy as np

__all__ = ["ProductionTable", "Flight"]


class Flight:
    """One in-flight production of a ``(sample_id, form)`` key."""

    __slots__ = ("key", "event", "value", "error", "done", "waiters")

    def __init__(self, key: Tuple[int, str]):
        self.key = key
        self.event = threading.Event()
        self.value = None
        self.error: Optional[BaseException] = None
        self.done = False
        self.waiters = 0


class ProductionTable:
    """Single-flight dedup of ``(sample_id, form)`` productions.

    ``enabled=False`` keeps the table in *observe* mode: every caller
    produces (the baseline behavior) but concurrent productions of the
    same key are still counted in :attr:`duplicates` — that counter is
    how the concurrency benchmark proves coalescing drives duplicate
    productions to ~0.
    """

    #: virtual seconds charged per join poll under a deterministic clock
    POLL_TICK = 1e-4
    #: poll budget: a joiner gives up (and produces itself) after this
    #: many ticks, so a dead leader can never strand it
    MAX_POLLS = 50_000

    def __init__(self, enabled: bool = True, timeout_s: float = 5.0):
        self._lock = threading.Lock()
        self._flights: Dict[Tuple[int, str], Flight] = {}
        self.enabled = bool(enabled)
        self.timeout_s = float(timeout_s)
        # counters (read unlocked by stats paths; written under _lock)
        self.led = 0            # unique productions that went through begin
        self.coalesced = 0      # productions avoided by joining a flight
        self.coalesce_wait_s = 0.0
        self.duplicates = 0     # productions begun while the key was
        #                         already in flight (observe mode, or
        #                         joiners that could not wait safely)

    # ------------------------------------------------------------------
    def begin(self, sid: int, form: str) -> Tuple[bool, Optional[Flight]]:
        """Claim a production.  Returns ``(leader, flight)``:

        * ``(True, flight)`` — the caller is the leader; it must call
          :meth:`finish` (or :meth:`abort`) with this flight.
        * ``(True, None)`` — coalescing is disabled and another
          production of the key is already in flight; produce anyway
          (counted as a duplicate), with nothing to finish.
        * ``(False, flight)`` — join the flight via :meth:`join`.
        """
        key = (int(sid), form)
        with self._lock:
            fl = self._flights.get(key)
            if fl is None:
                fl = Flight(key)
                self._flights[key] = fl
                self.led += 1
                return True, fl
            if not self.enabled:
                self.duplicates += 1
                return True, None
            fl.waiters += 1
            return False, fl

    def finish(self, flight: Optional[Flight], value) -> None:
        """Leader hand-off: publish ``value`` to every joiner (zero-copy
        — they receive this exact object) and retire the flight."""
        if flight is None:
            return
        with self._lock:
            # identity check: a timed-out flight may have been evicted
            # and superseded — never pop the successor's flight
            if self._flights.get(flight.key) is flight:
                del self._flights[flight.key]
        flight.value = value
        flight.done = True
        flight.event.set()

    def abort(self, flight: Optional[Flight],
              error: Optional[BaseException] = None) -> None:
        """Leader failure path: wake joiners empty-handed (they retry
        :meth:`begin`, and the first becomes the new leader)."""
        if flight is None:
            return
        with self._lock:
            if self._flights.get(flight.key) is flight:
                del self._flights[flight.key]
        # never leave error None on an abort: join() reads error-is-None
        # as success, and a None payload must not masquerade as a value
        flight.error = error if error is not None else \
            RuntimeError("production aborted")
        flight.done = True
        flight.event.set()

    # ------------------------------------------------------------------
    def join(self, flight: Flight, clock=None
             ) -> Tuple[bool, Optional[object]]:
        """Wait for a flight's result.  Returns ``(ok, value)``; ``ok``
        False means the flight aborted or the wait was abandoned — the
        caller should fall back to producing the sample itself.

        ``clock`` is the caller's duck-typed Clock (or None for wall
        time).  Deterministic clocks are polled via :meth:`Clock.stall`
        (see module doc); everything else blocks on the flight event
        with a wall timeout.
        """
        wall = clock is None or not getattr(clock, "deterministic", False)
        now = time.monotonic if clock is None else clock.now
        t0 = now()
        if not flight.done:
            if wall:
                flight.event.wait(self.timeout_s)
            else:
                if clock.bound_ticket() is None:
                    # cannot park as a clock participant: waiting would
                    # stall the dispatch loop.  Duplicate, but live.
                    with self._lock:
                        self.duplicates += 1
                    return False, None
                polls = 0
                while not flight.done and polls < self.MAX_POLLS:
                    clock.stall(self.POLL_TICK)
                    polls += 1
            if not flight.done:
                # leader presumed dead (dropped mid-shutdown, wedged):
                # evict the orphan so later missers lead fresh flights
                # instead of re-paying this timeout forever
                with self._lock:
                    if self._flights.get(flight.key) is flight:
                        del self._flights[flight.key]
                    self.duplicates += 1
        if flight.done and flight.error is None:
            with self._lock:
                self.coalesced += 1
                self.coalesce_wait_s += max(now() - t0, 0.0)
            return True, flight.value
        return False, None

    # ------------------------------------------------------------------
    def inflight_ids(self) -> List[int]:
        with self._lock:
            return [k[0] for k in self._flights]

    def inflight_mask(self, n: int) -> Optional[np.ndarray]:
        """bool[n] mask of sample ids with an in-flight production, or
        None when the table is idle (the common case — callers gate the
        O(N) mask work and keep the ODS fast path byte-identical)."""
        with self._lock:
            if not self._flights:
                return None
            ids = [k[0] for k in self._flights if 0 <= k[0] < n]
        if not ids:
            return None
        mask = np.zeros(n, bool)
        mask[ids] = True
        return mask

    def __len__(self) -> int:
        with self._lock:
            return len(self._flights)

    def stats(self) -> Dict[str, float]:
        with self._lock:
            return {
                "enabled": self.enabled,
                "led": self.led,
                "coalesced": self.coalesced,
                "coalesce_wait_s": self.coalesce_wait_s,
                "duplicates": self.duplicates,
                "in_flight": len(self._flights),
            }
