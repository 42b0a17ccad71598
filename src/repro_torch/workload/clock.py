"""Pluggable clocks for multi-job workload execution.

The :class:`~repro_torch.workload.runner.WorkloadRunner` paces every job thread
(arrival times, GPU-ingest rate limiting) through one of these clocks:

* :class:`RealClock` — wall time (``time.monotonic`` + interruptible
  sleeps).  What a live deployment uses.
* :class:`VirtualClock` — a deterministic discrete-event clock.  Every
  participant (one per job thread) registers up front; time advances only
  when *all* registered participants are blocked in
  :meth:`~VirtualClock.sleep_until`, and exactly **one** participant is
  released per advance — the one with the smallest ``(wake_time,
  ticket)`` pair.  Between two of its own sleeps a participant therefore
  runs *alone*: shared-state interleavings (cache admissions, ODS
  sampling, the service RNG) are serialized in a reproducible order, and
  two runs of the same trace produce byte-identical sample sequences and
  makespans.  Compute costs zero virtual time; only explicit sleeps
  advance the clock, so virtual makespans measure the *pacing* schedule
  (arrivals + ingest rates), not host CPU speed.

The contract a participant must honor for determinism to hold: do all
shared-state work between ``sleep_until`` calls on the registered thread
itself (no unregistered helper threads racing past the turn boundary).
The runner enforces this by pinning virtual-clock jobs to the per-sample
pipeline executor with a single worker and synchronous refills.
"""
from __future__ import annotations

import itertools
import threading
import time
from abc import ABC, abstractmethod
from typing import Dict, Optional

__all__ = ["Clock", "RealClock", "VirtualClock"]


class Clock(ABC):
    """Time source + cooperative scheduler used by workload job threads.

    ``register()`` hands out a participant ticket; every timed wait goes
    through ``sleep_until(ticket, wake_at)`` which returns the (possibly
    virtual) time at which the caller resumed.  ``interrupt`` is an
    optional :class:`threading.Event` that aborts the wait early
    (cancellation) — after it fires, determinism guarantees end but no
    participant may deadlock.
    """

    name: str = "clock"
    deterministic: bool = False

    @abstractmethod
    def now(self) -> float: ...

    @abstractmethod
    def register(self) -> int: ...

    @abstractmethod
    def unregister(self, ticket: int) -> None: ...

    @abstractmethod
    def sleep_until(self, ticket: int, wake_at: float,
                    interrupt: Optional[threading.Event] = None) -> float:
        ...

    def sleep(self, ticket: int, seconds: float,
              interrupt: Optional[threading.Event] = None) -> float:
        """Relative-time convenience over :meth:`sleep_until`."""
        return self.sleep_until(ticket, self.now() + max(seconds, 0.0),
                                interrupt=interrupt)

    # -- thread-ticket binding -----------------------------------------
    # Components deep inside the data path (the storage token bucket,
    # the open-loop serving phases) need to charge blocking stalls on
    # the clock without having a ticket threaded through every call
    # signature.  A participant thread binds its ticket once
    # (``bind``), and anything it later calls can ``stall(seconds)``:
    # with a bound ticket the stall is a real scheduled sleep (virtual
    # time advances deterministically); unbound threads fall back to a
    # wall sleep on non-deterministic clocks and a no-op on
    # deterministic ones (an unregistered thread cannot take a turn —
    # the VirtualClock contract pins all timed work to participants).

    def _bound(self) -> Dict[int, int]:
        d = getattr(self, "_thread_tickets", None)
        if d is None:
            d = self._thread_tickets = {}
        return d

    def bind(self, ticket: int) -> None:
        """Associate the calling thread with ``ticket`` for ``stall``."""
        self._bound()[threading.get_ident()] = ticket

    def unbind(self) -> None:
        self._bound().pop(threading.get_ident(), None)

    def bound_ticket(self) -> Optional[int]:
        return self._bound().get(threading.get_ident())

    def stall(self, seconds: float,
              interrupt: Optional[threading.Event] = None) -> float:
        """Charge a blocking stall of ``seconds`` on the calling
        thread's bound ticket; returns the clock time after the stall.
        """
        if seconds <= 0:
            return self.now()
        ticket = self.bound_ticket()
        if ticket is not None:
            return self.sleep(ticket, seconds, interrupt=interrupt)
        if not self.deterministic:
            if interrupt is not None:
                interrupt.wait(seconds)
            else:
                time.sleep(seconds)
        return self.now()


class RealClock(Clock):
    """Wall-clock time; sleeps are interruptible via the cancel event."""

    name = "real"
    deterministic = False

    def __init__(self) -> None:
        self._tickets = itertools.count()

    def now(self) -> float:
        return time.monotonic()

    def register(self) -> int:
        return next(self._tickets)

    def unregister(self, ticket: int) -> None:
        pass

    def sleep_until(self, ticket: int, wake_at: float,
                    interrupt: Optional[threading.Event] = None) -> float:
        dt = wake_at - time.monotonic()
        if dt > 0:
            if interrupt is not None:
                interrupt.wait(dt)
            else:
                time.sleep(dt)
        return time.monotonic()


class VirtualClock(Clock):
    """Deterministic discrete-event clock with a run-one-at-a-time turn
    discipline (see the module docstring for the full contract).

    Thread-safety: one condition variable guards all state.  A
    participant that exits must :meth:`unregister` (the runner does this
    in a ``finally``) or its peers would wait forever for its turn.
    """

    name = "virtual"
    deterministic = True

    def __init__(self, start: float = 0.0):
        self._cond = threading.Condition()
        self._now = float(start)
        self._tickets = itertools.count()
        self._registered: set = set()
        self._waiting: Dict[int, float] = {}   # ticket -> wake time
        self._running: Optional[int] = None

    def now(self) -> float:
        with self._cond:
            return self._now

    def register(self) -> int:
        with self._cond:
            t = next(self._tickets)
            self._registered.add(t)
            return t

    def unregister(self, ticket: int) -> None:
        with self._cond:
            self._registered.discard(ticket)
            self._waiting.pop(ticket, None)
            if self._running == ticket:
                self._running = None
            self._dispatch_locked()
            self._cond.notify_all()

    # ------------------------------------------------------------------
    def _dispatch_locked(self) -> None:
        """Advance time and hand the turn to the earliest waiter — only
        once every registered participant is parked (so no one is still
        running code whose shared-state effects could race the pick)."""
        if self._running is not None or not self._registered:
            return
        if any(t not in self._waiting for t in self._registered):
            return
        ticket = min(self._registered,
                     key=lambda t: (self._waiting[t], t))
        self._now = max(self._now, self._waiting.pop(ticket))
        self._running = ticket
        self._cond.notify_all()

    def sleep_until(self, ticket: int, wake_at: float,
                    interrupt: Optional[threading.Event] = None) -> float:
        with self._cond:
            if ticket not in self._registered:
                raise RuntimeError(
                    f"ticket {ticket} is not registered with this clock")
            self._waiting[ticket] = float(wake_at)
            if self._running == ticket:
                self._running = None
            self._dispatch_locked()
            while self._running != ticket:
                if interrupt is not None and interrupt.is_set():
                    # cancellation: give up the turn without deadlocking
                    # peers (determinism is over once a run is cancelled)
                    self._waiting.pop(ticket, None)
                    self._dispatch_locked()
                    self._cond.notify_all()
                    return self._now
                # timed wait so a set-after-check interrupt is still seen
                self._cond.wait(timeout=0.1)
            return self._now
