"""Shard/worker liveness: the generalized heartbeat registry.

The seed's ``HeartbeatRegistry`` lived inside ``distributed/ft.py`` and
tracked trainer hosts against ``time.monotonic``.  This generalization
tracks any hashable member (host ids, shard ids, worker names) against an
injected clock, and distinguishes two failure signals:

* **expiry** — a member whose last beat is older than ``dead_after_s``
  (the classic heartbeat timeout);
* **explicit marks** — ``mark_dead`` from a fault injector or a
  transport that just watched a shard's pipe break.  Cleared by
  ``mark_alive`` on restart.

``clock`` is duck-typed: anything with a ``now() -> float`` works
(:class:`~repro_torch.workload.clock.RealClock`, ``VirtualClock``, a test
fake).  The default reads ``time.monotonic`` directly so this module
stays import-light (no ``repro_torch.workload`` dependency — the service
layer imports it from cache-client code).
"""
from __future__ import annotations

import threading
import time
from typing import Any, Dict, Hashable, List, Optional, Set

__all__ = ["LivenessRegistry"]


class LivenessRegistry:
    """Clock-driven liveness over an arbitrary member set."""

    def __init__(self, dead_after_s: float = 10.0,
                 clock: Optional[Any] = None):
        self.dead_after_s = float(dead_after_s)
        self.clock = clock
        self.last_beat: Dict[Hashable, float] = {}
        self._down: Set[Hashable] = set()
        self._lock = threading.Lock()

    def _now(self) -> float:
        return self.clock.now() if self.clock is not None \
            else time.monotonic()

    # ------------------------------------------------------------------
    def beat(self, member: Hashable, now: Optional[float] = None) -> None:
        with self._lock:
            self.last_beat[member] = now if now is not None else self._now()

    def mark_dead(self, member: Hashable) -> None:
        """Explicit failure signal (fault injection, broken transport)."""
        with self._lock:
            self._down.add(member)

    def mark_alive(self, member: Hashable) -> None:
        """Clear an explicit mark (member restarted) and refresh its beat."""
        with self._lock:
            self._down.discard(member)
            self.last_beat[member] = self._now()

    def forget(self, member: Hashable) -> None:
        with self._lock:
            self._down.discard(member)
            self.last_beat.pop(member, None)

    # ------------------------------------------------------------------
    def is_dead(self, member: Hashable) -> bool:
        """Explicitly marked dead (expiry is reported via :meth:`failed`
        — an expired member may just be slow, a marked one is known
        gone)."""
        with self._lock:
            return member in self._down

    def failed(self, now: Optional[float] = None) -> List[Hashable]:
        """Members explicitly dead or whose beat expired, stable order."""
        with self._lock:
            now = now if now is not None else self._now()
            out = [m for m, t in self.last_beat.items()
                   if m in self._down or now - t > self.dead_after_s]
            out += [m for m in sorted(self._down, key=repr)
                    if m not in self.last_beat]
            return out
