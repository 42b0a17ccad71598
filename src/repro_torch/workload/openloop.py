"""Open-loop serving over the session API: trace-driven request
arrivals, per-request latency accounting, SLO-aware admission control.

Closed-loop training traces (:mod:`repro_torch.workload.runner`) only ask for
the next batch when the previous one is consumed — the pipeline can
never fall behind, only slow down.  Production preprocessing is
*open-loop*: requests arrive whether or not the pipeline is ready
(tf.data's service framing), and what matters is per-request **tail
latency** with a per-phase breakdown (CoorDL's data-stalls analysis) —
queue wait, fetch, decode, augment — not aggregate throughput.

Three pieces:

* **Arrival processes** — :func:`poisson_arrivals`,
  :func:`bursty_arrivals` (on/off modulated Poisson) and
  :func:`diurnal_arrivals` (sinusoidal rate, Lewis-Shedler thinning).
  Whole schedules are generated up front from one seeded
  ``numpy.random.default_rng``, so a schedule is byte-for-byte
  reproducible regardless of the clock that later replays it.
* **:class:`OpenLoopGenerator`** — replays a schedule against a live
  :class:`~repro_torch.api.server.SenecaServer` + ``RemoteStorage``: a
  generator participant enqueues requests at their arrival instants,
  ``n_workers`` worker participants serve them through the session
  (lookup → fetch → decode → augment, admitting produced forms back to
  the shared cache).  Under a
  :class:`~repro_torch.workload.clock.VirtualClock` the whole run is
  deterministic: the generator registers *first* (lowest ticket wins
  wake-time ties, so an arrival always lands before the service work at
  the same instant), workers bind their tickets so storage stalls from
  a clock-aware token bucket charge *virtual* time, and optional
  ``phase_costs`` model decode/augment service time on the clock
  (compute alone costs zero virtual seconds).
* **SLO admission control** — with an :class:`~repro_torch.api.server.SLO`
  each arrival's queue wait is estimated as ``backlog x service-time
  EWMA / workers`` and the request is admitted at a *work level*: full
  (augmented), degraded (skip augment), encoded (skip decode+augment),
  or shed outright past ``shed_frac`` / ``max_queue``.  Degrading caps
  the work a request may buy, never the quality of an already-cached
  form.  Every decision is counted in
  ``stats()["telemetry"]["requests"]``.

See docs/API.md "Open-loop serving & SLOs".
"""
from __future__ import annotations

import logging
import math
import threading
from collections import deque
from dataclasses import dataclass, field
from typing import Callable, Dict, List, Optional, Sequence

import numpy as np
import torch

from repro_torch.api.server import SLO, SenecaServer
from repro_torch.api.telemetry import quantile
from repro_torch.data.augment import augment_np
from repro_torch.data.pipeline import _aug_seed
from repro_torch.data.storage import RemoteStorage
from repro_torch.workload.clock import Clock, RealClock

log = logging.getLogger(__name__)

__all__ = ["poisson_arrivals", "bursty_arrivals", "diurnal_arrivals",
           "make_arrivals", "ARRIVAL_PROCESSES", "RequestResult",
           "ServeResult", "OpenLoopGenerator", "quantile"]

ARRIVAL_PROCESSES = ("poisson", "bursty", "diurnal")

#: admission work levels, most→least work; index = level
_LEVEL_FORMS = ("encoded", "decoded", "augmented")
_OUTCOME = {"augmented": "served", "decoded": "degraded",
            "encoded": "encoded"}


# ---------------------------------------------------------------------------
# arrival schedules (all offsets from 0, sorted, one seeded RNG)
# ---------------------------------------------------------------------------
def poisson_arrivals(rate: float, n: int, seed: int = 0) -> np.ndarray:
    """``n`` Poisson arrivals at ``rate`` req/s: i.i.d. exponential
    inter-arrival gaps, cumulatively summed."""
    if not rate > 0:
        raise ValueError(f"rate must be > 0, got {rate}")
    if n < 1:
        raise ValueError(f"n must be >= 1, got {n}")
    rng = np.random.default_rng(seed)
    return np.cumsum(rng.exponential(1.0 / rate, size=n))


def _thinned(rate_fn: Callable[[float], float], rate_max: float, n: int,
             seed: int) -> np.ndarray:
    """Lewis–Shedler thinning: candidate arrivals at ``rate_max``,
    accepted with probability ``rate_fn(t) / rate_max`` — an exact
    sampler for any bounded time-varying rate."""
    rng = np.random.default_rng(seed)
    out = np.empty(n, np.float64)
    t, i = 0.0, 0
    while i < n:
        t += rng.exponential(1.0 / rate_max)
        if rng.random() * rate_max <= rate_fn(t):
            out[i] = t
            i += 1
    return out


def bursty_arrivals(rate: float, n: int, seed: int = 0, *,
                    burst_factor: float = 3.0, duty: float = 0.25,
                    period_s: float = 4.0) -> np.ndarray:
    """On/off modulated Poisson with long-run mean ``rate``: for the
    first ``duty`` fraction of every ``period_s`` window the
    instantaneous rate is ``burst_factor x rate``; the off-phase rate is
    solved so the window mean stays ``rate`` (requires
    ``burst_factor < 1/duty``)."""
    if not rate > 0:
        raise ValueError(f"rate must be > 0, got {rate}")
    if not 0 < duty < 1:
        raise ValueError(f"duty must be in (0, 1), got {duty}")
    if not 1 <= burst_factor < 1.0 / duty:
        raise ValueError(f"burst_factor must be in [1, 1/duty={1/duty:g}), "
                         f"got {burst_factor}")
    hi = rate * burst_factor
    lo = rate * (1.0 - duty * burst_factor) / (1.0 - duty)

    def rate_fn(t: float) -> float:
        return hi if (t % period_s) < duty * period_s else lo

    return _thinned(rate_fn, hi, n, seed)


def diurnal_arrivals(rate: float, n: int, seed: int = 0, *,
                     depth: float = 0.8,
                     period_s: float = 60.0) -> np.ndarray:
    """Sinusoidally modulated Poisson (a compressed day/night cycle):
    instantaneous rate ``rate * (1 + depth * sin(2*pi*t/period_s))``,
    long-run mean ``rate``."""
    if not rate > 0:
        raise ValueError(f"rate must be > 0, got {rate}")
    if not 0 <= depth < 1:
        raise ValueError(f"depth must be in [0, 1), got {depth}")

    def rate_fn(t: float) -> float:
        return rate * (1.0 + depth * math.sin(2.0 * math.pi * t / period_s))

    return _thinned(rate_fn, rate * (1.0 + depth), n, seed)


def make_arrivals(process: str, rate: float, n: int, seed: int = 0,
                  **kw) -> np.ndarray:
    """Dispatch on ``process`` name (:data:`ARRIVAL_PROCESSES`)."""
    fns = {"poisson": poisson_arrivals, "bursty": bursty_arrivals,
           "diurnal": diurnal_arrivals}
    if process not in fns:
        raise ValueError(f"unknown arrival process {process!r}; expected "
                         f"one of {ARRIVAL_PROCESSES}")
    return fns[process](rate, n, seed, **kw)


# ---------------------------------------------------------------------------
# accounting
# ---------------------------------------------------------------------------
@dataclass
class RequestResult:
    """One request's outcome + per-phase latency (seconds, trace time
    relative to the run's t0).  Shed requests have zero latency and no
    phases — they never entered the queue."""

    req_id: int
    sample_id: int
    arrival_s: float
    outcome: str = "shed"        # "served"|"degraded"|"encoded"|"shed"
    level: int = 2               # admitted work level (2 full .. 0 encoded)
    form: Optional[str] = None   # cache form that answered the lookup
    start_s: float = 0.0         # dequeue instant (service start)
    end_s: float = 0.0
    queue_s: float = 0.0
    fetch_s: float = 0.0
    decode_s: float = 0.0
    augment_s: float = 0.0

    @property
    def total_s(self) -> float:
        return self.end_s - self.arrival_s

    def phases(self) -> Dict[str, float]:
        """Phase breakdown with zero-duration phases omitted (an
        augmented cache hit has no decode/augment phase at all)."""
        out = {"queue": self.queue_s, "fetch": self.fetch_s}
        if self.decode_s > 0:
            out["decode"] = self.decode_s
        if self.augment_s > 0:
            out["augment"] = self.augment_s
        return out


@dataclass
class ServeResult:
    """Outcome of one :meth:`OpenLoopGenerator.run` call."""

    requests: List[RequestResult]
    makespan_s: float            # last completion (trace time, from t0)
    clock: str                   # clock name ("real" | "virtual")
    offered_rate: float          # n_arrivals / last arrival offset
    wall_s: float = 0.0          # host seconds the run() call took
    slo: Optional[SLO] = None
    counts: Dict[str, int] = field(default_factory=dict)

    @property
    def completed(self) -> List[RequestResult]:
        return [r for r in self.requests if r.outcome != "shed"]

    @property
    def shed(self) -> int:
        return self.counts.get("shed", 0)

    @property
    def degraded(self) -> int:
        return self.counts.get("degraded", 0)

    def latencies(self) -> List[float]:
        return [r.total_s for r in self.completed]

    def percentiles(self) -> Dict[str, float]:
        """p50/p99/p999 of completed-request latency (exact
        nearest-rank — see :func:`repro_torch.api.telemetry.quantile`)."""
        lat = self.latencies()
        if not lat:
            return {}
        return {"p50": quantile(lat, 0.50), "p99": quantile(lat, 0.99),
                "p999": quantile(lat, 0.999)}

    def phase_percentiles(self) -> Dict[str, Dict[str, float]]:
        per: Dict[str, List[float]] = {}
        for r in self.completed:
            for phase, dt in r.phases().items():
                per.setdefault(phase, []).append(dt)
        return {p: {"p50": quantile(v, 0.50), "p99": quantile(v, 0.99)}
                for p, v in per.items()}

    def as_dict(self) -> Dict[str, object]:
        return {
            "n_requests": len(self.requests),
            "counts": dict(self.counts),
            "offered_rate": self.offered_rate,
            "makespan_s": self.makespan_s,
            "clock": self.clock,
            "latency_s": self.percentiles(),
            "phase_latency_s": self.phase_percentiles(),
        }


# ---------------------------------------------------------------------------
# the generator
# ---------------------------------------------------------------------------
_FROM_CONFIG = object()          # sentinel: inherit SenecaConfig.slo


class OpenLoopGenerator:
    """Replay an arrival schedule against a live server with per-request
    latency accounting and (optionally) SLO-aware admission control.

    ``slo`` defaults to the server's ``SenecaConfig.slo``; pass ``None``
    explicitly for the uncontrolled baseline (requests queue without
    bound).  ``phase_costs`` maps ``"decode"`` / ``"augment"`` to modeled
    per-request service seconds charged on the clock — required for
    meaningful queueing under a :class:`VirtualClock`, where compute is
    free; leave unset on a :class:`RealClock` to measure real compute.
    ``consumer`` is called as ``consumer(result, value)`` with every
    completed request's payload — the hook the resident inference model
    (``launch/serve.py --open-loop``) feeds from.
    """

    def __init__(self, server: SenecaServer, storage: RemoteStorage, *,
                 clock: Optional[Clock] = None, slo=_FROM_CONFIG,
                 n_workers: int = 2, seed: int = 0,
                 phase_costs: Optional[Dict[str, float]] = None,
                 consumer: Optional[Callable] = None):
        if n_workers < 1:
            raise ValueError(f"n_workers must be >= 1, got {n_workers}")
        self.server = server
        self.storage = storage
        self.clock = clock or RealClock()
        self.slo: Optional[SLO] = server.service.cfg.slo \
            if slo is _FROM_CONFIG else slo
        self.n_workers = n_workers
        self.seed = seed
        self.phase_costs = dict(phase_costs) if phase_costs else {}
        self.consumer = consumer
        if self.clock.deterministic:
            transport = getattr(server.service.cache, "transport_name",
                                "sim")
            if transport != "sim":
                raise ValueError(
                    "deterministic VirtualClock serving requires the 'sim' "
                    f"shard transport, not {transport!r} (process shards "
                    "reply on wall-clock OS scheduling)")
        self._lock = threading.Lock()
        self._stop = threading.Event()

    # ------------------------------------------------------------------
    def cancel(self) -> None:
        self._stop.set()

    def run(self, arrivals: Sequence[float], *,
            sample_ids: Optional[Sequence[int]] = None,
            raise_on_error: bool = True) -> ServeResult:
        """Replay ``arrivals`` (offsets from run start, sorted) and join.

        ``sample_ids`` assigns the sample each request asks for; by
        default they are drawn uniformly from the dataset with the
        generator's seed (schedule-independent, so the same ids pair
        with the same arrival offsets across runs).
        """
        arrivals = np.asarray(list(arrivals), np.float64)
        if arrivals.size == 0:
            raise ValueError("empty arrival schedule")
        if np.any(np.diff(arrivals) < 0):
            raise ValueError("arrival offsets must be sorted ascending")
        n_total = self.storage.dataset.n_samples
        if sample_ids is None:
            sids = np.random.default_rng(self.seed).integers(
                0, n_total, size=arrivals.size)
        else:
            sids = np.asarray(list(sample_ids), np.int64)
            if sids.size != arrivals.size:
                raise ValueError(
                    f"sample_ids has {sids.size} entries for "
                    f"{arrivals.size} arrivals")
        self._stop.clear()
        self._errors: List[BaseException] = []
        self._queue: "deque" = deque()
        self._results: List[Optional[RequestResult]] = [None] * arrivals.size
        self._next_arrival: Optional[float] = None
        self._gen_done = False
        self._svc_ewma: Optional[float] = None

        import time as _time
        wall0 = _time.monotonic()
        # clock-correct control plane for the whole run (repartition
        # cooldowns tick in trace time)
        self.server.service.set_clock(self.clock)
        sess = self.server.open_session(batch_size=1)
        t0 = self.clock.now()
        self._next_arrival = t0 + float(arrivals[0])
        # the generator registers FIRST: at equal wake times the lowest
        # ticket runs first, so an arrival always lands in the queue
        # before a worker waking at the same instant looks for it
        gen_ticket = self.clock.register()
        worker_tickets = [self.clock.register()
                          for _ in range(self.n_workers)]
        threads = [threading.Thread(
            target=self._generate, args=(gen_ticket, t0, arrivals, sids),
            name="openloop-gen", daemon=True)]
        threads += [threading.Thread(
            target=self._worker, args=(ticket, t0, sess),
            name=f"openloop-w{i}", daemon=True)
            for i, ticket in enumerate(worker_tickets)]
        for t in threads:
            t.start()
        for t in threads:
            t.join()
        end_now = self.clock.now()
        sess.close()

        requests = [r for r in self._results if r is not None]
        counts = {o: 0 for o in ("served", "degraded", "encoded", "shed")}
        for r in requests:
            counts[r.outcome] += 1
        out = ServeResult(
            requests=requests,
            makespan_s=max([r.end_s for r in requests] + [end_now - t0]),
            clock=self.clock.name,
            offered_rate=float(arrivals.size / max(arrivals[-1], 1e-9)),
            wall_s=_time.monotonic() - wall0,
            slo=self.slo, counts=counts)
        if self._errors and raise_on_error:
            raise RuntimeError(
                f"open-loop serving failed: {self._errors[0]!r}"
            ) from self._errors[0]
        return out

    # ------------------------------------------------------------------
    def _admit_locked(self, backlog: int) -> Optional[int]:
        """Admission decision for one arrival (lock held): the work
        level (2 full, 1 skip-augment, 0 encoded-only) or None = shed.
        The wait estimate is ``backlog x service-time EWMA / workers`` —
        the queueing delay this request would see if admitted now."""
        slo = self.slo
        if slo is None:
            return 2
        if backlog >= slo.max_queue:
            return None
        est = 0.0 if self._svc_ewma is None \
            else backlog * self._svc_ewma / self.n_workers
        target = slo.p99_target_s
        if est > slo.shed_frac * target:
            return None
        if est > slo.encode_frac * target:
            return 0
        if est > slo.degrade_frac * target:
            return 1
        return 2

    def _generate(self, ticket: int, t0: float, arrivals: np.ndarray,
                  sids: np.ndarray) -> None:
        tel = self.server.service.telemetry
        try:
            for i in range(arrivals.size):
                now = self.clock.sleep_until(ticket, t0 + float(arrivals[i]),
                                             interrupt=self._stop)
                if self._stop.is_set():
                    return
                with self._lock:
                    self._next_arrival = t0 + float(arrivals[i + 1]) \
                        if i + 1 < arrivals.size else None
                    level = self._admit_locked(len(self._queue))
                    if level is None:
                        res = RequestResult(
                            req_id=i, sample_id=int(sids[i]),
                            arrival_s=now - t0, outcome="shed",
                            start_s=now - t0, end_s=now - t0)
                        self._results[i] = res
                    else:
                        self._queue.append((i, int(sids[i]), now, level))
                if level is None:
                    tel.record_request("shed")
        except BaseException as e:      # noqa: BLE001 - reported after join
            with self._lock:
                self._errors.append(e)
            self._stop.set()
            log.warning("open-loop generator failed", exc_info=True)
        finally:
            with self._lock:
                self._gen_done = True
            self.clock.unregister(ticket)

    def _worker(self, ticket: int, t0: float, sess) -> None:
        # bind so storage token-bucket stalls (and modeled phase costs)
        # charge this participant's clock turn, not wall time
        self.clock.bind(ticket)
        try:
            while not self._stop.is_set():
                with self._lock:
                    item = self._queue.popleft() if self._queue else None
                    gen_done = self._gen_done
                    next_arr = self._next_arrival
                if item is None:
                    if gen_done:
                        return
                    now = self.clock.now()
                    # idle until the published next arrival; the small
                    # fallback step avoids a zero-advance livelock when
                    # that instant is already here but not yet enqueued
                    wake = next_arr if next_arr is not None \
                        and next_arr > now else now + 1e-3
                    self.clock.sleep_until(ticket, wake,
                                           interrupt=self._stop)
                    continue
                self._serve(item, t0, sess)
        except BaseException as e:      # noqa: BLE001 - reported after join
            with self._lock:
                self._errors.append(e)
            self._stop.set()
            log.warning("open-loop worker failed", exc_info=True)
        finally:
            self.clock.unbind()
            self.clock.unregister(ticket)

    # ------------------------------------------------------------------
    def _charge(self, phase: str) -> None:
        """Charge a modeled per-request service cost for ``phase`` on
        the clock (no-op unless configured in ``phase_costs``)."""
        cost = self.phase_costs.get(phase, 0.0)
        if cost > 0:
            self.clock.stall(cost, interrupt=self._stop)

    def _serve(self, item, t0: float, sess) -> None:
        """One request through lookup → fetch → decode → augment, capped
        at its admitted work level; admits produced forms back to the
        shared cache exactly like the closed-loop pipeline."""
        req_id, sid, arrival_abs, level = item
        now = self.clock.now
        ds = self.storage.dataset
        tel = self.server.service.telemetry
        start = now()
        form, value, _tier = sess.lookup_tiered(sid)
        if isinstance(value, torch.Tensor):
            # an HBM-tier hit is a device tensor; the form ladder below
            # and the consumer work on host arrays
            value = value.cpu().numpy()
        tel.record_serve(form)
        fetch_s = decode_s = augment_s = 0.0
        if form is None:
            enc = self.storage.fetch(sid)       # clock-aware stall
            sess.admit(sid, "encoded", enc, len(enc))
            cur_form, cur = "encoded", enc
        else:
            cur_form, cur = form, value
        fetch_s = now() - start
        # work up the form ladder, but never past the admitted level —
        # a cache hit above the level is served as-is (degrading caps
        # work, not the quality of what is already cached)
        if level >= 1 and cur_form == "encoded":
            t1 = now()
            self._charge("decode")
            img = ds.decode(cur, sid)
            sess.admit(sid, "decoded", img, img.nbytes)
            decode_s = now() - t1
            cur_form, cur = "decoded", img
        if level >= 2 and cur_form == "decoded":
            t2 = now()
            self._charge("augment")
            out = augment_np(cur, ds.crop_hw, np.random.default_rng(
                _aug_seed(sess.epoch, sid)))
            sess.admit(sid, "augmented", out, out.nbytes)
            augment_s = now() - t2
            cur_form, cur = "augmented", out
        end = now()
        res = RequestResult(
            req_id=req_id, sample_id=sid, arrival_s=arrival_abs - t0,
            outcome=_OUTCOME[cur_form], level=level, form=form,
            start_s=start - t0, end_s=end - t0,
            queue_s=start - arrival_abs, fetch_s=fetch_s,
            decode_s=decode_s, augment_s=augment_s)
        with self._lock:
            self._results[req_id] = res
            # service-time EWMA feeding the admission wait estimate
            svc = end - start
            self._svc_ewma = svc if self._svc_ewma is None \
                else 0.2 * svc + 0.8 * self._svc_ewma
        tel.record_request(res.outcome, total_s=res.total_s,
                           phases=res.phases())
        if self.consumer is not None:
            self.consumer(res, cur)
