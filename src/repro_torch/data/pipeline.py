"""The real (threaded) DSI pipeline: sampler -> fetch -> decode -> augment
-> collate -> device.

Feeds from a :class:`repro_torch.api.Session` over the shared Seneca service
(MDP-partitioned cache + pluggable sampling/admission/eviction policies),
so the paper's concurrency experiments run for real on CPU::

    server = SenecaServer.for_dataset(ds)
    pipe = DSIPipeline(server.open_session(batch_size=32), storage)
    batch = pipe.next_batch()

Three executors (the ``executor=`` knob):

* ``"per-sample"`` (default, the seed behavior): every sample runs
  fetch->decode->augment serially inside one worker, ``next_batch`` is a
  synchronous barrier over the whole batch.
* ``"device"``: device-resident preprocessing on the service's device
  (CUDA unless the server was built with ``device="cpu"``) — encoded
  samples go through the fused decode+augment kernel K1
  (:func:`repro_torch.kernels.augment.ops.decode_augment_batch_seeded`)
  in one launch per batch (only per-sample scalars cross the PCIe
  link), HBM cache hits serve zero-copy device tensors, decoded hits go
  through the augment kernel K2, and the collated ``"images"`` tensor
  is a float32 ``torch.Tensor`` on that device, ready for the training
  step.
  Host→device payload copies (DRAM/disk hits, decoded-hit uploads) are
  metered on the telemetry ``"h2d"`` channel, which calibrates
  ``HardwareProfile.b_hbm`` — an all-HBM-hit epoch records zero bytes
  there.  Synchronous and single-threaded like ``"per-sample"``
  (VirtualClock-deterministic with ``sync_refills``); requires a
  dataset whose ``decode`` is the counter-hash
  ``SyntheticDataset.decode`` (see :func:`fused_decode_seed`).
* ``"stage-parallel"``: a decoupled asynchronous executor — bounded
  queues between sampler -> fetch -> decode -> augment -> collate,
  per-stage worker groups sized from the service telemetry's stage EWMAs
  (:func:`plan_stage_workers`), an augment stage that batches decoded
  samples through the service's vectorized
  :class:`~repro_torch.api.backends.AugmentBackend` (CUDA kernel or
  NumPy loop), and batch-granular cache admission (one lock acquisition per
  admitted batch via ``Session.admit_batch``).  Batches are emitted in
  sampling order; batch N+1's storage fetches overlap batch N's
  decode/augment, so throughput approaches the slowest *stage* instead
  of the per-batch sum (benchmarks/fig_pipeline_throughput.py).

Both executors produce identical tensors for a given (epoch, sample id):
augmentation parameters derive from per-sample seeds, not executor
scheduling.  Batches carry an additive ``"ids"`` key with the sample ids
in slot order.

Cache admission goes through the service's :class:`AdmissionPolicy` hooks
(capacity is voted under the cache lock, atomically with the insert) —
this module never touches cache partitions directly.

The old ``DSIPipeline(job_id, service, storage, batch_size=...)`` call
style still works as a deprecated shim that opens a session internally.
"""
from __future__ import annotations

import logging
import queue
import threading
import time
import warnings
from concurrent.futures import ThreadPoolExecutor
from dataclasses import dataclass
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from repro_torch.api.server import SenecaService, Session, SessionClosed
from repro_torch.data.augment import augment_np
from repro_torch.data.storage import RemoteStorage
from repro_torch.data.synthetic import SyntheticDataset
from repro_torch.kernels.augment.ops import (augment_batch_seeded,
                                             decode_augment_batch_seeded)
from repro_torch.kernels.decode.ops import fused_decode_seed
from repro_torch.kernels.device import concrete_device

log = logging.getLogger(__name__)

EXECUTORS = ("per-sample", "stage-parallel", "device")


def _aug_seed(epoch_tag: int, sid: int) -> int:
    """The per-sample augmentation seed — shared by every executor and
    both augment backends, so batch composition never changes content."""
    return (epoch_tag * 1_000_003 + sid) & 0x7FFFFFFF


def _on_device(value, dev: torch.device) -> bool:
    """``value`` is a tensor on ``dev`` (an index-less ``cuda`` means
    the current CUDA device)."""
    return (isinstance(value, torch.Tensor)
            and value.device.type == dev.type
            and value.device == concrete_device(dev))


@dataclass
class StageTimes:
    fetch: float = 0.0
    decode: float = 0.0
    augment: float = 0.0
    collate: float = 0.0
    batches: int = 0

    def as_dict(self) -> Dict[str, float]:
        return {"fetch": self.fetch, "decode": self.decode,
                "augment": self.augment, "collate": self.collate,
                "batches": self.batches}


def plan_stage_workers(telemetry, n_workers: int) -> Tuple[int, int]:
    """Size the (fetch, decode) worker groups from the telemetry stage
    EWMAs.

    The ``n_workers`` budget is split proportionally to the observed
    storage-fetch vs decode latencies (clamped to >= 1 each; an even
    split until both signals exist, with a budget floor of 2).  The
    fetch share is then doubled: fetch workers spend most of their time
    parked in storage waits (token bucket / network), so 2x
    oversubscription keeps the storage channel busy through the GIL
    pauses of the CPU stages — decode keeps the plain CPU share.  The
    stage-parallel executor re-plans this every batch as the EWMAs move
    (elastic groups), so a pipeline that starts cache-cold and becomes
    decode-bound sheds fetch workers live.
    """
    total = max(int(n_workers), 2)
    lat = telemetry.snapshot().stage_latency
    fetch, decode = lat.get("fetch_storage"), lat.get("decode")
    if not fetch or not decode:
        base_fetch = max(total // 2, 1)
    else:
        base_fetch = int(round(total * fetch / (fetch + decode)))
        base_fetch = min(max(base_fetch, 1), total - 1)
    return 2 * base_fetch, total - base_fetch


class _Assembly:
    """One in-flight batch: slots fill in as samples finish their route.

    ``arrived`` is touched only by the single augment-stage thread (every
    sample's route ends there, pre-augmented cache hits included), which
    is what makes batch completion race-free without a per-batch lock.
    """

    __slots__ = ("seq", "ids", "epoch", "out", "arrived")

    def __init__(self, seq: int, ids: List[int], epoch: int):
        self.seq = seq
        self.ids = ids
        self.epoch = epoch
        self.out: List[Optional[np.ndarray]] = [None] * len(ids)
        self.arrived = 0


class _StageParallelExecutor:
    """Queue-fed stage pipeline over one DSIPipeline's session/storage.

    Thread layout: 1 sampler, ``n_fetch`` fetch workers, ``n_decode``
    decode workers, 1 augment (vectorized, batch-granular admission),
    1 collate (in-order emission, refill + repartition ticks).  Bounded
    queues propagate consumer backpressure all the way to the sampler;
    every put/get is stop-aware so teardown never deadlocks.
    """

    def __init__(self, pipe: "DSIPipeline", out_depth: int):
        self.pipe = pipe
        bs = pipe.bs
        self._stop = threading.Event()
        self.error: Optional[BaseException] = None
        self._session_closed = False
        self.fetch_q: "queue.Queue" = queue.Queue(maxsize=2 * bs)
        self.decode_q: "queue.Queue" = queue.Queue(maxsize=2 * bs)
        self.augment_q: "queue.Queue" = queue.Queue(maxsize=2 * bs)
        self.collate_q: "queue.Queue" = queue.Queue(maxsize=out_depth + 1)
        self.out_q: "queue.Queue" = queue.Queue(maxsize=max(out_depth, 1))
        # elastic worker groups: live/target counts per resizable stage.
        # The collate thread re-plans targets from telemetry every batch;
        # surplus workers retire themselves, missing ones are spawned.
        self._group_lock = threading.Lock()
        self._live = {"fetch": 0, "decode": 0}
        self._target = dict(zip(("fetch", "decode"), plan_stage_workers(
            pipe.telemetry, pipe._n_workers)))
        self._last_plan = dict(self._target)
        self._group_loops = {"fetch": self._fetch_loop,
                             "decode": self._decode_loop}
        self._threads: List[threading.Thread] = []
        for target, name in ((self._sampler_loop, "sampler"),
                             (self._augment_loop, "augment"),
                             (self._collate_loop, "collate")):
            t = threading.Thread(target=target, daemon=True,
                                 name=f"dsi-{name}")
            self._threads.append(t)
            t.start()
        self._reconcile_groups()

    # -- elastic worker groups -----------------------------------------
    def worker_counts(self) -> Dict[str, int]:
        with self._group_lock:
            return dict(self._live)

    def _resize_groups(self) -> None:
        """Re-plan the fetch/decode group sizes from the current stage
        EWMAs (collate thread, once per batch), debounced: a new plan is
        applied only when two consecutive batches agree on it, so EWMA
        jitter flapping across a rounding boundary cannot churn worker
        threads every batch, while any persistent shift in the stage
        balance lands within two batches."""
        planned = dict(zip(("fetch", "decode"), plan_stage_workers(
            self.pipe.telemetry, self.pipe._n_workers)))
        with self._group_lock:
            if planned == self._last_plan:
                self._target.update(planned)
            self._last_plan = planned
        self._reconcile_groups()

    def _reconcile_groups(self) -> None:
        """Spawn workers up to the group targets (retiring is the worker
        loops' own job) and drop finished threads from the join list so
        it cannot grow without bound across retarget cycles."""
        spawn: List[str] = []
        with self._group_lock:
            for group, tgt in self._target.items():
                while self._live[group] < tgt:
                    self._live[group] += 1
                    spawn.append(group)
        self._threads = [t for t in self._threads if t.is_alive()]
        for group in spawn:
            t = threading.Thread(target=self._group_loops[group],
                                 daemon=True, name=f"dsi-{group}")
            self._threads.append(t)
            t.start()

    def _surplus(self, group: str) -> bool:
        """True when this worker should retire (its group shrank)."""
        with self._group_lock:
            if self._live[group] > self._target[group]:
                self._live[group] -= 1
                return True
        return False

    # -- stop-aware queue plumbing -------------------------------------
    def _put(self, q: "queue.Queue", item) -> bool:
        while not self._stop.is_set():
            try:
                q.put(item, timeout=0.1)
                return True
            except queue.Full:
                continue
        return False

    def _get(self, q: "queue.Queue"):
        while not self._stop.is_set():
            try:
                return q.get(timeout=0.1)
            except queue.Empty:
                continue
        return None

    def _fail(self, exc: BaseException) -> None:
        """First failure wins: record, surface in telemetry, halt the
        executor (an incomplete assembly can never collate, so limping
        on would just hang the consumer)."""
        if self.error is None:
            self.error = exc
        if self.pipe.telemetry.record_error("pipeline") == 1:
            log.warning("stage-parallel executor failed; first error:",
                        exc_info=exc)
        self._stop.set()

    # -- stages --------------------------------------------------------
    def _sampler_loop(self) -> None:
        seq = 0
        pipe = self.pipe
        while not self._stop.is_set():
            try:
                ids, _forms = pipe.session.next_batch_ids()
            except SessionClosed:
                # normal lifecycle, not a failure — but the consumer must
                # fail fast like the per-sample executor does, not block
                # out a full get_batch timeout on a drained queue
                self._session_closed = True
                self._stop.set()
                return
            except Exception as e:      # noqa: BLE001 - recorded, not lost
                self._fail(e)
                return
            asm = _Assembly(seq, [int(x) for x in ids], pipe.session.epoch)
            seq += 1
            for slot in range(len(asm.ids)):
                if not self._put(self.fetch_q, (asm, slot)):
                    return

    def _fetch_loop(self) -> None:
        pipe = self.pipe
        tel = pipe.telemetry
        while not self._stop.is_set():
            if self._surplus("fetch"):
                return
            item = self._get(self.fetch_q)
            if item is None:
                return
            asm, slot = item
            sid = asm.ids[slot]
            try:
                t_look = pipe._now()
                form, value, tier = pipe.session.lookup_tiered(sid)
                tel.record_serve(form)
                t0 = pipe._now()
                if form is None:
                    ok = self._fetch_miss(asm, slot, sid)
                else:
                    pipe.times.fetch += t0 - t_look
                    tel.record_stage("fetch_cache", t0 - t_look)
                    nbytes = value.nbytes if hasattr(value, "nbytes") \
                        else len(value)
                    # spill-tier hits calibrate b_disk, DRAM hits b_cache
                    tel.record_bytes("disk" if tier == "disk" else "cache",
                                     nbytes, t0 - t_look)
                    if form == "augmented":
                        ok = self._put(self.augment_q,
                                       (asm, slot, value, None, False, True,
                                        None))
                    elif form == "decoded":
                        ok = self._put(self.augment_q,
                                       (asm, slot, value, None, False,
                                        False, None))
                    else:                        # encoded cache hit
                        ok = self._put(self.decode_q,
                                       (asm, slot, value, False, None))
                if not ok:
                    return
            except Exception as e:      # noqa: BLE001
                self._fail(e)
                return

    def _fetch_miss(self, asm: "_Assembly", slot: int, sid: int) -> bool:
        """Storage-miss path of the fetch stage, single-flight aware:
        the leader fetches and carries its flight through decode ->
        augment (finished with the augmented row in `_augment_group`);
        joiners receive the finished value and skip straight to the
        pre-augmented queue."""
        pipe = self.pipe
        tel = pipe.telemetry
        prod = pipe._production
        flight = None
        while prod is not None:
            leader, flight = prod.begin(sid, "augmented")
            if leader:
                break            # flight is None in observe mode
            t_j = pipe._now()
            ok, joined = prod.join(flight, pipe._clock)
            if ok:
                tel.record_coalesced(max(pipe._now() - t_j, 0.0))
                return self._put(self.augment_q,
                                 (asm, slot, joined, None, False, True,
                                  None))
            if not flight.done:
                # wait declined or timed out: produce ourselves
                flight = None
                break
            # leader aborted: retry begin(); the first retrier leads
        t0 = pipe._now()
        try:
            enc = pipe.storage.fetch(sid)
        except BaseException:
            if prod is not None:
                prod.abort(flight)
            raise
        dt = pipe._now() - t0
        pipe.times.fetch += dt
        tel.record_stage("fetch_storage", dt)
        tel.record_bytes("storage", len(enc), dt)
        ok = self._put(self.decode_q, (asm, slot, enc, True, flight))
        if not ok and prod is not None:
            prod.abort(flight)   # shutting down: don't strand joiners
        return ok

    def _decode_loop(self) -> None:
        pipe = self.pipe
        while not self._stop.is_set():
            if self._surplus("decode"):
                return
            item = self._get(self.decode_q)
            if item is None:
                return
            asm, slot, enc, from_storage, flight = item
            try:
                t1 = pipe._now()
                img = pipe.ds.decode(enc, asm.ids[slot])
                dt = pipe._now() - t1
                pipe.times.decode += dt
                # unlocked _live read: an approximate worker count is
                # fine for the calibration scale factor
                pipe.telemetry.record_stage(
                    "decode", dt, workers=max(self._live["decode"], 1))
                # carry enc along only when it still needs admission, so
                # the augment stage can batch-admit the encoded form too
                if not self._put(self.augment_q,
                                 (asm, slot, img,
                                  enc if from_storage else None, True,
                                  False, flight)):
                    if pipe._production is not None:
                        pipe._production.abort(flight)
                    return
            except Exception as e:      # noqa: BLE001
                if pipe._production is not None:
                    pipe._production.abort(flight)
                self._fail(e)
                return

    def _augment_loop(self) -> None:
        pipe = self.pipe
        sess = pipe.session
        # per-assembly buffers of samples awaiting vectorized augmentation:
        # seq -> [(slot, img, enc_to_admit, admit_decoded, flight)]
        buffers: Dict[int, List] = {}
        while not self._stop.is_set():
            item = self._get(self.augment_q)
            if item is None:
                return
            asm, slot, payload, enc, admit_dec, pre, flight = item
            try:
                if pre:
                    asm.out[slot] = payload
                else:
                    buffers.setdefault(asm.seq, []).append(
                        (slot, payload, enc, admit_dec, flight))
                asm.arrived += 1
                if asm.arrived < len(asm.ids):
                    continue
                group = buffers.pop(asm.seq, [])
                if group:
                    self._augment_group(sess, asm, group)
                if not self._put(self.collate_q, asm):
                    return
            except Exception as e:      # noqa: BLE001
                self._fail(e)
                return

    def _augment_group(self, sess: Session, asm: _Assembly,
                       group: List) -> None:
        """Vectorized augment + batch-granular admission for the samples
        of one assembly that were not served pre-augmented."""
        pipe = self.pipe
        try:
            self._augment_group_inner(sess, asm, group)
        except BaseException:
            prod = pipe._production
            if prod is not None:
                # no flight was finished yet (the hand-off loop is the
                # inner body's last step): wake every joiner to retry
                for _slot, _img, _enc, _ad, fl in group:
                    prod.abort(fl)
            raise

    def _augment_group_inner(self, sess: Session, asm: _Assembly,
                             group: List) -> None:
        pipe = self.pipe
        enc_entries = [(asm.ids[slot], enc, len(enc))
                       for slot, _img, enc, _ad, _fl in group
                       if enc is not None]
        if enc_entries:
            sess.admit_batch("encoded", enc_entries)
        dec_entries = [(asm.ids[slot], img, img.nbytes)
                       for slot, img, _enc, ad, _fl in group if ad]
        if dec_entries:
            sess.admit_batch("decoded", dec_entries)
        slots = [slot for slot, _img, _enc, _ad, _fl in group]
        imgs = np.stack([img for _slot, img, _enc, _ad, _fl in group])
        seeds = np.asarray([_aug_seed(asm.epoch, asm.ids[s]) for s in slots],
                           np.int64)
        t2 = pipe._now()
        outs = pipe.augment.augment_batch(imgs, pipe.ds.crop_hw, seeds)
        dt = pipe._now() - t2
        pipe.times.augment += dt
        # the augment stage is one thread, not the whole worker pool:
        # report that, or calibrate() would overestimate t_a ~n_workers x
        pipe.telemetry.record_stage("augment", dt, n=len(slots), workers=1)
        # np.array copies: cached rows must not pin the whole batch
        # array.  Pre-vote the metadata half of admission so the copies
        # are only built for entries the policy would take — under
        # unseen-only admission a single-session pipeline's own samples
        # are all already seen, so this skips B row copies per batch
        if pipe.svc.tier_capacity("augmented") > 0:
            ids = [asm.ids[s] for s in slots]
            wanted = pipe.svc.admission_votes("augmented", ids)
            entries = [(sid, np.array(outs[i]), outs[i].nbytes)
                       for i, (sid, w) in enumerate(zip(ids, wanted)) if w]
            if entries:
                sess.admit_batch("augmented", entries)
        for i, s in enumerate(slots):
            asm.out[s] = outs[i]
        prod = pipe._production
        if prod is not None:
            for i, (_slot, _img, _enc, _ad, fl) in enumerate(group):
                if fl is not None:
                    # np.array copy: the handed-off row must not pin
                    # the whole batch array in every joiner's cache
                    prod.finish(fl, np.array(outs[i]))

    def _collate_loop(self) -> None:
        pipe = self.pipe
        pending: Dict[int, _Assembly] = {}
        next_seq = 0
        while not self._stop.is_set():
            asm = self._get(self.collate_q)
            if asm is None:
                return
            try:
                pending[asm.seq] = asm
                while next_seq in pending:     # emit in sampling order
                    asm = pending.pop(next_seq)
                    t0 = pipe._now()
                    batch = {
                        # copy=False: backends return float32 already —
                        # don't re-copy the whole batch on the one
                        # thread that serializes emission
                        "images": np.stack(asm.out).astype(np.float32,
                                                           copy=False),
                        "labels": np.asarray(
                            [pipe.ds.label(s) for s in asm.ids], np.int32),
                        "ids": np.asarray(asm.ids, np.int64),
                    }
                    dt = pipe._now() - t0
                    pipe.times.collate += dt
                    pipe.telemetry.record_stage("collate", dt,
                                                n=len(asm.ids))
                    pipe.times.batches += 1
                    pipe._process_refills()
                    pipe.svc.maybe_repartition()
                    self._gauge_queues()
                    self._resize_groups()
                    if not self._put(self.out_q, batch):
                        return
                    next_seq += 1
            except Exception as e:      # noqa: BLE001 - same contract as
                self._fail(e)           # every other stage loop: no
                return                  # silent thread death

    def _gauge_queues(self) -> None:
        tel = self.pipe.telemetry
        for name, q in (("fetch", self.fetch_q), ("decode", self.decode_q),
                        ("augment", self.augment_q),
                        ("collate", self.collate_q), ("out", self.out_q)):
            tel.record_queue(name, q.qsize(), q.maxsize)

    # -- consumer side -------------------------------------------------
    def get_batch(self,
                  timeout: Optional[float] = 60.0
                  ) -> Dict[str, np.ndarray]:
        """Next collated batch.  ``timeout=None`` blocks until one is
        ready (``next_batch`` semantics — a slow pipeline is not an
        error); a finite timeout raises ``queue.Empty`` at the deadline
        (``get`` semantics, matching the per-sample prefetch queue).

        The inner poll is capped at the *remaining* deadline, never a
        fixed quantum: a finite ``timeout < 0.2`` used to overshoot by
        up to a full 0.2 s poll interval before the deadline was even
        checked."""
        deadline = float("inf") if timeout is None \
            else time.monotonic() + timeout
        while True:
            wait = min(0.2, deadline - time.monotonic()) \
                if deadline != float("inf") else 0.2
            try:
                return self.out_q.get(timeout=max(wait, 0.0))
            except queue.Empty:
                if self.error is not None:
                    raise RuntimeError(
                        "stage-parallel pipeline failed; see telemetry "
                        "errors") from self.error
                if self._session_closed:
                    raise SessionClosed(
                        "session closed while the stage-parallel "
                        "pipeline was running; open a new one with "
                        "SenecaServer.open_session()")
                if self._stop.is_set():
                    raise RuntimeError(
                        "stage-parallel pipeline is stopped")
                if time.monotonic() >= deadline:
                    raise

    def stop(self) -> None:
        self._stop.set()
        for t in list(self._threads):
            t.join(timeout=2.0)
        # don't leave this executor's group sizes scaling latencies that
        # a per-sample pipeline on the same service reports afterwards
        self.pipe.telemetry.clear_stage_workers("decode", "augment")


class DSIPipeline:
    """Per-session pipeline over a shared Seneca service + RemoteStorage."""

    def __init__(self, session, storage: Optional[RemoteStorage] = None,
                 *legacy_storage, batch_size: Optional[int] = None,
                 n_workers: int = 4, prefetch: int = 2, seed: int = 0,
                 executor: str = "per-sample", augment_backend=None,
                 consume_hook=None, sync_refills: bool = False,
                 clock=None):
        # validate before any side effect: the legacy path below
        # registers a job on the shared service, which must not leak
        # when construction fails
        if executor not in EXECUTORS:
            raise ValueError(f"unknown executor {executor!r}; expected "
                             f"one of {EXECUTORS}")
        if isinstance(session, Session):
            self.session = session
            if not isinstance(storage, RemoteStorage):
                raise TypeError("DSIPipeline(session, storage) needs a "
                                "RemoteStorage as its second argument")
        else:
            # legacy (job_id, service, storage, batch_size=...) call style
            warnings.warn(
                "DSIPipeline(job_id, service, storage, batch_size=...) is "
                "deprecated; pass a Session from "
                "SenecaServer.open_session()", DeprecationWarning,
                stacklevel=2)
            job_id, service = int(session), storage
            if len(legacy_storage) > 1 and batch_size is None:
                batch_size = legacy_storage[1]   # old positional form
            if not (isinstance(service, SenecaService) and legacy_storage
                    and batch_size):
                raise TypeError(
                    "expected DSIPipeline(session, storage) or legacy "
                    "DSIPipeline(job_id, service, storage, batch_size=N)")
            storage = legacy_storage[0]
            service.register_job(job_id, batch_size)
            self.session = Session(service, job_id, batch_size)
        self.executor = executor
        self.svc: SenecaService = self.session.service
        self.storage = storage
        self.ds: SyntheticDataset = storage.dataset
        self._fused_seed: Optional[int] = None
        if executor == "device":
            self._fused_seed = fused_decode_seed(self.ds)
            if self._fused_seed is None:
                raise ValueError(
                    "device executor needs a dataset whose decode is the "
                    "counter-hash SyntheticDataset.decode (the fused "
                    f"kernel's semantics); got {type(self.ds).__name__}")
        self.bs = self.session.batch_size
        self.pool = ThreadPoolExecutor(max_workers=n_workers)
        self.times = StageTimes()
        # pluggable time source for per-request/stage phase timestamps
        # (duck-typed Clock: .now()).  None keeps the historical wall
        # clock; a VirtualClock makes every recorded phase a *trace*
        # time — storage stalls charged through the clock-aware token
        # bucket then show up in fetch telemetry deterministically,
        # while pure-compute phases cost zero virtual seconds.
        # Host-side liveness deadlines (queue polls, thread joins) stay
        # on wall time regardless.
        self._now = time.monotonic if clock is None else clock.now
        self._clock = clock
        # cross-job single-flight table (service-level; None for bare
        # service doubles in tests) — consulted before producing a miss
        self._production = getattr(self.svc, "production", None)
        # telemetry feeds the adaptive repartition loop: per-stage EWMAs,
        # transfer bandwidths, per-form serve counts and (stage-parallel)
        # queue gauges, aggregated across every pipeline on the service
        self.telemetry = self.svc.telemetry
        self._n_workers = n_workers
        self.telemetry.add_concurrency(n_workers)
        self.rng = np.random.default_rng(seed + self.session.job_id)
        # batched augmentation engine (stage-parallel augment stage):
        # service-level knob, overridable per pipeline
        if augment_backend is None:
            self.augment = self.svc.augment
        else:
            from repro_torch.api.backends import resolve_augment_backend
            self.augment = resolve_augment_backend(augment_backend)
        # consumer-rate hook: called with every batch ``next_batch``
        # emits, on the emitting thread, before the batch is returned.
        # The WorkloadRunner installs a rate limiter here to emulate GPU
        # ingest (repro/workload/runner.py); anything callable works.
        self._consume_hook = consume_hook
        # deterministic mode: run background refills inline on the
        # calling thread instead of racing them on the worker pool
        # (required for byte-identical virtual-clock workload runs)
        self._sync_refills = sync_refills
        self._prefetch_depth = prefetch
        self._q: "queue.Queue" = queue.Queue(maxsize=prefetch)
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None
        self._prefetch_exc: Optional[BaseException] = None
        self._executor: Optional[_StageParallelExecutor] = None
        self._executor_lock = threading.Lock()

    # ------------------------------------------------------------------
    def _produce_sample(self, sid: int, epoch_tag: int) -> np.ndarray:
        """Run one sample through the remaining pipeline stages."""
        t_look = self._now()
        form, value, tier = self.session.lookup_tiered(sid)
        self.telemetry.record_serve(form)
        # spill-tier hits calibrate b_disk, DRAM hits b_cache
        channel = "disk" if tier == "disk" else "cache"
        t0 = self._now()
        if form == "augmented":
            # hit cost is the lookup interval (t0 - t_look): StageTimes
            # and telemetry account the same thing (the seed charged
            # "now - t0" ~ 0 here, undercounting every hit)
            self.times.fetch += t0 - t_look
            self.telemetry.record_stage("fetch_cache", t0 - t_look)
            self.telemetry.record_bytes(channel, value.nbytes, t0 - t_look)
            return value
        if form is not None:
            # decoded/encoded hit: the lookup interval is charged here,
            # the remaining production stages in _produce_miss
            nbytes = value.nbytes if form == "decoded" else len(value)
            self.times.fetch += t0 - t_look
            self.telemetry.record_stage("fetch_cache", t0 - t_look)
            self.telemetry.record_bytes(channel, nbytes, t0 - t_look)
        prod = self._production
        if prod is None:
            return self._produce_miss(sid, epoch_tag, form, value)
        # single-flight: first misser of (sid, "augmented") leads and
        # produces; concurrent missers join and receive the result
        # zero-copy, or fall back to producing when waiting is unsafe
        while True:
            leader, flight = prod.begin(sid, "augmented")
            if leader:
                if flight is None:   # observe mode: duplicate, but live
                    return self._produce_miss(sid, epoch_tag, form, value)
                try:
                    out = self._produce_miss(sid, epoch_tag, form, value)
                except BaseException as e:
                    prod.abort(flight, e)
                    raise
                prod.finish(flight, out)
                return out
            t_j = self._now()
            ok, joined = prod.join(flight, self._clock)
            if ok:
                self.telemetry.record_coalesced(max(self._now() - t_j, 0.0))
                return joined
            if not flight.done:
                # wait declined (deterministic clock, no bound ticket)
                # or timed out on a wedged leader: produce ourselves —
                # a duplicate production, never a stall
                return self._produce_miss(sid, epoch_tag, form, value)
            # leader aborted: retry begin(); the first retrier leads

    def _produce_miss(self, sid: int, epoch_tag: int,
                      form: Optional[str], value) -> np.ndarray:
        """Remaining stages for a sample not cached in augmented form:
        fetch/decode as ``form`` requires, then augment + admit."""
        if form == "decoded":
            img = value
        elif form == "encoded":
            t1 = self._now()
            img = self.ds.decode(value, sid)
            dt = self._now() - t1
            self.times.decode += dt
            self.telemetry.record_stage("decode", dt)
            self.session.admit(sid, "decoded", img, img.nbytes)
        else:
            t0 = self._now()
            enc = self.storage.fetch(sid)
            dt = self._now() - t0
            self.times.fetch += dt
            self.telemetry.record_stage("fetch_storage", dt)
            self.telemetry.record_bytes("storage", len(enc), dt)
            self.session.admit(sid, "encoded", enc, len(enc))
            t1 = self._now()
            img = self.ds.decode(enc, sid)
            dt = self._now() - t1
            self.times.decode += dt
            self.telemetry.record_stage("decode", dt)
            self.session.admit(sid, "decoded", img, img.nbytes)
        t2 = self._now()
        out = augment_np(img, self.ds.crop_hw,
                         np.random.default_rng(_aug_seed(epoch_tag, sid)))
        dt = self._now() - t2
        self.times.augment += dt
        self.telemetry.record_stage("augment", dt)
        self.session.admit(sid, "augmented", out, out.nbytes)
        return out

    # ------------------------------------------------------------------
    def next_batch(self) -> Dict[str, np.ndarray]:
        if self.executor == "stage-parallel":
            # block until produced, like the per-sample path: slowness is
            # backpressure, not failure (errors still raise immediately)
            batch = self._ensure_executor().get_batch(timeout=None)
            if self._consume_hook is not None:
                self._consume_hook(batch)
            return batch
        if self.executor == "device":
            batch = self._next_batch_device()
            if self._consume_hook is not None:
                self._consume_hook(batch)
            return batch
        ids, _forms = self.session.next_batch_ids()
        epoch_tag = self.session.epoch
        imgs = list(self.pool.map(
            lambda s: self._produce_sample(int(s), epoch_tag), ids))
        t0 = self._now()
        batch = {
            "images": np.stack(imgs).astype(np.float32),
            "labels": np.asarray([self.ds.label(int(s)) for s in ids],
                                 np.int32),
            "ids": np.asarray(ids, np.int64),
        }
        dt = self._now() - t0
        self.times.collate += dt
        self.telemetry.record_stage("collate", dt, n=len(ids))
        self.times.batches += 1
        self._process_refills()
        # adaptive-repartition tick: a fast no-op in "static"/"on-change"
        # modes; in "adaptive" this is where calibrated drift is checked
        self.svc.maybe_repartition()
        if self._consume_hook is not None:
            self._consume_hook(batch)
        return batch

    def _next_batch_device(self) -> Dict[str, object]:
        """One batch through the device route: fused decode+augment for
        encoded samples, zero-copy serve for HBM hits, device collate.

        Every sample ends as a row on the service's device; the only
        host→device payload traffic (metered on the ``"h2d"`` channel)
        is DRAM/disk-cached values being uploaded.  Encoded samples
        never materialize a host decoded image — the fused kernel ships
        per-sample scalars only — so (by design) this route admits no
        "decoded" forms.

        Telemetry timings call ``torch.cuda.synchronize`` before the
        closing timestamp — otherwise the h2d EWMA feeding the
        CALIBRATABLE ``b_hbm`` and the fused stage times would measure
        launch latency, not the transfer or compute, and mis-steer MDP
        repartitioning.

        Rows admitted into the HBM tier are clones: a row of a batch
        tensor is a view that keeps the whole batch's storage alive, so
        admitting it would let one cached row pin ``B`` rows of device
        memory that the tier's byte ledger never sees.
        """
        tel = self.telemetry
        dev = self.svc.device
        ids, _forms = self.session.next_batch_ids()
        epoch_tag = self.session.epoch
        rows: List = [None] * len(ids)
        enc_group: List[Tuple[int, int, bytes]] = []   # (slot, sid, payload)
        dec_group: List[Tuple[int, int, np.ndarray]] = []
        dec_dev_group: List[Tuple[int, int, object]] = []  # HBM decoded hits
        for slot, sid_ in enumerate(ids):
            sid = int(sid_)
            t_look = self._now()
            form, value, tier = self.session.lookup_tiered(sid)
            tel.record_serve(form)
            t0 = self._now()
            if form is None:
                enc = self.storage.fetch(sid)
                dt = self._now() - t0
                self.times.fetch += dt
                tel.record_stage("fetch_storage", dt)
                tel.record_bytes("storage", len(enc), dt)
                self.session.admit(sid, "encoded", enc, len(enc))
                enc_group.append((slot, sid, enc))
                continue
            self.times.fetch += t0 - t_look
            tel.record_stage("fetch_cache", t0 - t_look)
            # an "hbm" hit is device-resident only as a tensor on this
            # device: a process shard ships its HBM values down as host
            # copies, which take the host branch like a DRAM hit
            resident = tier == "hbm" and _on_device(value, dev)
            if form == "augmented" and resident:
                # zero-copy device serve: no h2d traffic at all
                rows[slot] = value
                continue
            channel = "disk" if tier == "disk" else "cache"
            if form == "augmented":
                host = np.asarray(value)
                tel.record_bytes(channel, host.nbytes, t0 - t_look)
                t1 = self._now()
                # torch.tensor copies: a read-only memmap (a spill or
                # exchange file) is never aliased
                rows[slot] = torch.tensor(host, device=dev)
                self._sync(dev)
                tel.record_bytes("h2d", host.nbytes, self._now() - t1)
            elif form == "decoded":
                if resident:
                    # device-resident decoded hit: augment on device —
                    # no host round-trip, so no byte-channel record (a
                    # d2h download metered as "cache" would skew b_cache)
                    dec_dev_group.append((slot, sid, value))
                else:
                    img = np.asarray(value)
                    tel.record_bytes(channel, img.nbytes, t0 - t_look)
                    dec_group.append((slot, sid, img))
            else:                                      # encoded cache hit
                tel.record_bytes(channel, len(value), t0 - t_look)
                enc_group.append((slot, sid, value))
        fresh: List[Tuple[int, torch.Tensor]] = []     # (sid, device row)
        if enc_group:
            sids = [sid for _s, sid, _p in enc_group]
            seeds = np.asarray([_aug_seed(epoch_tag, sid) for sid in sids],
                               np.int64)
            t1 = self._now()
            out = decode_augment_batch_seeded(
                [p for _s, _sid, p in enc_group], sids, seeds,
                ds_seed=self._fused_seed, image_hw=self.ds.image_hw,
                crop_h=self.ds.crop_hw[0], crop_w=self.ds.crop_hw[1],
                device=dev)
            self._sync(dev)
            dt = self._now() - t1
            # one fused launch covers both stages; split its time evenly
            # so the calibrated t_da = conc/(decode+augment) lands on
            # the fused rate
            self.times.decode += dt / 2
            self.times.augment += dt / 2
            tel.record_stage("decode", dt / 2, n=len(enc_group))
            tel.record_stage("augment", dt / 2, n=len(enc_group))
            for i, (slot, sid, _p) in enumerate(enc_group):
                rows[slot] = out[i]
                fresh.append((sid, out[i]))
        if dec_group:
            sids = [sid for _s, sid, _img in dec_group]
            imgs = np.stack([img for _s, _sid, img in dec_group])
            seeds = np.asarray([_aug_seed(epoch_tag, sid) for sid in sids],
                               np.int64)
            t1 = self._now()
            out = augment_batch_seeded(imgs, seeds, *self.ds.crop_hw,
                                       as_device=True, device=dev)
            self._sync(dev)
            dt = self._now() - t1
            self.times.augment += dt
            tel.record_stage("augment", dt, n=len(dec_group))
            # decoded pixels shipped up for the device-side augment
            tel.record_bytes("h2d", imgs.nbytes, dt)
            for i, (slot, sid, _img) in enumerate(dec_group):
                rows[slot] = out[i]
                fresh.append((sid, out[i]))
        if dec_dev_group:
            sids = [sid for _s, sid, _img in dec_dev_group]
            imgs_dev = torch.stack([img for _s, _sid, img in dec_dev_group])
            seeds = np.asarray([_aug_seed(epoch_tag, sid) for sid in sids],
                               np.int64)
            t1 = self._now()
            out = augment_batch_seeded(imgs_dev, seeds, *self.ds.crop_hw,
                                       as_device=True)
            self._sync(dev)
            dt = self._now() - t1
            self.times.augment += dt
            tel.record_stage("augment", dt, n=len(dec_dev_group))
            # pixels were already device-resident: no h2d traffic
            for i, (slot, sid, _img) in enumerate(dec_dev_group):
                rows[slot] = out[i]
                fresh.append((sid, out[i]))
        # admit the freshly augmented rows: HBM-first put routing keeps
        # them device-resident (as clones, see above); without a device
        # tier admit host copies so a DRAM slot never pins device memory
        if fresh and self.svc.tier_capacity("augmented") > 0:
            wanted = self.svc.admission_votes("augmented",
                                              [sid for sid, _r in fresh])
            entries = [(sid, row.clone() if self.svc.has_hbm
                        else row.cpu().numpy(),
                        row.numel() * row.element_size())
                       for (sid, row), w in zip(fresh, wanted) if w]
            if entries:
                self.session.admit_batch("augmented", entries)
        t0 = self._now()
        batch = {
            "images": torch.stack(rows).to(torch.float32),
            "labels": np.asarray([self.ds.label(int(s)) for s in ids],
                                 np.int32),
            "ids": np.asarray(ids, np.int64),
        }
        dt = self._now() - t0
        self.times.collate += dt
        tel.record_stage("collate", dt, n=len(ids))
        self.times.batches += 1
        self._process_refills()
        self.svc.maybe_repartition()
        return batch

    @staticmethod
    def _sync(dev: torch.device) -> None:
        """Wait for the device's queued work (the counterpart of the
        reference's ``block_until_ready``) before a closing timestamp."""
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)

    def _process_refills(self, max_n: int = 32) -> None:
        """ODS step 5: repopulate evicted augmented slots with *fresh*
        random samples (unseen by every job), on the worker pool — the
        paper's background-refill thread.  Also proactively tops up free
        augmented capacity (cold start)."""
        work = self.svc.take_refill_work(max_n)
        spare = max_n - len(work)
        if spare > 0 and self.svc.tier_capacity("augmented"):
            free_slots = self.svc.tier_free_bytes("augmented") \
                // max(self.ds.augmented_bytes(), 1)
            if free_slots > 0:
                extra = self.svc.refill_candidates(min(spare, free_slots))
                work = np.concatenate([work, extra]) if len(work) else extra
        for sid in work:
            if self._sync_refills:
                self._refill_one(int(sid))
            else:
                self.pool.submit(self._refill_one, int(sid))

    def _refill_one(self, sid: int) -> None:
        flight = None
        prod = self._production
        try:
            # a raced refill/admit may already have repopulated this
            # slot; form_of() is stats-neutral and containment-only, so
            # the check neither inflates misses nor reads a spilled
            # payload off disk just to learn the form
            if self.svc.cache.form_of(sid) == "augmented":
                return
            if prod is not None:
                leader, fl = prod.begin(sid, "augmented")
                if not leader:
                    # a foreground production of this id is already in
                    # flight and will admit the augmented form itself —
                    # the refill would be pure duplicate work
                    return
                flight = fl
            enc = self.storage.fetch(sid)
            img = self.ds.decode(enc, sid)
            out = augment_np(img, self.ds.crop_hw,
                             np.random.default_rng(sid ^ 0x5EED))
            self.session.admit(sid, "augmented", out, out.nbytes)
            if prod is not None:
                prod.finish(flight, out)
                flight = None
        except Exception:      # background worker must never kill serving
            if prod is not None and flight is not None:
                prod.abort(flight)   # wake joiners; the first retries
            # ... but it must not fail silently either: count every
            # failure (stats()["refill_errors"]) and log the first
            if self.telemetry.record_error("refill") == 1:
                log.warning(
                    "background refill failed for sample %d (first "
                    "occurrence; later failures only counted in "
                    "stats()['refill_errors'])", sid, exc_info=True)

    # ------------------------------------------------------------------
    def _ensure_executor(self) -> _StageParallelExecutor:
        with self._executor_lock:
            if self._executor is None:
                self._executor = _StageParallelExecutor(
                    self, out_depth=max(self._prefetch_depth, 1))
            return self._executor

    def start_prefetch(self) -> None:
        if self.executor == "stage-parallel":
            # the stage executor IS the prefetcher: out_q holds up to
            # ``prefetch`` collated batches
            self._ensure_executor()
            return

        def run():
            batch = None
            while not self._stop.is_set():
                if batch is None:
                    try:
                        batch = self.next_batch()
                    except Exception as e:   # noqa: BLE001
                        # record (don't silently die): get() re-raises
                        self._prefetch_exc = e
                        if self.telemetry.record_error("prefetch") == 1:
                            log.warning("prefetch thread failed in "
                                        "next_batch()", exc_info=True)
                        return
                try:
                    self._q.put(batch, timeout=0.5)
                except queue.Full:
                    # consumer is slow: hold the built batch and re-offer
                    # it (the seed rebuilt a fresh batch here, silently
                    # dropping this one's sample ids and wasting the work)
                    continue
                batch = None
        self._thread = threading.Thread(target=run, daemon=True)
        self._thread.start()

    def get(self, timeout: float = 60.0) -> Dict[str, np.ndarray]:
        if self.executor == "stage-parallel":
            batch = self._ensure_executor().get_batch(timeout)
            # same contract as next_batch(): the hook fires once per
            # emitted batch.  (On the per-sample path below, batches
            # reach the queue via the prefetch thread's next_batch(),
            # which already fired it.)
            if self._consume_hook is not None:
                self._consume_hook(batch)
            return batch
        deadline = time.monotonic() + timeout
        while True:
            # cap the poll at the remaining deadline (sub-poll timeouts
            # must not overshoot by a whole 0.2 s quantum)
            wait = min(0.2, deadline - time.monotonic())
            try:
                return self._q.get(timeout=max(wait, 0.0))
            except queue.Empty:
                if self._prefetch_exc is not None:
                    raise RuntimeError(
                        "prefetch thread died; no more batches are "
                        "coming") from self._prefetch_exc
                if time.monotonic() >= deadline:
                    raise

    def stop(self, close_session: bool = True) -> None:
        """Tear the pipeline down.  ``close_session=False`` keeps the
        session (and its sampler state) alive — the fault-recovery path
        rebuilds a fresh pipeline on the surviving session after a
        worker crash or around a preemption."""
        if not self._stop.is_set():
            self.telemetry.remove_concurrency(self._n_workers)
        self._stop.set()
        if self._thread:
            self._thread.join(timeout=2.0)
        if self._executor is not None:
            self._executor.stop()
        self.pool.shutdown(wait=False)
        if close_session:
            self.session.close()
