"""ODS metadata backends and batched augment backends, by name.

:class:`OdsBackend` is everything the server/sampler layer needs from
the ODS metadata engine (job registry, batch substitution, status
bookkeeping, admission value, stats).  Two engines ship:
:class:`NumpyOdsBackend` (the reference's default, on the host) and
:class:`TorchOdsBackend` ("torch": the batch substitution of
:mod:`repro_torch.core.ods_torch` on the service's device, the twin of
the reference's "jax" engine).  :class:`AugmentBackend` is the batched
transform the stage-parallel executor's augment stage calls: "numpy"
(the ``augment_np`` loop) or "cuda" (the hand-written K2 kernel).  The
reference's "jax" ODS engine and "pallas"/"jax" augment engines belong
to the JAX package; asking for them raises ``ValueError`` naming what
this package has.

Documented equivalence level (pinned by tests/test_torch_ods.py): the
two ODS engines agree on the ODS *invariants* — each job sees every
sample once per epoch, cached-unseen samples are preferred over storage
fetches, and augmented entries evict at refcount == threshold — not on
which random cached sample fills a given slot.
"""
from __future__ import annotations

import contextlib
from typing import Dict, Optional, Protocol, Tuple, runtime_checkable

import numpy as np

import torch

from repro_torch.core import ods_torch
from repro_torch.core.ods import AUGMENTED, IN_STORAGE, ODSState
from repro_torch.kernels.augment.ops import augment_batch_seeded
from repro_torch.kernels.device import resolve_device

__all__ = ["OdsBackend", "NumpyOdsBackend", "TorchOdsBackend",
           "NO_REFCOUNT_EVICT",
           "register_backend", "resolve_backend", "backend_names",
           "AugmentBackend", "NumpyAugmentBackend", "CudaAugmentBackend",
           "register_augment_backend", "resolve_augment_backend",
           "augment_backend_names"]


@runtime_checkable
class OdsBackend(Protocol):
    """Metadata + substitution engine behind a SenecaServer."""

    name: str
    n_samples: int

    # job registry -----------------------------------------------------
    def register_job(self, job_id: int) -> None: ...
    def unregister_job(self, job_id: int) -> None: ...
    @property
    def n_jobs(self) -> int: ...

    # sampling ---------------------------------------------------------
    def sample_batch(self, job_id: int, requested: np.ndarray,
                     evict_threshold: Optional[int] = None
                     ) -> Tuple[np.ndarray, np.ndarray]: ...
    def count_serve(self, batch: np.ndarray) -> None: ...
    def epoch_of(self, job_id: int) -> int: ...

    # cache bookkeeping ------------------------------------------------
    def status_of(self, ids: np.ndarray) -> np.ndarray: ...
    def mark_cached(self, ids: np.ndarray, form: int) -> None: ...
    def mark_evicted(self, ids: np.ndarray) -> None: ...
    def set_residency(self, levels: Optional[np.ndarray]) -> None: ...
    def set_inflight(self, mask: Optional[np.ndarray]) -> None: ...
    def admission_value(self, sample_id: int) -> int: ...
    def storage_pool(self) -> np.ndarray: ...

    # fault tolerance --------------------------------------------------
    def checkpoint_job(self, job_id: int) -> Dict: ...
    def restore_job(self, job_id: int, snap: Dict) -> None: ...

    # stats ------------------------------------------------------------
    @property
    def hits(self) -> int: ...
    @property
    def misses(self) -> int: ...
    @property
    def substitutions(self) -> int: ...
    def hit_rate(self) -> float: ...
    def metadata_bytes(self) -> int: ...


class NumpyOdsBackend:
    """Thin adapter over the vectorized NumPy ODS (the seed engine)."""

    name = "numpy"

    def __init__(self, n_samples: int, seed: int = 0):
        self.state = ODSState.create(n_samples, seed=seed)
        self.n_samples = n_samples

    # job registry -----------------------------------------------------
    def register_job(self, job_id):
        self.state.register_job(job_id)

    def unregister_job(self, job_id):
        self.state.unregister_job(job_id)

    @property
    def n_jobs(self):
        return self.state.n_jobs

    # sampling ---------------------------------------------------------
    def sample_batch(self, job_id, requested, evict_threshold=None):
        return self.state.sample_batch(job_id, requested,
                                       evict_threshold=evict_threshold)

    def count_serve(self, batch):
        cached = self.state.status[batch] != IN_STORAGE
        self.state.hits += int(cached.sum())
        self.state.misses += int(len(batch) - cached.sum())

    def epoch_of(self, job_id):
        return self.state.epoch.get(job_id, 0)

    # cache bookkeeping ------------------------------------------------
    def status_of(self, ids):
        return self.state.status[ids].copy()

    def mark_cached(self, ids, form):
        self.state.mark_cached(np.asarray(ids), form)

    def mark_evicted(self, ids):
        self.state.mark_evicted(np.asarray(ids))

    def set_residency(self, levels):
        self.state.set_residency(levels)

    def set_inflight(self, mask):
        self.state.set_inflight(mask)

    def admission_value(self, sample_id):
        return self.state.admission_value(sample_id)

    def storage_pool(self):
        return np.flatnonzero(self.state.status == IN_STORAGE)

    # fault tolerance --------------------------------------------------
    def checkpoint_job(self, job_id):
        return self.state.checkpoint_job(job_id)

    def restore_job(self, job_id, snap):
        self.state.restore_job(job_id, snap)

    # stats ------------------------------------------------------------
    @property
    def hits(self):
        return self.state.hits

    @property
    def misses(self):
        return self.state.misses

    @property
    def substitutions(self):
        return self.state.substitutions

    def hit_rate(self):
        return self.state.hit_rate()

    def metadata_bytes(self):
        return self.state.metadata_bytes()


# threshold meaning "never evict on refcount"
NO_REFCOUNT_EVICT = 1 << 30


def _host_copy(t: torch.Tensor) -> np.ndarray:
    """An owning, writable host array of ``t``: the host tables take
    writes from mark_cached / mark_evicted, so they must never alias a
    tensor (``.numpy()`` of a CPU tensor does)."""
    out = t.cpu().numpy()
    return out.copy() if t.device.type == "cpu" else out


class TorchOdsBackend:
    """Runs batch substitution through :mod:`repro_torch.core.ods_torch`
    on ``device`` (CUDA when None) while keeping per-job
    seen/served/epoch plus the shared status/refcount tables
    authoritative on the host: admissions and evictions arrive from
    cache worker threads between batches.  Each step uploads the tables,
    runs the core on the device and copies the results back.

    On CUDA the step runs on a stream of its own, so its copies back to
    the host wait for the step's work only, not for kernels that other
    jobs' pipelines queued on the default stream.  The one
    :class:`torch.Generator` is drawn only inside :meth:`sample_batch`,
    which the service calls under its lock."""

    name = "torch"
    #: resolve_backend passes the service's device to this factory
    takes_device = True

    def __init__(self, n_samples: int, seed: int = 0, device=None):
        self.device = resolve_device(device)
        self.n_samples = n_samples
        self.status = np.zeros(n_samples, np.uint8)
        self.refcount = np.zeros(n_samples, np.int32)
        self.seen: Dict[int, np.ndarray] = {}
        self.served: Dict[int, int] = {}
        self.epoch: Dict[int, int] = {}
        self.generator = torch.Generator(device=self.device)
        self.generator.manual_seed(seed)
        self._stream = torch.cuda.Stream(self.device) \
            if self.device.type == "cuda" else None
        self._residency: Optional[np.ndarray] = None
        self._inflight: Optional[np.ndarray] = None
        self._hits = 0
        self._misses = 0
        self._substitutions = 0

    # job registry -----------------------------------------------------
    def register_job(self, job_id):
        self.seen[job_id] = np.zeros(self.n_samples, bool)
        self.served[job_id] = 0
        self.epoch[job_id] = 0

    def unregister_job(self, job_id):
        self.seen.pop(job_id, None)
        self.served.pop(job_id, None)
        self.epoch.pop(job_id, None)

    @property
    def n_jobs(self):
        return max(len(self.seen), 1)

    # sampling ---------------------------------------------------------
    def _upload(self, a: np.ndarray) -> torch.Tensor:
        return torch.from_numpy(a).to(self.device)

    def sample_batch(self, job_id, requested, evict_threshold=None):
        thr = int(evict_threshold) if evict_threshold is not None \
            else self.n_jobs
        requested = np.asarray(requested)
        B = len(requested)
        # the core's rollover predicate, on the same host count, so
        # host epoch counting stays in lockstep with the seen reset
        if self.n_samples - self.served[job_id] < B:
            self.epoch[job_id] += 1
        pre_status = self.status
        pre_seen = self.seen[job_id]
        # with the in-flight mask absent (coalescing off or table idle)
        # the mask-free variants run, as in the reference
        infl = self._inflight
        if infl is not None and not infl.any():
            infl = None
        stream = torch.cuda.stream(self._stream) \
            if self._stream is not None else contextlib.nullcontext()
        with stream:
            state = ods_torch.ODSTorchState(
                status=self._upload(self.status),
                refcount=self._upload(self.refcount),
                seen=self._upload(pre_seen),
                served=self.served[job_id])
            req = self._upload(requested.astype(np.int64))
            if self._residency is not None:
                if infl is not None:
                    state, batch, evict_mask = \
                        ods_torch.substitute_tiered_inflight(
                            state, req, self.generator, thr,
                            self._upload(self._residency),
                            self._upload(infl))
                else:
                    state, batch, evict_mask = ods_torch.substitute_tiered(
                        state, req, self.generator, thr,
                        self._upload(self._residency))
            elif infl is not None:
                state, batch, evict_mask = ods_torch.substitute_inflight(
                    state, req, self.generator, thr, self._upload(infl))
            else:
                state, batch, evict_mask = ods_torch.substitute(
                    state, req, self.generator, thr)
            batch = _host_copy(batch)
            evicted = np.flatnonzero(evict_mask.cpu().numpy())
            status = _host_copy(state.status)
            refcount = _host_copy(state.refcount)
            seen = _host_copy(state.seen)
        cached = pre_status[batch] != IN_STORAGE
        self._hits += int(cached.sum())
        self._misses += int(B - cached.sum())
        direct = (pre_status[requested] != IN_STORAGE) & ~pre_seen[requested]
        self._substitutions += int(np.count_nonzero(
            ~direct & (pre_status[requested] == IN_STORAGE) & cached))
        self.status = status
        self.refcount = refcount
        self.seen[job_id] = seen
        self.served[job_id] = int(state.served)
        return batch, evicted

    def count_serve(self, batch):
        cached = self.status[batch] != IN_STORAGE
        self._hits += int(cached.sum())
        self._misses += int(len(batch) - cached.sum())

    def epoch_of(self, job_id):
        return self.epoch.get(job_id, 0)

    # cache bookkeeping ------------------------------------------------
    def status_of(self, ids):
        return self.status[ids].copy()

    def mark_cached(self, ids, form):
        ids = np.asarray(ids)
        self.status[ids] = form
        if form == AUGMENTED:
            # same semantics as ODSState.mark_cached: start the refcount at
            # the number of jobs that already consumed the sample so the
            # threshold still fires after the remaining jobs use it
            count = np.zeros(len(ids), np.int32)
            for bits in self.seen.values():
                count += bits[ids].astype(np.int32)
            self.refcount[ids] = count

    def mark_evicted(self, ids):
        ids = np.asarray(ids)
        self.status[ids] = IN_STORAGE
        self.refcount[ids] = 0

    def set_residency(self, levels):
        self._residency = levels

    def set_inflight(self, mask):
        self._inflight = mask

    def admission_value(self, sample_id):
        return self.n_jobs - int(sum(bits[sample_id]
                                     for bits in self.seen.values()))

    def storage_pool(self):
        return np.flatnonzero(self.status == IN_STORAGE)

    # fault tolerance --------------------------------------------------
    def checkpoint_job(self, job_id):
        """Same contract as :meth:`ODSState.checkpoint_job` — seen mask,
        epoch, served; the generator's state is recorded for inspection
        but not restored (it is shared across jobs)."""
        if job_id not in self.seen:
            raise KeyError(f"job {job_id} is not registered")
        return {
            "n_samples": self.n_samples,
            "seen": np.packbits(self.seen[job_id]),
            "epoch": int(self.epoch[job_id]),
            "served": int(self.served[job_id]),
            "substitutions": int(self._substitutions),
            "rng_state": self.generator.get_state().tolist(),
        }

    def restore_job(self, job_id, snap):
        if int(snap["n_samples"]) != self.n_samples:
            raise ValueError(
                f"snapshot is for a {snap['n_samples']}-sample dataset, "
                f"this one has {self.n_samples}")
        if job_id not in self.seen:
            raise KeyError(f"job {job_id} is not registered")
        self.seen[job_id] = np.unpackbits(
            np.asarray(snap["seen"], np.uint8),
            count=self.n_samples).astype(bool)
        self.epoch[job_id] = int(snap["epoch"])
        self.served[job_id] = int(snap["served"])

    # stats ------------------------------------------------------------
    @property
    def hits(self):
        return self._hits

    @property
    def misses(self):
        return self._misses

    @property
    def substitutions(self):
        return self._substitutions

    def hit_rate(self):
        total = self._hits + self._misses
        return self._hits / total if total else 0.0

    def metadata_bytes(self):
        return self.n_samples * len(self.seen) // 8 + self.n_samples


# ----------------------------------------------------------------------
# augment backends: the batched-transform twin of the ODS backend knob.
# The stage-parallel DSIPipeline executor hands its augment stage a whole
# group of decoded samples at once; which engine runs the pixel math is
# selected here (SenecaConfig.augment_backend / SenecaServer kwarg).
@runtime_checkable
class AugmentBackend(Protocol):
    """Vectorized augmentation over a batch of decoded uint8 images.

    ``augment_batch(images, crop_hw, seeds)`` takes (B,H,W,3) uint8 and
    per-sample integer seeds and returns (B,ch,cw,3) float32.  Both
    implementations derive the crop/flip parameters from the same
    per-seed draw sequence (repro_torch.data.augment.crop_flip_params), so the
    transform is deterministic per *sample id*, not per batch
    composition — swapping backends changes throughput, not content
    (within float tolerance).
    """

    name: str

    def augment_batch(self, images: np.ndarray, crop_hw: Tuple[int, int],
                      seeds: np.ndarray) -> np.ndarray: ...


class NumpyAugmentBackend:
    """Host-CPU fallback: the per-sample augment_np loop (paper-faithful
    placement; no jax required)."""

    name = "numpy"

    def augment_batch(self, images, crop_hw, seeds):
        from repro_torch.data.augment import augment_batch_np
        return augment_batch_np(images, crop_hw, seeds)


class CudaAugmentBackend:
    """The hand-written CUDA crop+flip+normalize kernel (K2,
    repro_torch.kernels.augment): the host batch is uploaded to
    ``device`` (CUDA when None), augmented there and copied back as
    float32.  Parameters are derived on host from the same per-sample
    seeds as the NumPy path, so the two agree bitwise.  The counterpart
    of the reference's "pallas" backend."""

    name = "cuda"

    def __init__(self, device=None):
        self.device = resolve_device(device)

    def augment_batch(self, images, crop_hw, seeds):
        return augment_batch_seeded(np.asarray(images), np.asarray(seeds),
                                    crop_hw[0], crop_hw[1],
                                    out_dtype=torch.float32,
                                    device=self.device)


_AUGMENT_BACKENDS: Dict[str, type] = {
    "numpy": NumpyAugmentBackend,
    "cuda": CudaAugmentBackend,
}

#: reference backend names that this package does not provide, and
#: what it has in their place
_UNPORTED = {"pallas": ("augment", "'cuda'"),
             "jax": ("augment or ODS", "'torch' (ODS) and 'cuda' (augment)")}


def register_augment_backend(name: str, factory: type) -> None:
    _AUGMENT_BACKENDS[name] = factory


def augment_backend_names() -> Tuple[str, ...]:
    return tuple(sorted(_AUGMENT_BACKENDS))


def resolve_augment_backend(spec):
    """Name or instance -> AugmentBackend."""
    if isinstance(spec, str):
        _reject_unported(spec, augment_backend_names())
        try:
            return _AUGMENT_BACKENDS[spec]()
        except KeyError:
            raise ValueError(
                f"unknown augment backend {spec!r}; registered: "
                f"{augment_backend_names()}") from None
    if not isinstance(spec, AugmentBackend):
        raise TypeError(f"{spec!r} does not implement AugmentBackend")
    return spec


_BACKENDS: Dict[str, type] = {"numpy": NumpyOdsBackend}


def _reject_unported(spec: str, have: Tuple[str, ...]) -> None:
    """A JAX-only backend name raises, naming what the port offers."""
    if spec in _UNPORTED:
        what, instead = _UNPORTED[spec]
        raise ValueError(
            f"the {spec!r} {what} backend belongs to the JAX package and "
            f"is not ported; this package's engine in its place is "
            f"{instead}, and it has {have}")


def register_backend(name: str, factory: type) -> None:
    _BACKENDS[name] = factory


def backend_names() -> Tuple[str, ...]:
    return tuple(sorted(_BACKENDS))


def resolve_backend(spec, n_samples: int, seed: int = 0, device=None):
    """Name or instance -> OdsBackend for ``n_samples``.  ``device`` goes
    to factories that place their engine (``takes_device``), as
    "torch" does."""
    if isinstance(spec, str):
        _reject_unported(spec, backend_names())
        try:
            factory = _BACKENDS[spec]
        except KeyError:
            raise ValueError(f"unknown ODS backend {spec!r}; registered: "
                             f"{backend_names()}") from None
        if getattr(factory, "takes_device", False):
            return factory(n_samples, seed=seed, device=device)
        return factory(n_samples, seed=seed)
    if not isinstance(spec, OdsBackend):
        raise TypeError(f"{spec!r} does not implement OdsBackend")
    return spec


register_backend("torch", TorchOdsBackend)
