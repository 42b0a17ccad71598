"""ODS metadata backends and batched augment backends, by name.

:class:`OdsBackend` is everything the server/sampler layer needs from
the ODS metadata engine (job registry, batch substitution, status
bookkeeping, admission value, stats); this package ships the NumPy
engine, :class:`NumpyOdsBackend`, which is also the reference's default.
:class:`AugmentBackend` is the batched transform the stage-parallel
executor's augment stage calls: "numpy" (the ``augment_np`` loop) or
"cuda" (the hand-written K2 kernel).  The reference's "jax" ODS engine
and "pallas"/"jax" augment engines are not ported yet; asking for them
raises ``ValueError`` naming what exists.
"""
from __future__ import annotations

from typing import Dict, Optional, Protocol, Tuple, runtime_checkable

import numpy as np

import torch

from repro_torch.core.ods import IN_STORAGE, ODSState
from repro_torch.kernels.augment.ops import augment_batch_seeded
from repro_torch.kernels.device import resolve_device

__all__ = ["OdsBackend", "NumpyOdsBackend",
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


# threshold meaning "never evict on refcount"; for the jit'd kernel it is
# a static argument, so the sentinel compiles once
NO_REFCOUNT_EVICT = 1 << 30


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

#: reference backend names that this package does not provide
_UNPORTED = {"pallas": "augment", "jax": "augment or ODS"}


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
        raise ValueError(
            f"the {spec!r} {_UNPORTED[spec]} backend belongs to the JAX "
            f"package and is not ported; this package has {have}")


def register_backend(name: str, factory: type) -> None:
    _BACKENDS[name] = factory


def backend_names() -> Tuple[str, ...]:
    return tuple(sorted(_BACKENDS))


def resolve_backend(spec, n_samples: int, seed: int = 0):
    """Name or instance -> OdsBackend for ``n_samples``."""
    if isinstance(spec, str):
        _reject_unported(spec, backend_names())
        try:
            return _BACKENDS[spec](n_samples, seed=seed)
        except KeyError:
            raise ValueError(f"unknown ODS backend {spec!r}; registered: "
                             f"{backend_names()}") from None
    if not isinstance(spec, OdsBackend):
        raise TypeError(f"{spec!r} does not implement OdsBackend")
    return spec
