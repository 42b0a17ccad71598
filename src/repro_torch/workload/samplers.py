"""Skewed / shifting request samplers for multi-tenant workloads.

The default per-job request stream is the :class:`~repro_torch.core.ods.
EpochSampler`'s uniform pseudo-random epoch permutation — every sample
exactly once per epoch, the paper's training workload.  Production
multi-tenant traffic is rarely that polite: serving-style jobs hammer a
Zipfian head, and training-over-changing-data walks a working set that
drifts.  This module provides drop-in request samplers for those shapes
(the ROADMAP's "skewed, shifting multi-tenant workloads" open item),
selected per job via ``JobSpec.sampler`` /
``SenecaServer.open_session(sampler=...)``.

All samplers implement the EpochSampler surface the service layer
consumes: ``next_request()`` (one batch of *distinct* ids), ``n`` /
``bs`` attributes, and ``state_dict()`` / ``load_state_dict()`` for the
fault-tolerance checkpoint path.  Unlike the epoch permutation they do
NOT promise once-per-epoch coverage — the ODS layer's substitution and
seen-tracking still apply downstream, so delivered batches keep the
ODS guarantees; only the *request* distribution changes.
"""
from __future__ import annotations

from typing import Dict, Optional

import numpy as np

from repro_torch.core.ods import EpochSampler

__all__ = ["ZipfianSampler", "PhaseShiftSampler", "make_request_sampler",
           "REQUEST_SAMPLERS"]


class ZipfianSampler:
    """Zipf(``alpha``)-weighted requests over a seed-shuffled rank
    assignment: rank-r ids are requested proportionally to
    ``(r+1)**-alpha``, so a small hot head dominates while the tail
    still appears.  Each batch draws ``bs`` *distinct* ids (weighted,
    without replacement) — the service layer assumes no duplicate ids
    within one request batch.

    Two jobs given the same seed share the same hot head (maximal
    working-set overlap, the coalescing benchmark's setup); different
    seeds give disjointly-shuffled heads.
    """

    name = "zipfian"

    def __init__(self, n_samples: int, batch_size: int, seed: int,
                 alpha: float = 1.1):
        if batch_size > n_samples:
            raise ValueError(f"batch_size {batch_size} > dataset size "
                             f"{n_samples}")
        self.n = n_samples
        self.bs = batch_size
        self.alpha = float(alpha)
        self.rng = np.random.default_rng(seed)
        # which ids are hot: a one-time seed-determined shuffle of the
        # rank order (id ranks[0] is the hottest)
        self._ranks = self.rng.permutation(self.n)
        w = (np.arange(self.n, dtype=np.float64) + 1.0) ** -self.alpha
        p = np.empty(self.n, np.float64)
        p[self._ranks] = w / w.sum()
        self._p = p

    def next_request(self) -> np.ndarray:
        return self.rng.choice(self.n, size=self.bs, replace=False,
                               p=self._p)

    # -- checkpoint surface (fault-tolerance path) ---------------------
    def state_dict(self) -> Dict:
        return {
            "kind": self.name,
            "n": self.n,
            "bs": self.bs,
            "alpha": self.alpha,
            "ranks": self._ranks.copy(),
            "rng_state": self.rng.bit_generator.state,
        }

    def load_state_dict(self, state: Dict) -> None:
        if int(state["n"]) != self.n or int(state["bs"]) != self.bs:
            raise ValueError(
                f"sampler snapshot is for n={state['n']} bs={state['bs']}"
                f", this sampler has n={self.n} bs={self.bs}")
        self._ranks = np.asarray(state["ranks"],
                                 dtype=self._ranks.dtype).copy()
        w = (np.arange(self.n, dtype=np.float64) + 1.0) ** -self.alpha
        p = np.empty(self.n, np.float64)
        p[self._ranks] = w / w.sum()
        self._p = p
        self.rng.bit_generator.state = state["rng_state"]


class PhaseShiftSampler:
    """A sliding working set: requests are drawn uniformly (distinct,
    without replacement) from a contiguous window of ``window`` ids,
    and every ``period`` batches the window slides forward by
    ``shift`` ids (wrapping at the dataset end) — a *phase shift*.

    Within one phase the traffic is an ideal cache workload (a small
    stable set); each shift invalidates ``shift`` ids' worth of cached
    work and warms new ones, exercising eviction/admission churn the
    uniform epoch permutation never produces.
    """

    name = "phase-shift"

    def __init__(self, n_samples: int, batch_size: int, seed: int,
                 window_frac: float = 0.25, period: int = 32,
                 shift_frac: float = 0.125):
        self.n = n_samples
        self.bs = batch_size
        self.window = max(batch_size, int(n_samples * window_frac))
        if self.window > n_samples:
            raise ValueError(f"batch_size {batch_size} > dataset size "
                             f"{n_samples}")
        self.period = max(1, int(period))
        self.shift = max(1, int(self.window * shift_frac))
        self.rng = np.random.default_rng(seed)
        self._offset = 0
        self._batches = 0

    def next_request(self) -> np.ndarray:
        if self._batches and self._batches % self.period == 0:
            self._offset = (self._offset + self.shift) % self.n
        self._batches += 1
        picks = self.rng.choice(self.window, size=self.bs, replace=False)
        return (self._offset + picks) % self.n

    # -- checkpoint surface (fault-tolerance path) ---------------------
    def state_dict(self) -> Dict:
        return {
            "kind": self.name,
            "n": self.n,
            "bs": self.bs,
            "window": self.window,
            "period": self.period,
            "shift": self.shift,
            "offset": int(self._offset),
            "batches": int(self._batches),
            "rng_state": self.rng.bit_generator.state,
        }

    def load_state_dict(self, state: Dict) -> None:
        if int(state["n"]) != self.n or int(state["bs"]) != self.bs:
            raise ValueError(
                f"sampler snapshot is for n={state['n']} bs={state['bs']}"
                f", this sampler has n={self.n} bs={self.bs}")
        self.window = int(state["window"])
        self.period = int(state["period"])
        self.shift = int(state["shift"])
        self._offset = int(state["offset"])
        self._batches = int(state["batches"])
        self.rng.bit_generator.state = state["rng_state"]


#: name -> factory(n_samples, batch_size, seed) registry ("epoch" is the
#: historical uniform permutation, the default everywhere)
REQUEST_SAMPLERS = {
    "epoch": EpochSampler,
    "zipfian": ZipfianSampler,
    "phase-shift": PhaseShiftSampler,
}


def make_request_sampler(spec: Optional[str], n_samples: int,
                         batch_size: int, seed: int):
    """Resolve a request sampler: None / "epoch" -> the historical
    :class:`EpochSampler` (byte-identical default), a registered name
    -> that sampler, a callable -> ``spec(n_samples, batch_size,
    seed)`` (escape hatch for parameterized instances)."""
    if spec is None:
        return EpochSampler(n_samples, batch_size, seed)
    if callable(spec):
        return spec(n_samples, batch_size, seed)
    try:
        factory = REQUEST_SAMPLERS[spec]
    except KeyError:
        raise ValueError(
            f"unknown request sampler {spec!r}; registered: "
            f"{tuple(sorted(REQUEST_SAMPLERS))}") from None
    return factory(n_samples, batch_size, seed)
