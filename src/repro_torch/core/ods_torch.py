"""ODS batch substitution as tensor ops on the device.

The port's twin of the reference's jittable ODS step
(``repro.core.ods_jax``): one batch-substitution step as a pure function
over flat tensors, so the decision runs on the card beside the cache's
HBM tier instead of walking the batch sample by sample on the host.
There is no compiled twin: each call dispatches plain torch ops on the
state's device.

Semantic difference vs :mod:`repro_torch.core.ods` (documented, tested):
candidate selection ranks every sample by (class score + uniform noise)
and takes the best, instead of ``Generator.choice``, so the two
implementations agree on *which class* of sample fills each slot (the
invariants), not on the specific random pick.  The noise comes from an
explicit :class:`torch.Generator` on the state's device, so the port and
the reference's JAX step also agree only at the invariant level, and
exactly where the choice is forced.

The epoch-rollover predicate reads the host-side ``served`` count, so a
step never waits on the device to decide it.
"""
from __future__ import annotations

from typing import NamedTuple, Optional, Tuple

import torch


class ODSTorchState(NamedTuple):
    status: torch.Tensor       # uint8[N]  0=storage 1=enc 2=dec 3=aug
    refcount: torch.Tensor     # int32[N]
    seen: torch.Tensor         # bool[N]   (one job's bit-vector)
    served: int                # samples this job was served this epoch


def create(n: int, device=None) -> ODSTorchState:
    """A fresh state of ``n`` samples on ``device`` (CPU when None: the
    state is data, the backend decides where it runs)."""
    return ODSTorchState(
        status=torch.zeros(n, dtype=torch.uint8, device=device),
        refcount=torch.zeros(n, dtype=torch.int32, device=device),
        seen=torch.zeros(n, dtype=torch.bool, device=device),
        served=0)


def _substitute_core(state: ODSTorchState, requested: torch.Tensor,
                     generator: torch.Generator, n_jobs: int,
                     residency: Optional[torch.Tensor],
                     inflight: Optional[torch.Tensor] = None
                     ) -> Tuple[ODSTorchState, torch.Tensor, torch.Tensor]:
    """One ODS batch step; the single body behind all public variants
    (the rollover / direct-hit / fill / refcount bookkeeping must never
    diverge between them — only candidate *scoring* differs).

    ``residency`` is ``None`` (single-tier: cached-unseen 2 > uncached-
    unseen 1) or uint8[N] tier levels 0 storage / 1 disk / 2 DRAM /
    3 HBM (tiered: HBM-unseen 4 > DRAM-unseen 3 > disk-unseen 2 >
    uncached-unseen 1; with no level-3 entries the ranks reduce exactly
    to the two-tier rule).

    ``inflight`` is ``None`` (no coalescing table) or bool[N] in-flight
    productions: scores are doubled and in-flight candidates pay a −1
    penalty, so within every class the clear ids outrank the in-flight
    ones while the class order itself is preserved exactly.

    Pure: no input tensor is written.
    """
    status = state.status
    dev = status.device
    N = status.shape[0]
    B = requested.shape[0]
    requested = requested.to(device=dev, dtype=torch.int64)

    # epoch rollover when fewer than B unseen remain (host-side count)
    roll = (N - int(state.served)) < B
    seen = torch.zeros_like(state.seen) if roll else state.seen
    served = 0 if roll else int(state.served)

    cached = status != 0
    direct = cached[requested] & ~seen[requested]

    # priority of every sample as a substitute; seen and in-batch
    # samples are excluded.  The reference's zeros.at[requested].max(
    # direct) is an "any" per id: a scatter of True at the direct ids,
    # with the non-direct ones sent to the sentinel N (no host sync)
    in_batch_direct = torch.zeros(N + 1, dtype=torch.bool, device=dev) \
        .index_fill_(0, torch.where(direct, requested, N), True)[:N]
    free = ~seen & ~in_batch_direct
    zero = torch.zeros((), dtype=torch.int32, device=dev)
    if residency is None:
        score = torch.where(free & cached, 2, zero)
    else:
        residency = residency.to(dev)
        hbm = residency >= 3
        dram = residency >= 2
        score = torch.where(free & cached & hbm, 4, zero)
        score = torch.where(free & cached & dram & ~hbm,
                            score.clamp(min=3), score)
        score = torch.where(free & cached & ~dram, score.clamp(min=2),
                            score)
    score = torch.where(free & ~cached, score.clamp(min=1), score)
    if inflight is not None:
        # double the class scores, then a −1 in-flight penalty: clear
        # ids win within each class, classes never interleave
        score = torch.where(inflight.to(dev) & (score > 0), 2 * score - 1,
                            2 * score)
    noise = torch.rand(N, generator=generator, device=dev)
    rank = score.to(torch.float32) + noise            # in (0, max_score+1)
    # best candidates first; stable, as the reference's argsort(-rank)
    order = torch.argsort(rank, descending=True, stable=True)

    take_slot = torch.cumsum(~direct, 0) - 1            # per-slot index
    batch = torch.where(direct, requested,
                        order[take_slot.clamp(0, N - 1)])

    # bookkeeping
    aug_hit = status[batch] == 3
    refcount = state.refcount.index_add(0, batch, aug_hit.to(torch.int32))
    evict_ids = torch.where(aug_hit & (refcount[batch] >= n_jobs), batch, N)
    evict_mask = torch.zeros(N + 1, dtype=torch.bool, device=dev) \
        .index_fill_(0, evict_ids, True)[:N]
    status = torch.where(evict_mask, 0, status).to(torch.uint8)
    refcount = torch.where(evict_mask, 0, refcount)
    seen = seen.index_fill(0, batch, True)
    return (ODSTorchState(status, refcount, seen, served + B), batch,
            evict_mask)


def substitute(state: ODSTorchState, requested: torch.Tensor,
               generator: torch.Generator, n_jobs: int
               ) -> Tuple[ODSTorchState, torch.Tensor, torch.Tensor]:
    """One ODS batch step. Returns (state', batch ids, evict mask[N]).

    Shape-static: selection ranks all N samples by (serveability, random
    key) and takes the top slots needed.
    """
    return _substitute_core(state, requested, generator, n_jobs, None)


def substitute_tiered(state: ODSTorchState, requested: torch.Tensor,
                      generator: torch.Generator, n_jobs: int,
                      residency: torch.Tensor
                      ) -> Tuple[ODSTorchState, torch.Tensor, torch.Tensor]:
    """Residency-aware ODS batch step: HBM-resident cached-unseen samples
    outrank DRAM-resident ones, which outrank disk-resident ones, which
    outrank unseen storage fetches — the preference order the NumPy
    ``_pick_candidates`` applies."""
    return _substitute_core(state, requested, generator, n_jobs, residency)


def substitute_inflight(state: ODSTorchState, requested: torch.Tensor,
                        generator: torch.Generator, n_jobs: int,
                        inflight: torch.Tensor
                        ) -> Tuple[ODSTorchState, torch.Tensor, torch.Tensor]:
    """Coalescing-aware ODS batch step: like :func:`substitute` but
    candidates whose production is in flight (bool[N] mask from the
    single-flight table) rank below clear candidates of the same class —
    another job is already making them, so a different pick widens
    aggregate coverage at no extra cost."""
    return _substitute_core(state, requested, generator, n_jobs, None,
                            inflight)


def substitute_tiered_inflight(state: ODSTorchState,
                               requested: torch.Tensor,
                               generator: torch.Generator, n_jobs: int,
                               residency: torch.Tensor,
                               inflight: torch.Tensor
                               ) -> Tuple[ODSTorchState, torch.Tensor,
                                          torch.Tensor]:
    """Residency- and coalescing-aware ODS batch step: tier order first
    (:func:`substitute_tiered`), clear-before-in-flight within each
    tier."""
    return _substitute_core(state, requested, generator, n_jobs, residency,
                            inflight)
