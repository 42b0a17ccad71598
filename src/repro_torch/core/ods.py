"""Opportunistic Data Sampling (Seneca §5.2).

Vectorized reimplementation of the paper's per-sample loop (DESIGN.md §2):
the metadata is exactly the paper's — a per-job *seen* bit-vector, a
per-dataset *status* byte and a *reference count* — but substitution is a
masked argsort over the batch instead of pointer chasing, so a batch costs
O(B log B + candidates) numpy time and has a direct device twin
(:mod:`repro_torch.core.ods_torch`).

Guarantees (§5.2, tested in tests/test_ods.py):
  1. a job sees every dataset sample exactly once per epoch;
  2. an augmented sample is never reused across epochs (refcount eviction
     at threshold = number of registered jobs);
  3. the delivered order remains pseudo-random (substitutions depend only
     on cache state and the job's PRNG).
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, Optional, Tuple

import numpy as np

# status byte values (paper: 1B per sample encodes status + refcount)
IN_STORAGE = 0
ENCODED = 1
DECODED = 2
AUGMENTED = 3


@dataclass
class ODSState:
    """Shared per-dataset state + per-job seen bit-vectors."""
    n_samples: int
    status: np.ndarray                    # uint8[N]
    refcount: np.ndarray                  # int32[N] (augmented-tier refs)
    seen: Dict[int, np.ndarray] = field(default_factory=dict)
    epoch: Dict[int, int] = field(default_factory=dict)
    served: Dict[int, int] = field(default_factory=dict)
    rng: np.random.Generator = field(
        default_factory=lambda: np.random.default_rng(0))
    # per-tier residency levels (0 storage / 1 disk / 2 DRAM), pushed by
    # the service when the cache has a spill tier; None = single-tier
    # cache, substitution stays byte-identical to the paper's
    residency: Optional[np.ndarray] = None
    # bool[N] mask of samples with an in-flight production (the
    # single-flight coalescing table), pushed by the service per batch;
    # None = table idle — every draw stays byte-identical to the
    # mask-free path.  Uncached fills prefer non-in-flight ids so
    # concurrent jobs fan out over distinct keys instead of piling onto
    # productions already being coalesced
    inflight: Optional[np.ndarray] = None
    # stats
    hits: int = 0
    misses: int = 0
    substitutions: int = 0

    @classmethod
    def create(cls, n_samples: int, seed: int = 0) -> "ODSState":
        return cls(n_samples=n_samples,
                   status=np.zeros(n_samples, np.uint8),
                   refcount=np.zeros(n_samples, np.int32),
                   rng=np.random.default_rng(seed))

    # ------------------------------------------------------------------
    def register_job(self, job_id: int) -> None:
        self.seen[job_id] = np.zeros(self.n_samples, bool)
        self.epoch[job_id] = 0
        self.served[job_id] = 0

    def unregister_job(self, job_id: int) -> None:
        self.seen.pop(job_id, None)
        self.epoch.pop(job_id, None)
        self.served.pop(job_id, None)

    @property
    def n_jobs(self) -> int:
        return max(len(self.seen), 1)

    def metadata_bytes(self) -> int:
        """Paper §5.2: ~1 bit/job/sample + 1 B/sample."""
        return self.n_samples * len(self.seen) // 8 + self.n_samples

    # ------------------------------------------------------------------
    def mark_cached(self, ids: np.ndarray, form: int) -> None:
        self.status[ids] = form
        if form == AUGMENTED:
            # an augmented tensor admitted via the serving path was already
            # consumed by the jobs whose seen-bit is set; start the
            # reference count there so threshold eviction still fires after
            # the *remaining* jobs use it (paper §5.2 semantics: evict once
            # every job consumed the augmentation once)
            if self.seen:
                seen_count = np.zeros(len(ids), np.int32)
                for bits in self.seen.values():
                    seen_count += bits[ids].astype(np.int32)
                self.refcount[ids] = seen_count
            else:
                self.refcount[ids] = 0

    def admission_value(self, sample_id: int) -> int:
        """How many jobs could still be served by caching this sample's
        augmented form (0 -> not worth a slot)."""
        return self.n_jobs - int(sum(bits[sample_id]
                                     for bits in self.seen.values()))

    def mark_evicted(self, ids: np.ndarray) -> None:
        self.status[ids] = IN_STORAGE
        self.refcount[ids] = 0

    def set_residency(self, levels: Optional[np.ndarray]) -> None:
        """Install the cache's per-sample tier levels (uint8[N]: 0
        storage / 1 disk / 2 DRAM).  When set, substitution prefers
        DRAM-resident candidates over disk-resident ones — a disk hit
        still beats a storage fetch, but not a DRAM hit."""
        self.residency = levels

    def set_inflight(self, mask: Optional[np.ndarray]) -> None:
        """Install the coalescing table's in-flight mask (bool[N], or
        None when the table is idle).  When set, substitution and
        uncached fills deprioritize in-flight ids — another job is
        already producing them, so a different pick costs the same and
        widens aggregate coverage."""
        self.inflight = mask

    # ------------------------------------------------------------------
    def sample_batch(self, job_id: int, requested: np.ndarray,
                     evict_threshold: Optional[int] = None
                     ) -> Tuple[np.ndarray, np.ndarray]:
        """ODS steps 1–4 (Fig. 6) for one batch request.

        ``requested`` is the next slice of the job's pseudo-random epoch
        permutation.  Returns (batch ids, eviction ids).  Slots whose
        requested sample misses in the cache (or was already consumed as an
        earlier substitute) are opportunistically replaced by cached,
        unseen samples; slots with no candidate keep the storage fetch.

        ``evict_threshold`` overrides the step-5 refcount threshold
        (default: the registered job count, the paper's rule; eviction
        policies pass a large sentinel to disable refcount churn).
        """
        seen = self.seen[job_id]
        requested = np.asarray(requested)
        B = len(requested)

        # epoch rollover: not enough unseen samples left for this batch
        if self.n_samples - self.served[job_id] < B:
            seen[:] = False
            self.served[job_id] = 0
            self.epoch[job_id] += 1

        cached_req = self.status[requested] != IN_STORAGE
        unseen_req = ~seen[requested]
        direct = cached_req & unseen_req            # serve as-is (hits)
        replace_slots = np.flatnonzero(~direct)     # misses + already-seen

        batch = requested.copy()
        if len(replace_slots):
            # candidates: cached, unseen, not already part of this batch
            cand_mask = (self.status != IN_STORAGE) & ~seen
            cand_mask[requested[direct]] = False
            cand = np.flatnonzero(cand_mask)
            take = min(len(cand), len(replace_slots))
            if take:
                picks = self._pick_candidates(cand, take)
                batch[replace_slots[:take]] = picks
                # substitutions = storage fetches avoided via cached unseen
                self.substitutions += int(
                    np.count_nonzero(~cached_req[replace_slots[:take]]))
            # leftover *already-seen* slots must still be served uniquely:
            # fall back to unseen, uncached samples
            left = replace_slots[take:]
            if len(left):
                need = left[seen[requested[left]]]
                if len(need):
                    pool = np.flatnonzero(~seen & (self.status == IN_STORAGE))
                    pool = np.setdiff1d(pool, batch, assume_unique=False)
                    # deprioritize ids another job is already producing
                    # (coalescing in flight) — but only when enough
                    # clear ids remain to fill every slot, so coverage
                    # guarantees never bend for a heuristic
                    if (self.inflight is not None and len(pool)
                            and self.inflight[pool].any()):
                        clear = pool[~self.inflight[pool]]
                        if len(clear) >= len(need):
                            pool = clear
                    fill = self.rng.permutation(pool)[:len(need)]
                    batch[need] = fill

        # step 3: increment refcounts of augmented-tier hits
        aug_hits = batch[self.status[batch] == AUGMENTED]
        self.refcount[aug_hits] += 1
        hit_ids = batch[self.status[batch] != IN_STORAGE]
        self.hits += len(hit_ids)
        self.misses += B - len(hit_ids)

        # step 4: update seen bit-vector
        seen[batch] = True
        self.served[job_id] += B

        # step 5: refcount-threshold eviction of augmented samples
        thr = self.n_jobs if evict_threshold is None else evict_threshold
        evict = aug_hits[self.refcount[aug_hits] >= thr]
        if len(evict):
            self.mark_evicted(evict)
        return batch, evict

    def _pick_candidates(self, cand: np.ndarray, take: int) -> np.ndarray:
        """Draw ``take`` substitution picks from ``cand``, in-flight
        ids last: a cached candidate whose (re)production is being
        coalesced right now is drawn only once the clear candidates run
        out.  With no in-flight overlap (the common case, and always
        when coalescing is off) this is exactly one :meth:`_draw` on
        the full candidate set — byte-identical to the mask-free
        sampler."""
        infl = self.inflight
        if infl is not None and len(cand) and infl[cand].any():
            busy_mask = infl[cand]
            groups = (cand[~busy_mask], cand[busy_mask])
            picks = []
            left = take
            for group in groups:
                n = min(left, len(group))
                if n:
                    picks.append(self._draw(group, n))
                    left -= n
            return (np.concatenate(picks) if picks
                    else np.empty(0, np.int64))
        return self._draw(cand, take)

    def _draw(self, cand: np.ndarray, take: int) -> np.ndarray:
        """Draw ``take`` picks from ``cand``.  Single-tier (residency
        None): one uniform draw, the paper's rule and the historical
        byte-identical path.  Tiered: faster-tier candidates are
        exhausted first (uniformly among themselves) — device (HBM)
        residents, then DRAM, then disk — opportunistic sampling
        prefers the fastest tier when several could fill a slot.  With
        no level-3 entries the HBM bucket is empty and the draw
        sequence is byte-identical to the two-tier rule."""
        if self.residency is None:
            return self.rng.choice(cand, size=take, replace=False)
        res = self.residency[cand]
        buckets = (cand[res >= 3], cand[(res >= 2) & (res < 3)],
                   cand[res < 2])
        picks = []
        left = take
        for bucket in buckets:
            n = min(left, len(bucket))
            if n:
                picks.append(self.rng.choice(bucket, size=n,
                                             replace=False))
                left -= n
        return np.concatenate(picks) if picks else np.empty(0, np.int64)

    # ------------------------------------------------------------------
    def hit_rate(self) -> float:
        total = self.hits + self.misses
        return self.hits / total if total else 0.0

    # ------------------------------------------------------------------
    def checkpoint_job(self, job_id: int) -> Dict:
        """Epoch-consistent snapshot of one job's sampling state.

        Captures exactly what exactly-once-per-epoch coverage depends
        on: the seen bit-vector (bit-packed), epoch counter, and served
        count.  The shared substitution RNG and counters are recorded
        for inspection but deliberately *not* restored by
        :meth:`restore_job` — they are dataset-global, and rewinding
        them would perturb every concurrent job.
        """
        if job_id not in self.seen:
            raise KeyError(f"job {job_id} is not registered")
        return {
            "n_samples": self.n_samples,
            "seen": np.packbits(self.seen[job_id]),
            "epoch": int(self.epoch[job_id]),
            "served": int(self.served[job_id]),
            "substitutions": int(self.substitutions),
            "rng_state": self.rng.bit_generator.state,
        }

    def restore_job(self, job_id: int, snap: Dict) -> None:
        """Install a :meth:`checkpoint_job` snapshot for ``job_id`` (the
        id may differ from the one snapshotted — re-admitted jobs get a
        fresh session id)."""
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


def merge_residency(parts) -> np.ndarray:
    """Merge per-shard residency (or status) arrays into the global
    view the ODS substitution sampler consumes.

    Shards own disjoint key ranges (the consistent-hash ring maps every
    sample to exactly one shard), so each sample is nonzero in at most
    one shard's array and an elementwise maximum is an exact merge —
    while also being safe under transient double-residency (a key mid-
    migration reports its best tier).
    """
    arrays = [np.asarray(p) for p in parts]
    if not arrays:
        raise ValueError("merge_residency needs at least one shard array")
    out = arrays[0].copy()
    for a in arrays[1:]:
        if a.shape != out.shape:
            raise ValueError(
                f"shard array shapes differ: {a.shape} vs {out.shape}")
        np.maximum(out, a, out=out)
    return out


class EpochSampler:
    """Per-job pseudo-random epoch permutation, consumed batch by batch."""

    def __init__(self, n_samples: int, batch_size: int, seed: int):
        self.n = n_samples
        self.bs = batch_size
        self.rng = np.random.default_rng(seed)
        self._perm = self.rng.permutation(self.n)
        self._pos = 0

    def next_request(self) -> np.ndarray:
        if self._pos + self.bs > self.n:
            self._perm = self.rng.permutation(self.n)
            self._pos = 0
        out = self._perm[self._pos:self._pos + self.bs]
        self._pos += self.bs
        return out

    # ------------------------------------------------------------------
    def state_dict(self) -> Dict:
        """Full sampler position: current permutation, offset, and RNG
        state — restoring reproduces the exact upcoming request
        sequence, including every future re-permutation."""
        return {
            "n": self.n,
            "bs": self.bs,
            "perm": self._perm.copy(),
            "pos": int(self._pos),
            "rng_state": self.rng.bit_generator.state,
        }

    def load_state_dict(self, state: Dict) -> None:
        if int(state["n"]) != self.n or int(state["bs"]) != self.bs:
            raise ValueError(
                f"sampler snapshot is for n={state['n']} bs={state['bs']}"
                f", this sampler has n={self.n} bs={self.bs}")
        self._perm = np.asarray(state["perm"], dtype=self._perm.dtype).copy()
        self._pos = int(state["pos"])
        self.rng.bit_generator.state = state["rng_state"]
