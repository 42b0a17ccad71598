"""Fluid-flow simulator of the DSI pipeline.

Reproduces the paper's measured numbers without their hardware: per batch
round, each resource's busy time is ``demand / rate`` and the round takes
the *max* across resources (perfectly-overlapped pipeline, matching the
min-form of the closed-form model) — but the batch *composition* (which
tier serves each sample, ODS substitutions, refcount evictions, refills,
page-cache churn) is simulated mechanistically from real sampler + cache
state.  The closed-form model (Eqs. 1–9) and this simulator share only the
hardware constants, so Fig. 8's model-vs-"measured" correlation is a real
cross-validation.

All seven loaders of Table 7 are expressible as a :class:`LoaderSpec`.

The port's copy of ``repro.sim.desim``: numpy only, over the port's
``core.{mdp,ods,perf_model}``; no device is involved.  Same specs and
seed give the reference's results exactly.
"""
from __future__ import annotations

from dataclasses import dataclass, field, replace
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from repro_torch.core.mdp import optimize
from repro_torch.core.ods import EpochSampler, ODSState
from repro_torch.core.perf_model import (DatasetProfile, HardwareProfile,
                                         JobProfile)

ENC, DEC, AUG = 1, 2, 3


@dataclass(frozen=True)
class LoaderSpec:
    """Knobs expressing the Table 7 loader matrix."""
    name: str
    sampling: str = "random"           # random | ods | quiver | importance
    cache_forms: Tuple[str, ...] = ("encoded",)
    shares_cache: bool = True          # False -> per-job private pipelines
    page_cache: bool = False           # LRU over encoded (PyTorch/DALI)
    cpu_scale: float = 1.0             # DALI pipelining gain / SHADE 1-thread
    gpu_offload: bool = False          # DALI-GPU: preprocessing on the GPU
    mdp_split: bool = False            # size tiers with MDP
    evict_refcount: bool = True        # Seneca augmented-tier eviction
    oversample: int = 1                # Quiver: 10x candidate requests
    split_override: Optional[Tuple[float, float, float]] = None
    # background refill thread speed: fraction of the augmented tier it can
    # repopulate per batch round (1/8 calibrated against Fig. 13's Azure
    # measurement; an unbounded thread saturates the hit rate at 1.0)
    refill_rate: float = 0.125


PYTORCH = LoaderSpec("pytorch", page_cache=True, shares_cache=False)
DALI_CPU = LoaderSpec("dali-cpu", page_cache=True, shares_cache=False,
                      cpu_scale=1.35)
DALI_GPU = LoaderSpec("dali-gpu", page_cache=True, shares_cache=False,
                      gpu_offload=True)
MINIO = LoaderSpec("minio", cache_forms=("encoded",), shares_cache=True)
QUIVER = LoaderSpec("quiver", sampling="quiver", oversample=10,
                    cache_forms=("encoded",))
SHADE = LoaderSpec("shade", sampling="importance", cpu_scale=1 / 8,
                   cache_forms=("encoded",))
MDP_ONLY = LoaderSpec("mdp", mdp_split=True,
                      cache_forms=("encoded", "decoded", "augmented"))
SENECA = LoaderSpec("seneca", sampling="ods", mdp_split=True,
                    cache_forms=("encoded", "decoded", "augmented"))

ALL_LOADERS = (PYTORCH, DALI_CPU, MINIO, QUIVER, SHADE, MDP_ONLY, SENECA)


@dataclass
class SimJob:
    job_id: int
    gpu_rate: float                  # samples/s this model trains at
    batch_size: int = 512
    epochs: int = 1
    arrival_s: float = 0.0
    # runtime
    served: int = 0
    done_at: Optional[float] = None
    dsi_busy: Dict[str, float] = field(default_factory=dict)


@dataclass
class SimResult:
    makespan: float
    total_samples: int
    throughput: float                # aggregate DSI samples/s
    hit_rate: float
    per_job_seconds: Dict[int, float]
    busy: Dict[str, float]           # resource busy seconds
    preprocess_ops: int              # decode+augment executions
    stable_epoch_s: Dict[int, float]
    first_epoch_s: Dict[int, float]


class DSISimulator:
    def __init__(self, hw: HardwareProfile, ds: DatasetProfile,
                 loader: LoaderSpec, cache_bytes: Optional[float] = None,
                 job_profile: Optional[JobProfile] = None, seed: int = 0,
                 aug_inflation: Optional[float] = None,
                 overlap: bool = True):
        self.hw = hw
        self.ds = ds
        self.loader = loader
        # overlap=True: round time = max resource time (pipelined).
        # overlap=False: per-form service classes serialize (the Eq. 9
        # weighted-mean discipline) — used by the Fig. 8 validation.
        self.overlap = overlap
        self.cache_bytes = cache_bytes if cache_bytes is not None \
            else hw.s_cache
        self.jobp = job_profile or JobProfile()
        self.rng = np.random.default_rng(seed)
        # per-form byte sizes (see DatasetProfile)
        if aug_inflation is not None:
            self.aug_b = self.dec_b = self.gpu_b = aug_inflation * ds.s_data
        elif ds.inflation:
            self.aug_b = self.dec_b = self.gpu_b = ds.inflation * ds.s_data
        else:
            self.aug_b, self.dec_b, self.gpu_b = (
                ds.augmented_bytes, ds.decoded_bytes, ds.gpu_bytes)
        N = ds.n_total

        # tier membership (bitmask arrays)
        self.in_enc = np.zeros(N, bool)
        self.in_dec = np.zeros(N, bool)
        self.in_aug = np.zeros(N, bool)
        self.refcount = np.zeros(N, np.int32)

        # partition capacities in samples
        if loader.split_override is not None:
            split = loader.split_override
        elif loader.mdp_split:
            hw2 = replace(hw, s_cache=float(self.cache_bytes))
            p = optimize(hw2, ds, self.jobp, step=0.02)
            split = (p.x_e, p.x_d, p.x_a)
        else:
            split = (1.0, 0.0, 0.0)
        self.split = split
        self.cap_enc = int(split[0] * self.cache_bytes / ds.s_data)
        self.cap_dec = int(split[1] * self.cache_bytes / self.dec_b)
        self.cap_aug = int(split[2] * self.cache_bytes / self.aug_b)
        if loader.page_cache:
            # page cache: all DRAM as one LRU over encoded files
            self.cap_enc = int(self.cache_bytes / ds.s_data)
            self.cap_dec = self.cap_aug = 0
        self._lru: List[int] = []       # page-cache LRU order (enc ids)

        # SHADE importance scores (sampling distribution precomputed)
        imp = self.rng.pareto(2.0, N) + 1.0
        self.importance_p = imp / imp.sum()

        # incremental tier occupancy counters (avoid O(N) scans per round)
        self.n_enc = 0
        self.n_dec = 0
        self.n_aug = 0

        self.hits = 0
        self.misses = 0
        self.preprocess_ops = 0

    # ------------------------------------------------------------------
    def _tier(self, ids: np.ndarray) -> np.ndarray:
        t = np.zeros(len(ids), np.int8)
        t[self.in_enc[ids]] = ENC
        t[self.in_dec[ids]] = DEC
        t[self.in_aug[ids]] = AUG
        return t

    def _admit(self, ids: np.ndarray) -> list:
        """Fill tiers (most-processed-first) up to capacity; page-cache LRU
        churns instead.  Returns ids admitted to the augmented tier."""
        aug_admitted = []
        if self.loader.page_cache:
            for sid in ids:
                if self.in_enc[sid]:
                    continue
                if self.n_enc >= max(self.cap_enc, 0) and self._lru:
                    victim = self._lru.pop(0)
                    self.in_enc[victim] = False
                    self.n_enc -= 1
                self.in_enc[sid] = True
                self.n_enc += 1
                self._lru.append(int(sid))
            return aug_admitted
        for sid in ids:
            if self.in_aug[sid] or self.in_dec[sid] or self.in_enc[sid]:
                continue
            if self.n_aug < self.cap_aug:
                self.in_aug[sid] = True
                self.refcount[sid] = 0
                self.n_aug += 1
                aug_admitted.append(int(sid))
            elif self.n_dec < self.cap_dec:
                self.in_dec[sid] = True
                self.n_dec += 1
            elif self.n_enc < self.cap_enc:
                self.in_enc[sid] = True
                self.n_enc += 1
        return aug_admitted

    # ------------------------------------------------------------------
    def run(self, jobs: Sequence[SimJob], max_rounds: int = 100_000
            ) -> SimResult:
        N = self.ds.n_total
        n_jobs = len(jobs)
        ods = ODSState.create(N, seed=17)
        samplers: Dict[int, EpochSampler] = {}
        seen_priv: Dict[int, np.ndarray] = {}
        for j in jobs:
            ods.register_job(j.job_id)
            samplers[j.job_id] = EpochSampler(N, j.batch_size,
                                              11 + j.job_id)
            seen_priv[j.job_id] = np.zeros(N, bool)

        clock = 0.0
        busy = {k: 0.0 for k in ("storage", "cache_bw", "nic", "pcie",
                                 "cpu", "gpu")}
        epoch_marks: Dict[int, List[float]] = {j.job_id: [0.0] for j in jobs}
        total_served = 0
        S = self.ds.s_data
        a_b, d_b, g_b = self.aug_b, self.dec_b, self.gpu_b
        hw = self.hw
        n = hw.n_nodes

        rounds = 0
        while any(j.done_at is None for j in jobs) and rounds < max_rounds:
            rounds += 1
            active = [j for j in jobs
                      if j.done_at is None and j.arrival_s <= clock]
            if not active:
                future = [j.arrival_s for j in jobs if j.done_at is None]
                clock = min(future)
                continue

            demand = {k: 0.0 for k in busy}
            gpu_times: List[float] = []
            serial_times: List[float] = []
            for j in active:
                jid = j.job_id
                req = samplers[jid].next_request()
                if self.loader.sampling == "ods":
                    ods.status[:] = 0
                    ods.status[self.in_enc] = 1
                    ods.status[self.in_dec] = 2
                    ods.status[self.in_aug] = 3
                    ods.refcount[:] = self.refcount
                    batch, evicted = ods.sample_batch(jid, req)
                    self.refcount[:] = ods.refcount
                    # count tiers BEFORE applying evictions: a sample served
                    # from the augmented tier on its final use is a hit
                    tiers_pre = self._tier(batch)
                    if self.loader.evict_refcount:
                        if len(evicted):
                            was_aug = self.in_aug[evicted]
                            self.in_aug[evicted] = False
                            self.n_aug -= int(np.count_nonzero(was_aug))
                        # background refill (paper step 5): replace evicted
                        # slots 1:1; during the cold first epoch also fill
                        # empty capacity (initial population)
                        free = self.cap_aug - self.n_aug
                        warm_quota = j.batch_size \
                            if ods.epoch.get(jid, 0) == 0 else 0
                        rate_cap = max(
                            int(self.cap_aug * self.loader.refill_rate
                                / max(len(jobs), 1)), 1)
                        budget = min(free, rate_cap,
                                     max(len(evicted), warm_quota))
                        if budget > 0:
                            all_seen = np.ones(N, bool)
                            for bits in ods.seen.values():
                                all_seen &= bits
                            pool = np.flatnonzero(
                                ~self.in_aug & ~self.in_dec & ~self.in_enc
                                & ~all_seen)
                            take = min(budget, len(pool))
                            if take:
                                picks = self.rng.choice(pool, take,
                                                        replace=False)
                                fresh = self._admit(picks)
                                self.refcount[fresh] = 0
                                demand["storage"] += len(fresh) * S
                                demand["cpu"] += len(fresh) / (
                                    hw.t_da * self.loader.cpu_scale) / n
                elif self.loader.sampling == "quiver":
                    cand = samplers[jid].next_request()
                    for _ in range(self.loader.oversample - 1):
                        cand = np.concatenate(
                            [cand, samplers[jid].next_request()])
                    cached = cand[self._tier(cand) > 0]
                    un = cached[~seen_priv[jid][cached]][:j.batch_size]
                    rest = req[~np.isin(req, un)][:j.batch_size - len(un)]
                    batch = np.concatenate([un, rest])[:j.batch_size]
                    seen_priv[jid][batch] = True
                    if seen_priv[jid].sum() >= N - j.batch_size:
                        seen_priv[jid][:] = False
                    # over-sampling burns cache bandwidth on probes
                    demand["cache_bw"] += len(cand) * 0.002 * S
                elif self.loader.sampling == "importance":
                    batch = self.rng.choice(N, j.batch_size, replace=False,
                                            p=self.importance_p)
                else:
                    batch = req

                tiers = tiers_pre if self.loader.sampling == "ods" \
                    else self._tier(batch)
                n_aug = int(np.count_nonzero(tiers == AUG))
                n_dec = int(np.count_nonzero(tiers == DEC))
                n_enc = int(np.count_nonzero(tiers == ENC))
                n_sto = len(batch) - n_aug - n_dec - n_enc
                self.hits += n_aug + n_dec + n_enc
                self.misses += n_sto

                # resource demands (bytes / samples)
                demand["storage"] += n_sto * S
                demand["cache_bw"] += (n_enc * S + n_dec * d_b + n_aug * a_b)
                demand["nic"] += ((n_sto + n_enc) * S + n_dec * d_b
                                  + n_aug * a_b) / n
                demand["pcie"] += len(batch) * g_b / n
                if not self.overlap:
                    # Eq. 9 service discipline: each form-class runs to
                    # completion at its own min()-bound rate, serially
                    cls = [
                        max(n_sto * S / hw.b_storage,
                            n_sto * S / (n * hw.b_nic),
                            n_sto / (hw.t_da * self.loader.cpu_scale * n),
                            n_sto * g_b / (n * hw.b_pcie),
                            n_sto / (n * hw.t_gpu)),
                        max(n_enc * S / hw.b_cache,
                            n_enc * S / (n * hw.b_nic),
                            n_enc / (hw.t_da * self.loader.cpu_scale * n),
                            n_enc * g_b / (n * hw.b_pcie),
                            n_enc / (n * hw.t_gpu)),
                        max(n_dec * d_b / hw.b_cache,
                            n_dec * d_b / (n * hw.b_nic),
                            n_dec / (hw.t_a * self.loader.cpu_scale * n),
                            n_dec * g_b / (n * hw.b_pcie),
                            n_dec / (n * hw.t_gpu)),
                        max(n_aug * a_b / hw.b_cache,
                            n_aug * a_b / (n * hw.b_nic),
                            n_aug * g_b / (n * hw.b_pcie),
                            n_aug / (n * hw.t_gpu)),
                    ]
                    serial_times.append(sum(cls))
                cpu_da = (n_sto + n_enc) / self.loader.cpu_scale
                cpu_a = n_dec / self.loader.cpu_scale
                # decode executions (the Fig. 4b preprocessing count)
                self.preprocess_ops += n_sto + n_enc
                gpu_t = len(batch) / j.gpu_rate
                if self.loader.gpu_offload:
                    gpu_t += (n_sto + n_enc + n_dec) / (hw.t_gpu * 2.0)
                else:
                    demand["cpu"] += (cpu_da / hw.t_da + cpu_a / hw.t_a) / n
                gpu_times.append(gpu_t)

                # admissions: storage fetches may populate the cache; an
                # augmented tensor admitted via the serving path was
                # already consumed by jobs whose seen-bit is set — start
                # its refcount there so threshold eviction still fires
                fresh = self._admit(batch[tiers == 0])
                if fresh and self.loader.sampling == "ods":
                    fa = np.asarray(fresh)
                    cnt = np.zeros(len(fa), np.int32)
                    for bits in ods.seen.values():
                        cnt += bits[fa].astype(np.int32)
                    # all-seen admissions would pin a slot until epoch
                    # rollover without serving anyone: reject them
                    dead = fa[cnt >= len(ods.seen)]
                    if len(dead):
                        self.in_aug[dead] = False
                        self.n_aug -= len(dead)
                    live = fa[cnt < len(ods.seen)]
                    self.refcount[live] = cnt[cnt < len(ods.seen)]

                j.served += len(batch)
                total_served += len(batch)
                if j.served >= N * (len(epoch_marks[j.job_id])):
                    epoch_marks[j.job_id].append(clock)  # epoch boundary

            # round time = slowest resource (pipelined overlap); jobs train
            # on separate GPUs concurrently -> gpu term is the per-job max
            times = {
                "storage": demand["storage"] / hw.b_storage,
                "cache_bw": demand["cache_bw"] / hw.b_cache,
                "nic": demand["nic"] / hw.b_nic,
                "pcie": demand["pcie"] / hw.b_pcie,
                "cpu": demand["cpu"],
                "gpu": max(gpu_times) if gpu_times else 0.0,
            }
            if self.overlap:
                dt = max(times.values())
            else:
                dt = max(max(serial_times) if serial_times else 0.0,
                         times["gpu"])
            for k in busy:
                busy[k] += times[k]
            clock += dt

            for j in active:
                if j.served >= N * j.epochs:
                    j.done_at = clock

        makespan = max((j.done_at or clock) for j in jobs)
        per_job = {j.job_id: (j.done_at or clock) - j.arrival_s
                   for j in jobs}
        first_epoch = {}
        stable_epoch = {}
        for j in jobs:
            marks = epoch_marks[j.job_id]
            marks.append(j.done_at or clock)
            deltas = np.diff(marks)
            deltas = deltas[deltas > 0]
            if len(deltas):
                first_epoch[j.job_id] = float(deltas[0])
                stable_epoch[j.job_id] = float(
                    np.mean(deltas[1:]) if len(deltas) > 1 else deltas[0])
        hr = self.hits / max(self.hits + self.misses, 1)
        return SimResult(
            makespan=makespan, total_samples=total_served,
            throughput=total_served / max(makespan, 1e-9), hit_rate=hr,
            per_job_seconds=per_job, busy=busy,
            preprocess_ops=self.preprocess_ops,
            stable_epoch_s=stable_epoch, first_epoch_s=first_epoch)
