"""Model-Driven Partitioning (Seneca §5.1 + §5.3).

Brute-force search over the (x_E, x_D, x_A) simplex at 1% granularity
(5151 points), fully vectorized through the performance model — one numpy
pass, well under the paper's "<1s" budget.
"""
from __future__ import annotations

from dataclasses import dataclass, replace
from typing import Optional, Tuple

import numpy as np

from repro_torch.core.perf_model import (DatasetProfile, HardwareProfile,
                                   JobProfile, dsi_throughput,
                                   dsi_throughput_tiered)


@dataclass(frozen=True)
class Partition:
    x_e: float
    x_d: float
    x_a: float
    throughput: float          # predicted samples/s

    @property
    def label(self) -> str:
        return (f"{round(self.x_e * 100)}-{round(self.x_d * 100)}-"
                f"{round(self.x_a * 100)}")

    def bytes_split(self, cache_bytes: float) -> Tuple[float, float, float]:
        return (self.x_e * cache_bytes, self.x_d * cache_bytes,
                self.x_a * cache_bytes)


def simplex_grid(step: float = 0.01) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """All (x_e, x_d, x_a) with x_e + x_d + x_a = 1 at ``step`` granularity."""
    n = int(round(1.0 / step))
    e, d = np.meshgrid(np.arange(n + 1), np.arange(n + 1), indexing="ij")
    keep = (e + d) <= n
    e, d = e[keep], d[keep]
    a = n - e - d
    return e / n, d / n, a / n


# grid construction dominates a re-solve once dsi_throughput is one
# vectorized pass; share grids across solver instances (read-only)
_GRIDS: dict = {}


def _grid_cached(step: float) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    grid = _GRIDS.get(step)
    if grid is None:
        grid = simplex_grid(step)
        for arr in grid:
            arr.setflags(write=False)
        _GRIDS[step] = grid
    return grid


def _solve_on_grid(hw: HardwareProfile, ds: DatasetProfile,
                   job: JobProfile, grid) -> Partition:
    """One vectorized model pass over ``grid`` -> best Partition (shared
    by optimize() and IncrementalSolver so the construction-time solve
    and the controller's re-solves can never diverge)."""
    xe, xd, xa = grid
    out = dsi_throughput(hw, ds, job, xe, xd, xa)
    best = int(np.argmax(out.overall))
    return Partition(float(xe[best]), float(xd[best]), float(xa[best]),
                     float(out.overall[best]))


def optimize(hw: HardwareProfile, ds: DatasetProfile,
             job: Optional[JobProfile] = None,
             step: float = 0.01) -> Partition:
    """MDP: return the optimal cache split for (hardware, dataset, job)."""
    return _solve_on_grid(hw, ds, job or JobProfile(), _grid_cached(step))


# ---------------------------------------------------------------------------
# Form × tier MDP (DRAM split + disk-spill split)
# ---------------------------------------------------------------------------

@dataclass(frozen=True)
class TieredPartition:
    """One split per cache level: ``dram`` partitions ``s_cache``,
    ``disk`` partitions ``s_disk``, and (when a device tier is
    configured) ``hbm`` partitions ``s_hbm``; ``throughput`` is the
    combined multi-level model prediction (member Partitions carry it
    too).  ``hbm`` trails with a ``None`` default so existing
    two-level positional construction keeps working."""
    dram: Partition
    disk: Partition
    throughput: float
    hbm: Optional[Partition] = None

    @property
    def label(self) -> str:
        if self.hbm is not None:
            return f"{self.hbm.label}|{self.dram.label}|{self.disk.label}"
        return f"{self.dram.label}|{self.disk.label}"


def _solve_level_on_grid(hw, ds, job, grid, fixed, level: str,
                         fixed_hbm=None) -> Partition:
    """Sweep one level's simplex with the other level(s) fixed — a
    single vectorized tiered model pass.  ``fixed_hbm`` pins the device
    level while sweeping dram/disk; ``level == "hbm"`` sweeps the
    device level with ``fixed`` = (dram_split, disk_split)."""
    xe, xd, xa = grid
    if level == "dram":
        overall = dsi_throughput_tiered(hw, ds, job, (xe, xd, xa), fixed,
                                        fixed_hbm)
    elif level == "disk":
        overall = dsi_throughput_tiered(hw, ds, job, fixed, (xe, xd, xa),
                                        fixed_hbm)
    else:                                  # "hbm"
        dram_fixed, disk_fixed = fixed
        overall = dsi_throughput_tiered(hw, ds, job, dram_fixed,
                                        disk_fixed, (xe, xd, xa))
    best = int(np.argmax(overall))
    return Partition(float(xe[best]), float(xd[best]), float(xa[best]),
                     float(overall[best]))


def optimize_tiered(hw: HardwareProfile, ds: DatasetProfile,
                    job: Optional[JobProfile] = None, step: float = 0.01,
                    sweeps: int = 2) -> TieredPartition:
    """Form×tier MDP: coordinate descent over up to three simplexes.

    A joint 1%-grid over multiple levels is combinatorial (~26M points
    for two, ~10^11 for three); instead each sweep fixes the other
    level(s) and brute-forces one (vectorized 5151-point passes).  The
    objective is monotone under each conditional argmax, so a couple of
    sweeps reach a coordinate-wise optimum — in practice the first pass
    per level already lands it, because faster levels' greedy coverage
    is solved first and slower levels only see the leftovers.  With no
    disk tier configured the result degenerates to :func:`optimize`'s
    split with an all-encoded disk label placeholder; with no device
    tier ``hbm`` stays ``None`` and the solve is exactly the two-level
    descent.
    """
    job = job or JobProfile()
    grid = _grid_cached(step)
    dram = _solve_on_grid(hw, ds, job, grid)      # one-level warm start
    disk = Partition(1.0, 0.0, 0.0, dram.throughput)
    has_hbm = hw.b_hbm > 0 and hw.s_hbm > 0
    has_disk = hw.b_disk > 0 and hw.s_disk > 0
    if not has_disk and not has_hbm:
        return TieredPartition(dram, disk, dram.throughput)
    hbm = Partition(0.0, 0.0, 1.0, dram.throughput) if has_hbm else None
    for _ in range(max(int(sweeps), 1)):
        hbm_fixed = (hbm.x_e, hbm.x_d, hbm.x_a) if has_hbm else None
        if has_hbm:
            # fastest level first: device coverage shapes what the
            # lower levels are left to cover
            hbm = _solve_level_on_grid(
                hw, ds, job, grid,
                ((dram.x_e, dram.x_d, dram.x_a),
                 (disk.x_e, disk.x_d, disk.x_a)), "hbm")
            hbm_fixed = (hbm.x_e, hbm.x_d, hbm.x_a)
        if has_disk:
            disk = _solve_level_on_grid(
                hw, ds, job, grid,
                (dram.x_e, dram.x_d, dram.x_a), "disk", hbm_fixed)
        dram = _solve_level_on_grid(
            hw, ds, job, grid,
            (disk.x_e, disk.x_d, disk.x_a), "dram", hbm_fixed)
    thr = dram.throughput
    return TieredPartition(replace_throughput(dram, thr),
                           replace_throughput(disk, thr), thr,
                           replace_throughput(hbm, thr) if hbm else None)


def replace_throughput(p: Partition, thr: float) -> Partition:
    return Partition(p.x_e, p.x_d, p.x_a, thr)


# ---------------------------------------------------------------------------
# Per-shard solves (the sharded data plane, src/repro/service/)
# ---------------------------------------------------------------------------

def shard_view(hw: HardwareProfile, ds: DatasetProfile, n_shards: int
               ) -> Tuple[HardwareProfile, DatasetProfile]:
    """One shard's view of (hardware, dataset) for a shard-local solve.

    The consistent-hash ring divides both the capacity (each shard owns
    1/N of the cache and spill budget) and the key space (each shard
    owns ~1/N of the samples), so capacity fields and the population
    scale down together — the coverage ratios the model's miss-rate
    terms consume are preserved.  Bandwidth/rate fields stay whole:
    each request still sees the full channel.
    """
    n = max(int(n_shards), 1)
    if n == 1:
        return hw, ds
    return (replace(hw, s_cache=hw.s_cache / n, s_disk=hw.s_disk / n,
                    s_hbm=hw.s_hbm / n),
            replace(ds, n_total=max(int(np.ceil(ds.n_total / n)), 1)))


def optimize_shard(hw: HardwareProfile, ds: DatasetProfile,
                   job: Optional[JobProfile] = None, n_shards: int = 1,
                   step: float = 0.01, tiered: bool = False):
    """Form(×tier) MDP for one shard of an N-way sharded cache: the
    global solve re-run on the shard's 1/N view.  Returns a
    :class:`Partition` (or :class:`TieredPartition` with ``tiered``)."""
    shw, sds = shard_view(hw, ds, n_shards)
    if tiered:
        return optimize_tiered(shw, sds, job, step)
    return optimize(shw, sds, job, step)


class IncrementalSolver:
    """Re-solvable MDP for one (dataset, job): the simplex grid is built
    once and every ``solve(hw)`` is a single vectorized model pass, so the
    RepartitionController can re-run MDP per calibration tick well under
    the paper's <1 s budget.
    """

    def __init__(self, ds: DatasetProfile, job: Optional[JobProfile] = None,
                 step: float = 0.01):
        self.ds = ds
        self.job = job or JobProfile()
        self.step = step
        self._grid = _grid_cached(step)
        self.n_solves = 0

    def solve(self, hw: HardwareProfile) -> Partition:
        """Best split for ``hw`` (typically a calibrated profile)."""
        self.n_solves += 1
        return _solve_on_grid(hw, self.ds, self.job, self._grid)

    def predict(self, hw: HardwareProfile,
                split: Tuple[float, float, float]) -> float:
        """Model-predicted throughput of one concrete split under ``hw``
        (the drift / hysteresis comparisons in the controller)."""
        out = dsi_throughput(hw, self.ds, self.job, *split)
        return float(out.overall)

    def solve_tiered(self, hw: HardwareProfile) -> TieredPartition:
        """Form×tier re-solve (shares the cached grid; two coordinate
        sweeps, each one vectorized pass)."""
        self.n_solves += 1
        return optimize_tiered(hw, self.ds, self.job, self.step)

    def predict_tiered(self, hw: HardwareProfile,
                       dram_split: Tuple[float, float, float],
                       disk_split: Tuple[float, float, float],
                       hbm_split: Optional[Tuple[float, float, float]]
                       = None) -> float:
        """Tiered model prediction for one concrete (dram, disk[, hbm])
        split tuple."""
        return float(dsi_throughput_tiered(hw, self.ds, self.job,
                                           dram_split, disk_split,
                                           hbm_split))


def sweep(hw: HardwareProfile, ds: DatasetProfile,
          job: Optional[JobProfile] = None, step: float = 0.01):
    """Full grid (for benchmarks / plots): (xe, xd, xa, throughput)."""
    job = job or JobProfile()
    xe, xd, xa = simplex_grid(step)
    out = dsi_throughput(hw, ds, job, xe, xd, xa)
    return xe, xd, xa, out.overall
