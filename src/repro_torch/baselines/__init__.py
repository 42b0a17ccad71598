"""Baseline dataloaders (Table 7), expressed as simulator LoaderSpecs.

The port's copy of ``repro.baselines``.  Each baseline from the paper's
comparison matrix is a configuration of the same mechanistic substrate
(sim/desim.py) rather than a fork — PyTorch and DALI ride the page-cache
LRU, MINIO pins encoded samples without eviction, Quiver over-samples
10x and substitutes, SHADE importance-samples on one thread, MDP
partitions without ODS.
"""
from repro_torch.sim.desim import (ALL_LOADERS, DALI_CPU, DALI_GPU,
                                   MDP_ONLY, MINIO, PYTORCH, QUIVER, SENECA,
                                   SHADE, LoaderSpec)

__all__ = ["ALL_LOADERS", "DALI_CPU", "DALI_GPU", "MDP_ONLY", "MINIO",
           "PYTORCH", "QUIVER", "SENECA", "SHADE", "LoaderSpec"]
