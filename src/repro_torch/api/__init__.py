"""repro_torch.api — the public surface of the PyTorch port.

Live service (sessions over one shared cache + sampler)::

    from repro_torch.api import SenecaServer

    server = SenecaServer.for_dataset(ds, cache_frac=0.35)   # on CUDA
    with server.open_session(batch_size=32) as sess:
        ids, forms = sess.next_batch_ids()

``device=None`` (the default) places the HBM tier, the device executor
and the "torch" ODS engine on CUDA and raises where CUDA is missing;
``device="cpu"`` runs the same code with the kernels' plain PyTorch
versions.  ``backend="torch"`` runs the ODS batch substitution on that
device (:class:`TorchOdsBackend`); "numpy" keeps it on the host.

Multi-job workloads and open-loop serving (re-exported from
:mod:`repro_torch.workload`)::

    from repro_torch.api import JobSpec, VirtualClock

    res = server.run_workload(
        [JobSpec("a", epochs=1, batch_size=16),
         JobSpec("b", arrival_s=0.05, epochs=1, batch_size=16)],
        RemoteStorage(ds), clock=VirtualClock())   # deterministic

On a ``RealClock`` (the default), ``JobSpec(executor="device")`` runs
each job's pipeline through the fused decode+augment kernel.  Fault
injection (:class:`FaultSpec`, :class:`FaultInjector`) replays on the
same clock.  The sharded data plane (``shards=N``,
``shard_transport="sim" | "process"``; :class:`ShardedCache` and its
router and shards) keeps each shard's HBM tier on the service's device.
Policies, telemetry, adaptive repartitioning and the closed-form
performance model behave as in the reference package.  The fluid-flow
simulator behind the paper-figure benchmarks (:class:`DSISimulator` and
the Table 7 :class:`LoaderSpec` matrix) is re-exported too, as in the
reference.
"""
from repro_torch.api.backends import (AugmentBackend, CudaAugmentBackend,
                                      NumpyAugmentBackend, NumpyOdsBackend,
                                      OdsBackend, TorchOdsBackend,
                                      augment_backend_names,
                                      backend_names,
                                      register_augment_backend,
                                      register_backend,
                                      resolve_augment_backend,
                                      resolve_backend)
from repro_torch.api.policies import (AdmissionPolicy, CapacityAdmission,
                                      EvictionPolicy, LruEviction,
                                      NaiveSampler, OdsSampler,
                                      RefcountEviction, SamplerPolicy,
                                      UnseenOnlyAdmission, policy_names,
                                      register_policy, resolve_policy)
from repro_torch.api.server import (CODE_FORM, FORM_CODE, SLO,
                                    RepartitionController, SenecaConfig,
                                    SenecaServer, SenecaService, Session,
                                    SessionClosed, state_from_reference)
from repro_torch.api.telemetry import (Ewma, TelemetryAggregator,
                                       TelemetrySnapshot)
# hardware / dataset profiles + the closed-form DSI model
from repro_torch.core.perf_model import (AWS_P3, AZURE_NC96, DATASETS,
                                         EVAL_PROFILES, GB, Gbit,
                                         IMAGENET_1K, IMAGENET_22K,
                                         IN_HOUSE, KB, MB, OPENIMAGES,
                                         VALIDATION_PROFILES,
                                         DatasetProfile, HardwareProfile,
                                         JobProfile, dsi_throughput,
                                         dsi_throughput_tiered)
# mechanistic simulator (Table 7 loader matrix)
from repro_torch.sim.desim import (ALL_LOADERS, DALI_CPU, DALI_GPU,
                                   DSISimulator, LoaderSpec, MDP_ONLY,
                                   MINIO, PYTORCH, QUIVER, SENECA, SHADE,
                                   SimJob, SimResult)
# sharded data plane: consistent-hash router + per-shard caches behind
# sim/process transports, selected via SenecaConfig(shards=N,
# shard_transport=...)
from repro_torch.service import (CacheShard, ShardConfig, ShardedCache,
                                 ShardRouter)
# fault injection + failover
from repro_torch.faults import (FAULT_KINDS, FaultInjector, FaultSpec,
                                LivenessRegistry)

# live multi-job workload runner + pluggable clocks; VirtualClock makes
# concurrency deterministic.  These are re-exported lazily (PEP 562):
# repro_torch.workload.runner imports the pipeline, which imports
# repro_torch.api.server, which initializes this package — an eager
# import here would close that cycle on a partially initialized module.
_WORKLOAD_EXPORTS = ("Clock", "JobResult", "JobSpec", "RealClock",
                     "VirtualClock", "WorkloadResult", "WorkloadRunner",
                     "deterministic_runner",
                     # open-loop serving
                     "OpenLoopGenerator", "RequestResult", "ServeResult",
                     "ARRIVAL_PROCESSES", "poisson_arrivals",
                     "bursty_arrivals", "diurnal_arrivals",
                     "make_arrivals")


def __getattr__(name: str):
    if name in _WORKLOAD_EXPORTS:
        import repro_torch.workload as _workload
        return getattr(_workload, name)
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")


__all__ = [
    # server / session facade
    "SenecaServer", "Session", "SessionClosed", "SenecaConfig",
    "SenecaService", "SLO", "FORM_CODE", "CODE_FORM",
    "state_from_reference",
    # telemetry + adaptive repartitioning
    "RepartitionController", "TelemetryAggregator", "TelemetrySnapshot",
    "Ewma",
    # policies
    "SamplerPolicy", "AdmissionPolicy", "EvictionPolicy",
    "OdsSampler", "NaiveSampler", "UnseenOnlyAdmission",
    "CapacityAdmission", "RefcountEviction", "LruEviction",
    "register_policy", "resolve_policy", "policy_names",
    # backends
    "OdsBackend", "NumpyOdsBackend", "TorchOdsBackend",
    "register_backend", "resolve_backend", "backend_names",
    "AugmentBackend", "NumpyAugmentBackend", "CudaAugmentBackend",
    "register_augment_backend", "resolve_augment_backend",
    "augment_backend_names",
    # profiles + closed-form model
    "HardwareProfile", "DatasetProfile", "JobProfile", "dsi_throughput",
    "dsi_throughput_tiered",
    "AZURE_NC96", "AWS_P3", "IN_HOUSE", "VALIDATION_PROFILES",
    "EVAL_PROFILES", "DATASETS", "IMAGENET_1K", "IMAGENET_22K",
    "OPENIMAGES", "GB", "MB", "KB", "Gbit",
    # simulator
    "DSISimulator", "LoaderSpec", "SimJob", "SimResult", "ALL_LOADERS",
    "PYTORCH", "DALI_CPU", "DALI_GPU", "MINIO", "QUIVER", "SHADE",
    "MDP_ONLY", "SENECA",
    # live multi-job workloads
    "WorkloadRunner", "JobSpec", "JobResult", "WorkloadResult",
    "Clock", "RealClock", "VirtualClock", "deterministic_runner",
    # open-loop serving
    "OpenLoopGenerator", "RequestResult", "ServeResult",
    "ARRIVAL_PROCESSES", "poisson_arrivals", "bursty_arrivals",
    "diurnal_arrivals", "make_arrivals",
    # sharded data plane
    "ShardRouter", "ShardedCache", "CacheShard", "ShardConfig",
    # fault injection + failover
    "FaultSpec", "FaultInjector", "LivenessRegistry", "FAULT_KINDS",
]
