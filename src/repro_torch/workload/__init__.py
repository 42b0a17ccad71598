"""Multi-job workload execution over the live Seneca stack.

:class:`WorkloadRunner` admits a trace of :class:`JobSpec`\\ s against a
:class:`~repro_torch.api.server.SenecaServer` (shared cache) or a per-job
server factory (private baseline), pacing each job's pipeline with a
rate-limited consumer that emulates GPU ingest.  The :class:`Clock`
abstraction makes concurrency reproducible: :class:`RealClock` is wall
time, :class:`VirtualClock` serializes job threads deterministically so
multi-job interleavings are byte-for-byte repeatable in tests.

Open-loop serving (docs/API.md "Open-loop serving & SLOs"):
:class:`OpenLoopGenerator` replays a trace-driven arrival schedule
(:func:`poisson_arrivals` / :func:`bursty_arrivals` /
:func:`diurnal_arrivals`) against the session API with per-request
p50/p99/p999 latency accounting and SLO-aware admission control.

See docs/API.md "Multi-job workloads".
"""
from repro_torch.workload.clock import Clock, RealClock, VirtualClock
from repro_torch.workload.openloop import (ARRIVAL_PROCESSES,
                                           OpenLoopGenerator, RequestResult,
                                           ServeResult, bursty_arrivals,
                                           diurnal_arrivals, make_arrivals,
                                           poisson_arrivals, quantile)
from repro_torch.workload.runner import (JobResult, JobSpec, WorkloadResult,
                                         WorkloadRunner,
                                         deterministic_runner)
from repro_torch.workload.samplers import (REQUEST_SAMPLERS,
                                           PhaseShiftSampler, ZipfianSampler,
                                           make_request_sampler)

__all__ = [
    "Clock", "RealClock", "VirtualClock",
    "JobSpec", "JobResult", "WorkloadResult", "WorkloadRunner",
    "deterministic_runner",
    "ZipfianSampler", "PhaseShiftSampler", "make_request_sampler",
    "REQUEST_SAMPLERS",
    "OpenLoopGenerator", "RequestResult", "ServeResult",
    "ARRIVAL_PROCESSES", "poisson_arrivals", "bursty_arrivals",
    "diurnal_arrivals", "make_arrivals", "quantile",
]
