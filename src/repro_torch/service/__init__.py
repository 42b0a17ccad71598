"""The disaggregated Seneca data plane (tf.data-service-style).

A consistent-hash :class:`ShardRouter` maps sample keys to N
:class:`CacheShard` instances — each with its own tiered cache,
shard-local form×tier MDP solve, and telemetry — behind a small
request/response protocol with two interchangeable transports:
in-process simulation (deterministic under the VirtualClock) and one
OS process per shard (payloads moved zero-copy via codec files +
``np.memmap``).  :class:`ShardedCache` is the client: a drop-in for
``TieredCache`` that ``SenecaServer(shards=N, shard_transport=...)``
constructs, so sessions and pipelines work unchanged.

Each shard's HBM tier lives on the service's device (``ShardConfig.
device``; ``None`` means CUDA): in the caller's process over the sim
transport, and in the shard's own process — with its own CUDA context —
over the process transport.  Device payloads cross a process boundary
only as host copies in exchange files, never pickled as tensors.
"""
from repro_torch.service.client import ShardedCache
from repro_torch.service.proto import Request, Response
from repro_torch.service.router import ShardRouter
from repro_torch.service.shard import CacheShard, ShardConfig
from repro_torch.service.transport import (ProcessTransport, ShardDownError,
                                           SimTransport, TRANSPORTS,
                                           make_transport)

__all__ = [
    "ShardRouter", "ShardedCache", "CacheShard", "ShardConfig",
    "Request", "Response", "SimTransport", "ProcessTransport",
    "ShardDownError", "TRANSPORTS", "make_transport",
]
