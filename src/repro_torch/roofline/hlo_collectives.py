"""Collective-byte accounting: the reference's, fed by the port's own
collectives.

The reference (``repro.roofline.hlo_collectives``) parses the compiled
HLO of a program: every all-gather / all-reduce / reduce-scatter /
all-to-all / collective-permute op is matched, its result shape sized,
and ring-algorithm wire-byte factors applied per op kind and
replica-group size.  The port compiles no HLO.  It keeps the name, so
that the two module lists pair, and the accounting: the same
:class:`CollectiveStats` and the same factors (:func:`wire_bytes`),
applied to :class:`Record` s of kind, result bytes and group size.

The records come from :func:`record`: a ``TorchDispatchMode`` that, while
it is open, sees each collective the port issues through
``torch.distributed`` (the ``c10d`` ops behind ``all_reduce``,
``all_gather``, ``reduce_scatter_tensor``, ``all_to_all_single`` and
``isend``, and the functional collectives behind DTensor and
``torch.distributed._functional_collectives``) and writes one record per
op, per rank, as the reference's SPMD module is a per-device program:

============================  ====================  =====================
port call                     reference kind        result bytes
============================  ====================  =====================
``all_reduce``                all-reduce            the tensor
``all_gather(_into_tensor)``  all-gather            the gathered output
``reduce_scatter_tensor``     reduce-scatter        the shard
``all_to_all_single``         all-to-all            the output
``isend`` (with its irecv)    collective-permute    the tensor sent
============================  ====================  =====================

A hand-off of ``distributed.pp.pipeline_forward`` is an ``isend``/``irecv``
pair; it is counted once, at its send.  Other ops (broadcast, gather,
scatter, barrier) are not counted, as the reference's parser matches
only the five kinds.

The reference multiplies the collectives inside a ``while`` body by the
loop's trip count, read from its condition.  Eager torch runs every
iteration of a loop, and each is recorded, so that part has no twin.
A group of one rank sends nothing: its records count, with 0 wire
bytes (the reference never sees one, as XLA drops such ops and its
parser takes 2 for a group it cannot read).
"""
from __future__ import annotations

from collections import defaultdict
from dataclasses import dataclass, field
from typing import Dict, Iterable, List

import torch
from torch.utils._python_dispatch import TorchDispatchMode

#: the dispatcher ops of the collectives, by name, and their kinds
_KINDS = {
    # c10d: the ops behind torch.distributed's calls
    "allreduce_": "all-reduce",
    "allreduce_coalesced_": "all-reduce",
    "allgather_": "all-gather",
    "_allgather_base_": "all-gather",
    "allgather_into_tensor_coalesced_": "all-gather",
    "reduce_scatter_": "reduce-scatter",
    "_reduce_scatter_base_": "reduce-scatter",
    "reduce_scatter_tensor_coalesced_": "reduce-scatter",
    "alltoall_": "all-to-all",
    "alltoall_base_": "all-to-all",
    "send": "collective-permute",
    # functional collectives (DTensor, torch.distributed._functional_...)
    "all_reduce": "all-reduce",
    "all_reduce_": "all-reduce",
    "all_reduce_coalesced": "all-reduce",
    "all_reduce_coalesced_": "all-reduce",
    "all_gather_into_tensor": "all-gather",
    "all_gather_into_tensor_out": "all-gather",
    "all_gather_into_tensor_coalesced": "all-gather",
    "reduce_scatter_tensor": "reduce-scatter",
    "reduce_scatter_tensor_coalesced": "reduce-scatter",
    "all_to_all_single": "all-to-all",
}
_C10D = "c10d"
_FUNCTIONAL = ("_c10d_functional", "_c10d_functional_autograd")


@dataclass(frozen=True)
class Record:
    """One collective on one rank: its kind (the reference's names), the
    bytes of its result and the ranks of its group."""
    kind: str
    nbytes: int
    group: int


@dataclass
class CollectiveStats:
    per_kind_bytes: Dict[str, float] = field(
        default_factory=lambda: defaultdict(float))
    per_kind_count: Dict[str, int] = field(
        default_factory=lambda: defaultdict(int))

    @property
    def total_wire_bytes(self) -> float:
        return sum(self.per_kind_bytes.values())

    def summary(self) -> Dict[str, float]:
        out = {f"{k}_bytes": v for k, v in self.per_kind_bytes.items()}
        out.update({f"{k}_count": v for k, v in self.per_kind_count.items()})
        out["total_wire_bytes"] = self.total_wire_bytes
        return out


def wire_bytes(rec: Record) -> float:
    """Bytes one rank puts on the wire for ``rec`` under a ring
    algorithm, by the reference's factors."""
    out_bytes, g = rec.nbytes, rec.group
    if g < 2:
        return 0.0
    if rec.kind == "all-reduce":
        return out_bytes * 2.0 * (g - 1) / g
    if rec.kind == "all-gather":
        return out_bytes * (g - 1) / g            # output = gathered size
    if rec.kind == "reduce-scatter":
        return out_bytes * (g - 1)                # output = scattered shard
    if rec.kind == "all-to-all":
        return out_bytes * (g - 1) / g
    return out_bytes                              # collective-permute


def analyze(records: Iterable[Record]) -> CollectiveStats:
    """Count and wire bytes per kind of ``records``."""
    st = CollectiveStats()
    for rec in records:
        st.per_kind_bytes[rec.kind] += wire_bytes(rec)
        st.per_kind_count[rec.kind] += 1
    return st


def _nbytes(x) -> int:
    if isinstance(x, torch.Tensor):
        return x.numel() * x.element_size()
    if isinstance(x, (list, tuple)):
        return sum(_nbytes(t) for t in x)
    return 0


def _group_size(args) -> int:
    import torch.distributed as dist
    from torch.distributed.distributed_c10d import _resolve_process_group
    for a in args:
        if isinstance(a, torch.ScriptObject) and \
                "ProcessGroup" in str(a._type()):
            return dist.ProcessGroup.unbox(a).size()
    # a functional collective names its group last
    return _resolve_process_group(args[-1]).size()


class Recorder(TorchDispatchMode):
    """The records of the collectives issued while the mode is open
    (``records``), and their :func:`analyze` (``analyze()``)."""

    def __init__(self):
        super().__init__()
        self.records: List[Record] = []

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        if isinstance(func, torch._ops.HigherOrderOperator):
            return func(*args, **kwargs)
        from torch.distributed.tensor import DTensor
        if any(issubclass(t, DTensor) for t in types):
            # let DTensor turn the op into collectives on local tensors,
            # which then come through here
            return NotImplemented
        out = func(*args, **kwargs)
        name = func._opname
        if func.namespace == _C10D and name in _KINDS:
            # a c10d op's first argument is its output (the tensors sent
            # for a send, reduced in place for an all-reduce)
            self.records.append(Record(_KINDS[name], _nbytes(args[0]),
                                       _group_size(args)))
        elif func.namespace in _FUNCTIONAL and name in _KINDS:
            self.records.append(Record(_KINDS[name], _nbytes(out),
                                       _group_size(args)))
        return out

    def analyze(self) -> CollectiveStats:
        return analyze(self.records)


def record() -> Recorder:
    """``with record() as rec: ...`` then ``rec.analyze()``."""
    return Recorder()
