"""Logical-axis sharding rules (DP / FSDP / TP / EP / SP).

The port's twin of ``repro.distributed.sharding``.  Models name the
dimensions of parameters and activations by *logical* axes; this module
maps them onto the physical axes of a mesh for one
:class:`ParallelismConfig`.  The mapping is installed with a context
manager (:func:`use_rules`), so model code stays mesh-agnostic: without
rules nothing is sharded.

Physical axes: an optional ``pod``, ``data`` (DP/FSDP/SP) and ``model``
(TP/EP).  A mesh is a ``torch.distributed.device_mesh.DeviceMesh`` whose
dimensions carry those names (``repro_torch.launch.mesh``).

Where the reference hands a ``PartitionSpec`` to XLA, which then lays
out every array, the port's layers run on local tensors, one rank's
block of each array:

* :meth:`ShardingRules.spec` gives the reference's spec as a plain
  tuple, one entry per dimension: ``None``, an axis name or a tuple of
  names; :meth:`ShardingRules.placements` maps it onto DTensor
  placements (``Shard(dim)`` on each mesh dimension named, ``Replicate()``
  elsewhere);
* :func:`local_block` cuts a rank's block of a full tensor by a spec
  (the block ``shard_map`` hands each device); a caller feeds each rank
  its block of the batch, ``local_block(x, rules, "batch", "act_seq")``;
* :func:`shard` leaves a plain tensor as it is, as
  ``with_sharding_constraint`` leaves values, and redistributes a
  DTensor on the rules' mesh to the spec's placements;
* :func:`distribute_model` places the parameters whose layers read a
  local shard: of the rules' parameter axes only ``expert`` has such a
  reader (the expert-parallel moe, ``models/moe.py``), which takes its
  ``Shard(0)`` block with ``.to_local()``.  Every other parameter stays a
  plain tensor, replicated on every rank.

Only two reads of the rules change what a model computes: the
expert-parallel branch of ``moe_ffn`` and the sequence-parallel SSD of
``transformer._ssm_block`` (``models/ssm_sp.py``).  Their collectives
differentiate: :func:`all_reduce_over` for a mean over ranks that each
hold their own loss term, and the pair :func:`replicated_to_partial` /
:func:`sum_to_replicated` around work split over ranks that share one.
"""
from __future__ import annotations

import contextlib
import contextvars
from dataclasses import dataclass
from typing import Any, Dict, Optional, Sequence, Tuple

import torch
import torch.distributed as dist
from torch import nn

from repro_torch.configs.base import ModelConfig, ParallelismConfig, ShapeConfig

# Logical axis names used across the model zoo.
PARAM_AXES = ("layers", "embed", "q_heads", "kv_heads", "mlp", "vocab",
              "expert", "ssm_inner", "ssm_state", "conv", "classes")
ACT_AXES = ("batch", "act_seq", "kv_seq", "act_heads", "act_kv", "act_mlp",
            "act_embed", "act_vocab", "act_expert", "act_inner")

#: the parameter axes whose layers read a local shard (``distribute_model``)
LOCAL_PARAM_AXES = ("expert",)


def _names(entry) -> Tuple[str, ...]:
    """The mesh axes one spec entry names, major first."""
    if entry is None:
        return ()
    return tuple(entry) if isinstance(entry, (tuple, list)) else (entry,)


def _entry(entry):
    names = _names(entry)
    return names[0] if len(names) == 1 else (names or None)


@dataclass(frozen=True)
class ShardingRules:
    mapping: Dict[str, Any]
    enabled: bool = True
    mesh: Any = None               # DeviceMesh when EP / SP paths are live
    ep_axis: Optional[str] = None  # physical axis experts shard over
    batch_axes: Any = None         # physical axes the batch shards over

    def spec(self, *axes: Optional[str]) -> Tuple:
        """The reference's ``PartitionSpec`` as a tuple: per dimension
        ``None``, a mesh axis name or a tuple of several (one name in a
        tuple stands alone, as ``PartitionSpec`` gives it)."""
        return tuple(_entry(self.mapping.get(a) if a is not None else None)
                     for a in axes)

    def placements(self, mesh, *axes: Optional[str]) -> Tuple:
        """DTensor placements of ``spec(*axes)`` on ``mesh``: ``Shard(d)``
        on each mesh dimension that dimension ``d`` names, ``Replicate()``
        on the others."""
        return placements_of(mesh, self.spec(*axes))


def placements_of(mesh, spec: Sequence) -> Tuple:
    from torch.distributed.tensor import Replicate, Shard
    dims = {}
    for d, entry in enumerate(spec):
        for name in _names(entry):
            if name in dims:
                raise ValueError(f"mesh axis {name!r} shards two dimensions "
                                 f"of {spec}")
            dims[name] = d
    return tuple(Shard(dims[name]) if name in dims else Replicate()
                 for name in mesh.mesh_dim_names)


_NULL = ShardingRules(mapping={}, enabled=False)
_current: contextvars.ContextVar[ShardingRules] = contextvars.ContextVar(
    "sharding_rules", default=_NULL)


@contextlib.contextmanager
def use_rules(rules: ShardingRules):
    tok = _current.set(rules)
    try:
        yield rules
    finally:
        _current.reset(tok)


def current_rules() -> ShardingRules:
    return _current.get()


def shard(x: torch.Tensor, *axes: Optional[str]) -> torch.Tensor:
    """Constrain a DTensor's layout by logical axes: a DTensor on the
    rules' mesh is redistributed to their placements; a plain tensor, and
    anything without rules, is returned as it is."""
    from torch.distributed.tensor import DTensor
    rules = _current.get()
    if not rules.enabled or rules.mesh is None or not isinstance(x, DTensor) \
            or x.device_mesh != rules.mesh:
        return x
    return x.redistribute(rules.mesh, rules.placements(rules.mesh, *axes))


def group_of(mesh, axes):
    """The process group of this rank's peers over the mesh axes ``axes``
    (one name, or several taken together: their flattened dimension,
    ``DeviceMesh._flatten``, checked on torch 2.11 and 2.13)."""
    names = _names(axes)
    if len(names) == 1:
        return mesh.get_group(names[0])
    from torch._subclasses.fake_tensor import unset_fake_temporarily
    # the flattened mesh's rank bookkeeping is host tensors of its own,
    # real ones also inside a trace's fake tensors (launch/dryrun.py)
    with unset_fake_temporarily():
        return mesh[names]._flatten().get_group()


def axis_rank(mesh, axes) -> Tuple[int, int]:
    """(this rank's index, count) over the mesh axes ``axes`` taken
    together, the first axis major, as a ``PartitionSpec`` entry orders
    them; (0, 1) for no axes."""
    idx, n = 0, 1
    for name in _names(axes):
        size = mesh.size(mesh.mesh_dim_names.index(name))
        idx = idx * size + mesh.get_local_rank(name)
        n *= size
    return idx, n


def local_block(x: torch.Tensor, rules: ShardingRules,
                *axes: Optional[str]) -> torch.Tensor:
    """This rank's block of the full tensor ``x`` under ``rules.spec(*axes)``
    on ``rules.mesh``: each dimension cut into as many contiguous equal
    blocks as its axes have ranks.  Without rules or a mesh, ``x``."""
    if not rules.enabled or rules.mesh is None:
        return x
    return block_of(x, rules.mesh, rules.spec(*axes))


def block_of(x: torch.Tensor, mesh, spec: Sequence) -> torch.Tensor:
    for d, entry in enumerate(spec):
        i, n = axis_rank(mesh, entry)
        if n == 1:
            continue
        if x.shape[d] % n:
            raise ValueError(f"dimension {d} of {tuple(x.shape)} does not "
                             f"split over {n} ranks of {entry}")
        step = x.shape[d] // n
        x = x.narrow(d, i * step, step)
    return x


def distribute_model(model: nn.Module, rules: ShardingRules) -> nn.Module:
    """Place ``model``'s full parameters (each rank holding all of them,
    as ``models/convert.py`` loads them) by ``rules`` on ``rules.mesh``.
    A parameter whose leading logical axis is one of ``LOCAL_PARAM_AXES``
    and mapped to a mesh axis (the experts' ``we_*``) becomes a DTensor
    ``Shard(0)`` on that axis holding only this rank's block, cut locally
    with no communication.  The rest stay plain and whole: the router,
    whose expert axis is its last, is read whole by every rank, as the
    reference's ``shard_map`` takes it (``P(None, None)``).  Returns
    ``model``."""
    from torch.distributed.tensor import DTensor
    from repro_torch.models.params import ParamDef, ParamTree
    mesh = rules.mesh
    if not rules.enabled or mesh is None:
        return model
    for tree in model.modules():
        if not isinstance(tree, ParamTree):
            continue
        for name, d in tree.defs.items():
            if not (isinstance(d, ParamDef) and d.axes
                    and d.axes[0] in LOCAL_PARAM_AXES
                    and rules.mapping.get(d.axes[0])):
                continue
            p = tree[name]
            if isinstance(p.data, DTensor):
                continue
            spec = (rules.mapping[d.axes[0]],) + (None,) * (len(d.axes) - 1)
            local = block_of(p.detach(), mesh, spec)
            if local.numel() < p.numel():
                local = local.clone()     # lets the whole tensor go
            setattr(tree, name, nn.Parameter(
                DTensor.from_local(local, mesh, placements_of(mesh, spec),
                                   run_check=False),
                requires_grad=p.requires_grad))
    return model


def make_rules(model: ModelConfig, shape: ShapeConfig,
               parallel: ParallelismConfig, *,
               multi_pod: bool = False, tp_size: int = 16,
               dp_size: int = 16, mesh: Any = None) -> ShardingRules:
    """Build the logical->physical mapping for one (arch x shape) cell."""
    batch_axes: Any = ("pod", "data") if multi_pod else ("data",)
    dp_total = dp_size * (2 if multi_pod else 1)
    # pure-DP over the model axis only when the batch actually divides the
    # widened grid; otherwise fall back to TP (an idle model axis would
    # replicate 16x the per-chip work)
    pure_dp = (parallel.dp_over_model and not parallel.tp and not parallel.ep
               and shape.global_batch % (dp_total * tp_size) == 0)
    tp = parallel.tp or (parallel.dp_over_model and not pure_dp)
    if pure_dp:
        batch_axes = batch_axes + ("model",)
        dp_total *= tp_size

    m: Dict[str, Any] = {}
    # ----- params -----
    m["layers"] = None
    m["embed"] = "data" if parallel.fsdp else None
    m["q_heads"] = "model" if tp else None
    kv_ok = model.n_kv_heads and (model.n_kv_heads % tp_size == 0)
    m["kv_heads"] = "model" if (tp and kv_ok) else None
    m["mlp"] = "model" if tp else None
    m["vocab"] = "model" if tp else None
    m["expert"] = "model" if parallel.ep else None
    m["ssm_inner"] = "model" if tp else None
    m["ssm_state"] = None
    m["conv"] = None
    m["classes"] = None
    # ----- activations -----
    batch_shardable = shape.global_batch % dp_total == 0 and \
        shape.global_batch >= dp_total
    m["batch"] = batch_axes if batch_shardable else None
    # SP shards activations' sequence dim only when the batch can't shard
    # (long_500k, batch=1); prefill batches (>=32) shard over data directly.
    m["act_seq"] = "data" if (parallel.sp and not batch_shardable
                              and shape.kind != "decode") else None
    if parallel.sp_ssd and shape.kind == "prefill" and not tp:
        m["act_seq"] = "model"      # sequence-parallel SSD (ssm_sp.py)
    # decode KV layout: batch over data when possible; the sequence dim of
    # the cache goes to 'model' unless kv heads already shard.
    if shape.kind == "decode":
        m["kv_seq"] = "model" if not kv_ok else None
        if shape.name == "long_500k":
            m["kv_seq"] = "data" if not batch_shardable else "model"
    else:
        m["kv_seq"] = None
    m["act_heads"] = "model" if tp else None
    m["act_kv"] = "model" if (tp and kv_ok) else None
    m["act_mlp"] = "model" if tp else None
    m["act_embed"] = None
    m["act_vocab"] = "model" if tp else None
    m["act_expert"] = "model" if parallel.ep else None
    m["act_inner"] = "model" if tp else None
    m["ssm_gather_out"] = bool(parallel.ssm_gather_out)
    return ShardingRules(
        mapping=m, mesh=mesh,
        ep_axis="model" if parallel.ep else None,
        batch_axes=m["batch"])


def data_axis_names(multi_pod: bool) -> Tuple[str, ...]:
    return ("pod", "data") if multi_pod else ("data",)


def all_reduce_over(x: torch.Tensor, mesh, axes) -> Tuple[torch.Tensor, int]:
    """The sum of ``x`` over this rank's peers on the mesh axes ``axes``
    (one name, or several: one reduction per axis, which covers their
    product), and the peers' count.  Differentiable: the backward sums
    the gradient over the same peers, right where each peer's result
    enters its own loss term (the aux loss averaged over data ranks)."""
    from torch.distributed.nn.functional import all_reduce
    n = 1
    for name in _names(axes):
        x = all_reduce(x, group=mesh.get_group(name))
        n *= mesh.size(mesh.mesh_dim_names.index(name))
    return x, n


class _SumToReplicated(torch.autograd.Function):
    """Forward: the sum over ``group``; backward: the gradient as it is.
    For partial results whose sum every rank of the group then uses in
    one shared loss term: each rank holds that term's whole gradient."""

    @staticmethod
    def forward(ctx, x, group):
        x = x.clone(memory_format=torch.contiguous_format)
        dist.all_reduce(x, group=group)
        return x

    @staticmethod
    def backward(ctx, g):
        return g, None


class _ReplicatedToPartial(torch.autograd.Function):
    """Forward: ``x`` as it is; backward: the gradient summed over
    ``group``.  For a replicated input each rank of the group feeds into
    its own part of a later :func:`sum_to_replicated`."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x

    @staticmethod
    def backward(ctx, g):
        g = g.clone(memory_format=torch.contiguous_format)
        dist.all_reduce(g, group=ctx.group)
        return g, None


def sum_to_replicated(x: torch.Tensor, group) -> torch.Tensor:
    return _SumToReplicated.apply(x, group)


def replicated_to_partial(x: torch.Tensor, group) -> torch.Tensor:
    return _ReplicatedToPartial.apply(x, group)
