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
* :func:`distribute_model` places the parameters by their specs: every
  parameter of a family in :data:`LAYOUT_FAMILIES` (dense, moe, ssm and
  hybrid) whose spec names a mesh axis becomes a DTensor with
  :func:`placements_of` its spec, holding only this rank's block: the
  reference's FSDP (``embed`` over ``data``), tensor parallelism
  (``q_heads``, ``kv_heads`` where the kv heads divide, ``mlp``,
  ``vocab``, ``ssm_inner`` over ``model``) and expert parallelism
  (``expert`` over ``model``).  With
  ``experts_only``, and in the other families, only the experts are
  placed (``Shard(0)`` on ``model``): the expert-parallel program of the
  data-parallel step (``train/dp_shard.py``), whose other parameters
  stay plain tensors, replicated on every rank.

The layers read a placed parameter through :func:`take`: its local
block, with its shards over every mesh axis but ``model`` gathered (the
FSDP gather, :class:`_GatherShards`: an all-gather in the forward, a
reduce-scatter of the gradient in the backward); :func:`take_whole`
gathers it over ``model`` too (the moe router, which the reference's
``shard_map`` reads whole); :func:`model_split` says which block of the
``model`` axis it is.  Their collectives differentiate:
:func:`all_reduce_over` for a mean over ranks that each hold their own
loss term; the pair :func:`replicated_to_partial` /
:func:`sum_to_replicated` around work split over ranks that share one
(tensor parallelism's input and output, the expert-parallel dispatch);
:func:`sum_over` for a statistic each rank adds its part to and then
uses on its own columns (the ssm block's gated norm over ``ssm_inner``);
:func:`gather_replicated` for columns gathered whole so that every rank
computes alike (the ssm block's ``ssm_gather_out``); :func:`regroup`
for columns of heads moved between ranks; and the vocab-parallel
reductions of ``transformer.cross_entropy``
(:func:`vocab_parallel_nll`).  Decode's collectives (the combine of a
cache whose sequence is split, :func:`seq_split`) are in
``models/layers.py``.  Every collective goes through
``torch.distributed`` inside :func:`collective`, so
``roofline.hlo_collectives.record()`` sees it and the dry-run counts
none of the ops its backend issues.  Whether a model runs the sharded
program at all is :func:`layout_rules`: rules with a mesh that run the
layout for the model's family (:func:`runs_layout`), the model not
placed ``experts_only``.
:func:`relayout` moves a block from one spec to another (a prefill's
cache to the decode layout's).
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

#: the families whose layers run the reference's whole layout: every
#: parameter placed by its spec (:func:`distribute_model`), the layers
#: tensor-parallel and FSDP-gathered, the loss over the global batch
#: (:func:`layout_rules`)
LAYOUT_FAMILIES = ("dense", "moe", "ssm", "hybrid")


def runs_layout(family: str, mapping: Dict[str, Any]) -> bool:
    """Whether rules of ``mapping`` run the reference's sharded program
    for a model of ``family``: every rule set for the dense and moe
    families; for the ssm and hybrid families those that place the SSD
    heads (``ssm_inner`` on a mesh axis: tensor parallelism).  Their
    other cells (pure data-parallel training, the ssm family's
    sequence-parallel prefill) hold every parameter whole in the
    reference too, and run the replicated program."""
    if family not in LAYOUT_FAMILIES:
        return False
    return family in ("dense", "moe") or bool(mapping.get("ssm_inner"))


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


_IN_COLLECTIVE: contextvars.ContextVar[bool] = contextvars.ContextVar(
    "in_collective", default=False)


@contextlib.contextmanager
def collective():
    """Marks a ``torch.distributed`` call of the layers' collectives: the
    ops its backend issues while it completes (gloo copies into an
    all-gather's output at ``wait``) are the collective's own, and the
    dry-run's counts leave them out (:func:`in_collective`)."""
    tok = _IN_COLLECTIVE.set(True)
    try:
        yield
    finally:
        _IN_COLLECTIVE.reset(tok)


def in_collective() -> bool:
    return _IN_COLLECTIVE.get()


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


def _placed_spec(d, mapping, whole: bool):
    """The spec a parameter with def ``d`` is placed by (None: it stays
    plain): its whole spec, or with ``whole`` false its leading
    ``expert`` axis alone (the experts' ``we_*``; the router, whose
    expert axis is its last, stays whole)."""
    if whole:
        spec = tuple(_entry(mapping.get(a)) if a is not None else None
                     for a in d.axes)
    elif d.axes and d.axes[0] == "expert":
        spec = (_entry(mapping.get(d.axes[0])),) + (None,) * (
            len(d.axes) - 1)
    else:
        return None
    return spec if any(e is not None for e in spec) else None


def distribute_model(model: nn.Module, rules: ShardingRules, *,
                     experts_only: bool = False) -> nn.Module:
    """Place ``model``'s full parameters (each rank holding all of them,
    as ``models/convert.py`` loads them) by ``rules`` on ``rules.mesh``.
    A parameter whose spec (:func:`_placed_spec`) names a mesh axis
    becomes a DTensor with :func:`placements_of` that spec, holding only
    this rank's block, cut locally with no communication: in the
    families of :data:`LAYOUT_FAMILIES` every such parameter (the
    reference's FSDP, tensor and expert parallelism, ``partition_specs``
    of its defs); with
    ``experts_only``, and in the other families, the experts' ``we_*``
    (the model is marked so, and :func:`layout_rules` then leaves it
    out).  The rest stay plain and whole.  Returns ``model``."""
    from torch.distributed.tensor import DTensor
    from repro_torch.models.params import ParamDef, ParamTree
    mesh = rules.mesh
    if not rules.enabled or mesh is None:
        return model
    cfg = getattr(model, "cfg", None)
    whole = (cfg is not None and cfg.family in LAYOUT_FAMILIES
             and not experts_only)
    model.experts_only = experts_only
    for tree in model.modules():
        if not isinstance(tree, ParamTree):
            continue
        for name, d in tree.defs.items():
            if not isinstance(d, ParamDef):
                continue
            spec = _placed_spec(d, rules.mapping, whole)
            p = tree[name]
            if spec is None or isinstance(p.data, DTensor):
                continue
            local = block_of(p.detach(), mesh, spec)
            if local.numel() < p.numel():
                local = local.clone()     # lets the whole tensor go
            setattr(tree, name, nn.Parameter(
                DTensor.from_local(local, mesh, placements_of(mesh, spec),
                                   run_check=False),
                requires_grad=p.requires_grad))
    return model


def layout_rules(model: nn.Module) -> Optional["ShardingRules"]:
    """The rules in force when ``model`` runs the reference's sharded
    program (rules with a mesh that run it for the model's family,
    :func:`runs_layout`; the model not placed ``experts_only``), else
    None: its loss is then the mean over the global batch, each rank's
    loss its term of it, and the training step sums the gradients over
    the batch axes."""
    rules = _current.get()
    if not rules.enabled or rules.mesh is None \
            or not runs_layout(model.cfg.family, rules.mapping) \
            or getattr(model, "experts_only", False):
        return None
    return rules


def seq_split(rules: ShardingRules) -> Optional["Split"]:
    """The split of the decode cache's sequence (``kv_seq``) over the
    rules' mesh, None where the rules keep it whole."""
    entry = rules.mapping.get("kv_seq")
    if not entry or rules.mesh is None:
        return None
    return Split(group_of(rules.mesh, entry), *axis_rank(rules.mesh, entry),
                 axes=_names(entry))


# ---------------------------------------------------------------------------
# Local blocks of placed parameters
# ---------------------------------------------------------------------------

@dataclass(frozen=True)
class Split:
    """A block of a mesh axis (``model``, or the ``axes`` taken
    together): the axis's process group, this rank's index on it and
    the axis's size."""
    group: Any
    rank: int
    size: int
    axes: Tuple[str, ...] = ("model",)


def model_split(p) -> Optional[Split]:
    """The ``model`` axis a placed parameter (a DTensor) is sharded over,
    None for a plain tensor or one replicated over ``model``."""
    from torch.distributed.tensor import DTensor, Shard
    if not isinstance(p, DTensor):
        return None
    mesh = p.device_mesh
    for i, pl in enumerate(p.placements):
        if isinstance(pl, Shard) and mesh.mesh_dim_names[i] == "model":
            return Split(mesh.get_group(i), mesh.get_local_rank(i),
                         mesh.size(i))
    return None


def take(p) -> torch.Tensor:
    """A parameter as the layers compute with it: a plain tensor as it
    is; a DTensor's local block (``to_local``: its gradient comes back as
    a DTensor of the same placements) with its shards over every mesh
    axis but ``model`` gathered (:class:`_GatherShards`).  Called inside
    the block that ``transformer._run`` checkpoints, so remat gathers
    again in the recompute, as XLA does."""
    from torch.distributed.tensor import DTensor, Shard
    if not isinstance(p, DTensor):
        return p
    mesh = p.device_mesh
    t = p.to_local()
    for i, pl in enumerate(p.placements):
        if isinstance(pl, Shard) and mesh.mesh_dim_names[i] != "model":
            t = _GatherShards.apply(t, pl.dim, mesh.get_group(i))
    return t


def take_whole(p) -> torch.Tensor:
    """A parameter whole on every rank: a plain tensor as it is; a
    DTensor's blocks gathered over every mesh axis its placements shard
    (:class:`_GatherWhole`).  For a weight that every rank of ``model``
    applies alike to the tokens they share (the moe router), so that
    each holds its whole gradient."""
    from torch.distributed.tensor import DTensor
    if not isinstance(p, DTensor):
        return p
    return _GatherWhole.apply(p.to_local(), p.device_mesh,
                              tuple(p.placements))


def gather_dim(x: torch.Tensor, dim: int, group) -> torch.Tensor:
    """The all-gather over ``group`` of each rank's block of ``x`` along
    ``dim``, the blocks in the group's rank order (not differentiable)."""
    n = dist.get_world_size(group)
    xm = x.movedim(dim, 0).contiguous()
    out = xm.new_empty((n * xm.shape[0], *xm.shape[1:]))
    with collective():
        dist.all_gather_into_tensor(out, xm, group=group)
    return out.movedim(0, dim).contiguous()


def reduce_scatter_dim(g: torch.Tensor, dim: int, group) -> torch.Tensor:
    """The reduce-scatter (sum) over ``group`` of ``g`` along ``dim``:
    each rank keeps its block of the sum, in the group's rank order (not
    differentiable)."""
    n = dist.get_world_size(group)
    gm = g.movedim(dim, 0).contiguous()
    out = gm.new_empty((gm.shape[0] // n, *gm.shape[1:]))
    with collective():
        dist.reduce_scatter_tensor(out, gm, group=group)
    return out.movedim(0, dim).contiguous()


class _GatherShards(torch.autograd.Function):
    """The FSDP gather: forward, the all-gather over ``group`` of each
    rank's block along ``dim``; backward, the reduce-scatter (sum) of the
    gradient, each rank keeping its block's: the sum of every rank's
    term of the loss."""

    @staticmethod
    def forward(ctx, x, dim, group):
        ctx.dim, ctx.group = dim, group
        return gather_dim(x, dim, group)

    @staticmethod
    def backward(ctx, g):
        return reduce_scatter_dim(g, ctx.dim, ctx.group), None, None


class _GatherWhole(torch.autograd.Function):
    """:func:`take_whole`: forward, the all-gather of a DTensor's local
    block ``x`` over each dimension of ``mesh`` that ``placements``
    shard; backward, over ``model`` this rank's block of the gradient (the
    ranks of ``model`` share one batch block and compute alike, so each
    holds the whole gradient already), over the other axes the
    reduce-scatter (sum) of the FSDP gather."""

    @staticmethod
    def forward(ctx, x, mesh, placements):
        from torch.distributed.tensor import Shard
        ctx.dims = [(mesh.mesh_dim_names[i], pl.dim, mesh.get_group(i),
                     mesh.get_local_rank(i))
                    for i, pl in enumerate(placements)
                    if isinstance(pl, Shard)][::-1]
        for _, dim, group, _ in ctx.dims:
            x = gather_dim(x, dim, group)
        return x

    @staticmethod
    def backward(ctx, g):
        for name, dim, group, rank in reversed(ctx.dims):
            if name == "model":
                n = g.shape[dim] // dist.get_world_size(group)
                g = g.narrow(dim, rank * n, n).contiguous()
            else:
                g = reduce_scatter_dim(g, dim, group)
        return g, None, None


def unblock(x: torch.Tensor, mesh, spec: Sequence) -> torch.Tensor:
    """The whole tensor of this rank's block ``x`` under ``spec`` (the
    inverse of :func:`block_of`), gathered over each axis the spec
    names, the minor axis of an entry first (not differentiable)."""
    for d, entry in enumerate(spec):
        for name in reversed(_names(entry)):
            x = gather_dim(x, d, mesh.get_group(name))
    return x


def relayout(x: torch.Tensor, mesh, src: Sequence,
             dst: Sequence) -> torch.Tensor:
    """This rank's block under the spec ``dst`` of the tensor whose block
    under ``src`` is ``x`` (gathered whole, then cut): the step that
    carries a prefill's cache (its kv heads on ``model`` only where they
    divide the axis) to the decode layout's (its sequence on ``model``
    where they do not).  Not part of the reference's program, whose
    decode takes its cache in its own spec."""
    return block_of(unblock(x, mesh, src), mesh, dst).clone()


def head_range(n_heads: int, split: Split) -> Tuple[int, int]:
    """This rank's whole heads ``[start, end)`` of ``n_heads`` over the
    ``model`` axis: contiguous blocks, the first ``n_heads % size`` ranks
    one head more (the blocks of the spec's columns when the heads
    divide)."""
    base, extra = divmod(n_heads, split.size)
    start = split.rank * base + min(split.rank, extra)
    return start, start + base + (split.rank < extra)


def _overlaps(lo: int, hi: int, ranges) -> list:
    return [max(0, min(hi, b) - max(lo, a)) for a, b in ranges]


def regroup(x: torch.Tensor, n_heads: int, hd: int, split: Split,
            to_heads: bool = True) -> torch.Tensor:
    """Move the last dimension of ``x`` between two blocks of the
    ``n_heads * hd`` columns over the ``model`` axis, by one all-to-all:
    from the spec's equal column blocks (the ``q_heads`` shard, which may
    cut a head) to this rank's whole heads (:func:`head_range`), or back
    with ``to_heads=False``.  Differentiable: the backward is the
    all-to-all the other way."""
    width = n_heads * hd // split.size
    cols = [(r * width, (r + 1) * width) for r in range(split.size)]
    heads = [tuple(c * hd for c in head_range(n_heads, Split(
        split.group, r, split.size))) for r in range(split.size)]
    src, dst = (cols, heads) if to_heads else (heads, cols)
    send = _overlaps(*src[split.rank], dst)
    recv = _overlaps(*dst[split.rank], src)
    return _AllToAll.apply(x, send, recv, split.group)


class _AllToAll(torch.autograd.Function):
    """An all-to-all of the last dimension's columns: ``send[j]`` of this
    rank's columns (in order) go to rank ``j``, ``recv[i]`` come from
    rank ``i`` (in rank order); the backward sends them back."""

    @staticmethod
    def forward(ctx, x, send, recv, group):
        ctx.send, ctx.recv, ctx.group = send, recv, group
        return _all_to_all_cols(x, send, recv, group)

    @staticmethod
    def backward(ctx, g):
        return (_all_to_all_cols(g, ctx.recv, ctx.send, ctx.group), None,
                None, None)


def _all_to_all_cols(x, send, recv, group):
    lead = x.shape[:-1]
    rows = x.reshape(-1, x.shape[-1]).t().contiguous()
    out = rows.new_empty((sum(recv), rows.shape[1]))
    with collective():
        dist.all_to_all_single(out, rows, output_split_sizes=list(recv),
                               input_split_sizes=list(send), group=group)
    return out.t().reshape(*lead, sum(recv))


class _VocabParallelNll(torch.autograd.Function):
    """The negative log-likelihood of ``labels`` under logits split over
    the vocab: this rank's block ``lf`` (..., V_l) float32, its columns
    from ``offset`` of the whole vocab.  The max, the sum of
    exponentials and the target's logit go through the model group, in
    ``torch.logsumexp``'s steps (max, ``exp(x - max)``, sum, log, + max),
    and the backward is autograd's of the local path (``exp(x - lse)``
    times the gradient, less it at the target), so at one rank of
    ``model`` both paths give the same bits."""

    @staticmethod
    def forward(ctx, lf, labels, offset, v_pad, group):
        # the reference's mask of the padded vocab is the caller's (global
        # indices); the max's guard against infinities is logsumexp's
        m = torch.amax(lf, dim=-1, keepdim=True)
        with collective():
            dist.all_reduce(m, op=dist.ReduceOp.MAX, group=group)
        m_sq = m.squeeze(-1).masked_fill(m.squeeze(-1).abs() == float("inf"),
                                         0.0)
        s = torch.sum(torch.exp(lf - m), dim=-1)
        with collective():
            dist.all_reduce(s, group=group)
        lse = torch.log(s) + m_sq
        idx = labels.clamp(0, v_pad - 1).long() - offset
        inside = (idx >= 0) & (idx < lf.shape[-1])
        idx = idx.clamp(0, lf.shape[-1] - 1)
        tgt = torch.gather(lf, -1, idx[..., None])[..., 0]
        tgt = tgt.masked_fill(~inside, 0.0)
        with collective():
            dist.all_reduce(tgt, group=group)
        ctx.save_for_backward(lf, lse, idx, inside)
        return lse - tgt

    @staticmethod
    def backward(ctx, g):
        lf, lse, idx, inside = ctx.saved_tensors
        d = g[..., None] * torch.exp(lf - lse[..., None])
        at = torch.zeros_like(d).scatter_add_(
            -1, idx[..., None], (-g).masked_fill(~inside, 0.0)[..., None])
        return d + at, None, None, None, None


def vocab_parallel_nll(lf: torch.Tensor, labels: torch.Tensor, offset: int,
                       v_pad: int, split: Split) -> torch.Tensor:
    return _VocabParallelNll.apply(lf, labels, offset, v_pad, split.group)


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
    n = 1
    for name in _names(axes):
        x = sum_over(x, mesh.get_group(name))
        n *= mesh.size(mesh.mesh_dim_names.index(name))
    return x, n


class _SumToReplicated(torch.autograd.Function):
    """Forward: the sum over ``group``; backward: the gradient as it is.
    For partial results whose sum every rank of the group then uses in
    one shared loss term: each rank holds that term's whole gradient."""

    @staticmethod
    def forward(ctx, x, group):
        x = x.clone(memory_format=torch.contiguous_format)
        with collective():
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
        with collective():
            dist.all_reduce(g, group=ctx.group)
        return g, None


class _SumOver(torch.autograd.Function):
    """Forward: the sum over ``group``; backward: the gradient summed
    over ``group``.  For a value each rank adds its part to and then
    uses in a loss term: the moe's aux loss, each data rank's own term
    (:func:`all_reduce_over`); the ssm block's gated-norm statistic,
    which each rank of ``model`` applies to its own columns of one
    shared term.  The sum's gradient is the sum of every use of it."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        x = x.clone(memory_format=torch.contiguous_format)
        with collective():
            dist.all_reduce(x, group=group)
        return x

    @staticmethod
    def backward(ctx, g):
        g = g.clone(memory_format=torch.contiguous_format)
        with collective():
            dist.all_reduce(g, group=ctx.group)
        return g, None


class _GatherReplicated(torch.autograd.Function):
    """Forward: each rank's block of ``x`` along ``dim`` all-gathered
    over the ``model`` split; backward: this rank's block of the
    gradient.  For columns gathered whole so that every rank of the
    group computes the same shared loss term from them: each rank's
    block enters that term once."""

    @staticmethod
    def forward(ctx, x, dim, split):
        ctx.dim, ctx.split, ctx.n = dim, split, x.shape[dim]
        return gather_dim(x, dim, split.group)

    @staticmethod
    def backward(ctx, g):
        return (g.narrow(ctx.dim, ctx.split.rank * ctx.n, ctx.n)
                .contiguous(), None, None)


def sum_to_replicated(x: torch.Tensor, group) -> torch.Tensor:
    return _SumToReplicated.apply(x, group)


def replicated_to_partial(x: torch.Tensor, group) -> torch.Tensor:
    return _ReplicatedToPartial.apply(x, group)


def sum_over(x: torch.Tensor, group) -> torch.Tensor:
    return _SumOver.apply(x, group)


def gather_replicated(x: torch.Tensor, dim: int, split: Split) -> torch.Tensor:
    return _GatherReplicated.apply(x, dim, split)
