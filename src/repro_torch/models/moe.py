"""Mixture-of-Experts FFN: the port's twin of ``repro.models.moe``, its
local path.

* **Routing** — float32 softmax over the router's logits, top-k with
  capacity-based token dropping and the Switch-style auxiliary loss.
  Among equal probabilities the lower expert id comes first, as
  ``jax.lax.top_k`` orders them (``torch.topk`` promises no order; a
  stable descending sort does).
* **Dispatch** — sort-based, over all experts: assignments sorted by
  expert id (stable), each given its position within its expert, and
  those within the capacity gathered into a dense ``(E, C, D)`` buffer
  (an overflow row takes the dropped ones).  Each kept slot holds one
  assignment, so the buffer is a gather, not a scatter-add.  The
  gathers are ``index_select``s, whose backward is an ``index_add_``:
  advanced indexing's backward processes the many reads of the zero and
  overflow rows one after another (70% of a forward and backward's device time
  at deepseek-moe-16b's widths on an H100).
* **Expert products** — three batched products over the experts
  (``torch.bmm``), plain matrix products as in the reference, which
  computes them outside any Pallas kernel.
* **Combine** — each token's kept rows, weighted by their gates, are
  added in the reference's order: ascending expert id, one after another
  in the activations' type.  The reference's scatter-add adds them in
  that order; an ``index_add_`` on the card would add them by atomics,
  in an order that changes from run to run.
* **Shared experts** — one dense gated MLP of width
  ``n_shared * d_ff_expert`` (``layers.gated_mlp``).

* **Expert parallelism** — the twin of the reference's ``shard_map``
  branch, taken when the sharding rules (``distributed/sharding.py``)
  are enabled and name a mesh and an ``ep_axis``.  Each rank is handed
  its block of the batch (``local_block(x, rules, "batch", ...)``),
  replicated over the expert axis, and routes it over all experts; it
  dispatches to its ``n_local = E / ep`` experts from ``r * n_local``
  (assignments to other ranks' experts go to the overflow row), in the
  same sorted order, and the partial outputs are summed by an
  ``all_reduce`` over the expert axis's group.  The aux loss is averaged
  over the batch axes' group.  A rank's expert weights are its block of
  a placed ``we_*`` (``sharding.distribute_model``), read through
  ``sharding.take``; a whole ``(E, ...)`` tensor is cut to the rank's
  experts.  Gradients: the ranks of the expert axis share one loss term
  (the same batch block), so the sum of the partial outputs passes the
  gradient back as it is and the tokens and gates entering the dispatch
  sum theirs over the group (``sharding.sum_to_replicated`` /
  ``replicated_to_partial``): each rank holds the whole gradient of its
  block's loss for the replicated weights, and its experts' part for its
  own.  The aux loss's mean over the data ranks sums its gradient back
  over them, so the data ranks' gradients averaged (as the data-parallel
  step does) are those of the mean loss, as ``jax.grad`` of the
  reference's ``shard_map`` gives.

* **The reference's layout** (a model that ``distribute_model`` placed
  whole): tensor parallelism beside expert parallelism on ``model``, as
  XLA lays out the reference's arrays by ``make_rules``.  The shared
  experts are column- then row-parallel over ``model``, like the dense
  MLP, their sum over ``model`` an all-reduce of its own beside the
  experts' (the reference's order of the two sums); the router is read
  whole (``sharding.take_whole``: gathered over ``model`` and, under
  FSDP, over ``data``, the reference's ``P(None, None)``), its bytes
  stored by its spec; a rank's experts are its ``model`` block of the
  ``we_*``, their ``embed`` shards gathered over ``data`` under FSDP, as
  the ``shard_map``'s ``P(ep_axis, None, None)`` gathers them.  The
  attention around the layer is the dense family's tensor-parallel one
  (``models/layers.py``).

Without rules the dispatch runs locally over all experts, the
reference's path "without a mesh".
"""
from __future__ import annotations

from typing import Dict, Tuple

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ModelConfig
from repro_torch.distributed.sharding import (all_reduce_over, current_rules,
                                              replicated_to_partial,
                                              sum_to_replicated, take,
                                              take_whole)
from repro_torch.models.layers import gated_mlp
from repro_torch.models.params import ParamDef

F32 = torch.float32


def moe_defs(cfg: ModelConfig) -> Dict:
    d = cfg.d_model
    e = cfg.moe
    defs = {
        "router": ParamDef((d, e.n_experts), ("embed", "expert"), scale=0.1),
        "we_gate": ParamDef((e.n_experts, d, e.d_ff_expert),
                            ("expert", "embed", None)),
        "we_up": ParamDef((e.n_experts, d, e.d_ff_expert),
                          ("expert", "embed", None)),
        "we_out": ParamDef((e.n_experts, e.d_ff_expert, d),
                           ("expert", None, "embed"),
                           scale=1.0 / max(1, (2 * cfg.n_layers)) ** 0.5),
    }
    if e.n_shared:
        f = e.n_shared * e.d_ff_expert
        defs["ws_gate"] = ParamDef((d, f), ("embed", "mlp"))
        defs["ws_up"] = ParamDef((d, f), ("embed", "mlp"))
        defs["ws_out"] = ParamDef((f, d), ("mlp", "embed"),
                                  scale=1.0 / max(1, (2 * cfg.n_layers)) ** 0.5)
    return defs


# ---------------------------------------------------------------------------
# Routing
# ---------------------------------------------------------------------------

def _route(x2d: torch.Tensor, router_w: torch.Tensor, k: int):
    """x2d: (T, D) -> (top_e (T, k) int64, top_g (T, k) in x's type,
    aux float32 scalar)."""
    logits = torch.matmul(x2d, router_w).to(F32)
    probs = torch.softmax(logits, dim=-1)
    top_e = torch.sort(probs, dim=-1, descending=True,
                       stable=True).indices[:, :k]
    # load-balancing aux loss (Switch-style): E * sum_e f_e * p_e
    T, E = probs.shape
    me = torch.mean(probs, dim=0)
    counts = torch.bincount(top_e.reshape(-1), minlength=E).to(F32)
    ce = counts / T / k
    aux = E * torch.sum(me * ce)
    return top_e, gates(probs, top_e, x2d.dtype), aux


def gates(probs: torch.Tensor, top_e: torch.Tensor,
          dtype: torch.dtype) -> torch.Tensor:
    """The chosen experts' probabilities renormalised to sum to 1, in
    ``dtype``."""
    top_g = torch.gather(probs, 1, top_e)
    top_g = top_g / torch.clamp(torch.sum(top_g, dim=-1, keepdim=True),
                                min=1e-9)
    return top_g.to(dtype)


def _capacity(T: int, k: int, E: int, factor: float) -> int:
    cap = int(T * k * factor / E) + 1
    return max(cap, 4)


# ---------------------------------------------------------------------------
# Local sorted dispatch + expert products + combine
# ---------------------------------------------------------------------------

def dispatch_plan(top_e: torch.Tensor, n_experts: int, capacity: int,
                  e_start: int = 0):
    """Where each assignment goes, for the ``n_experts`` experts from
    ``e_start``.  top_e: (T, k) expert ids.

    Returns ``(slot, src)``: ``slot`` (T, k) is each assignment's row of
    the flattened ``(n_experts * C)`` buffer, ``n_experts * C`` (the
    overflow row) where its expert is full or not among these; ``src``
    (n_experts * C,) is the token each buffer row holds, ``T`` (a zero
    row) where a row is empty.  Assignments fill their expert in the
    reference's sorted order: stable by expert id, so by token, then by
    rank among the token's k choices; the other experts' sort last.
    """
    T, k = top_e.shape
    dev = top_e.device
    flat_e = top_e.reshape(-1)
    local = (flat_e >= e_start) & (flat_e < e_start + n_experts)
    key = torch.where(local, flat_e - e_start,
                      torch.full_like(flat_e, n_experts))
    order = torch.sort(key, stable=True).indices
    s_e = key[order]
    first_idx = torch.searchsorted(
        s_e, torch.arange(n_experts + 1, device=dev, dtype=s_e.dtype))
    pos_in_e = torch.arange(T * k, device=dev) - first_idx[s_e]
    keep = (s_e < n_experts) & (pos_in_e < capacity)
    s_slot = torch.where(keep, s_e * capacity + pos_in_e,
                         torch.full_like(s_e, n_experts * capacity))
    slot = torch.empty_like(s_slot)
    slot[order] = s_slot
    src = torch.full((n_experts * capacity + 1,), T, dtype=torch.int64,
                     device=dev)
    src[s_slot] = torch.div(order, k, rounding_mode="floor")
    return slot.reshape(T, k), src[:-1]


def _dispatch_local(x2d: torch.Tensor, top_e: torch.Tensor,
                    top_g: torch.Tensor, capacity: int, we_gate, we_up,
                    we_out, e_start: int = 0) -> torch.Tensor:
    """Sorted capacity dispatch over the experts of ``we_*`` (``E`` of
    them, from ``e_start``).  x2d: (T, D); top_e / top_g: (T, k) expert
    ids / gate weights.  Returns (T, D): these experts' contributions."""
    T, D = x2d.shape
    E = we_gate.shape[0]
    slot, src = dispatch_plan(top_e, E, capacity, e_start)
    zero = x2d.new_zeros((1, D))
    buf = torch.index_select(torch.cat([x2d, zero]), 0, src).reshape(
        E, capacity, D)

    g = torch.bmm(buf, we_gate)
    u = torch.bmm(buf, we_up)
    h = F.silu(g.to(F32)).to(x2d.dtype) * u
    y = torch.bmm(h, we_out)                              # (E, C, D)

    # combine: each token's rows in ascending expert id, weighted by
    # their gates, added one after another (dropped rows read the zero
    # overflow row)
    y_pad = torch.cat([y.reshape(E * capacity, D), zero])
    by_expert = torch.argsort(top_e, dim=1)
    slot = torch.gather(slot, 1, by_expert)
    gate = torch.gather(top_g, 1, by_expert)
    out = torch.zeros_like(x2d)
    for j in range(slot.shape[1]):
        out = out + torch.index_select(y_pad, 0, slot[:, j]) \
            * gate[:, j, None]
    return out


# ---------------------------------------------------------------------------
# Public layer
# ---------------------------------------------------------------------------

def local_experts(w: torch.Tensor, rank: int, n_local: int,
                  n_experts: int) -> torch.Tensor:
    """Expert rank ``rank``'s ``n_local`` experts of ``w``: a DTensor's
    block over ``model`` with its FSDP shards gathered
    (``sharding.take``), or that slice of a whole ``(n_experts, ...)``
    tensor."""
    from torch.distributed.tensor import DTensor
    if isinstance(w, DTensor):
        local = take(w)
        if local.shape[0] != n_local:
            raise ValueError(f"expert block of {local.shape[0]} experts, "
                             f"expected {n_local}")
        return local
    if w.shape[0] != n_experts:
        raise ValueError(f"expert weights of {w.shape[0]} experts, expected "
                         f"{n_experts}")
    return w.narrow(0, rank * n_local, n_local)


def moe_ffn(p, x: torch.Tensor,
            cfg: ModelConfig) -> Tuple[torch.Tensor, torch.Tensor]:
    """MoE FFN. x: (B, S, D). Returns (y, aux * aux_loss_weight)."""
    e = cfg.moe
    B, S, D = x.shape
    rules = current_rules()
    x2d = x.reshape(B * S, D)
    top_e, top_g, aux = _route(x2d, take_whole(p["router"]), e.top_k)
    cap = _capacity(B * S, e.top_k, e.n_experts, e.capacity_factor)
    if rules.enabled and rules.mesh is not None \
            and rules.ep_axis is not None:
        mesh, ep_axis = rules.mesh, rules.ep_axis
        n_local = e.n_experts // mesh.size(mesh.mesh_dim_names.index(ep_axis))
        r = mesh.get_local_rank(ep_axis)
        group = mesh.get_group(ep_axis)
        we = [local_experts(p[n], r, n_local, e.n_experts)
              for n in ("we_gate", "we_up", "we_out")]
        y = _dispatch_local(replicated_to_partial(x2d, group), top_e,
                            replicated_to_partial(top_g, group), cap, *we,
                            e_start=r * n_local)
        y = sum_to_replicated(y, group)
        if rules.batch_axes:
            total, n = all_reduce_over(aux, mesh, rules.batch_axes)
            aux = total / n
    else:
        y = _dispatch_local(x2d, top_e, top_g, cap, p["we_gate"],
                            p["we_up"], p["we_out"])
    # the shared experts after the routed ones: x's gradient then sums
    # their two products' first, as their tensor-parallel form does
    shared_y = 0.0
    if "ws_gate" in p:
        shared_y = gated_mlp(x, p["ws_gate"], p["ws_up"], p["ws_out"])
    return y.reshape(B, S, D) + shared_y, aux * e.aux_loss_weight
