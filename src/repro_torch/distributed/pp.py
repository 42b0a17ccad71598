"""GPipe-style pipeline parallelism over a ``pipe`` mesh axis.

The port's twin of ``repro.distributed.pp``: each rank of the axis owns a
contiguous stage of layers, and microbatches flow through a steady-state
loop of M + S - 1 ticks for M microbatches over S stages.  At every tick
stage 0 takes microbatch t while t < M (and otherwise keeps what it
received), every stage runs its layers on what it holds, bubbles
included, the last stage writes microbatch t - S + 1, and the
activations rotate to the next stage, i -> (i + 1) mod S.  At the end
the last stage's outputs are summed over the axis with the other
stages' zeros, so every rank returns the whole batch.

Forward only (inference PP), as the reference's: no gradient is taken.

The reference's ``lax.ppermute`` is here one ``isend``/``irecv`` pair per
rank and tick (``dist.batch_isend_irecv``; a blocking send then receive
around the ring would deadlock under NCCL); at one stage the permutation
is the identity and nothing is exchanged.  :func:`pipeline_forward_local`
runs the same schedule with every stage in one process, the hand-offs by
assignment, through the same tick (:func:`stage_tick`): it checks the
schedule past one stage where there is one card.
"""
from __future__ import annotations

from typing import Any, Callable, List, Mapping, Sequence

import torch
import torch.distributed as dist


def _leaves(tree) -> List[torch.Tensor]:
    if isinstance(tree, torch.Tensor):
        return [tree]
    return [t for k in sorted(tree) for t in _leaves(tree[k])]


def _layer(tree, i: int):
    if isinstance(tree, torch.Tensor):
        return tree[i]
    return {k: _layer(v, i) for k, v in tree.items()}


def layers_of(params) -> List[Any]:
    """The per-layer trees of ``params``: a tree (nested mappings) whose
    leaves are stacked ``(L, ...)``, as the reference holds them, or a
    sequence of L per-layer trees, as the port's models hold
    ``params["blocks"]``."""
    if isinstance(params, Mapping):
        L = _leaves(params)[0].shape[0]
        return [_layer(params, i) for i in range(L)]
    return list(params)


def stage_layers(layers: Sequence, stage: int, n_stages: int) -> list:
    """The contiguous layers stage ``stage`` of ``n_stages`` owns."""
    if len(layers) % n_stages:
        raise ValueError(f"{len(layers)} layers do not split into "
                         f"{n_stages} stages")
    per = len(layers) // n_stages
    return list(layers[stage * per:(stage + 1) * per])


def microbatches_of(x: torch.Tensor, microbatches: int) -> torch.Tensor:
    """``x`` (B, ...) as (M, B / M, ...)."""
    B = x.shape[0]
    if B % microbatches:
        raise ValueError(f"batch {B} does not split into {microbatches} "
                         f"microbatches")
    return x.reshape((microbatches, B // microbatches) + tuple(x.shape[1:]))


def stage_tick(block_fn: Callable, layers: Sequence, bufs: torch.Tensor,
               cur: torch.Tensor, out: torch.Tensor, t: int, stage: int,
               n_stages: int) -> torch.Tensor:
    """Stage ``stage``'s work at tick ``t``: stage 0 takes microbatch
    ``t`` of ``bufs`` while t < M, the stage runs its ``layers`` on what it
    holds, and the last stage writes microbatch t - S + 1 into ``out``.
    Returns what the stage hands to the next one."""
    if stage == 0 and t < bufs.shape[0]:
        cur = bufs[t]
    for lp in layers:
        cur = block_fn(lp, cur)
    emit = t - n_stages + 1
    if stage == n_stages - 1 and emit >= 0:
        out[emit].copy_(cur)
    return cur


def _hand_off(y: torch.Tensor, group, stage: int, n_stages: int):
    """Send ``y`` to stage + 1 and receive stage - 1's (mod S)."""
    if n_stages == 1:
        return y
    y = y.contiguous()
    got = torch.empty_like(y)
    nxt = dist.get_global_rank(group, (stage + 1) % n_stages)
    prev = dist.get_global_rank(group, (stage - 1) % n_stages)
    for req in dist.batch_isend_irecv([
            dist.P2POp(dist.isend, y, nxt, group),
            dist.P2POp(dist.irecv, got, prev, group)]):
        req.wait()
    return got


@torch.no_grad()
def pipeline_forward(block_fn: Callable, params_stacked, x: torch.Tensor,
                     mesh, axis: str = "pipe",
                     microbatches: int = 4) -> torch.Tensor:
    """Run a layer stack split into ``axis`` stages over microbatches.

    ``block_fn(layer_params, x) -> x``; ``params_stacked``: a tree whose
    leaves are (L, ...), or a sequence of L per-layer trees
    (:func:`layers_of`), with L % n_stages == 0; ``x``: (B, ...) with
    B % microbatches == 0, the same on every rank of the axis.  ``mesh``
    is a ``DeviceMesh`` with a dimension named ``axis``.  Every rank
    returns the whole (B, ...) output.
    """
    n_stages = mesh.size(mesh.mesh_dim_names.index(axis))
    stage = mesh.get_local_rank(axis)
    group = mesh.get_group(axis)
    layers = stage_layers(layers_of(params_stacked), stage, n_stages)
    bufs = microbatches_of(x, microbatches)
    out = torch.zeros_like(bufs)
    cur = torch.zeros_like(bufs[0])
    for t in range(microbatches + n_stages - 1):
        y = stage_tick(block_fn, layers, bufs, cur, out, t, stage, n_stages)
        cur = _hand_off(y, group, stage, n_stages)
    # only the last stage holds real outputs; the others add zeros
    dist.all_reduce(out, group=group)
    return out.reshape(x.shape)


@torch.no_grad()
def pipeline_forward_local(block_fn: Callable, params_stacked,
                           x: torch.Tensor, n_stages: int,
                           microbatches: int = 4) -> torch.Tensor:
    """:func:`pipeline_forward`'s schedule over ``n_stages`` stages, all
    in this process with no collective: at every tick each stage runs
    :func:`stage_tick`, then stage i's output becomes stage i + 1's input
    (mod S).  Returns the last stage's output, which
    ``pipeline_forward`` hands every rank."""
    layers = layers_of(params_stacked)
    owned = [stage_layers(layers, s, n_stages) for s in range(n_stages)]
    bufs = microbatches_of(x, microbatches)
    out = torch.zeros_like(bufs)
    cur = [torch.zeros_like(bufs[0])] * n_stages
    for t in range(microbatches + n_stages - 1):
        ys = [stage_tick(block_fn, owned[s], bufs, cur[s], out, t, s,
                         n_stages) for s in range(n_stages)]
        cur = [ys[(s - 1) % n_stages] for s in range(n_stages)]
    return out.reshape(x.shape)
