"""The train step: loss + grad (+ microbatch accumulation) + optimizer.

The port's twin of ``repro.train.step``.  ``build_train_step(model,
parallel, opt)`` returns ``step(model, opt_state, batch) -> (model,
opt_state', metrics)``: the reference's ``step(params, opt_state, batch)``
with the parameters held by the model and updated in place.  It turns
the model's gradients on (serving leaves them off).

Gradients come from ``torch.autograd.grad``, never accumulated in
``.grad``.  With ``microbatches > 1`` each microbatch's gradients are
added into float32 buffers and divided by n at the end, as the
reference's ``lax.scan`` carry does (a bf16 ``.grad`` would round every
partial sum); with one microbatch they keep the parameters' type, as
``jax.grad`` gives them.  ``parallel.remat`` is passed to the model's
loss.

The mesh comes from the sharding rules in force, as the reference's
jitted step takes its layout from ``in_shardings``: under rules with a
mesh, for a family that runs the reference's layout
(``sharding.layout_rules``; the model placed by
``sharding.distribute_model``), ``batch`` is this rank's block of the
global batch (of each microbatch in turn: microbatch i is rows ``[i *
b/n, (i + 1) * b/n)`` of the rank's b rows, its block of the reference's
microbatch i) and each rank's loss its term of the global mean.  A
placed parameter's gradient is its local block (the FSDP gather's
backward reduce-scattered it over ``data``), and so are the float32
accumulators; each gradient is then summed over the batch axes it is
not sharded over (a replicated parameter's over all of them), once per
step, and the loss likewise.  The other fields of
``ParallelismConfig`` are the cell's layout, which ``make_rules`` reads.
The data-parallel step of the reference's ``shard_map`` twin, parameters
replicated, is ``train/dp_shard.py``.
"""
from __future__ import annotations

from typing import Callable, Dict

import torch
import torch.distributed as dist

from repro_torch.configs.base import ParallelismConfig
from repro_torch.distributed.sharding import _names, group_of, layout_rules
from repro_torch.models.model import Model
from repro_torch.train.optimizer import AdamW, AdamWState, local_tensor

F32 = torch.float32


def _split_microbatches(batch: Dict, n: int):
    if any(x.shape[0] % n for x in batch.values()):
        raise ValueError(f"batch of {next(iter(batch.values())).shape[0]} "
                         f"does not split into {n} microbatches")
    return [{k: x.reshape(n, x.shape[0] // n, *x.shape[1:])[i]
             for k, x in batch.items()} for i in range(n)]


def _unsharded_batch_axes(p, batch_axes) -> tuple:
    """The batch axes a parameter's placement does not shard it over."""
    from torch.distributed.tensor import DTensor, Shard
    sharded = set()
    if isinstance(p, DTensor):
        names = p.device_mesh.mesh_dim_names
        sharded = {names[i] for i, pl in enumerate(p.placements)
                   if isinstance(pl, Shard)}
    return tuple(a for a in _names(batch_axes) if a not in sharded)


class TrainStep:
    """The step :func:`build_train_step` returns; :meth:`microbatch` is
    one microbatch's loss and gradients added into the accumulators
    (``launch/dryrun.py`` traces the first and counts it for the
    rest)."""

    def __init__(self, model: Model, parallel: ParallelismConfig,
                 opt: AdamW):
        self.remat = parallel.remat
        self.n_micro = parallel.microbatches
        self.opt = opt
        model.requires_grad_(True)

    def loss_and_grads(self, model: Model, params, mb: Dict):
        loss = model.loss(mb, remat=self.remat)
        return loss.detach(), torch.autograd.grad(loss, params)

    def microbatch(self, model: Model, params, mb: Dict, acc, losses,
                   i: int) -> None:
        """Microbatch ``i``: its gradients added into ``acc``, its loss
        written to ``losses[i]`` (it leaves no storage behind)."""
        loss, g = self.loss_and_grads(model, params, mb)
        for a, gi in zip(acc, g):
            a.add_(local_tensor(gi))
        losses[i] = loss

    def __call__(self, model: Model, opt_state: AdamWState, batch: Dict):
        names, params = zip(*model.named_parameters())
        if self.n_micro > 1:
            acc = [torch.zeros(local_tensor(p).shape, dtype=F32,
                               device=p.device) for p in params]
            losses = torch.empty(self.n_micro, dtype=F32,
                                 device=params[0].device)
            for i, mb in enumerate(_split_microbatches(batch, self.n_micro)):
                self.microbatch(model, params, mb, acc, losses, i)
            for a in acc:
                a.div_(self.n_micro)
            grads = acc
            loss = torch.mean(losses)
        else:
            loss, grads = self.loss_and_grads(model, params, batch)
            grads = [local_tensor(g) for g in grads]
        rules = layout_rules(model)
        if rules is not None and rules.batch_axes:
            groups = {}

            def group(axes):
                if axes not in groups:
                    groups[axes] = group_of(rules.mesh, axes)
                return groups[axes]

            for i, p in enumerate(params):
                axes = _unsharded_batch_axes(p, rules.batch_axes)
                if axes:
                    # a collective takes a dense tensor (a concatenation's
                    # backward gives views)
                    grads[i] = grads[i].contiguous()
                    dist.all_reduce(grads[i], group=group(axes))
            loss = loss.clone()
            dist.all_reduce(loss, group=group(_names(rules.batch_axes)))
        grads = dict(zip(names, grads))
        model, opt_state, gnorm = self.opt.update(grads, opt_state, model)
        metrics = {"loss": loss.to(F32), "grad_norm": gnorm}
        return model, opt_state, metrics


def build_train_step(model: Model, parallel: ParallelismConfig,
                     opt: AdamW) -> Callable:
    return TrainStep(model, parallel, opt)


def build_eval_step(model: Model) -> Callable:
    def step(model: Model, batch: Dict) -> torch.Tensor:
        with torch.no_grad():
            return model.loss(batch)
    return step
