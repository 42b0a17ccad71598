"""Explicit-collective data-parallel trainer.

The port's twin of ``repro.train.dp_shard``, whose ``shard_map`` path
makes the gradient reduction explicit so that it can be compressed on
the wire (``train/compression.py``).  Here the reduction is
``torch.distributed`` collectives over the process group of one mesh
axis.

``build_dp_train_step(model, opt, mesh, axis)`` returns ``step(model,
opt_state, ef, batch) -> (model, opt_state', ef', metrics)``, the
contract of ``train/step.py`` with the error-feedback state beside it:

* parameters are replicated (each rank holds all of them) and updated
  in place by the port's ``AdamW``; the experts that
  ``distributed.sharding.distribute_model(..., experts_only=True)``
  placed (the expert-parallel moe, run under the cell's rules) are each
  rank's local blocks;
* every rank is handed the global batch and takes its contiguous slice
  along dim 0 by its index on ``axis`` — one mesh axis, or several taken
  together (the rules' batch axes, ``("pod", "data")``), the block
  ``P(axis)`` gives a device;
* gradients come from ``torch.autograd.grad`` of the local loss (under
  ``remat``, as ``train/step.py`` passes it) and are averaged over the
  axis (``all_reduce`` SUM, then divided by the axis's size, as
  ``pmean``), or go through ``allreduce_compressed``; the loss is
  averaged likewise, and ``metrics`` holds ``loss`` and ``grad_norm``.
"""
from __future__ import annotations

from typing import Callable, Dict

import torch
import torch.distributed as dist

from repro_torch.distributed.sharding import block_of, group_of
from repro_torch.models.model import Model
from repro_torch.train import compression
from repro_torch.train.optimizer import AdamW, local_tensor

F32 = torch.float32


def build_dp_train_step(model: Model, opt: AdamW, mesh, axis="data",
                        compress_grads: bool = False,
                        remat: str = "none") -> Callable:
    """Params replicated; batch sharded over ``axis`` (a mesh axis name or
    a tuple of them); explicit all-reduce."""
    group = group_of(mesh, axis)
    world = dist.get_world_size(group)
    model.requires_grad_(True)

    def step(model: Model, opt_state, ef: compression.EFState, batch: Dict):
        local = {k: block_of(v, mesh, (axis,)) for k, v in batch.items()}
        names, params = zip(*model.named_parameters())
        loss = model.loss(local, remat=remat)
        # a collective takes a dense tensor: a gradient that comes out of
        # a concatenation's backward is a view that may not be one; a
        # placed expert's gradient is its local block's
        grads = {n: local_tensor(g).contiguous() for n, g in
                 zip(names, torch.autograd.grad(loss, params))}
        loss = loss.detach().to(F32)
        if compress_grads:
            grads, ef = compression.allreduce_compressed(grads, ef, group)
        else:
            for g in grads.values():
                dist.all_reduce(g, group=group)
                g.div_(world)
        dist.all_reduce(loss, group=group)
        loss = loss / world
        model, opt_state, gnorm = opt.update(grads, opt_state, model)
        return model, opt_state, ef, {"loss": loss, "grad_norm": gnorm}

    return step
