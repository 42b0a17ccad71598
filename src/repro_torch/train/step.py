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
loss; the other fields of ``ParallelismConfig`` describe a mesh, which
this single-device step does not use (the data-parallel step over a
mesh is ``train/dp_shard.py``).
"""
from __future__ import annotations

from typing import Callable, Dict

import torch

from repro_torch.configs.base import ParallelismConfig
from repro_torch.models.model import Model
from repro_torch.train.optimizer import AdamW, AdamWState

F32 = torch.float32


def _split_microbatches(batch: Dict, n: int):
    if any(x.shape[0] % n for x in batch.values()):
        raise ValueError(f"batch of {next(iter(batch.values())).shape[0]} "
                         f"does not split into {n} microbatches")
    return [{k: x.reshape(n, x.shape[0] // n, *x.shape[1:])[i]
             for k, x in batch.items()} for i in range(n)]


def build_train_step(model: Model, parallel: ParallelismConfig,
                     opt: AdamW) -> Callable:
    remat = parallel.remat
    n_micro = parallel.microbatches
    model.requires_grad_(True)

    def step(model: Model, opt_state: AdamWState, batch: Dict):
        names, params = zip(*model.named_parameters())

        def loss_and_grads(mb):
            loss = model.loss(mb, remat=remat)
            return loss.detach(), torch.autograd.grad(loss, params)

        if n_micro > 1:
            acc = [torch.zeros(p.shape, dtype=F32, device=p.device)
                   for p in params]
            losses = []
            for mb in _split_microbatches(batch, n_micro):
                loss, g = loss_and_grads(mb)
                for a, gi in zip(acc, g):
                    a.add_(gi)
                losses.append(loss)
                del g
            for a in acc:
                a.div_(n_micro)
            grads = acc
            loss = torch.mean(torch.stack(losses))
        else:
            loss, grads = loss_and_grads(batch)
        grads = dict(zip(names, grads))
        model, opt_state, gnorm = opt.update(grads, opt_state, model)
        metrics = {"loss": loss.to(F32), "grad_norm": gnorm}
        return model, opt_state, metrics

    return step


def build_eval_step(model: Model) -> Callable:
    def step(model: Model, batch: Dict) -> torch.Tensor:
        with torch.no_grad():
            return model.loss(batch)
    return step
