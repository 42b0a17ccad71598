"""Gradient compression for the DP all-reduce: int8 with error feedback.

The port's twin of ``repro.train.compression``, used by the
explicit-collective trainer (``train/dp_shard.py``): each data rank
quantizes its local gradient to int8 with per-block scales, all-reduces
the payload accumulated in int32, and keeps the quantization residual
locally for the next step (error feedback keeps the scheme unbiased over
time).  4x fewer gradient bytes on the wire.

Arithmetic as the reference's, operation for operation in float32:
``torch.round`` rounds half to even as ``jnp.round`` does, so the codes
and scales come out byte-equal to the reference's on the same gradient,
and so do the residuals: ``compress`` rounds the product and the
difference apart, as the reference's eager ``compress`` does, and
``allreduce_compressed`` rounds them once, as XLA's fused multiply-add
gives the reference's inside ``shard_map`` (``_residual``, in float32
with the scale split in two).
The reference's three collectives inside ``shard_map`` become
``all_reduce(MAX)`` of the per-block scales, ``all_reduce(SUM)`` of the
codes widened to int32, and the group's size.  Plain torch operations:
the reference computes all of it outside any Pallas kernel.

Gradients and residuals are dicts keyed by the port's parameter names
(``model.named_parameters()``), as ``AdamW.update`` takes them.
"""
from __future__ import annotations

from typing import Dict, NamedTuple, Tuple

import torch
import torch.distributed as dist

QBLOCK = 256
F32 = torch.float32


class EFState(NamedTuple):
    residual: Dict[str, torch.Tensor]      # float32, one per parameter


def init_ef(model) -> EFState:
    """Zero residuals for ``model``'s parameters (``named_parameters()``)."""
    return EFState({n: torch.zeros(p.shape, dtype=F32, device=p.device)
                    for n, p in model.named_parameters()})


def _blocks(x: torch.Tensor) -> Tuple[torch.Tensor, int]:
    flat = x.reshape(-1)
    pad = (-flat.shape[0]) % QBLOCK
    return torch.nn.functional.pad(flat, (0, pad)).reshape(-1, QBLOCK), \
        flat.shape[0]


def _div(x: torch.Tensor, d: float) -> torch.Tensor:
    """``x / d`` rounded as one division.  Divided by a Python number, a
    CUDA tensor is multiplied by the number's reciprocal instead, which
    can round otherwise; by a 0-dim tensor on its device it is not (made
    there by a fill, with no copy from the host to wait for)."""
    return x / torch.full((), d, dtype=x.dtype, device=x.device)


def _scale(blocks: torch.Tensor) -> torch.Tensor:
    return _div(torch.amax(torch.abs(blocks), dim=1, keepdim=True), 127.0)


def _quantize(blocks: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    return torch.clamp(torch.round(blocks / torch.clamp(scale, min=1e-12)),
                       -127, 127).to(torch.int8)


def _unblock(flat: torch.Tensor, n: int, shape) -> torch.Tensor:
    return flat.reshape(-1)[:n].reshape(shape)


def _residual(blocks: torch.Tensor, q: torch.Tensor, scale: torch.Tensor,
              n: int, shape) -> torch.Tensor:
    """``blocks - q * scale`` rounded once, unblocked to ``shape``, as the
    reference's ``allreduce_compressed`` gets it: under ``shard_map`` XLA
    fuses the product into the subtraction (a fused multiply-add).  In
    float32: ``scale`` splits into ``hi``, its top 12 significant bits,
    and ``lo = scale - hi``, at most 12 more; a code has 8, so ``q * hi``
    and ``q * lo`` are exact.  ``blocks - q * hi`` is exact too (within a
    factor 2 of each other where ``q`` is not 0, Sterbenz's lemma), so
    the one rounding is that of ``- q * lo``.  Exact for normal scales,
    whether or not ``addcmul`` fuses its product."""
    hi = (scale.view(torch.int32) & ~0xFFF).view(F32)
    qf = q.to(F32)
    t = torch.addcmul(blocks, qf, hi, value=-1.0)
    return _unblock(torch.addcmul(t, qf, scale - hi, value=-1.0), n, shape)


def compress(g: torch.Tensor, residual: torch.Tensor
             ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Returns (int8 payload, scales, new residual)."""
    corrected = g.to(F32) + residual
    blocks, n = _blocks(corrected)
    scale = _scale(blocks)
    q = _quantize(blocks, scale)
    deq = _unblock(q.to(F32) * scale, n, g.shape)
    return q, scale, corrected - deq


def decompress(q: torch.Tensor, scale: torch.Tensor, shape) -> torch.Tensor:
    flat = (q.to(F32) * scale).reshape(-1)
    n = 1
    for s in shape:
        n *= s
    return flat[:n].reshape(shape)


def allreduce_compressed(grads: Dict[str, torch.Tensor], ef: EFState,
                         group=None) -> Tuple[Dict[str, torch.Tensor], EFState]:
    """int8 error-feedback all-reduce over the process group ``group``
    (default: the world).  Returns the float32 mean gradients and the new
    residuals.

    The int8 payloads are summed as int32: lossless across ranks, given
    the ranks first agree on one scale per block."""
    world = dist.get_world_size(group)

    def one(g, r):
        corrected = g.to(F32) + r
        blocks, n = _blocks(corrected)
        # 1) agree on a shared per-block scale (a small float32 collective)
        scale = _scale(blocks)
        dist.all_reduce(scale, op=dist.ReduceOp.MAX, group=group)
        # 2) quantize against the shared scale; the residual stays local
        q = _quantize(blocks, scale)
        new_r = _residual(blocks, q, scale, n, g.shape)
        # 3) int32-accumulated all-reduce of the int8 payload
        total = q.to(torch.int32)
        dist.all_reduce(total, op=dist.ReduceOp.SUM, group=group)
        mean = _div(total.to(F32) * scale, float(world))
        return _unblock(mean, n, g.shape), new_r

    outs = {name: one(g, ef.residual[name]) for name, g in grads.items()}
    return ({n: o[0] for n, o in outs.items()},
            EFState({n: o[1] for n, o in outs.items()}))
