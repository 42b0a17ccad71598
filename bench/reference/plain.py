"""Plain float32 building blocks of the reference models, and the
control's products in float8.

The reference computes every product in float32 with TF32 off
(:func:`strict_float32`).  The control (:class:`Fp8MatMul`) computes
each product in float8 where the program computes it in bf16: its
operands and its result go through float8 (e4m3 forward, e5m2 for the
gradients), each tensor scaled so that its largest magnitude meets the
format's largest, as an fp8 training path does; the products add in
float32, as the program's do.
"""
from __future__ import annotations

import torch

F32 = torch.float32


def strict_float32() -> None:
    """float32 products in float32, not TF32."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.set_float32_matmul_precision("highest")


def _fp8(x: torch.Tensor, dtype) -> torch.Tensor:
    top = torch.finfo(dtype).max
    scale = x.abs().amax().clamp(min=1e-30) / top
    return (x / scale).to(dtype).to(F32) * scale


class Fp8MatMul(torch.autograd.Function):
    @staticmethod
    def forward(ctx, a, b):
        qa, qb = _fp8(a, torch.float8_e4m3fn), _fp8(b, torch.float8_e4m3fn)
        ctx.save_for_backward(qa, qb)
        return _fp8(torch.matmul(qa, qb), torch.float8_e4m3fn)

    @staticmethod
    def backward(ctx, g):
        qa, qb = ctx.saved_tensors
        qg = _fp8(g, torch.float8_e5m2)
        ga = torch.matmul(qg, qb.transpose(-1, -2))
        gb = torch.matmul(qa.transpose(-1, -2), qg)
        # a broadcast operand's gradient summed over the broadcast rows
        while ga.dim() > qa.dim():
            ga = ga.sum(0)
        while gb.dim() > qb.dim():
            gb = gb.sum(0)
        if gb.shape != qb.shape:
            gb = gb.sum_to_size(qb.shape)
        if ga.shape != qa.shape:
            ga = ga.sum_to_size(qa.shape)
        return _fp8(ga, torch.float8_e5m2), _fp8(gb, torch.float8_e5m2)


def fp8_matmul(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    return Fp8MatMul.apply(a, b)


PRECISIONS = {"float32": torch.matmul, "fp8": fp8_matmul}


def rmsnorm(x: torch.Tensor, w: torch.Tensor, eps: float) -> torch.Tensor:
    return x * torch.rsqrt(torch.mean(x * x, -1, keepdim=True) + eps) * w


def nll_sum(logits: torch.Tensor, labels: torch.Tensor,
            n_valid: int) -> torch.Tensor:
    """Summed negative log-likelihood of ``labels`` under ``logits``
    (..., V), over the first ``n_valid`` columns (the rest is padding)."""
    if logits.shape[-1] > n_valid:
        logits = logits[..., :n_valid]
    lse = torch.logsumexp(logits, -1)
    tgt = torch.gather(logits, -1, labels[..., None].long())[..., 0]
    return torch.sum(lse - tgt)
