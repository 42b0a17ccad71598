"""Plain AdamW with int8 moments, as the configuration states it.

Hyper-parameters b1 0.9, b2 0.95, eps 1e-8, weight decay 0.1 on every
leaf of two or more dimensions (a stacked leaf of per-layer norms
included), gradients clipped to a global norm of 1.  Both moments are
kept blockwise in blocks of 256: along the trailing axis where it
divides 256, else over the flattened (stacked) leaf padded with zeros.
The first moment is coded as signed absmax int8 (scale = block max /
127), the second as uint8 codes of its fourth root over the block's
largest value.  Each step decodes the moments, updates in float32,
writes the parameter back in its stored type (bf16) and codes the
moments again.
"""
from __future__ import annotations

import math
from typing import Dict

import torch

F32 = torch.float32
Q = 256


def blocks(x: torch.Tensor) -> torch.Tensor:
    if x.dim() and x.shape[-1] % Q == 0:
        return x.reshape(*x.shape[:-1], x.shape[-1] // Q, Q)
    flat = x.reshape(-1)
    return torch.nn.functional.pad(flat, (0, -flat.numel() % Q)) \
        .reshape(-1, Q)


def unblocks(b: torch.Tensor, shape) -> torch.Tensor:
    return b.reshape(-1)[:math.prod(shape)].reshape(shape)


def code_signed(x: torch.Tensor):
    b = blocks(x)
    scale = torch.amax(b.abs(), -1, keepdim=True) / 127.0
    return torch.round(b / scale.clamp(min=1e-12)).to(torch.int8), scale


def decode_signed(q, scale, shape) -> torch.Tensor:
    return unblocks(q.to(F32) * scale, shape)


def code_root(x: torch.Tensor):
    b = blocks(x)
    top = torch.amax(b, -1, keepdim=True)
    root = torch.sqrt(torch.sqrt(b / top.clamp(min=1e-30)))
    return torch.round(root * 255.0).to(torch.uint8), top


def decode_root(q, top, shape) -> torch.Tensor:
    r = q.to(F32) / 255.0
    r = r * r
    return unblocks(r * r * top, shape)


class AdamW8:
    def __init__(self, lr: float, b1: float = 0.9, b2: float = 0.95,
                 eps: float = 1e-8, wd: float = 0.1, clip: float = 1.0,
                 param_dtype=torch.bfloat16):
        self.lr, self.b1, self.b2, self.eps = lr, b1, b2, eps
        self.wd, self.clip, self.param_dtype = wd, clip, param_dtype
        self.t = 0
        self.m: Dict[str, tuple] = {}
        self.v: Dict[str, tuple] = {}

    def first_moment(self, path: str, shape) -> torch.Tensor:
        return decode_signed(*self.m[path], shape)

    @torch.no_grad()
    def step(self, params: Dict[str, torch.Tensor],
             grads: Dict[str, torch.Tensor]) -> float:
        """Update ``params`` (float32 tensors holding bf16 values) in
        place from ``grads``; returns the global gradient norm."""
        self.t += 1
        gnorm = torch.sqrt(sum(torch.sum(g.to(F32) ** 2)
                               for g in grads.values()))
        scale = torch.clamp(self.clip / gnorm.clamp(min=1e-12), max=1.0)
        # the bias corrections in float32, as the moments
        t = torch.tensor(float(self.t), dtype=F32)
        dev = next(iter(params.values())).device
        b1c = (1.0 - torch.tensor(self.b1, dtype=F32) ** t).to(dev)
        b2c = (1.0 - torch.tensor(self.b2, dtype=F32) ** t).to(dev)
        for path, p in params.items():
            g = grads[path].to(F32) * scale
            if path in self.m:
                m = decode_signed(*self.m[path], p.shape)
                v = decode_root(*self.v[path], p.shape)
            else:
                m = torch.zeros_like(p, dtype=F32)
                v = torch.zeros_like(p, dtype=F32)
            m = self.b1 * m + (1 - self.b1) * g
            v = self.b2 * v + (1 - self.b2) * g * g
            delta = (m / b1c) / (torch.sqrt(v / b2c) + self.eps)
            if p.dim() >= 2:
                delta = delta + self.wd * p
            p.copy_((p - self.lr * delta).to(self.param_dtype).to(F32))
            self.m[path] = code_signed(m)
            self.v[path] = code_root(v)
        return float(gnorm)
