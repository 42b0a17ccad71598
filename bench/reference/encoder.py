"""Plain float32 vit-huge (the encoder family): the classifier over stub
patch embeddings that the configuration describes.

Per block, pre-norm: RMSNorm, multi-head self-attention without mask or
rotary (softmax of q k^T / sqrt(hd), no bias), a residual add, RMSNorm,
the gated MLP ``(silu(h Wg) * (h Wu)) Wo``, a residual add; then the
final RMSNorm and the class head on the first token; the loss is the
mean cross-entropy over the images.  The stream starts as the bf16 patch
embeddings plus the learned position table.  Parameters are addressed
by leaf path, a block's by its layer along the stacked leaf's first axis.
"""
from __future__ import annotations

from typing import Dict, List, Tuple

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from bench import yardstick
from bench.reference.plain import nll_sum, rmsnorm


def param_specs(cfg: Dict) -> List[Tuple[str, Tuple[int, ...], str, float]]:
    """(name, shape, init, scale) of every parameter, named as the
    model's ``named_parameters`` are: ``normal`` is a fan-in scaled
    normal, ``embed`` a normal of 0.02, ``ones`` and ``zeros`` constants."""
    d, L, T = cfg["d_model"], cfg["n_layers"], cfg["frontend_tokens"]
    H, K = cfg["n_heads"], cfg["n_kv_heads"]
    hd = cfg["head_dim"] or d // H
    out = 1.0 / max(1, 2 * L) ** 0.5
    specs = []
    for l in range(L):
        b = f"blocks.{l}."
        specs += [(b + "attn.wq", (d, H * hd), "normal", 1.0),
                  (b + "attn.wk", (d, K * hd), "normal", 1.0),
                  (b + "attn.wv", (d, K * hd), "normal", 1.0),
                  (b + "attn.wo", (H * hd, d), "normal", out),
                  (b + "ln1", (d,), "ones", 1.0),
                  (b + "ln2", (d,), "ones", 1.0),
                  (b + "mlp.wi_gate", (d, cfg["d_ff"]), "normal", 1.0),
                  (b + "mlp.wi_up", (d, cfg["d_ff"]), "normal", 1.0),
                  (b + "mlp.wo", (cfg["d_ff"], d), "normal", out)]
    specs += [("final_norm", (d,), "ones", 1.0),
              ("head", (d, cfg["n_classes"]), "normal", 1.0),
              ("pos_embed", (T, d), "embed", 1.0)]
    return specs


def _block(P, l: int, x: torch.Tensor, cfg: Dict, mm) -> torch.Tensor:
    b, T, d = x.shape
    H, K = cfg["n_heads"], cfg["n_kv_heads"]
    hd = cfg["head_dim"] or d // H
    eps = cfg["norm_eps"]
    h = rmsnorm(x, P["blocks/ln1"][l], eps)
    q = mm(h, P["blocks/attn/wq"][l]).reshape(b, T, H, hd).transpose(1, 2)
    k = mm(h, P["blocks/attn/wk"][l]).reshape(b, T, K, hd).transpose(1, 2)
    v = mm(h, P["blocks/attn/wv"][l]).reshape(b, T, K, hd).transpose(1, 2)
    if K != H:
        k = k.repeat_interleave(H // K, dim=1)
        v = v.repeat_interleave(H // K, dim=1)
    s = mm(q, k.transpose(-1, -2)) / hd ** 0.5
    o = mm(torch.softmax(s, -1), v).transpose(1, 2).reshape(b, T, H * hd)
    x = x + mm(o, P["blocks/attn/wo"][l])
    h = rmsnorm(x, P["blocks/ln2"][l], eps)
    g = mm(h, P["blocks/mlp/wi_gate"][l])
    u = mm(h, P["blocks/mlp/wi_up"][l])
    return x + mm(F.silu(g) * u, P["blocks/mlp/wo"][l])


def loss_sum(P: Dict[str, torch.Tensor], cfg: Dict, batch: Dict,
             mm) -> torch.Tensor:
    """Summed cross-entropy of a block of images: ``batch`` holds
    ``patch_embeds`` (b, T, d) bf16 and ``labels`` (b,)."""
    x = batch["patch_embeds"].float() + P["pos_embed"]
    for l in range(cfg["n_layers"]):
        x = checkpoint(_block, P, l, x, cfg, mm, use_reentrant=False)
    x = rmsnorm(x, P["final_norm"], cfg["norm_eps"])
    logits = mm(x[:, 0], P["head"])
    return nll_sum(logits, batch["labels"], cfg["n_classes"])


def count(batch: Dict) -> int:
    """The examples the mean loss is over."""
    return batch["labels"].numel()


def step_flops(cfg: Dict, cell: Dict) -> float:
    """Model FLOPs of one training step of the cell (the yardstick's)."""
    return yardstick.encoder_step_flops(cfg, cell["batch"])
