"""Public op: GQA-aware flash attention.

``flash_mha(q, k, v)`` takes the model's layout, q (B, Sq, H, hd) and k/v
(B, Sk, K, hd) with ``H % K == 0``, as the reference's ``flash_mha`` does;
the key length Sk may differ from Sq without the causal mask (the encdec
family's cross-attention).
The reference expands the grouped kv heads with ``jnp.repeat`` and
swaps to (B, H, S, hd) for its kernel; the port's kernel reads the
grouping and the layout directly, so nothing is copied.  ``q``, ``k``
and ``v`` are made contiguous (the model's projections already are).
The call goes through :class:`FlashAttention`, so gradients flow through
K4's backward kernel.
"""
from __future__ import annotations

import torch

from repro_torch.kernels.flash_attention.kernel import FlashAttention


def flash_mha(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
              causal: bool = True, window: int = 0) -> torch.Tensor:
    """q: (B, Sq, H, hd); k/v: (B, Sk, K, hd) -> (B, Sq, H, hd), Sk = Sq
    under the causal mask; ``window > 0`` (causal only) limits query i to
    keys ``i - window < j <= i``."""
    return FlashAttention.apply(q.contiguous(), k.contiguous(),
                                v.contiguous(), causal, window)
