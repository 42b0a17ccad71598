"""Blockwise (flash) attention forward: the CUDA kernel and its plain twin.

:func:`flash_attention` (K4) launches the hand-written kernel of
``csrc/flash_attention.cu`` for CUDA tensors and takes
:func:`flash_attention_plain` for CPU tensors.  Both compute what the
reference's Pallas ``_flash_kernel`` computes: scores in float32 scaled
by ``1/sqrt(hd)``, softmax with a float32 normalizer, float32 ``P·V``,
one division by ``max(l, 1e-20)`` and one cast to q's type at the end.
The plain version keeps the probabilities in float32; the float32 kernel
does too, and the bfloat16 kernel (tensor cores) carries them as two
bfloat16 parts, hi + lo, to ~2**-17.  The reference's oracle
``attention_ref`` casts them to q's type first, so in bfloat16 the two
differ at the reference's 2e-2 tolerance.

Unlike the reference kernel, both take the model's layout, q (B, S, H,
hd) and k/v (B, S, K, hd) with query head ``h`` reading kv head
``h // (H // K)`` (grouped-query attention), and any S.
"""
from __future__ import annotations

import ctypes
import math

import torch

from repro_torch.kernels.device import (check_launch, check_tensor,
                                        library, stream_ptr)

_DTYPES = (torch.float32, torch.bfloat16)
NEG_INF = -1e30
#: the largest head width the kernels stage (float32 tiles are padded to
#: 16, 32, 64 or 128 columns, bfloat16 TMA boxes to 64 or 128)
MAX_HEAD_DIM = 128
#: the bfloat16 kernel's host-side failures (negative return codes)
_TMA_ERRORS = {-1: "the driver gave no cuTensorMapEncodeTiled entry point",
               -2: "a TMA tensor map was refused by cuTensorMapEncodeTiled"}


def _check(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor) -> None:
    check_tensor("q", q, q.dtype, 4)
    check_tensor("k", k, q.dtype, 4, q.device)
    check_tensor("v", v, q.dtype, 4, q.device)
    if q.dtype not in _DTYPES:
        raise TypeError(f"q must be one of {_DTYPES}, got {q.dtype}")
    B, S, H, hd = q.shape
    if k.shape != v.shape or k.shape[0] != B or k.shape[1] != S \
            or k.shape[3] != hd:
        raise ValueError(f"k/v must be (B, S, K, hd) = ({B}, {S}, K, {hd}); "
                         f"got {tuple(k.shape)} and {tuple(v.shape)}")
    K = k.shape[2]
    if K == 0 or H % K != 0:
        raise ValueError(f"{H} query heads do not group over {K} kv heads")
    if hd % 8 != 0 or not 0 < hd <= MAX_HEAD_DIM:
        raise ValueError(f"head_dim must be a multiple of 8 in "
                         f"[8, {MAX_HEAD_DIM}], got {hd}")


def flash_attention_plain(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                          causal: bool = True) -> torch.Tensor:
    """Plain twin of K4 in the model layout: float32 scores, softmax as
    ``exp(s - max) / max(sum, 1e-20)`` over float32 ``P·V``, cast at the
    end."""
    B, S, H, hd = q.shape
    K = k.shape[2]
    G = H // K
    qg = q.float().reshape(B, S, K, G, hd)
    s = torch.einsum("bqkgh,bskh->bkgqs", qg, k.float()) * (1.0 / math.sqrt(hd))
    if causal:
        pos = torch.arange(S, device=q.device)
        s = s.masked_fill(pos[None, :] > pos[:, None], NEG_INF)
    m = s.amax(dim=-1, keepdim=True)
    p = torch.exp(s - m)
    if causal:
        p = p.masked_fill(pos[None, :] > pos[:, None], 0.0)
    l = p.sum(dim=-1, keepdim=True)
    acc = torch.einsum("bkgqs,bskh->bqkgh", p, v.float())
    out = acc / l.clamp_min(1e-20).permute(0, 3, 1, 2, 4)
    return out.reshape(B, S, H, hd).to(q.dtype)


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool = True) -> torch.Tensor:
    """K4: q (B, S, H, hd), k/v (B, S, K, hd), float32 or bfloat16, all
    contiguous -> (B, S, H, hd) in q's type.  A CUDA tensor launches the
    kernel (or raises); a CPU tensor takes the plain version."""
    _check(q, k, v)
    if q.device.type == "cpu":
        return flash_attention_plain(q, k, v, causal)
    if q.device.type != "cuda":
        raise ValueError(f"no flash_attention kernel for device {q.device}")
    B, S, H, hd = q.shape
    if B * H > 65_535:
        raise ValueError(f"B*H = {B * H} exceeds the kernel's grid")
    out = torch.empty_like(q)
    fn = library("flash_attention").repro_torch_flash_attention
    fn.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 6 \
        + [ctypes.c_float, ctypes.c_int, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    with torch.cuda.device(q.device):
        flash_attention.launches += 1
        err = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), B,
                 S, H, k.shape[2], hd, int(causal), 1.0 / math.sqrt(hd),
                 int(q.dtype == torch.bfloat16), stream_ptr(q))
    if err in _TMA_ERRORS:
        raise RuntimeError(f"CUDA kernel flash_attention: {_TMA_ERRORS[err]}")
    check_launch("flash_attention", err)
    return out


flash_attention.launches = 0
