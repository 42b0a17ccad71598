"""Blockwise (flash) attention: the CUDA kernels and their plain twins.

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

Unlike the reference kernel, both take the model's layout, q (B, Sq, H,
hd) and k/v (B, Sk, K, hd) with query head ``h`` reading kv head
``h // (H // K)`` (grouped-query attention), and any Sq and Sk: the key
length may differ from the query length without the causal mask (the
encdec family's cross-attention, Sq decoder rows over Sk encoder rows;
``causal=True`` asks for Sk = Sq, since the reference's causal mask
never meets two lengths in the model).  They also take
the reference's sliding window (``window > 0``, causal only), which its
Pallas kernel lacks: key j is valid for query i iff ``j <= i`` and
``j > i - window``, the mask of the reference's XLA paths
(``models/layers.py`` ``causal_mask`` and ``blockwise_attention``).  The
kernels skip key tiles wholly outside the window, as they skip tiles
above the diagonal, and mask elements only on the tiles that cross
either edge; ``window >= S`` gives the bits of ``window = 0``.

The backward, :func:`flash_attention_backward`, launches the kernels of
``csrc/flash_attention_bwd.cu`` for CUDA tensors and takes
:func:`flash_attention_backward_plain` for CPU tensors; the reference
has no counterpart (XLA differentiates its attention).  It routes by
type as K4 does: bfloat16 takes the tensor-core kernels (wgmma, TMA; P
and dS carried as hi + lo bfloat16 parts), float32 the CUDA-core form.
:class:`FlashAttention` joins the two for autograd: its forward is K4,
its backward the backward kernel, so a gradient on the card never drops
silently through a kernel's output.

On the card both launch through ``torch.library`` ops,
``repro_torch::flash_attention`` and ``repro_torch::flash_attention_bwd``
(the backward's op also returns its per-row scratch, lse and delta): the
implementation is the ``ctypes`` launch with its ``launches`` count; a
fake implementation gives the outputs' shapes, so a trace of fake
tensors (``launch/dryrun.py``) goes through the op; a FLOP formula
counts the products of the plain version at the same arguments.
"""
from __future__ import annotations

import ctypes
import math

import torch
from torch.utils.flop_counter import register_flop_formula

from repro_torch.kernels.device import (check_launch, check_tensor,
                                        library, plain_flops, stream_ptr,
                                        takes_plain)

_DTYPES = (torch.float32, torch.bfloat16)
NEG_INF = -1e30
#: the largest head width the kernels stage (float32 tiles are padded to
#: 16, 32, 64 or 128 columns, bfloat16 TMA boxes to 64 or 128)
MAX_HEAD_DIM = 128
#: the bfloat16 kernels' host-side failures (negative return codes)
_TMA_ERRORS = {-1: "the driver gave no cuTensorMapEncodeTiled entry point",
               -2: "a TMA tensor map was refused by cuTensorMapEncodeTiled"}


def _check(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor) -> None:
    """Validate K4's arguments (the backward adds ``out`` and ``dout``):
    k/v (B, Sk, K, hd) beside q (B, Sq, H, hd)."""
    check_tensor("q", q, q.dtype, 4)
    check_tensor("k", k, q.dtype, 4, q.device)
    check_tensor("v", v, q.dtype, 4, q.device)
    if q.dtype not in _DTYPES:
        raise TypeError(f"q must be one of {_DTYPES}, got {q.dtype}")
    B, S, H, hd = q.shape
    if k.shape != v.shape or k.shape[0] != B or k.shape[1] < 1 \
            or k.shape[3] != hd:
        raise ValueError(f"k/v must be (B, Sk, K, hd) = ({B}, Sk >= 1, K, "
                         f"{hd}); got {tuple(k.shape)} and "
                         f"{tuple(v.shape)}")
    K = k.shape[2]
    if K == 0 or H % K != 0:
        raise ValueError(f"{H} query heads do not group over {K} kv heads")
    if hd % 8 != 0 or not 0 < hd <= MAX_HEAD_DIM:
        raise ValueError(f"head_dim must be a multiple of 8 in "
                         f"[8, {MAX_HEAD_DIM}], got {hd}")


def _check_mask(causal: bool, window: int, q: torch.Tensor,
                k: torch.Tensor) -> None:
    """The mask's arguments: a window only with the causal mask, and the
    causal mask only over as many keys as queries (the reference never
    asks for either otherwise)."""
    if window < 0:
        raise ValueError(f"window must be >= 0, got {window}")
    if window and not causal:
        raise ValueError("a sliding window needs the causal mask (the "
                         "reference never asks for one without it)")
    if causal and k.shape[1] != q.shape[1]:
        raise ValueError(f"the causal mask needs as many keys as queries, "
                         f"got Sq = {q.shape[1]} and Sk = {k.shape[1]}")


def _masked(S: int, causal: bool, window: int, device):
    """(S, S) bool, True where key j is invalid for query i: above the
    diagonal under the causal mask (which has Sk = Sq = S), at or below
    ``i - window`` under a window; None without a mask."""
    if not causal:
        return None
    pos = torch.arange(S, device=device)
    above = pos[None, :] > pos[:, None]
    if window:
        above |= pos[None, :] <= pos[:, None] - window
    return above


def flash_attention_plain(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                          causal: bool = True,
                          window: int = 0) -> torch.Tensor:
    """Plain twin of K4 in the model layout, q (B, Sq, H, hd) and k/v (B,
    Sk, K, hd): float32 scores, softmax as ``exp(s - max) / max(sum,
    1e-20)`` over float32 ``P·V``, cast at the end."""
    _check_mask(causal, window, q, k)
    B, S, H, hd = q.shape
    K = k.shape[2]
    G = H // K
    qg = q.float().reshape(B, S, K, G, hd)
    s = torch.einsum("bqkgh,bskh->bkgqs", qg, k.float()) * (1.0 / math.sqrt(hd))
    masked = _masked(S, causal, window, q.device)
    if masked is not None:
        s = s.masked_fill(masked, NEG_INF)
    m = s.amax(dim=-1, keepdim=True)
    p = torch.exp(s - m)
    if masked is not None:
        p = p.masked_fill(masked, 0.0)
    l = p.sum(dim=-1, keepdim=True)
    acc = torch.einsum("bkgqs,bskh->bqkgh", p, v.float())
    out = acc / l.clamp_min(1e-20).permute(0, 3, 1, 2, 4)
    return out.reshape(B, S, H, hd).to(q.dtype)


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool = True, window: int = 0) -> torch.Tensor:
    """K4: q (B, Sq, H, hd), k/v (B, Sk, K, hd) (Sk = Sq under the causal
    mask), float32 or bfloat16, all contiguous -> (B, Sq, H, hd) in q's
    type; ``window > 0`` (causal only) limits query i to keys ``i -
    window < j <= i``.  A CUDA tensor goes through the op
    ``repro_torch::flash_attention``, which launches the kernel (or
    raises); a CPU tensor takes the plain version."""
    _check(q, k, v)
    _check_mask(causal, window, q, k)
    if takes_plain(q, "flash_attention"):
        return flash_attention_plain(q, k, v, causal, window)
    return torch.ops.repro_torch.flash_attention(q, k, v, causal, window)


@torch.library.custom_op("repro_torch::flash_attention", mutates_args=(),
                         device_types="cuda")
def _flash_attention_launch(q: torch.Tensor, k: torch.Tensor,
                            v: torch.Tensor, causal: bool,
                            window: int) -> torch.Tensor:
    """K4's launch, the op's implementation (arguments checked by
    :func:`flash_attention`)."""
    B, S, H, hd = q.shape
    if B * H > 65_535:
        raise ValueError(f"B*H = {B * H} exceeds the kernel's grid")
    out = torch.empty_like(q)
    fn = library("flash_attention").repro_torch_flash_attention_kv
    fn.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 8 \
        + [ctypes.c_float, ctypes.c_int, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    with torch.cuda.device(q.device):
        flash_attention.launches += 1
        err = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), B,
                 S, k.shape[1], H, k.shape[2], hd, int(causal), int(window),
                 1.0 / math.sqrt(hd), int(q.dtype == torch.bfloat16),
                 stream_ptr(q))
    if err in _TMA_ERRORS:
        raise RuntimeError(f"CUDA kernel flash_attention: {_TMA_ERRORS[err]}")
    check_launch("flash_attention", err)
    return out


@_flash_attention_launch.register_fake
def _(q, k, v, causal, window):
    return torch.empty_like(q)


@register_flop_formula(torch.ops.repro_torch.flash_attention)
def _(q, k, v, causal, window, *, out_shape=None):
    return plain_flops(flash_attention_plain, (q, k, v), causal, window)


flash_attention.launches = 0


def flash_attention_backward_plain(q: torch.Tensor, k: torch.Tensor,
                                   v: torch.Tensor, out: torch.Tensor,
                                   dout: torch.Tensor, causal: bool = True,
                                   window: int = 0):
    """Plain twin of K4's backward: the explicit formula in float32, not
    autograd through :func:`flash_attention_plain`.  With P the
    normalized probabilities and ``D = rowsum(dout * out)``,
    ``dS = P * (dout V^T - D)``; returns ``(dS K / sqrt(hd),
    dS^T Q / sqrt(hd), P^T dout)`` in q's, k's and v's types, the G query
    heads of a kv head summed into its dK and dV."""
    _check_mask(causal, window, q, k)
    B, S, H, hd = q.shape
    K = k.shape[2]
    G = H // K
    scale = 1.0 / math.sqrt(hd)
    qg = q.float().reshape(B, S, K, G, hd)
    dog = dout.float().reshape(B, S, K, G, hd)
    kf, vf = k.float(), v.float()
    s = torch.einsum("bqkgh,bskh->bkgqs", qg, kf) * scale
    masked = _masked(S, causal, window, q.device)
    if masked is not None:
        s = s.masked_fill(masked, NEG_INF)
    p = torch.exp(s - s.amax(dim=-1, keepdim=True))
    if masked is not None:
        p = p.masked_fill(masked, 0.0)
    p = p / p.sum(dim=-1, keepdim=True).clamp_min(1e-20)
    delta = (dog * out.float().reshape(B, S, K, G, hd)).sum(-1)
    dp = torch.einsum("bqkgh,bskh->bkgqs", dog, vf)
    ds = p * (dp - delta.permute(0, 2, 3, 1)[..., None])
    dq = torch.einsum("bkgqs,bskh->bqkgh", ds, kf) * scale
    dk = torch.einsum("bkgqs,bqkgh->bskh", ds, qg) * scale
    dv = torch.einsum("bkgqs,bqkgh->bskh", p, dog)
    return (dq.reshape(B, S, H, hd).to(q.dtype), dk.to(k.dtype),
            dv.to(v.dtype))


def flash_attention_backward(q: torch.Tensor, k: torch.Tensor,
                             v: torch.Tensor, out: torch.Tensor,
                             dout: torch.Tensor, *, causal: bool = True,
                             window: int = 0):
    """K4's backward: K4's arguments plus its output ``out`` and the
    output's gradient ``dout`` (both (B, Sq, H, hd), q's type, contiguous)
    -> ``(dq, dk, dv)`` in the inputs' types, dk and dv (B, Sk, K, hd).
    A CUDA tensor goes through the op ``repro_torch::flash_attention_bwd``,
    which launches the kernels (or raises): bfloat16 the tensor-core ones,
    float32 the CUDA-core ones; a CPU tensor takes the plain version."""
    _check(q, k, v)
    _check_mask(causal, window, q, k)
    for name, t in (("out", out), ("dout", dout)):
        check_tensor(name, t, q.dtype, 4, q.device)
        if t.shape != q.shape:
            raise ValueError(f"{name} must have q's shape {tuple(q.shape)}, "
                             f"got {tuple(t.shape)}")
    if takes_plain(q, "flash_attention_bwd"):
        return flash_attention_backward_plain(q, k, v, out, dout, causal,
                                              window)
    dq, dk, dv, _, _ = torch.ops.repro_torch.flash_attention_bwd(
        q, k, v, out, dout, causal, window)
    return dq, dk, dv


def bwd_rows(S: int) -> int:
    """Rows of the backward's per-row scratch for S query rows: whole
    128-row tiles (``repro_torch_flash_attention_bwd_rows``)."""
    return -(-S // 128) * 128


@torch.library.custom_op("repro_torch::flash_attention_bwd", mutates_args=(),
                         device_types="cuda")
def _flash_attention_bwd_launch(
        q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, out: torch.Tensor,
        dout: torch.Tensor, causal: bool, window: int
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor,
           torch.Tensor]:
    """K4's backward launch, the op's implementation: ``(dq, dk, dv, lse,
    delta)``, lse and delta the per query row log-sum-exp and
    ``rowsum(dout * out)`` the first pass fills (arguments checked by
    :func:`flash_attention_backward`)."""
    B, S, H, hd = q.shape
    if B * H > 65_535:
        raise ValueError(f"B*H = {B * H} exceeds the kernel's grid")
    lib = library("flash_attention_bwd")
    dq, dk, dv = (torch.empty_like(t) for t in (q, k, v))
    # per query row log-sum-exp and rowsum(dout * out), filled by the
    # first pass; the tensor-core kernels read whole 128-row tiles of them
    rows_fn = lib.repro_torch_flash_attention_bwd_rows
    rows_fn.argtypes, rows_fn.restype = [ctypes.c_int], ctypes.c_int
    lse = torch.empty((B, H, rows_fn(S)), dtype=torch.float32,
                      device=q.device)
    delta = torch.empty_like(lse)
    fn = lib.repro_torch_flash_attention_bwd_kv
    fn.argtypes = [ctypes.c_void_p] * 10 + [ctypes.c_int] * 8 \
        + [ctypes.c_float, ctypes.c_int, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    with torch.cuda.device(q.device):
        flash_attention_backward.launches += 1
        err = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
                 dout.data_ptr(), dq.data_ptr(), dk.data_ptr(), dv.data_ptr(),
                 lse.data_ptr(), delta.data_ptr(), B, S, k.shape[1], H,
                 k.shape[2], hd, int(causal), int(window),
                 1.0 / math.sqrt(hd),
                 int(q.dtype == torch.bfloat16), stream_ptr(q))
    if err in _TMA_ERRORS:
        raise RuntimeError(f"CUDA kernel flash_attention_bwd: "
                           f"{_TMA_ERRORS[err]}")
    check_launch("flash_attention_bwd", err)
    return dq, dk, dv, lse, delta


@_flash_attention_bwd_launch.register_fake
def _(q, k, v, out, dout, causal, window):
    B, S, H, _ = q.shape
    lse = torch.empty((B, H, bwd_rows(S)), dtype=torch.float32,
                      device=q.device)
    return (*(torch.empty_like(t) for t in (q, k, v)), lse,
            torch.empty_like(lse))


@register_flop_formula(torch.ops.repro_torch.flash_attention_bwd)
def _(q, k, v, out, dout, causal, window, *, out_shape=None):
    return plain_flops(flash_attention_backward_plain, (q, k, v, out, dout),
                       causal, window)


flash_attention_backward.launches = 0


class FlashAttention(torch.autograd.Function):
    """K4 with its backward: ``FlashAttention.apply(q, k, v, causal,
    window)``, k and v of their own length without the causal mask.
    Forward and backward each take the kernel for CUDA tensors
    and the plain version for CPU tensors; the backward keeps q, k, v and
    the output, and recomputes the probabilities from them."""

    @staticmethod
    def forward(ctx, q, k, v, causal, window=0):
        out = flash_attention(q, k, v, causal=causal, window=window)
        ctx.save_for_backward(q, k, v, out)
        ctx.causal, ctx.window = causal, window
        return out

    @staticmethod
    def backward(ctx, dout):
        q, k, v, out = ctx.saved_tensors
        # the plain forward's output may be a strided view; K4's is not
        dq, dk, dv = flash_attention_backward(q, k, v, out.contiguous(),
                                              dout.contiguous(),
                                              causal=ctx.causal,
                                              window=ctx.window)
        return dq, dk, dv, None, None
