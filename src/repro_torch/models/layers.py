"""Transformer building blocks — functions over ParamDef-declared params.

The port's twin of ``repro.models.layers``.  Conventions as there:

* activations in the parameter type (bf16 by default), reductions, norms
  and softmax accumulate in float32;
* attention layout (B, S, H, hd); GQA groups q-heads over kv-heads;
* every block has a full-sequence form and a single-token decode form.

Full-sequence self-attention goes through K4 (``ops.flash_mha``): on a
CUDA tensor the hand-written kernel, on a CPU tensor its plain twin.
The reference's XLA paths (``_sdpa`` for short sequences,
``blockwise_attention`` for long ones) compute the same function and are
what the parity tests hold the port to, sliding windows (``window > 0``,
the hybrid family's) included: K4 takes the window and skips the key
tiles outside it.  Cross-attention (``kv_x``, the encdec family's
decoder over its encoder's output) runs through K4 too, non-causal with
Sq decoder rows over Sk encoder rows.  One-token decode stays plain
torch (``_sdpa``), windowed, cross or not: the reference has no kernel
for it.

Under the reference's layout (a model placed by
``distributed.sharding.distribute_model``; each parameter a DTensor of
its spec), the layers compute on each rank's local blocks, as XLA lays
out the reference's arrays by ``make_rules``: a parameter is read
through ``sharding.take`` (its local block, FSDP shards over ``data``
gathered), and a parameter sharded over ``model`` makes its layer
tensor-parallel (Megatron's column and row split).  Attention: q is
column-parallel (the rank's heads); k and v are the rank's kv heads when
``kv_heads`` maps to ``model``, else every kv head, computed on every
rank (their weights replicated) and cut to the kv heads the rank's q
heads read under GQA (by the global head index); K4 runs on the local
heads; ``wo`` is row-parallel, summed over ``model``.  Where the heads
do not divide the ``model`` axis (qwen1.5-32b: 40 over 16), ``wq``'s
columns stay split as the spec splits them (2.5 heads a rank) and q,
and the attention's output before ``wo``, are regrouped into whole
heads by an all-to-all (``sharding.regroup``; each rank 3 or 2 heads,
not every head on every rank).  The MLP's gate and up projections are
column-parallel and ``wo`` row-parallel; the embedding is a masked
lookup in the rank's vocab rows summed over ``model``; the logits are
the rank's vocab block.  A replicated input of a tensor-parallel layer
enters through ``sharding.replicated_to_partial`` (its gradient summed
over ``model``), and so does a replicated weight that each rank uses
for its own heads only (``wk``/``wv`` when the kv heads do not divide,
``q_norm``, ``k_norm``).  Decode (:func:`attention_decode`) takes the
cache's blocks by the decode rules' spec: where they put the cache's
sequence on ``model`` (the kv heads do not divide the axis), each rank
holds its block of positions of every kv head, and the attention is the
flash-decoding combine (:func:`_attention_decode_tp`), the partial
softmaxes that XLA partitions the reference's ``_sdpa`` into; the encdec
family's decode-time cross-attention (:func:`cross_attention_decode`)
reads its cross cache's blocks alike, with no new key and no mask.  With
no placed parameter every path computes what it computes on one device.

Where a bf16 activation meets float32 weights (the encdec family's
encoder takes its frame embeddings as bf16 whatever the parameters'
type), jnp's ``einsum`` promotes to float32 and ``torch.matmul`` raises;
the projections promote at the product (:func:`_mm`), so the bf16 input
keeps the reference's rounding and a bf16 model is untouched.
"""
from __future__ import annotations

from typing import Dict, Optional

import torch
import torch.distributed as dist
import torch.nn.functional as F

from repro_torch.configs.base import ModelConfig
from repro_torch.distributed.sharding import (collective, gather_dim,
                                              head_range, model_split,
                                              reduce_scatter_dim, regroup,
                                              replicated_to_partial,
                                              sum_to_replicated, take)
from repro_torch.kernels.flash_attention.ops import flash_mha
from repro_torch.models.params import ParamDef

F32 = torch.float32
NEG_INF = -1e30


# ---------------------------------------------------------------------------
# Norms
# ---------------------------------------------------------------------------

def rmsnorm_def(d: int) -> ParamDef:
    return ParamDef((d,), ("embed",), init="ones")


def rmsnorm(x: torch.Tensor, scale: torch.Tensor, eps: float) -> torch.Tensor:
    scale = take(scale)
    xf = x.to(F32)
    var = torch.mean(xf * xf, dim=-1, keepdim=True)
    y = xf * torch.rsqrt(var + eps)
    return (y * scale.to(F32)).to(x.dtype)


# ---------------------------------------------------------------------------
# Rotary position embedding
# ---------------------------------------------------------------------------

def rotary(x: torch.Tensor, positions: torch.Tensor,
           theta: float) -> torch.Tensor:
    """x: (B, S, H, hd); positions: (S,) or (B, S)."""
    hd = x.shape[-1]
    half = hd // 2
    freqs = 1.0 / (theta ** (torch.arange(0, half, dtype=F32,
                                          device=x.device) / half))
    if positions.dim() == 1:
        ang = positions.to(F32)[:, None] * freqs[None, :]       # (S, half)
        ang = ang[None, :, None, :]                              # (1,S,1,half)
    else:
        ang = positions.to(F32)[..., None] * freqs               # (B,S,half)
        ang = ang[:, :, None, :]
    cos, sin = torch.cos(ang), torch.sin(ang)
    x1, x2 = x[..., :half].to(F32), x[..., half:].to(F32)
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return out.to(x.dtype)


# ---------------------------------------------------------------------------
# Attention
# ---------------------------------------------------------------------------

def attention_defs(cfg: ModelConfig, *, cross: bool = False) -> Dict:
    d, hd = cfg.d_model, cfg.resolved_head_dim
    H, K = cfg.n_heads, cfg.n_kv_heads
    defs = {
        "wq": ParamDef((d, H * hd), ("embed", "q_heads")),
        "wk": ParamDef((d, K * hd), ("embed", "kv_heads")),
        "wv": ParamDef((d, K * hd), ("embed", "kv_heads")),
        "wo": ParamDef((H * hd, d), ("q_heads", "embed"),
                       scale=1.0 / max(1, (2 * cfg.n_layers)) ** 0.5),
    }
    if cfg.qkv_bias and not cross:
        defs["bq"] = ParamDef((H * hd,), ("q_heads",), init="zeros")
        defs["bk"] = ParamDef((K * hd,), ("kv_heads",), init="zeros")
        defs["bv"] = ParamDef((K * hd,), ("kv_heads",), init="zeros")
    if cfg.qk_norm:
        defs["q_norm"] = ParamDef((hd,), (None,), init="ones")
        defs["k_norm"] = ParamDef((hd,), (None,), init="ones")
    return defs


def _mm(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """``x @ w`` in the promoted type of the two, as jnp's ``einsum``
    takes it; for operands of one type, ``torch.matmul`` itself."""
    if x.dtype != w.dtype:
        dt = torch.promote_types(x.dtype, w.dtype)
        x, w = x.to(dt), w.to(dt)
    return torch.matmul(x, w)


def _project_qkv(p, x: torch.Tensor, kv_x: torch.Tensor, cfg: ModelConfig,
                 positions, kv_positions, *, use_rope: bool = True):
    B = x.shape[0]
    hd = cfg.resolved_head_dim
    H, K = cfg.n_heads, cfg.n_kv_heads
    q = _mm(x, take(p["wq"]))
    k = _mm(kv_x, take(p["wk"]))
    v = _mm(kv_x, take(p["wv"]))
    if "bq" in p:
        q, k, v = q + take(p["bq"]), k + take(p["bk"]), v + take(p["bv"])
    q = q.reshape(B, -1, H, hd)
    k = k.reshape(B, -1, K, hd)
    v = v.reshape(B, -1, K, hd)
    if "q_norm" in p:
        q = rmsnorm(q, p["q_norm"], cfg.norm_eps)
        k = rmsnorm(k, p["k_norm"], cfg.norm_eps)
    if use_rope:
        q = rotary(q, positions, cfg.rope_theta)
        k = rotary(k, kv_positions, cfg.rope_theta)
    return q, k, v


def _sdpa(q, k, v, mask, cfg: ModelConfig):
    """Grouped scaled-dot-product attention. q:(B,Sq,H,hd) k/v:(B,Sk,K,hd).

    Materializes (Sq, Sk) scores; the port uses it for one-token decode
    only (full sequences go through K4).  The reference's ``_sdpa``
    grouping, mask and softmax, in K4's arithmetic: inputs cast to
    float32, scores scaled by ``1/sqrt(hd)``, float32 probabilities and
    ``P·V``, one cast at the end.  The reference's decode shares its
    forward's arithmetic (both run ``_sdpa``, which casts the
    probabilities to the activation type); the port's forward runs K4,
    so its decode takes K4's, and decode after prefill continues the
    prefill's logits as closely as in the reference.
    """
    B, Sq, H, hd = q.shape
    K = k.shape[2]
    G = H // K if K else 1
    qg = q.reshape(B, Sq, K, G, hd).to(F32)
    scores = torch.einsum("bqkgh,bskh->bkgqs", qg, k.to(F32)) \
        * (1.0 / hd ** 0.5)
    if mask is not None:
        scores = torch.where(mask, scores, torch.full((), NEG_INF,
                                                      device=q.device))
    probs = torch.softmax(scores, dim=-1)
    out = torch.einsum("bkgqs,bskh->bqkgh", probs, v.to(F32))
    # contiguous: the strides the einsum leaves on a size-1 dimension
    # differ between real and fake tensors, and ``matmul`` with ``wo``
    # folds the rows into one product only when they line up
    return out.reshape(B, Sq, H, hd).to(q.dtype,
                                         memory_format=torch.contiguous_format)


def attention(p, x: torch.Tensor, cfg: ModelConfig, *,
              positions: torch.Tensor, causal: bool, window: int = 0,
              kv_x: Optional[torch.Tensor] = None,
              kv_positions: Optional[torch.Tensor] = None,
              use_rope: bool = True, return_kv: bool = False):
    """Full-sequence attention (training / prefill / cross) through K4;
    ``window > 0`` (with ``causal``) limits query i to keys
    ``i - window < j <= i``.  With ``kv_x`` (B, Sk, d) the keys and values
    come from it, at ``kv_positions`` (default ``positions``); Sk may
    differ from the query length only without ``causal``, as K4 asks.
    With ``wq`` sharded over ``model``, tensor-parallel
    (:func:`_attention_tp`)."""
    kv_x = x if kv_x is None else kv_x
    kv_positions = positions if kv_positions is None else kv_positions
    split = model_split(p["wq"])
    if split is not None:
        return _attention_tp(p, x, kv_x, cfg, positions, kv_positions,
                             causal, window, use_rope, return_kv, split)
    q, k, v = _project_qkv(p, x, kv_x, cfg, positions, kv_positions,
                           use_rope=use_rope)
    out = flash_mha(q, k, v, causal=causal, window=window)
    out = out.reshape(x.shape[0], -1, cfg.n_heads * cfg.resolved_head_dim)
    y = torch.matmul(out, take(p["wo"]))
    if return_kv:
        return y, k, v
    return y


def _attention_tp(p, x, kv_x, cfg: ModelConfig, positions, kv_positions,
                  causal: bool, window: int, use_rope: bool,
                  return_kv: bool, split):
    """Tensor-parallel attention on this rank's heads (the module's
    docstring).  ``return_kv`` gives the keys and values the cache holds:
    the rank's kv heads when they are sharded, else all of them.  A
    ``kv_x`` other than ``x`` (cross-attention) comes as the caller made
    it partial: the encoder's output enters every layer's
    cross-attention through one ``replicated_to_partial``
    (``transformer._encode``), so that its gradient sums over the layers
    in the unsharded order before one reduction over ``model``."""
    B, hd = x.shape[0], cfg.resolved_head_dim
    H, K = cfg.n_heads, cfg.n_kv_heads
    grp = split.group
    self_attn = kv_x is x
    x = replicated_to_partial(x, grp)
    if self_attn:
        kv_x = x
    q = _mm(x, take(p["wq"]))
    if "bq" in p:
        q = q + take(p["bq"])
    s, e = head_range(H, split)
    if H % split.size:
        q = regroup(q, H, hd, split)
    q = q.reshape(B, -1, e - s, hd)

    kv_sharded = model_split(p["wk"]) is not None

    def kv_weight(name):
        w = take(p[name])
        return w if kv_sharded else replicated_to_partial(w, grp)

    k = _mm(kv_x, kv_weight("wk"))
    v = _mm(kv_x, kv_weight("wv"))
    if "bk" in p:
        k, v = k + kv_weight("bk"), v + kv_weight("bv")
    k = k.reshape(B, -1, k.shape[-1] // hd, hd)
    v = v.reshape(B, -1, v.shape[-1] // hd, hd)
    if "q_norm" in p:
        q = rmsnorm(q, replicated_to_partial(take(p["q_norm"]), grp),
                    cfg.norm_eps)
        k = rmsnorm(k, replicated_to_partial(take(p["k_norm"]), grp),
                    cfg.norm_eps)
    if use_rope:
        q = rotary(q, positions, cfg.rope_theta)
        k = rotary(k, kv_positions, cfg.rope_theta)
    ka, va = (k, v) if kv_sharded else _kv_for_heads(k, v, s, e, H // K)
    if e > s:
        out = flash_mha(q, ka, va, causal=causal, window=window)
    else:          # a rank past the last head (heads fewer than ranks)
        out = q
    out = out.reshape(B, -1, (e - s) * hd)
    if H % split.size:
        out = regroup(out, H, hd, split, to_heads=False)
    y = sum_to_replicated(torch.matmul(out, take(p["wo"])), grp)
    if return_kv:
        return y, k, v
    return y


def _kv_for_heads(k, v, start: int, end: int, group: int):
    """Of every kv head (B, S, K, hd), those the q heads ``[start, end)``
    read under GQA (q head h reads kv head ``h // group``): a contiguous
    slice when each of them serves the same number of the rank's heads
    in order, as K4's grouping asks, else one kv head per q head."""
    idx = [h // group for h in range(start, end)]
    if not idx:
        return k[:, :, :0], v[:, :, :0]
    first, n = idx[0], idx[-1] - idx[0] + 1
    per = len(idx) // n
    if per * n == len(idx) and idx == [first + i // per
                                       for i in range(len(idx))]:
        return k[:, :, first:first + n], v[:, :, first:first + n]
    sel = torch.tensor(idx, device=k.device)
    return k.index_select(2, sel), v.index_select(2, sel)


def write_kv(cache_k: torch.Tensor, cache_v: torch.Tensor, k: torch.Tensor,
             v: torch.Tensor, slot: Optional[int]) -> None:
    """Write one token's key and value (B, 1, K, hd) at ``slot`` of the
    caches (B, S, K, hd), in place; ``slot`` None writes nothing (the
    position lies in another rank's block of the sequence).  Like the
    reference's ``dynamic_update_slice``, a key of another type than the
    cache raises ``TypeError``."""
    if k.dtype != cache_k.dtype or v.dtype != cache_v.dtype:
        raise TypeError(
            f"the KV cache is {cache_k.dtype} and the new key/value "
            f"{k.dtype}: the cache must have the activations' type")
    if slot is not None:
        cache_k[:, slot] = k[:, 0]
        cache_v[:, slot] = v[:, 0]


def _decode_mask(S: int, start: int, total: int, index: int, window: int,
                 ring: bool, device) -> torch.Tensor:
    """Which of the ``S`` cache slots from ``start`` (of ``total`` in the
    whole cache) a query at position ``index`` reads, as a mask over the
    scores: a linear cache's positions up to ``index`` (above ``index -
    window`` with a window); a ring buffer's slots whose position ``index
    - (index - slot) mod total`` is not negative."""
    slot = start + torch.arange(S, device=device)
    if ring:
        valid = index - torch.remainder(index - slot, total) >= 0
    else:
        valid = slot <= index
        if window:
            valid &= slot > index - window
    return valid[None, None, None, None, :]


def attention_decode(p, x: torch.Tensor, cfg: ModelConfig, *,
                     cache_k: torch.Tensor, cache_v: torch.Tensor,
                     index: int, window: int = 0, use_rope: bool = True,
                     seq=None, ring: bool = False):
    """One-token decode against a preallocated KV cache.

    x: (B, 1, D); cache_k/v: (B, S_max, K, hd); index: the position.
    Writes the new key and value at ``index`` in place (the reference
    returns updated copies; the caller keeps only the new cache either
    way; :func:`write_kv`) and returns ``(y, cache_k, cache_v)``.
    ``window > 0`` masks the keys at or below ``index - window``, as the
    reference.  With ``ring``, the cache is the hybrid family's ring
    buffer of W = S_max slots: the new key and value go to slot ``index
    % W``, and slot j holds position ``index - (index - j) % W``, read
    where that is not negative (the reference's
    ``transformer._attention_decode_window``).  With ``wq`` sharded over
    ``model``, or ``seq`` (the split of the cache's sequence, or of the
    ring's slots, ``sharding.seq_split``), the decode layout's
    (:func:`_attention_decode_tp`).
    """
    split = model_split(p["wq"])
    if split is not None or seq is not None:
        return _attention_decode_tp(p, x, cfg, cache_k, cache_v, index,
                                    window, use_rope, split, seq, ring)
    B = x.shape[0]
    hd = cfg.resolved_head_dim
    pos = torch.full((1,), index, dtype=torch.int32, device=x.device)
    q, k, v = _project_qkv(p, x, x, cfg, pos, pos, use_rope=use_rope)
    S_max = cache_k.shape[1]
    write_kv(cache_k, cache_v, k, v, index % S_max if ring else index)
    mask = _decode_mask(S_max, 0, S_max, index, window, ring, x.device)
    out = _sdpa(q, cache_k, cache_v, mask, cfg)
    out = out.reshape(B, 1, cfg.n_heads * hd)
    y = torch.matmul(out, take(p["wo"]))
    return y, cache_k, cache_v


def _attention_decode_tp(p, x, cfg: ModelConfig, cache_k, cache_v,
                         index: int, window: int, use_rope: bool, split,
                         seq, ring: bool = False):
    """Decode under the reference's decode layout, on this rank's blocks
    (no gradient: the collectives here do not differentiate).

    * ``split`` (``wq`` over ``model``) alone: q is the rank's heads
      (regrouped into whole heads where they do not divide the axis, as
      :func:`_attention_tp`), k and v the rank's kv heads where ``wk`` is
      sharded, else every kv head; ``_sdpa`` on the rank's heads against
      the cache's kv heads they read; ``wo`` row-parallel, summed over
      ``model``.
    * ``seq`` (the cache holds the rank's block of positions, from
      ``seq.rank * S_local``): the new key and value go into the cache
      only on the rank whose block holds ``index``, and the attention is
      the flash-decoding combine (:func:`_sdpa_partial`): each rank
      scores its block, the maxima and the sums of exponentials are
      reduced over ``seq``'s group, each rank's probability-weighted
      values are its partial of the output.  Where ``seq`` is the
      ``model`` axis, the rank's block needs every head's query: q's
      column blocks are all-gathered over ``model`` (B x H x hd), the
      heads' partials reduce-scattered back into the column blocks
      ``wo``'s rows take (B x H x hd float32): no regroup, whether the
      heads divide the axis or not.  Elsewhere the partials are summed
      over ``seq``'s group.
    * ``ring`` (a ring buffer, :func:`attention_decode`): with ``seq``
      the rank holds the ring's slots from ``seq.rank * S_local`` of W =
      ``S_local * seq.size``; slot ``index % W`` is written on the rank
      whose block holds it, and each slot is read by its position.
    """
    B, hd = x.shape[0], cfg.resolved_head_dim
    H, K = cfg.n_heads, cfg.n_kv_heads
    pos = torch.full((1,), index, dtype=torch.int32, device=x.device)
    q, s, e, all_heads = _decode_q(p, x, cfg, split, seq)
    kv_sharded = model_split(p["wk"]) is not None
    k = _mm(x, take(p["wk"]))
    v = _mm(x, take(p["wv"]))
    if "bk" in p:
        k, v = k + take(p["bk"]), v + take(p["bv"])
    k = k.reshape(B, 1, -1, hd)
    v = v.reshape(B, 1, -1, hd)
    if "q_norm" in p:
        q = rmsnorm(q, p["q_norm"], cfg.norm_eps)
        k = rmsnorm(k, p["k_norm"], cfg.norm_eps)
    if use_rope:
        q = rotary(q, pos, cfg.rope_theta)
        k = rotary(k, pos, cfg.rope_theta)
    S = cache_k.shape[1]
    start = seq.rank * S if seq is not None else 0
    total = S * (seq.size if seq is not None else 1)
    slot = index % total if ring else index
    write_kv(cache_k, cache_v, k, v,
             slot - start if start <= slot < start + S else None)
    kc, vc = (cache_k, cache_v) if all_heads or kv_sharded else \
        _kv_for_heads(cache_k, cache_v, s, e, H // K)
    mask = _decode_mask(S, start, total, index, window, ring, x.device)
    y = _decode_out(p, q, kc, vc, mask, cfg, split, seq, all_heads)
    return y, cache_k, cache_v


def _decode_q(p, x, cfg: ModelConfig, split, seq):
    """One decode row's query on this rank's heads, ``(q, start, end,
    all_heads)``: q (B, 1, end - start, hd) of heads ``[start, end)``;
    ``all_heads`` where every head's query is needed (no ``model``
    split, or the cache's sequence on ``model``: q's column blocks
    all-gathered), else the rank's heads (regrouped into whole heads
    where they do not divide the axis)."""
    B, hd, H = x.shape[0], cfg.resolved_head_dim, cfg.n_heads
    q = _mm(x, take(p["wq"]))
    if "bq" in p:
        q = q + take(p["bq"])
    all_heads = split is None or (seq is not None and seq.axes == ("model",))
    if split is not None and all_heads:
        q = gather_dim(q, -1, split.group)
        s, e = 0, H
    elif split is not None:
        s, e = head_range(H, split)
        if H % split.size:
            q = regroup(q, H, hd, split)
    else:
        s, e = 0, H
    return q.reshape(B, 1, e - s, hd), s, e, all_heads


def _decode_out(p, q, kc, vc, mask, cfg: ModelConfig, split, seq,
                all_heads: bool) -> torch.Tensor:
    """The attention of :func:`_decode_q`'s ``q`` over the rank's keys
    and values ``kc``/``vc`` (the heads q reads; with ``seq``, the rank's
    block of positions: the combine, :func:`_sdpa_partial`), through
    ``wo`` (row-parallel and summed over ``model`` under ``split``)."""
    B, hd, H = q.shape[0], cfg.resolved_head_dim, cfg.n_heads
    if seq is None:
        out = _sdpa(q, kc, vc, mask, cfg)
    else:
        out = _sdpa_partial(q, kc, vc, mask, seq.group)
        if all_heads and split is not None:
            out = reduce_scatter_dim(out.reshape(B, 1, H * hd), -1,
                                     split.group)
        else:
            out = out.contiguous()
            with collective():
                dist.all_reduce(out, group=seq.group)
        out = out.to(q.dtype)
    out = out.reshape(B, 1, -1)
    if split is not None and not all_heads and H % split.size:
        out = regroup(out, H, hd, split, to_heads=False)
    y = torch.matmul(out, take(p["wo"]))
    if split is not None:
        y = sum_to_replicated(y, split.group)
    return y


def cross_attention_decode(p, x: torch.Tensor, cfg: ModelConfig,
                           ck: torch.Tensor, cv: torch.Tensor,
                           seq=None) -> torch.Tensor:
    """Decode-time cross-attention of one row against the encoder's keys
    and values ``ck``/``cv`` (B, S_src, K, hd): no rotary, no mask, no
    norm of q (the reference's ``_cross_attention_cached``).  With
    ``wq`` sharded over ``model``, or ``seq`` (the cross cache's rows
    split as the self-attention cache's sequence is), on this rank's
    blocks as :func:`_attention_decode_tp`, without the new key: q the
    rank's heads (every head where ``seq`` is the ``model`` axis), ck/cv
    the rank's kv heads where ``wk`` is sharded, else those its heads
    read; over split rows the combine with every row valid; ``wo``
    row-parallel, summed over ``model``."""
    split = model_split(p["wq"])
    q, s, e, all_heads = _decode_q(p, x, cfg, split, seq)
    kc, vc = (ck, cv) if all_heads or model_split(p["wk"]) is not None \
        else _kv_for_heads(ck, cv, s, e, cfg.n_heads // cfg.n_kv_heads)
    return _decode_out(p, q, kc, vc, None, cfg, split, seq, all_heads)


def _sdpa_partial(q, k, v, mask, group) -> torch.Tensor:
    """This rank's partial of grouped attention over a sequence split
    over ``group`` (q:(B,Sq,H,hd), k/v:(B,Sk,K,hd) the rank's block of
    positions, ``mask`` its validity): ``_sdpa``'s scores, their maximum
    and sum of exponentials reduced over the group (a block wholly
    masked scores ``NEG_INF`` everywhere, and its exponentials vanish
    against the group's maximum, which position 0 makes a real score),
    the probabilities times the block's values in float32 (B,Sq,H,hd):
    the group's partials sum to ``_sdpa``'s output before its cast.
    ``mask`` None: every position is valid (the cross cache's rows)."""
    B, Sq, H, hd = q.shape
    K = k.shape[2]
    G = H // K if K else 1
    qg = q.reshape(B, Sq, K, G, hd).to(F32)
    scores = torch.einsum("bqkgh,bskh->bkgqs", qg, k.to(F32)) \
        * (1.0 / hd ** 0.5)
    if mask is not None:
        scores = torch.where(mask, scores, torch.full((), NEG_INF,
                                                      device=q.device))
    m = torch.amax(scores, dim=-1, keepdim=True)
    with collective():
        dist.all_reduce(m, op=dist.ReduceOp.MAX, group=group)
    ex = torch.exp(scores - m)
    total = torch.sum(ex, dim=-1, keepdim=True)
    with collective():
        dist.all_reduce(total, group=group)
    out = torch.einsum("bkgqs,bskh->bqkgh", ex / total, v.to(F32))
    return out.reshape(B, Sq, H, hd)


# ---------------------------------------------------------------------------
# Gated MLP
# ---------------------------------------------------------------------------

def mlp_defs(cfg: ModelConfig, d_ff: Optional[int] = None) -> Dict:
    d, f = cfg.d_model, d_ff or cfg.d_ff
    return {
        "wi_gate": ParamDef((d, f), ("embed", "mlp")),
        "wi_up": ParamDef((d, f), ("embed", "mlp")),
        "wo": ParamDef((f, d), ("mlp", "embed"),
                       scale=1.0 / max(1, (2 * cfg.n_layers)) ** 0.5),
    }


def mlp(p, x: torch.Tensor) -> torch.Tensor:
    """The gated MLP (:func:`gated_mlp`)."""
    return gated_mlp(x, p["wi_gate"], p["wi_up"], p["wo"])


def gated_mlp(x: torch.Tensor, w_gate, w_up, w_out) -> torch.Tensor:
    """``silu(x @ w_gate) * (x @ w_up) @ w_out``; column- then
    row-parallel when ``w_gate`` is sharded over ``model`` (the input's
    gradient summed over ``model``, the output summed over it)."""
    split = model_split(w_gate)
    if split is not None:
        x = replicated_to_partial(x, split.group)
    g = torch.matmul(x, take(w_gate))
    u = torch.matmul(x, take(w_up))
    h = F.silu(g.to(F32)).to(x.dtype) * u
    y = torch.matmul(h, take(w_out))
    return y if split is None else sum_to_replicated(y, split.group)


# ---------------------------------------------------------------------------
# Embedding / logits
# ---------------------------------------------------------------------------

def embed_defs(cfg: ModelConfig, v_pad: int) -> Dict:
    d = cfg.d_model
    defs = {"tok": ParamDef((v_pad, d), ("vocab", "embed"), init="embed")}
    if not cfg.tie_embeddings:
        defs["head"] = ParamDef((d, v_pad), ("embed", "vocab"))
    return defs


def embed(p, tokens: torch.Tensor) -> torch.Tensor:
    """The token embeddings; with the table's vocab sharded over
    ``model``, each rank looks up the tokens in its rows (the others
    zero) and the rows are summed over ``model``."""
    split = model_split(p["tok"])
    tok = take(p["tok"])
    if split is None:
        return tok[tokens]
    n = tok.shape[0]
    idx = tokens - split.rank * n
    inside = (idx >= 0) & (idx < n)
    y = tok[idx.clamp(0, n - 1)].masked_fill(~inside[..., None], 0)
    return sum_to_replicated(y, split.group)


def logits(p, x: torch.Tensor) -> torch.Tensor:
    """The logits; with the head's vocab sharded over ``model``, this
    rank's block of the vocab (:func:`vocab_split` says which)."""
    split = vocab_split(p)
    w = take(p["head"]) if "head" in p else take(p["tok"]).T
    if split is not None:
        x = replicated_to_partial(x, split.group)
    return torch.matmul(x, w)


def vocab_split(p):
    """The ``model`` split of the logits' vocab (its blocks in rank
    order), or None when the logits hold the whole vocab."""
    return model_split(p["head"] if "head" in p else p["tok"])
