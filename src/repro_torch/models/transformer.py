"""Model assembly: the port's twin of ``repro.models.transformer`` for
every family of the pool: dense (qwen3, deepseek-7b, qwen1.5, llama3),
moe (deepseek-moe, kimi-k2), vlm (internvl2), encdec/audio (seamless),
ssm (mamba2), hybrid (zamba2) and encoder (vit).

The reference scans over stacked per-layer params (``lax.scan``); the
port loops over the ``nn.ModuleList`` of layers.  ``remat != "none"``
recomputes each block in the backward
(``torch.utils.checkpoint.checkpoint(..., use_reentrant=False)`` per
block, as the reference's ``jax.checkpoint`` of the scan body), under
the sharding rules the forward ran under.

The dense and moe families run the reference's sharded program when
their parameters are placed (``sharding.distribute_model``) and the
rules hold a mesh (``sharding.layout_rules``): the layers compute on
local blocks (``models/layers.py``, ``models/moe.py``); each block's
FSDP shards are gathered inside the body that ``_run`` checkpoints, so
remat gathers them again in the recompute; the loss is this rank's term
of the mean over the global batch, its CE over the logits' vocab block
(:func:`cross_entropy`), plus the moe's aux loss (already the mean over
the batch ranks) over their count; prefill writes the cache's local
blocks; decode takes the rank's block of the tokens and the cache's
blocks by the decode rules' spec (the sequence over ``model`` where the
kv heads do not divide it: the flash-decoding combine,
``layers.attention_decode``) and returns the rank's vocab block.  The
ssm and hybrid families run it where the rules place the SSD heads
(``ssm_inner`` on ``model``, ``sharding.runs_layout``): their blocks are
tensor-parallel over the heads (``models/ssm.py``), the hybrid's shared
block the dense one's tensor-parallel attention and MLP; decode takes
the rank's heads of the state ``h``, the whole conv buffer, and the
shared block's ring buffers by their spec (the rank's kv heads; where
the rules map ``kv_seq`` to ``data``, its block of the ring's slots and
the combine over them).

The vlm family is the dense stack with ``patch_embeds`` (B, P, d), cast
to the activations' type, in front of the token embeddings; positions
run over the P + S_text rows, and its cache and decode are the dense
ones.

The encdec family (``"audio"`` alike, as in the reference) runs a
bidirectional encoder (``enc_blocks``: non-causal, with rotary, under
remat like the decoder, then ``enc_norm``) over ``src_embeds`` (B,
S_src, d) taken as bf16, and a decoder whose blocks add, after the
self-attention, a cross-attention (``lnc``, ``cross``: non-causal, no
rotary, no qkv bias) from the S decoder rows to the S_src encoder rows
through K4 with Sq != Sk.  Its decode cache adds the cross keys and
values ``ck``/``cv`` of ``encdec_src_len(s_max)`` rows; prefill
*replaces* them with its own ``encdec_src_len(S)`` rows, projected from
the encoder's output with no norm, as the reference's does, and decode
reads whatever the cache holds (a plain one-row attention, no mask).

The hybrid family runs the ssm stack with one weight-tied attention
block (``shared``, unstacked) applied after every ``hybrid_attn_every``
ssm layers, causal with the sliding window ``attn_window``; the last
``n_layers % hybrid_attn_every`` layers follow without it.  As in the
reference, remat checkpoints the ssm layers and not the shared block,
whose activations are kept.  Its decode keeps, per site of the shared
block, a ring buffer of W = min(s_max, attn_window) keys and values
(slot = index % W).

The encoder family classifies ``patch_embeds`` (B, T, d): a learned
``pos_embed``, the blocks without causal mask or rotary, and a class
``head`` on the first token.  It has no decode state, as in the
reference: ``cache_defs`` raises ``ValueError``, and ``prefill`` and
``decode_step`` raise ``KeyError`` for the ``embed`` table it does not
have.

Caches are dicts of stacked tensors with the reference's shapes and
types.  Two differences of form, neither of result:

* dense and moe ``decode_step`` write the new key and value into the
  cache in place and return the same dict, and hybrid ``decode_step``
  writes its ring buffers in place (the reference returns updated
  copies; its callers keep only the new cache);
* ssm and hybrid ``prefill`` return forward's logits and the cache they
  were given, untouched — the reference does exactly this (its
  recurrent-state prefill lives in the serving loop, which prefills
  token by token).
"""
from __future__ import annotations

import contextlib
from typing import Dict, Tuple

import torch
import torch.distributed as dist
from torch.utils.checkpoint import checkpoint

from repro_torch.configs.base import FAMILIES, ModelConfig
from repro_torch.distributed.sharding import (axis_rank, current_rules,
                                              group_of, layout_rules,
                                              seq_split, use_rules,
                                              vocab_parallel_nll)
from repro_torch.models import layers as lyr
from repro_torch.models import moe as moe_mod
from repro_torch.models import ssm as ssm_mod
from repro_torch.models.params import ParamDef, padded_vocab, stack_defs
from repro_torch.models.ssm_sp import ssm_block_seq_parallel

F32 = torch.float32
#: the families with an encoder and cross-attention (the reference treats
#: both names alike)
ENCDEC = ("encdec", "audio")


# ---------------------------------------------------------------------------
# Param defs
# ---------------------------------------------------------------------------

def _block_defs(cfg: ModelConfig, *, cross: bool = False,
                ssm: bool = False) -> Dict:
    d = {"ln1": lyr.rmsnorm_def(cfg.d_model)}
    if ssm:
        d["ssm"] = ssm_mod.ssm_defs(cfg)
        return d
    d["attn"] = lyr.attention_defs(cfg)
    if cross:
        d["lnc"] = lyr.rmsnorm_def(cfg.d_model)
        d["cross"] = lyr.attention_defs(cfg, cross=True)
    d["ln2"] = lyr.rmsnorm_def(cfg.d_model)
    if cfg.moe is not None:
        d["moe"] = moe_mod.moe_defs(cfg)
    else:
        d["mlp"] = lyr.mlp_defs(cfg)
    return d


def param_defs(cfg: ModelConfig) -> Dict:
    if cfg.family not in FAMILIES:
        raise ValueError(cfg.family)
    defs: Dict = {"final_norm": lyr.rmsnorm_def(cfg.d_model),
                  "blocks": stack_defs(_block_defs(
                      cfg, cross=cfg.family in ENCDEC,
                      ssm=cfg.family in ("ssm", "hybrid")), cfg.n_layers)}
    if cfg.family == "hybrid":
        defs["shared"] = _block_defs(cfg)          # weight-tied attn block
    if cfg.family in ENCDEC:
        defs["enc_blocks"] = stack_defs(_block_defs(cfg),
                                        cfg.n_encoder_layers)
        defs["enc_norm"] = lyr.rmsnorm_def(cfg.d_model)
    if cfg.family == "encoder":
        defs["pos_embed"] = ParamDef((cfg.frontend_tokens, cfg.d_model),
                                     (None, "embed"), init="embed")
        defs["head"] = ParamDef((cfg.d_model, cfg.n_classes),
                                ("embed", "classes"))
    else:
        defs["embed"] = lyr.embed_defs(cfg, padded_vocab(cfg.vocab_size))
    return defs


# ---------------------------------------------------------------------------
# Stacks (full-sequence)
# ---------------------------------------------------------------------------

def _attn_block(lp, x: torch.Tensor, cfg: ModelConfig, positions, *,
                causal: bool, window: int = 0, enc_out=None,
                use_rope: bool = True, return_kv: bool = False):
    """One attention block: ``(x, aux)``; with ``return_kv``, ``(x, aux,
    kv)``, kv the self-attention's keys and values ``{"k", "v"}`` and, in
    a block with cross-attention, its keys and values ``{"ck", "cv"}``."""
    kv = {}
    h = lyr.rmsnorm(x, lp["ln1"], cfg.norm_eps)
    a = lyr.attention(lp["attn"], h, cfg, positions=positions, causal=causal,
                      window=window, use_rope=use_rope, return_kv=return_kv)
    if return_kv:
        a, kv["k"], kv["v"] = a
    x = x + a
    if "cross" in lp:
        h = lyr.rmsnorm(x, lp["lnc"], cfg.norm_eps)
        a = lyr.attention(lp["cross"], h, cfg, positions=positions,
                          causal=False, kv_x=enc_out, use_rope=False,
                          return_kv=return_kv)
        if return_kv:
            a, kv["ck"], kv["cv"] = a
        x = x + a
    h = lyr.rmsnorm(x, lp["ln2"], cfg.norm_eps)
    f, aux = _ffn(lp, h, cfg)
    x = x + f
    if return_kv:
        return x, aux, kv
    return x, aux


def _ffn(lp, h: torch.Tensor, cfg: ModelConfig):
    """The block's feed-forward: (output, aux loss)."""
    if "moe" in lp:
        return moe_mod.moe_ffn(lp["moe"], h, cfg)
    return lyr.mlp(lp["mlp"], h), torch.zeros((), dtype=F32, device=h.device)


def _ssm_block(lp, x: torch.Tensor, cfg: ModelConfig) -> torch.Tensor:
    """Pre-norm Mamba2 block.  Under sharding rules with a mesh that map
    ``act_seq`` to ``model`` (the ssm family's prefill layout), ``x`` is
    this rank's block of the sequence and the block runs sequence-parallel
    (``models/ssm_sp.py``), as the reference's ``_ssm_block`` routes it."""
    h = lyr.rmsnorm(x, lp["ln1"], cfg.norm_eps)
    rules = current_rules()
    if (rules.enabled and rules.mesh is not None
            and rules.mapping.get("act_seq") == "model"
            and cfg.family == "ssm"):
        return x + ssm_block_seq_parallel(lp["ssm"], h, cfg, rules.mesh)
    return x + ssm_mod.ssm_block(lp["ssm"], h, cfg)


def _run(body, x: torch.Tensor, remat: str):
    """One block, recomputed in the backward under remat.  The recompute
    runs under the sharding rules of the forward: on the card the
    backward runs in autograd's device thread, which sees no context
    variable of this one, and would otherwise take the local paths
    (the moe's over all experts, the SSD's over the whole sequence)."""
    if remat != "none":
        rules = current_rules()
        return checkpoint(body, x, use_reentrant=False, context_fn=lambda: (
            contextlib.nullcontext(), use_rules(rules)))
    return body(x)


def run_decoder(params, x: torch.Tensor, cfg: ModelConfig, positions, *,
                causal: bool = True, enc_out=None, use_rope: bool = True,
                remat: str = "none") -> Tuple[torch.Tensor, torch.Tensor]:
    """Run the main block stack (the decoder's blocks attend to
    ``enc_out`` too in the encdec family). Returns (x, aux_loss)."""
    aux = torch.zeros((), dtype=F32, device=x.device)
    every = cfg.hybrid_attn_every if cfg.family == "hybrid" else 0
    for l, lp in enumerate(params["blocks"]):
        if cfg.family in ("ssm", "hybrid"):
            def body(h, lp=lp):
                return _ssm_block(lp, h, cfg), torch.zeros_like(aux)
        else:
            def body(h, lp=lp):
                return _attn_block(lp, h, cfg, positions, causal=causal,
                                   enc_out=enc_out, use_rope=use_rope)
        x, a = _run(body, x, remat)
        aux = aux + a
        if every and (l + 1) % every == 0:
            # the weight-tied block, outside the checkpoint as in the
            # reference: its activations are kept
            x, a = _attn_block(params["shared"], x, cfg, positions,
                               causal=True, window=cfg.attn_window)
            aux = aux + a
    return x, aux


def run_encoder(params, src: torch.Tensor, cfg: ModelConfig,
                remat: str = "none") -> Tuple[torch.Tensor, torch.Tensor]:
    """The bidirectional encoder over frame embeddings (encdec family):
    non-causal blocks with rotary, then ``enc_norm``.  Returns (the
    encoder's output, its aux loss)."""
    positions = torch.arange(src.shape[1], device=src.device)
    x, aux = src, torch.zeros((), dtype=F32, device=src.device)
    for lp in params["enc_blocks"]:
        def body(h, lp=lp):
            return _attn_block(lp, h, cfg, positions, causal=False)
        x, a = _run(body, x, remat)
        aux = aux + a
    return lyr.rmsnorm(x, params["enc_norm"], cfg.norm_eps), aux


def _encode(params, cfg: ModelConfig, batch: Dict, remat: str = "none"):
    """The encoder's output for an encdec batch (its ``src_embeds`` taken
    as bf16, as the reference takes them), None for the other families."""
    if cfg.family not in ENCDEC:
        return None
    return run_encoder(params, batch["src_embeds"].to(torch.bfloat16), cfg,
                       remat)[0]


def _embed_inputs(params, cfg: ModelConfig, batch: Dict) -> torch.Tensor:
    """The decoder's input rows: the token embeddings, behind the vlm
    family's ``patch_embeds`` in the embeddings' type."""
    x = lyr.embed(params["embed"], batch["tokens"])
    if cfg.family == "vlm":
        x = torch.cat([batch["patch_embeds"].to(x.dtype), x], dim=1)
    return x


# ---------------------------------------------------------------------------
# Forward passes (train / prefill)
# ---------------------------------------------------------------------------

def forward(params, cfg: ModelConfig, batch: Dict, *,
            remat: str = "none") -> Tuple[torch.Tensor, torch.Tensor]:
    """Full-sequence forward.  Returns (logits, aux_loss).

    batch keys by family:
      dense/moe/ssm/hybrid: tokens (B, S) int -> logits (B, S, V_pad)
      vlm:       tokens (B, S - P) + patch_embeds (B, P, d) -> (B, S, V_pad)
      encdec:    src_embeds (B, S_src, d) + tokens (B, S) -> (B, S, V_pad)
      encoder:   patch_embeds (B, T, d) -> class logits (B, n_classes)
    """
    if cfg.family == "encoder":
        # bf16 embeddings plus the parameter: float32 parameters promote
        # the stream to float32, as jnp promotes it
        x = batch["patch_embeds"].to(torch.bfloat16) + params["pos_embed"]
        positions = torch.arange(x.shape[1], device=x.device)
        x, aux = run_decoder(params, x, cfg, positions, causal=False,
                             use_rope=False, remat=remat)
        x = lyr.rmsnorm(x, params["final_norm"], cfg.norm_eps)
        return torch.matmul(x[:, 0], params["head"]), aux
    enc_out = _encode(params, cfg, batch, remat)
    x = _embed_inputs(params, cfg, batch)
    positions = torch.arange(x.shape[1], device=x.device)
    x, aux = run_decoder(params, x, cfg, positions, causal=True,
                         enc_out=enc_out, remat=remat)
    x = lyr.rmsnorm(x, params["final_norm"], cfg.norm_eps)
    return lyr.logits(params["embed"], x), aux


def cross_entropy(logits: torch.Tensor, labels: torch.Tensor,
                  vocab_size: int, *, vocab=None,
                  batch_group=None) -> torch.Tensor:
    """Masked CE over a padded vocab. labels < 0 are ignored.

    ``vocab``: the ``model`` split (``lyr.vocab_split``) whose rank's
    block of the vocab ``logits`` are, in rank order; the padding mask is
    in global indices and the log-sum-exp and the target's logit go
    through the ``model`` group (``sharding.vocab_parallel_nll``).
    ``batch_group``: the labels are this rank's block of the batch, and
    the count of labels >= 0 is summed over the group, so that the loss
    is this rank's term of the masked mean over the global batch (the
    terms of the group's ranks sum to it)."""
    lf = logits.to(F32)
    offset = 0 if vocab is None else vocab.rank * logits.shape[-1]
    v_pad = logits.shape[-1] * (1 if vocab is None else vocab.size)
    if vocab_size and v_pad > vocab_size:
        pad_mask = torch.arange(offset, offset + lf.shape[-1],
                                device=lf.device) >= vocab_size
        lf = lf.masked_fill(pad_mask, lyr.NEG_INF)
    if vocab is None:
        lse = torch.logsumexp(lf, dim=-1)
        tgt = torch.gather(lf, -1,
                           labels.clamp(0, v_pad - 1).long()[..., None])
        nll = lse - tgt[..., 0]
    else:
        nll = vocab_parallel_nll(lf, labels, offset, v_pad, vocab)
    mask = (labels >= 0).to(F32)
    count = torch.sum(mask)
    if batch_group is not None:
        dist.all_reduce(count, group=batch_group)
    return torch.sum(nll * mask) / torch.clamp(count, min=1.0)


def loss_fn(params, cfg: ModelConfig, batch: Dict, *,
            remat: str = "none") -> torch.Tensor:
    """Next-token CE (batch: tokens and labels, (B, S) int), or for the
    encoder family the class CE (labels (B,) int), plus the blocks'
    auxiliary loss.  Under the reference's layout
    (``sharding.layout_rules``) the CE runs over the logits' vocab block
    and is this rank's term of the mean over the global batch (the aux
    loss, the same on every batch rank, its share)."""
    logits, aux = forward(params, cfg, batch, remat=remat)
    if cfg.family == "encoder":
        return cross_entropy(logits[:, None, :], batch["labels"][:, None],
                             cfg.n_classes) + aux
    rules = layout_rules(params)
    if rules is None:
        return cross_entropy(logits, batch["labels"], cfg.vocab_size) + aux
    group = group_of(rules.mesh, rules.batch_axes) if rules.batch_axes \
        else None
    # aux is the same mean on every batch rank: each adds its share
    n = axis_rank(rules.mesh, rules.batch_axes)[1]
    return cross_entropy(logits, batch["labels"], cfg.vocab_size,
                         vocab=lyr.vocab_split(params["embed"]),
                         batch_group=group) + aux / n


# ---------------------------------------------------------------------------
# KV / state caches + decode
# ---------------------------------------------------------------------------

def cache_defs(cfg: ModelConfig, B: int, s_max: int) -> Dict:
    """Decode-state ParamDefs (init=zeros), as in the reference."""
    if cfg.family == "encoder":
        raise ValueError(f"no decode cache for family {cfg.family}")
    L = cfg.n_layers
    bf16, f32 = torch.bfloat16, torch.float32
    if cfg.family in ("dense", "moe", "vlm") + ENCDEC:
        hd, K = cfg.resolved_head_dim, cfg.n_kv_heads
        kv_axes = ("layers", "batch", "kv_seq", "act_kv", None)
        defs = {
            "k": ParamDef((L, B, s_max, K, hd), kv_axes, "zeros", dtype=bf16),
            "v": ParamDef((L, B, s_max, K, hd), kv_axes, "zeros", dtype=bf16),
        }
        if cfg.family in ENCDEC:
            s_src = encdec_src_len(s_max)
            for name in ("ck", "cv"):
                defs[name] = ParamDef((L, B, s_src, K, hd), kv_axes, "zeros",
                                      dtype=bf16)
        return defs
    s = cfg.ssm
    d_in = s.expand * cfg.d_model
    nh = d_in // s.head_dim
    defs = {
        "h": ParamDef((L, B, nh, s.head_dim, s.d_state),
                      ("layers", "batch", "act_inner", None, None),
                      "zeros", dtype=f32),
        "conv": ParamDef((L, B, s.d_conv - 1, d_in + 2 * s.d_state),
                         ("layers", "batch", None, None), "zeros",
                         dtype=bf16),
    }
    if cfg.family == "hybrid":
        hd, K = cfg.resolved_head_dim, cfg.n_kv_heads
        kv_axes = ("layers", "batch", "kv_seq", "act_kv", None)
        sites = cfg.n_layers // cfg.hybrid_attn_every
        W = min(s_max, cfg.attn_window or s_max)
        defs["ak"] = ParamDef((sites, B, W, K, hd), kv_axes, "zeros",
                              dtype=bf16)
        defs["av"] = ParamDef((sites, B, W, K, hd), kv_axes, "zeros",
                              dtype=bf16)
    return defs


def encdec_src_len(seq_len: int) -> int:
    """Audio frames entering the encoder (8x downsampled frontend)."""
    return max(seq_len // 8, 16)


def _cross_attention_cached(p, x: torch.Tensor, cfg: ModelConfig,
                            ck: torch.Tensor, cv: torch.Tensor):
    """Decode-time cross-attention of one row against the encoder's keys
    and values ck/cv (B, S_src, K, hd): no rotary, no mask."""
    B = x.shape[0]
    hd = cfg.resolved_head_dim
    q = torch.matmul(x, p["wq"]).reshape(B, 1, cfg.n_heads, hd)
    out = lyr._sdpa(q, ck, cv, None, cfg)
    return torch.matmul(out.reshape(B, 1, cfg.n_heads * hd), p["wo"])


def decode_step(params, cfg: ModelConfig, cache: Dict, tokens: torch.Tensor,
                index: int) -> Tuple[torch.Tensor, Dict]:
    """One-token decode. tokens: (B, 1) int; index: the position.

    Returns (logits (B, 1, V_pad), new cache).  The dense, moe, vlm and
    encdec families update ``cache`` in place and return it (moe drops its
    auxiliary loss; encdec reads ``ck``/``cv`` and leaves them); the ssm
    family returns new state
    tensors (whose conv buffer takes the promoted type, as in the
    reference), and so does the hybrid family, whose ring buffers ``ak``
    and ``av`` it updates in place.  As in the reference, float32
    parameters raise ``TypeError`` on the bf16 attention cache.

    Under the reference's layout (``sharding.layout_rules``) ``tokens``
    are this rank's block by ``("batch", None)``, ``cache`` the blocks by
    the cache's spec (its sequence, or the hybrid ring's slots, split
    where the rules map ``kv_seq``, ``sharding.seq_split``), and the
    logits the rank's vocab block.
    """
    index = int(index)
    rules = layout_rules(params)
    seq = seq_split(rules) if rules is not None else None
    x = lyr.embed(params["embed"], tokens)
    if cfg.family in ("dense", "moe", "vlm") + ENCDEC:
        for l, lp in enumerate(params["blocks"]):
            h = lyr.rmsnorm(x, lp["ln1"], cfg.norm_eps)
            a, _, _ = lyr.attention_decode(lp["attn"], h, cfg,
                                           cache_k=cache["k"][l],
                                           cache_v=cache["v"][l], index=index,
                                           seq=seq)
            x = x + a
            if "cross" in lp:
                h = lyr.rmsnorm(x, lp["lnc"], cfg.norm_eps)
                x = x + _cross_attention_cached(lp["cross"], h, cfg,
                                                cache["ck"][l],
                                                cache["cv"][l])
            h = lyr.rmsnorm(x, lp["ln2"], cfg.norm_eps)
            x = x + _ffn(lp, h, cfg)[0]
        new_cache = cache
    else:
        every = cfg.hybrid_attn_every if cfg.family == "hybrid" else 0
        hs, convs = [], []
        for l, lp in enumerate(params["blocks"]):
            hh = lyr.rmsnorm(x, lp["ln1"], cfg.norm_eps)
            y, h, conv = ssm_mod.ssm_decode_step(lp["ssm"], hh, cfg,
                                                 cache["h"][l],
                                                 cache["conv"][l])
            x = x + y
            hs.append(h)
            convs.append(conv)
            if every and (l + 1) % every == 0:
                site, sp = (l + 1) // every - 1, params["shared"]
                h = lyr.rmsnorm(x, sp["ln1"], cfg.norm_eps)
                x = x + lyr.attention_decode(
                    sp["attn"], h, cfg, cache_k=cache["ak"][site],
                    cache_v=cache["av"][site], index=index, seq=seq,
                    ring=True)[0]
                h = lyr.rmsnorm(x, sp["ln2"], cfg.norm_eps)
                x = x + lyr.mlp(sp["mlp"], h)
        new_cache = {"h": torch.stack(hs), "conv": torch.stack(convs)}
        if every:
            new_cache["ak"], new_cache["av"] = cache["ak"], cache["av"]
    x = lyr.rmsnorm(x, params["final_norm"], cfg.norm_eps)
    return lyr.logits(params["embed"], x), new_cache


def prefill(params, cfg: ModelConfig, batch: Dict,
            cache: Dict) -> Tuple[torch.Tensor, Dict]:
    """Prefill: one forward pass that also fills the decode cache (dense,
    moe and vlm: positions past S are zero, as the reference pads them;
    encdec also replaces ``ck``/``cv`` with the cross keys and values of
    its ``encdec_src_len(S)`` encoder rows, those its cross-attention
    projected: the reference's ``einsum`` of the encoder's output, as the
    cross projections have no bias and no encdec config has qk_norm).

    Under the reference's layout the batch and ``cache`` are this rank's
    blocks (the cache's by its specs: batch over ``data``, ``act_kv``
    over ``model`` where the kv heads divide), the attention writes the
    rank's kv heads, or all of them where they are replicated, and the
    logits are the rank's block of the vocab."""
    if cfg.family in ("ssm", "hybrid"):
        logits, _ = forward(params, cfg, batch)
        return logits, cache

    enc_out = _encode(params, cfg, batch)
    x = _embed_inputs(params, cfg, batch)
    S = x.shape[1]
    positions = torch.arange(S, device=x.device)
    # each layer's keys and values go into the new cache as they come
    # (no per-layer list to stack: the cache's bytes once, not twice)
    new_cache = dict(cache)
    for name in ("k", "v"):
        new_cache[name] = torch.zeros_like(cache[name])
    cross = {"ck": [], "cv": []}
    for l, lp in enumerate(params["blocks"]):
        x, _, kv = _attn_block(lp, x, cfg, positions, causal=True,
                               enc_out=enc_out, return_kv=True)
        for name, t in kv.items():
            if name in cross:
                cross[name].append(t)
            else:
                new_cache[name][l, :, :S] = t.to(new_cache[name].dtype)
        del kv
    x = lyr.rmsnorm(x, params["final_norm"], cfg.norm_eps)
    logits = lyr.logits(params["embed"], x)
    if enc_out is not None:
        for name in ("ck", "cv"):
            new_cache[name] = torch.stack(cross[name]).to(cache[name].dtype)
    return logits, new_cache
