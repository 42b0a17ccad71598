"""Model assembly: the port's twin of ``repro.models.transformer`` for
the families ported so far, dense (qwen3, deepseek-7b, qwen1.5,
llama3), moe (deepseek-moe, kimi-k2), ssm (mamba2), hybrid (zamba2) and
encoder (vit).

The reference scans over stacked per-layer params (``lax.scan``); the
port loops over the ``nn.ModuleList`` of layers.  ``remat != "none"``
recomputes each block in the backward
(``torch.utils.checkpoint.checkpoint(..., use_reentrant=False)`` per
block, as the reference's ``jax.checkpoint`` of the scan body).  The
other families (vlm, encdec/audio) raise ``NotImplementedError`` until
they are ported (ROADMAP.md).

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

from typing import Dict, Tuple

import torch
from torch.utils.checkpoint import checkpoint

from repro_torch.configs.base import ModelConfig
from repro_torch.models import layers as lyr
from repro_torch.models import moe as moe_mod
from repro_torch.models import ssm as ssm_mod
from repro_torch.models.params import ParamDef, padded_vocab, stack_defs

F32 = torch.float32
PORTED_FAMILIES = ("dense", "moe", "ssm", "hybrid", "encoder")


def check_family(cfg: ModelConfig) -> None:
    if cfg.family not in PORTED_FAMILIES:
        raise NotImplementedError(
            f"family {cfg.family!r} ({cfg.name}) is not ported yet; see "
            f"ROADMAP.md")


# ---------------------------------------------------------------------------
# Param defs
# ---------------------------------------------------------------------------

def _block_defs(cfg: ModelConfig, *, ssm: bool = False) -> Dict:
    d = {"ln1": lyr.rmsnorm_def(cfg.d_model)}
    if ssm:
        d["ssm"] = ssm_mod.ssm_defs(cfg)
        return d
    d["attn"] = lyr.attention_defs(cfg)
    d["ln2"] = lyr.rmsnorm_def(cfg.d_model)
    if cfg.moe is not None:
        d["moe"] = moe_mod.moe_defs(cfg)
    else:
        d["mlp"] = lyr.mlp_defs(cfg)
    return d


def param_defs(cfg: ModelConfig) -> Dict:
    check_family(cfg)
    defs: Dict = {"final_norm": lyr.rmsnorm_def(cfg.d_model),
                  "blocks": stack_defs(_block_defs(
                      cfg, ssm=cfg.family in ("ssm", "hybrid")),
                      cfg.n_layers)}
    if cfg.family == "hybrid":
        defs["shared"] = _block_defs(cfg)          # weight-tied attn block
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
                causal: bool, window: int = 0, use_rope: bool = True,
                return_kv: bool = False):
    h = lyr.rmsnorm(x, lp["ln1"], cfg.norm_eps)
    a = lyr.attention(lp["attn"], h, cfg, positions=positions, causal=causal,
                      window=window, use_rope=use_rope, return_kv=return_kv)
    if return_kv:
        a, k, v = a
    x = x + a
    h = lyr.rmsnorm(x, lp["ln2"], cfg.norm_eps)
    f, aux = _ffn(lp, h, cfg)
    x = x + f
    if return_kv:
        return x, aux, k, v
    return x, aux


def _ffn(lp, h: torch.Tensor, cfg: ModelConfig):
    """The block's feed-forward: (output, aux loss)."""
    if "moe" in lp:
        return moe_mod.moe_ffn(lp["moe"], h, cfg)
    return lyr.mlp(lp["mlp"], h), torch.zeros((), dtype=F32, device=h.device)


def _ssm_block(lp, x: torch.Tensor, cfg: ModelConfig) -> torch.Tensor:
    h = lyr.rmsnorm(x, lp["ln1"], cfg.norm_eps)
    return x + ssm_mod.ssm_block(lp["ssm"], h, cfg)


def run_decoder(params, x: torch.Tensor, cfg: ModelConfig, positions, *,
                causal: bool = True, use_rope: bool = True,
                remat: str = "none") -> Tuple[torch.Tensor, torch.Tensor]:
    """Run the main block stack. Returns (x, aux_loss)."""
    check_family(cfg)
    aux = torch.zeros((), dtype=F32, device=x.device)
    every = cfg.hybrid_attn_every if cfg.family == "hybrid" else 0
    for l, lp in enumerate(params["blocks"]):
        if cfg.family in ("ssm", "hybrid"):
            def body(h, lp=lp):
                return _ssm_block(lp, h, cfg), torch.zeros_like(aux)
        else:
            def body(h, lp=lp):
                return _attn_block(lp, h, cfg, positions, causal=causal,
                                   use_rope=use_rope)
        if remat != "none":
            x, a = checkpoint(body, x, use_reentrant=False)
        else:
            x, a = body(x)
        aux = aux + a
        if every and (l + 1) % every == 0:
            # the weight-tied block, outside the checkpoint as in the
            # reference: its activations are kept
            x, a = _attn_block(params["shared"], x, cfg, positions,
                               causal=True, window=cfg.attn_window)
            aux = aux + a
    return x, aux


# ---------------------------------------------------------------------------
# Forward passes (train / prefill)
# ---------------------------------------------------------------------------

def forward(params, cfg: ModelConfig, batch: Dict, *,
            remat: str = "none") -> Tuple[torch.Tensor, torch.Tensor]:
    """Full-sequence forward.  Returns (logits, aux_loss).

    batch keys by family:
      dense/moe/ssm/hybrid: tokens (B, S) int -> logits (B, S, V_pad)
      encoder:   patch_embeds (B, T, d) -> class logits (B, n_classes)
    """
    check_family(cfg)
    if cfg.family == "encoder":
        # bf16 embeddings plus the parameter: float32 parameters promote
        # the stream to float32, as jnp promotes it
        x = batch["patch_embeds"].to(torch.bfloat16) + params["pos_embed"]
        positions = torch.arange(x.shape[1], device=x.device)
        x, aux = run_decoder(params, x, cfg, positions, causal=False,
                             use_rope=False, remat=remat)
        x = lyr.rmsnorm(x, params["final_norm"], cfg.norm_eps)
        return torch.matmul(x[:, 0], params["head"]), aux
    x = lyr.embed(params["embed"], batch["tokens"])
    positions = torch.arange(x.shape[1], device=x.device)
    x, aux = run_decoder(params, x, cfg, positions, causal=True, remat=remat)
    x = lyr.rmsnorm(x, params["final_norm"], cfg.norm_eps)
    return lyr.logits(params["embed"], x), aux


def cross_entropy(logits: torch.Tensor, labels: torch.Tensor,
                  vocab_size: int) -> torch.Tensor:
    """Masked CE over a padded vocab. labels < 0 are ignored."""
    v_pad = logits.shape[-1]
    lf = logits.to(F32)
    if vocab_size and v_pad > vocab_size:
        pad_mask = torch.arange(v_pad, device=lf.device) >= vocab_size
        lf = lf.masked_fill(pad_mask, lyr.NEG_INF)
    lse = torch.logsumexp(lf, dim=-1)
    tgt = torch.gather(lf, -1, labels.clamp(0, v_pad - 1).long()[..., None])
    nll = lse - tgt[..., 0]
    mask = (labels >= 0).to(F32)
    return torch.sum(nll * mask) / torch.clamp(torch.sum(mask), min=1.0)


def loss_fn(params, cfg: ModelConfig, batch: Dict, *,
            remat: str = "none") -> torch.Tensor:
    """Next-token CE (batch: tokens and labels, (B, S) int), or for the
    encoder family the class CE (labels (B,) int), plus the blocks'
    auxiliary loss."""
    logits, aux = forward(params, cfg, batch, remat=remat)
    if cfg.family == "encoder":
        return cross_entropy(logits[:, None, :], batch["labels"][:, None],
                             cfg.n_classes) + aux
    return cross_entropy(logits, batch["labels"], cfg.vocab_size) + aux


# ---------------------------------------------------------------------------
# KV / state caches + decode
# ---------------------------------------------------------------------------

def cache_defs(cfg: ModelConfig, B: int, s_max: int) -> Dict:
    """Decode-state ParamDefs (init=zeros), as in the reference."""
    check_family(cfg)
    if cfg.family == "encoder":
        raise ValueError(f"no decode cache for family {cfg.family}")
    L = cfg.n_layers
    bf16, f32 = torch.bfloat16, torch.float32
    if cfg.family in ("dense", "moe"):
        hd, K = cfg.resolved_head_dim, cfg.n_kv_heads
        kv_axes = ("layers", "batch", "kv_seq", "act_kv", None)
        return {
            "k": ParamDef((L, B, s_max, K, hd), kv_axes, "zeros", dtype=bf16),
            "v": ParamDef((L, B, s_max, K, hd), kv_axes, "zeros", dtype=bf16),
        }
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


def _attention_decode_window(p, x: torch.Tensor, cfg: ModelConfig,
                             ck: torch.Tensor, cv: torch.Tensor, index: int):
    """Ring-buffer windowed decode: the new key and value go to slot
    ``index % W`` of ck/cv (B, W, K, hd), in place; slot j holds position
    ``index - (index - j) % W``, valid where that is >= 0."""
    B = x.shape[0]
    pos = torch.full((1,), index, dtype=torch.int32, device=x.device)
    q, k, v = lyr._project_qkv(p, x, x, cfg, pos, pos)
    W = ck.shape[1]
    lyr.write_kv(ck, cv, k, v, index % W)
    j = torch.arange(W, device=x.device)
    slot_pos = index - torch.remainder(index - j, W)
    mask = (slot_pos >= 0)[None, None, None, None, :]
    out = lyr._sdpa(q, ck, cv, mask, cfg)
    out = out.reshape(B, 1, cfg.n_heads * cfg.resolved_head_dim)
    return torch.matmul(out, p["wo"])


def decode_step(params, cfg: ModelConfig, cache: Dict, tokens: torch.Tensor,
                index: int) -> Tuple[torch.Tensor, Dict]:
    """One-token decode. tokens: (B, 1) int; index: the position.

    Returns (logits (B, 1, V_pad), new cache).  The dense and moe
    families update ``cache`` in place and return it (moe drops its
    auxiliary loss); the ssm family returns new state
    tensors (whose conv buffer takes the promoted type, as in the
    reference), and so does the hybrid family, whose ring buffers ``ak``
    and ``av`` it updates in place.  As in the reference, float32
    parameters raise ``TypeError`` on the bf16 attention cache.
    """
    check_family(cfg)
    index = int(index)
    x = lyr.embed(params["embed"], tokens)
    if cfg.family in ("dense", "moe"):
        for l, lp in enumerate(params["blocks"]):
            h = lyr.rmsnorm(x, lp["ln1"], cfg.norm_eps)
            a, _, _ = lyr.attention_decode(lp["attn"], h, cfg,
                                           cache_k=cache["k"][l],
                                           cache_v=cache["v"][l], index=index)
            x = x + a
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
                x = x + _attention_decode_window(
                    sp["attn"], h, cfg, cache["ak"][site],
                    cache["av"][site], index)
                h = lyr.rmsnorm(x, sp["ln2"], cfg.norm_eps)
                x = x + lyr.mlp(sp["mlp"], h)
        new_cache = {"h": torch.stack(hs), "conv": torch.stack(convs)}
        if every:
            new_cache["ak"], new_cache["av"] = cache["ak"], cache["av"]
    x = lyr.rmsnorm(x, params["final_norm"], cfg.norm_eps)
    return lyr.logits(params["embed"], x), new_cache


def prefill(params, cfg: ModelConfig, batch: Dict,
            cache: Dict) -> Tuple[torch.Tensor, Dict]:
    """Prefill: one forward pass that also fills the decode cache (dense
    and moe; positions past S are zero, as the reference pads them)."""
    check_family(cfg)
    if cfg.family in ("ssm", "hybrid"):
        logits, _ = forward(params, cfg, batch)
        return logits, cache

    x = lyr.embed(params["embed"], batch["tokens"])
    S = x.shape[1]
    positions = torch.arange(S, device=x.device)
    ks, vs = [], []
    for lp in params["blocks"]:
        x, _, k, v = _attn_block(lp, x, cfg, positions, causal=True,
                                 return_kv=True)
        ks.append(k)
        vs.append(v)
    x = lyr.rmsnorm(x, params["final_norm"], cfg.norm_eps)
    logits = lyr.logits(params["embed"], x)

    new_cache = dict(cache)
    for name, kv in (("k", ks), ("v", vs)):
        full = torch.zeros_like(cache[name])
        full[:, :, :S] = torch.stack(kv).to(full.dtype)
        new_cache[name] = full
    return logits, new_cache
