"""The port's encdec family (seamless-m4t-large-v2, reduced: 2 encoder
and 2 decoder layers, d 64, 4 | 4 heads of 16) and K4 with a key length
of its own (cross-attention, Sq != Sk) against the JAX package.

Parameters come from the reference's ``init`` (loaded with
``params_from_jax``); tokens and frame embeddings are drawn with numpy
from a seed, ``encdec_src_len(S)`` frames for S tokens (S 20 -> 16 and S
160 -> 20, both ragged against K4's tiles).  The port runs on the CPU,
where attention takes K4's plain version.

The reference's float32 encdec forward raises ``TypeError``: its
encoder scans over the blocks with the bf16 frame embeddings as the
carry, and the first block's float32 weights promote it to float32.  The
float32 cases therefore hold the port against the reference's own blocks
with the encoder's scan unrolled (``_ref_encode``: ``_attn_block`` per
layer, then ``enc_norm``), and its own ``run_decoder``, ``rmsnorm`` and
``logits`` after it; the bf16 cases against its ``forward``, ``prefill``
and ``decode_step`` themselves.  Tolerances, with their reasons:

* float32 forward and ``run_encoder``: 1e-4, as the other families
  (``tests/test_torch_models.py``);
* bf16 forward: the reference's bf16 criterion of
  ``tests/test_torch_hybrid.py`` (1.5e-1 absolute, 5e-2 relative, argmax
  agreement >= 0.9): the reference rounds the attention probabilities to
  bf16, the port keeps them in float32 (K4's arithmetic);
* cross-attention (``layers.attention(kv_x=)``) and K4's plain version
  and its backward at Sq != Sk, float32: 1e-5, as the window's
  (``tests/test_torch_hybrid.py``);
* loss 1e-5 relative, every gradient 1e-4 scaled by its largest
  magnitude, as ``tests/test_torch_hybrid.py``;
* prefill's keys and values (self and cross) against the reference's:
  the bf16 forward's criterion and a relative RMS of 2e-2, the hybrid
  family's bound against the reference's own bf16 trajectory: past the
  first layer they carry the attention's rounding difference (layer 0's
  agree to 3e-5, layer 1's differ by up to 0.078, relative RMS 1.3e-2);
  decode at
  index S on the reference's converted cache: 5e-2, as the dense family;
  against forward on the extended sequence: 1e-2, the reference's own
  (``tests/test_models.py:79``);
* one train step with int8 moments: every payload within one code of
  the reference's; fed the same gradients, byte-equal, with torch's CPU
  ``sqrt`` replaced by numpy's (``test_adamw_payloads_equal_reference``:
  torch's is not always correctly rounded on the CPU, XLA's and numpy's
  are);
* ``lm_batch_source``: bitwise, three batches.
"""
import dataclasses
import functools
import re
import types

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs import registry as ref_registry  # noqa: E402
from repro.configs.base import ParallelismConfig as RefParallel  # noqa: E402
from repro.launch.train import lm_batch_source as ref_batches  # noqa: E402
from repro.models import layers as ref_layers  # noqa: E402
from repro.models import transformer as ref_tfm  # noqa: E402
from repro.models.model import build as ref_build  # noqa: E402
from repro.train import optimizer as ref_opt  # noqa: E402
from repro.train.step import build_train_step as ref_step  # noqa: E402

from repro_torch.configs import registry  # noqa: E402
from repro_torch.configs.base import ParallelismConfig  # noqa: E402
from repro_torch.kernels.flash_attention import kernel as fa  # noqa: E402
from repro_torch.launch import serve as serve_cli  # noqa: E402
from repro_torch.launch import train as train_cli  # noqa: E402
from repro_torch.models import layers as lyr  # noqa: E402
from repro_torch.models import transformer as tfm  # noqa: E402
from repro_torch.models.convert import (cache_from_jax,  # noqa: E402
                                        params_from_jax, params_to_numpy)
from repro_torch.models.model import build  # noqa: E402
from repro_torch.models.params import padded_vocab  # noqa: E402
from repro_torch.train.optimizer import AdamW, param_leaves  # noqa: E402
from repro_torch.train.step import build_train_step  # noqa: E402
from test_torch_serve import \
    test_server_matches_reference as _server_check  # noqa: E402

ARCH = "seamless-m4t-large-v2"
_JDT = {"float32": jnp.float32, "bfloat16": jnp.bfloat16}


@functools.lru_cache(maxsize=None)
def _ref(dtype):
    """The reference model and its (immutable) params, made once."""
    rm = ref_build(ref_registry.get_reduced(ARCH))
    return rm, rm.init(jax.random.key(0), dtype=_JDT[dtype])


def _pair(dtype="float32"):
    """(reference model, its params, the port's model with them)."""
    rm, params = _ref(dtype)
    pm = params_from_jax(build(registry.get_reduced(ARCH)),
                         jax.tree.map(np.asarray, params))
    return rm, params, pm


def _batch(B=2, S=20, seed=3, labels=True):
    rng = np.random.default_rng(seed)
    toks = rng.integers(0, 512, (B, S + 1)).astype(np.int32)
    b = {"tokens": toks[:, :-1],
         "src_embeds": rng.standard_normal(
             (B, tfm.encdec_src_len(S), 64)).astype(np.float32)}
    if labels:
        b["labels"] = toks[:, 1:]
    return b


def _jax(b):
    return {k: jnp.asarray(v) for k, v in b.items()}


def _torch(b):
    return {k: torch.from_numpy(v.astype(np.int64) if v.dtype == np.int32
                                else v) for k, v in b.items()}


def _ref_encode(params, cfg, src):
    """The reference's ``run_encoder`` with its scan unrolled: its own
    ``_attn_block`` per layer (non-causal, rotary), then ``enc_norm``."""
    x = jnp.asarray(src).astype(jnp.bfloat16)
    positions = jnp.arange(x.shape[1])
    for l in range(cfg.n_encoder_layers):
        lp = jax.tree.map(lambda a: a[l], params["enc_blocks"])
        x, _ = ref_tfm._attn_block(lp, x, cfg, positions, causal=False)
    return ref_layers.rmsnorm(x, params["enc_norm"], cfg.norm_eps)


def _ref_forward(params, cfg, b, remat="none"):
    """The reference's ``forward`` over ``_ref_encode``: (logits, aux)."""
    enc = _ref_encode(params, cfg, b["src_embeds"])
    x = ref_layers.embed(params["embed"], jnp.asarray(b["tokens"]))
    x, aux = ref_tfm.run_decoder(params, x, cfg, jnp.arange(x.shape[1]),
                                 causal=True, enc_out=enc, remat=remat)
    x = ref_layers.rmsnorm(x, params["final_norm"], cfg.norm_eps)
    return ref_layers.logits(params["embed"], x), aux


def _ref_loss(params, b, *, remat="none"):
    cfg = ref_registry.get_reduced(ARCH)
    logits, aux = _ref_forward(params, cfg, b, remat)
    return ref_tfm.cross_entropy(logits, b["labels"], cfg.vocab_size) + aux


def _leaf(tree, path):
    for k in path.split("/"):
        tree = tree[k]
    return tree


def _named_grads(gtree, cfg):
    gm = params_from_jax(build(cfg), jax.tree.map(np.asarray, gtree))
    return {n: p.detach() for n, p in gm.named_parameters()}


# ------------------------------------------------------------ the config

def test_registry_resolves_as_the_reference():
    assert dataclasses.asdict(registry.get(ARCH)) == dataclasses.asdict(
        ref_registry.get(ARCH))
    assert dataclasses.asdict(registry.get_reduced(ARCH)) == \
        dataclasses.asdict(ref_registry.get_reduced(ARCH))
    cfg = registry.get(ARCH)
    assert (cfg.family, cfg.n_layers, cfg.n_encoder_layers, cfg.d_model,
            cfg.n_heads, cfg.n_kv_heads, cfg.resolved_head_dim) == \
        ("encdec", 24, 24, 1024, 16, 16, 64)


@pytest.mark.parametrize("reduced", [True, False])
def test_n_params_equals_reference(reduced):
    """The defs' count (nothing allocated) and the analytic count equal
    the reference's; at full size 2,038,556,672 in the defs (vocab padded
    to 258,048) and 2,034,783,232 analytic."""
    get, ref_get = ((registry.get_reduced, ref_registry.get_reduced)
                    if reduced else (registry.get, ref_registry.get))
    assert build(get(ARCH)).n_params() == ref_build(ref_get(ARCH)).n_params()
    assert get(ARCH).n_params() == ref_get(ARCH).n_params()
    if not reduced:
        assert build(get(ARCH)).n_params() == 2_038_556_672
        assert get(ARCH).n_params() == 2_034_783_232


def test_cross_defs_have_no_bias_and_the_audio_family_is_encdec():
    """The cross block has ``lnc`` and ``cross`` (no qkv bias even where
    the self-attention has one, as the reference's ``attention_defs(
    cross=True)``); the "audio" family builds the same tree."""
    cfg = dataclasses.replace(registry.get_reduced(ARCH), qkv_bias=True)
    ref = ref_tfm.param_defs(dataclasses.replace(
        ref_registry.get_reduced(ARCH), qkv_bias=True))
    mine = tfm.param_defs(cfg)
    assert sorted(mine) == sorted(ref) == sorted(
        ["final_norm", "embed", "enc_blocks", "enc_norm", "blocks"])
    assert sorted(mine["blocks"].defs["cross"]) == sorted(
        ref["blocks"]["cross"]) == ["wk", "wo", "wq", "wv"]
    assert "bq" in mine["blocks"].defs["attn"]
    audio = build(dataclasses.replace(cfg, family="audio"))
    assert [n for n, _ in audio.named_parameters()] == \
        [n for n, _ in build(cfg).named_parameters()]


# ------------------------------------------------------------ forward

@pytest.mark.parametrize("S", [20, 160])
def test_forward_matches_reference_float32(S):
    """S 20 runs 16 frames, S 160 runs 20: cross-attention with Sq !=
    Sk, ragged against K4's tiles."""
    _, params, pm = _pair()
    b = _batch(S=S, labels=False)
    ref = np.asarray(_ref_forward(params, pm.cfg, _jax(b))[0])
    out, aux = pm.forward(_torch(b))
    assert out.shape == (2, S, padded_vocab(pm.cfg.vocab_size))
    assert float(aux) == 0.0
    np.testing.assert_allclose(out.numpy(), ref, atol=1e-4, rtol=1e-4)


def test_reference_float32_forward_raises():
    """Why the float32 cases unroll the reference's encoder: its own
    forward raises on the scan's carry type (bf16 frames in, float32 out
    of the first block)."""
    rm, params, _ = _pair()
    with pytest.raises(TypeError):
        rm.forward(params, _jax(_batch(labels=False)))


@pytest.mark.parametrize("S", [20, 160])
def test_forward_matches_reference_bf16(S):
    rm, params, pm = _pair("bfloat16")
    b = _batch(S=S, labels=False)
    ref = np.asarray(rm.forward(params, _jax(b))[0], np.float32)
    out = pm.forward(_torch(b))[0].float().numpy()
    np.testing.assert_allclose(out, ref, atol=1.5e-1, rtol=5e-2)
    assert np.mean(out.argmax(-1) == ref.argmax(-1)) >= 0.9


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_run_encoder_matches_reference(dtype):
    """The encoder alone over bf16 frames: float32 against the unrolled
    reference (1e-4), bf16 against the reference's ``run_encoder``."""
    _, params, pm = _pair(dtype)
    src = _batch(S=160)["src_embeds"]
    out, aux = tfm.run_encoder(pm, torch.from_numpy(src).to(torch.bfloat16),
                               pm.cfg)
    assert out.dtype == getattr(torch, dtype) and float(aux) == 0.0
    if dtype == "float32":
        ref = np.asarray(_ref_encode(params, pm.cfg, src))
        np.testing.assert_allclose(out.numpy(), ref, atol=1e-4, rtol=1e-4)
    else:
        ref = np.asarray(ref_tfm.run_encoder(
            params, jnp.asarray(src).astype(jnp.bfloat16), pm.cfg)[0],
            np.float32)
        np.testing.assert_allclose(out.float().numpy(), ref, atol=1.5e-1,
                                   rtol=5e-2)


# ------------------------------------------------------------ cross-attention

@pytest.mark.parametrize("use_rope", [False, True])
def test_cross_attention_layer_matches_reference(use_rope):
    """``layers.attention(kv_x=, kv_positions=)``: 20 query rows over 16
    key rows, non-causal, the cross weights of layer 1 (the model's
    cross-attention has no rotary; with it, the keys take
    ``kv_positions``)."""
    _, params, pm = _pair()
    rng = np.random.default_rng(11)
    x, kv = (rng.standard_normal((2, n, 64)).astype(np.float32)
             for n in (20, 16))
    kv_pos = np.arange(3, 19)
    ref = ref_layers.attention(
        jax.tree.map(lambda a: a[1], params["blocks"]["cross"]),
        jnp.asarray(x), pm.cfg, positions=jnp.arange(20), causal=False,
        kv_x=jnp.asarray(kv), kv_positions=jnp.asarray(kv_pos),
        use_rope=use_rope)
    got = lyr.attention(pm["blocks"][1]["cross"], torch.from_numpy(x),
                        pm.cfg, positions=torch.arange(20), causal=False,
                        kv_x=torch.from_numpy(kv),
                        kv_positions=torch.from_numpy(kv_pos),
                        use_rope=use_rope)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), atol=1e-5,
                               rtol=1e-5)
    with pytest.raises(ValueError, match="as many keys as queries"):
        lyr.attention(pm["blocks"][1]["cross"], torch.from_numpy(x), pm.cfg,
                      positions=torch.arange(20), causal=True,
                      kv_x=torch.from_numpy(kv), use_rope=False)


def _qkv(B, Sq, Sk, H, K, hd, seed=0):
    rng = np.random.default_rng(seed)
    return [rng.standard_normal(shape).astype(np.float32)
            for shape in ((B, Sq, H, hd), (B, Sk, K, hd), (B, Sk, K, hd),
                          (B, Sq, H, hd))]


@pytest.mark.parametrize("Sq,Sk", [(37, 16), (37, 130), (20, 100),
                                   (100, 37), (64, 64)])
def test_plain_k4_with_its_own_key_length_matches_reference(Sq, Sk):
    """K4's plain version at Sq != Sk (non-causal, GQA 4 | 2) against the
    reference's ``_sdpa`` without a mask, and its backward against
    ``jax.vjp`` of it: dk and dv have the keys' length."""
    q, k, v, do = _qkv(2, Sq, Sk, 4, 2, 16, seed=Sq + Sk)
    ref, vjp = jax.vjp(lambda q, k, v: ref_layers._sdpa(q, k, v, None, None),
                       *(jnp.asarray(a) for a in (q, k, v)))
    tq, tk, tv, tdo = (torch.from_numpy(a) for a in (q, k, v, do))
    out = fa.flash_attention(tq, tk, tv, causal=False)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), atol=1e-5,
                               rtol=1e-5)
    got = fa.flash_attention_backward(tq, tk, tv, out.contiguous(), tdo,
                                      causal=False)
    for g, w, t in zip(got, vjp(jnp.asarray(do)), (tq, tk, tv)):
        assert g.shape == t.shape
        np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=1e-5,
                                   rtol=1e-5)


@pytest.mark.parametrize("fn", ["forward", "backward", "plain",
                                "plain_backward", "mha"])
def test_causal_with_another_key_length_raises(fn):
    q, k, v, do = (torch.from_numpy(a) for a in _qkv(1, 8, 12, 2, 2, 8))
    call = {"forward": lambda: fa.flash_attention(q, k, v, causal=True),
            "backward": lambda: fa.flash_attention_backward(
                q, k, v, q, do, causal=True),
            "plain": lambda: fa.flash_attention_plain(q, k, v, True),
            "plain_backward": lambda: fa.flash_attention_backward_plain(
                q, k, v, q, do, True),
            "mha": lambda: fa.FlashAttention.apply(q, k, v, True, 0)}[fn]
    with pytest.raises(ValueError, match="as many keys as queries"):
        call()


def test_model_reaches_k4_with_the_cross_shapes(monkeypatch):
    """Forward and backward reach K4 once per attention: the encoder's
    (16 | 16 rows, non-causal), each decoder layer's self-attention (20 |
    20, causal) and cross-attention (20 | 16, non-causal, window 0)."""
    _, _, pm = _pair()
    seen = {"fwd": [], "bwd": []}
    fwd, bwd = fa.flash_attention, fa.flash_attention_backward

    def spy_fwd(q, k, v, causal=True, window=0):
        seen["fwd"].append((q.shape[1], k.shape[1], causal, window))
        return fwd(q, k, v, causal=causal, window=window)

    def spy_bwd(q, k, v, out, dout, causal=True, window=0):
        seen["bwd"].append((q.shape[1], k.shape[1], causal, window))
        return bwd(q, k, v, out, dout, causal=causal, window=window)

    monkeypatch.setattr(fa, "flash_attention", spy_fwd)
    monkeypatch.setattr(fa, "flash_attention_backward", spy_bwd)
    pm.requires_grad_(True)
    pm.loss(_torch(_batch()), remat="none").backward()
    enc, self_, cross = (16, 16, False, 0), (20, 20, True, 0), \
        (20, 16, False, 0)
    assert seen["fwd"] == [enc, enc, self_, cross, self_, cross]
    assert sorted(seen["bwd"]) == sorted(seen["fwd"])


# ------------------------------------------------------------ loss, grads

@pytest.mark.parametrize("remat", ["none", "block"])
def test_loss_and_grads_match_reference(remat):
    """The loss and every gradient, the encoder's blocks, ``enc_norm``
    and every decoder layer's cross weights included, against
    ``jax.value_and_grad`` of the reference's loss over the unrolled
    encoder."""
    _, params, pm = _pair()
    b = _batch(S=24)
    loss, g = jax.jit(jax.value_and_grad(functools.partial(
        _ref_loss, remat=remat)))(params, _jax(b))
    pm.requires_grad_(True)
    mine = pm.loss(_torch(b), remat=remat)
    names, ps = zip(*pm.named_parameters())
    grads = torch.autograd.grad(mine, ps)
    np.testing.assert_allclose(float(mine.detach()), float(loss), rtol=1e-5)
    want = _named_grads(g, pm.cfg)
    for n, gp in zip(names, grads):
        scale = float(want[n].abs().max())
        np.testing.assert_allclose(gp.numpy(), want[n].numpy(),
                                   atol=1e-4 * max(scale, 1.0), rtol=1e-4,
                                   err_msg=n)
    got = dict(zip(names, grads))
    for n in [f"blocks.{l}.cross.{w}" for l in (0, 1)
              for w in ("wq", "wk", "wv", "wo")] + [
            "blocks.1.lnc", "enc_blocks.0.attn.wq", "enc_blocks.1.attn.wk",
            "enc_blocks.0.mlp.wi_up", "enc_norm", "blocks.0.attn.wv"]:
        assert float(got[n].abs().max()) > 0, n


# ------------------------------------------------------------ prefill, decode

def test_cache_defs_equal_reference():
    rm, _, pm = _pair("bfloat16")
    for s_max in (24, 200):
        ref = jax.tree.map(lambda a: (a.shape, a.dtype.name),
                           rm.init_cache(batch=2, s_max=s_max))
        mine = {k: (tuple(t.shape), str(t.dtype).split(".")[-1])
                for k, t in pm.init_cache(batch=2, s_max=s_max).items()}
        assert mine == ref
        assert mine["ck"][0] == (2, 2, tfm.encdec_src_len(s_max), 4, 16)


def test_prefill_matches_forward_and_the_reference_cache():
    """Prefill's logits equal forward's bitwise; its self keys and values
    and its cross keys and values match the reference's prefill.  The
    cross ones *replace* the cache's: ``encdec_src_len(160)`` = 20 rows
    where the cache of s_max 200 has 25, as in the reference."""
    rm, params, pm = _pair("bfloat16")
    b = _batch(S=160, labels=False)
    cache = pm.init_cache(batch=2, s_max=200)
    logits, new = pm.prefill(_torch(b), cache)
    assert torch.equal(logits, pm.forward(_torch(b))[0])
    _, rcache = rm.prefill(params, _jax(b), rm.init_cache(batch=2, s_max=200))
    assert cache["ck"].shape[2] == 25 and new["ck"].shape[2] == 20
    for name in ("k", "v", "ck", "cv"):
        assert tuple(new[name].shape) == rcache[name].shape, name
        assert new[name].dtype == torch.bfloat16
        got, want = new[name].float().numpy(), np.asarray(rcache[name],
                                                          np.float32)
        np.testing.assert_allclose(got, want, atol=1.5e-1, rtol=5e-2,
                                   err_msg=name)
        assert np.linalg.norm(got - want) / np.linalg.norm(want) <= 2e-2
    assert not new["k"][:, :, 160:].any()


@pytest.mark.parametrize("S", [20, 160])
def test_decode_matches_reference_and_forward(S):
    """The reference's own check (``tests/test_models.py:60``): decode at
    index S after prefill against forward on the extended sequence with
    the same frames (1e-2); and the port's decode step on the reference's
    converted cache against the reference's decode step (5e-2).  Decode
    reads prefill's ``encdec_src_len(S)`` cross rows, not the cache's
    ``encdec_src_len(S + 40)``."""
    rm, params, pm = _pair("bfloat16")
    b = _batch(S=S, labels=False)
    nxt = np.full((2, 1), 3, np.int32)
    _, cache = pm.prefill(_torch(b), pm.init_cache(batch=2, s_max=S + 40))
    dec, _ = pm.decode_step(cache, torch.from_numpy(nxt), S)
    ext = dict(b, tokens=np.concatenate([b["tokens"], nxt], axis=1))
    full = pm.forward(_torch(ext))[0]
    np.testing.assert_allclose(dec[:, 0].float().numpy(),
                               full[:, -1].float().numpy(), atol=1e-2,
                               rtol=1e-2)
    _, rcache = rm.prefill(params, _jax(b),
                           rm.init_cache(batch=2, s_max=S + 40))
    want, _ = rm.decode_step(params, rcache, jnp.asarray(nxt), jnp.int32(S))
    got, _ = pm.decode_step(cache_from_jax(jax.tree.map(np.asarray, rcache)),
                            torch.from_numpy(nxt), S)
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(want, np.float32), atol=5e-2,
                               rtol=5e-2)


def test_server_matches_reference():
    """``Server`` prefills token by token through the decode step, as
    the reference's, so it decodes against the zero cross cache of
    ``init_cache`` and never runs the encoder (ROADMAP.md, Queue 3).
    The port's tokens and per-step logits against the reference's,
    under ``tests/test_torch_serve.py``'s criteria."""
    _server_check(ARCH)


# ------------------------------------------------------------ batches

def test_lm_batch_source_equals_reference():
    """Three batches bitwise: tokens, labels, and ``encdec_src_len(seq)``
    frame embeddings (bf16) drawn after the tokens."""
    cfg = registry.get_reduced(ARCH)
    pm = build(cfg).init(seed=0, device="cpu")
    mine = train_cli.lm_batch_source(pm, 3, 160, seed=7)
    ref = ref_batches(ref_build(ref_registry.get_reduced(ARCH)), 3, 160,
                      seed=7)
    for _ in range(3):
        got, want = mine(), ref()
        assert set(got) == set(want) == {"tokens", "labels", "src_embeds"}
        assert got["src_embeds"].shape == (3, 20, 64)
        assert got["src_embeds"].dtype == torch.bfloat16
        for k in want:
            np.testing.assert_array_equal(
                got[k].float().numpy() if k == "src_embeds"
                else got[k].numpy(), np.asarray(want[k], np.float32)
                if k == "src_embeds" else np.asarray(want[k]), err_msg=k)


# ------------------------------------------------------------ training

def test_train_step_matches_reference():
    """One float32 step of each package with block remat and int8
    moments (the reference's step around its loss over the unrolled
    encoder): loss, grad norm and parameters agree, every int8 payload
    within one code of the reference's, at most one in a thousand off."""
    _, params, pm = _pair()
    b = _batch(S=24, seed=5)
    ropt = ref_opt.AdamW(lr=1e-3, state_dtype="int8")
    popt = AdamW(lr=1e-3, state_dtype="int8")
    rstep = jax.jit(ref_step(types.SimpleNamespace(loss=_ref_loss),
                             RefParallel(remat="block"), ropt))
    pstep = build_train_step(pm, ParallelismConfig(remat="block"), popt)
    params, rs, rmet = rstep(params, ropt.init(params), _jax(b))
    _, ps, pmet = pstep(pm, popt.init(pm), _torch(b))
    np.testing.assert_allclose(float(pmet["loss"]), float(rmet["loss"]),
                               rtol=1e-5)
    np.testing.assert_allclose(float(pmet["grad_norm"]),
                               float(rmet["grad_norm"]), rtol=1e-4)
    for r, mine in zip(jax.tree.leaves(params),
                       jax.tree.leaves(params_to_numpy(pm))):
        np.testing.assert_allclose(mine, np.asarray(r), rtol=0, atol=1e-4)
    codes = differ = 0
    for leaf in param_leaves(pm):
        for mine, ref in ((ps.m[leaf.path], _leaf(rs.m, leaf.path)),
                          (ps.v[leaf.path], _leaf(rs.v, leaf.path))):
            d = np.abs(mine.q.numpy().astype(np.int32)
                       - np.asarray(ref.q).astype(np.int32))
            assert d.max() <= 1, leaf.path
            codes, differ = codes + d.size, differ + int((d > 0).sum())
    assert differ <= codes // 1000, (differ, codes)


def test_four_train_steps_track_reference():
    """Four float32 steps of each package on one fixed batch (block
    remat, int8 moments, lr 1e-2, where the reduced model fits the batch
    fast): the port's loss and grad norm follow the reference's at every
    step to 1e-4 relative, the float32 forward's tolerance.  The port's
    training dynamics are the reference's; how a loss moves over a few
    steps on one batch is the model's and the rate's."""
    _, params, pm = _pair()
    b = _batch(S=24, seed=5)
    ropt = ref_opt.AdamW(lr=1e-2, state_dtype="int8")
    popt = AdamW(lr=1e-2, state_dtype="int8")
    rstep = jax.jit(ref_step(types.SimpleNamespace(loss=_ref_loss),
                             RefParallel(remat="block"), ropt))
    pstep = build_train_step(pm, ParallelismConfig(remat="block"), popt)
    rs, ps = ropt.init(params), popt.init(pm)
    got, want = [], []
    for _ in range(4):
        params, rs, rmet = rstep(params, rs, _jax(b))
        pm, ps, pmet = pstep(pm, ps, _torch(b))
        want.append((float(rmet["loss"]), float(rmet["grad_norm"])))
        got.append((float(pmet["loss"]), float(pmet["grad_norm"])))
    np.testing.assert_allclose(got, want, rtol=1e-4)
    assert want[-1][0] < want[0][0]


def _rounded_sqrt(real_sqrt):
    """``torch.sqrt`` correctly rounded on the CPU: numpy's, which (as
    XLA's) rounds every float32 root correctly.  torch's own CPU sqrt
    does not always: a float32 root can land one ulp low."""
    def sqrt(x, *args, **kwargs):
        if args or kwargs or x.device.type != "cpu":
            return real_sqrt(x, *args, **kwargs)
        return torch.from_numpy(np.asarray(np.sqrt(x.detach().numpy())))
    return sqrt


def test_rounded_sqrt_is_correctly_rounded():
    """Why ``test_adamw_payloads_equal_reference`` swaps the sqrt: the
    fourth-root code of one ``embed/head`` element of its second step is
    ``sqrt(sqrt(x)) * 255`` with x = 0.0251017... (the block's second
    moment over its max), exactly 101.5 in IEEE float32, a rounding tie
    between codes 101 and 102.  numpy's float32 sqrt gives it; wherever
    torch's CPU sqrt lands one ulp low, the code drops to 101.  The
    check: numpy's roots, and so ``_rounded_sqrt``'s, are those of
    float64 rounded to float32; where torch's differ they differ by one
    ulp."""
    x = np.random.default_rng(0).random(1 << 16, dtype=np.float32)
    exact = np.sqrt(x.astype(np.float64)).astype(np.float32)
    np.testing.assert_array_equal(np.sqrt(x), exact)
    np.testing.assert_array_equal(
        _rounded_sqrt(torch.sqrt)(torch.from_numpy(x)).numpy(), exact)
    mine = torch.sqrt(torch.from_numpy(x)).numpy()
    off = mine != exact
    assert np.all(np.abs(mine[off].view(np.int32)
                         - exact[off].view(np.int32)) == 1)


def test_adamw_payloads_equal_reference(monkeypatch):
    """AdamW over the reduced encdec's leaves (``enc_blocks`` stacked as
    ``blocks``, in the reference's flatten order), 3 steps with the same
    gradients on both sides: int8 payloads byte-equal, scales within
    float32 rounding, parameters equal.  The port's update runs with a
    correctly rounded ``torch.sqrt`` (``_rounded_sqrt``): with torch's
    own CPU sqrt one fourth-root code of ``embed/head`` at step 2 is
    101.49999 where the reference's is the tie 101.5, and rounds to 101
    instead of 102 (``test_rounded_sqrt_is_correctly_rounded``)."""
    _, params, pm = _pair()
    ropt, popt = (ref_opt.AdamW(lr=1e-2, state_dtype="int8"),
                  AdamW(lr=1e-2, state_dtype="int8"))
    rs, ps = ropt.init(params), popt.init(pm)
    flat = jax.tree_util.tree_flatten_with_path(params)[0]
    assert [lf.path for lf in param_leaves(pm)] == [
        "/".join(p.key for p in path) for path, _ in flat]
    monkeypatch.setattr(torch, "sqrt", _rounded_sqrt(torch.sqrt))
    rng = np.random.default_rng(0)
    for _ in range(3):
        g = jax.tree.map(lambda p: jnp.asarray(
            rng.standard_normal(p.shape).astype(np.float32) * 1e-3), params)
        params, rs, _ = ropt.update(g, rs, params)
        _, ps, _ = popt.update(_named_grads(g, pm.cfg), ps, pm)
    for leaf in param_leaves(pm):
        for mine, ref in ((ps.m[leaf.path], _leaf(rs.m, leaf.path)),
                          (ps.v[leaf.path], _leaf(rs.v, leaf.path))):
            np.testing.assert_array_equal(mine.q.numpy(), np.asarray(ref.q),
                                          err_msg=leaf.path)
            np.testing.assert_allclose(mine.scale.numpy(),
                                       np.asarray(ref.scale), rtol=0,
                                       atol=1e-7)
    for r, mine in zip(jax.tree.leaves(params),
                       jax.tree.leaves(params_to_numpy(pm))):
        np.testing.assert_allclose(mine, np.asarray(r), rtol=0, atol=1e-7)


# ------------------------------------------------------------ the CLIs

def test_cli_trains_seamless_on_cpu(tmp_path, capsys):
    train_cli.main(["--arch", ARCH, "--steps", "3", "--batch", "2", "--seq",
                    "32", "--device", "cpu", "--ckpt-dir", str(tmp_path)])
    out = capsys.readouterr().out
    assert f"arch={ARCH}" in out and "3 steps in" in out
    losses = [float(x) for x in re.findall(r"loss ([0-9.eE+-]+)", out)]
    assert losses and all(np.isfinite(losses))


def test_cli_serves_seamless_on_cpu(capsys):
    serve_cli.main(["--arch", ARCH, "--requests", "3", "--slots", "2",
                    "--prompt-len", "4", "--max-new", "3", "--device",
                    "cpu"])
    assert "3 requests, 21 tokens" in capsys.readouterr().out
