"""The port's hybrid family (zamba2-1.2b, reduced: 4 mamba2 layers, the
weight-tied attention block after every 2, window 64) and K4's sliding
window against the JAX package.

Parameters come from the reference's ``init`` (loaded with
``params_from_jax``); tokens, activations and gradients are drawn with
numpy from a seed.  Sequences are 160 tokens, so the window of 64 bites
in the forward and the decode ring buffer (W = 64 slots) wraps.  The port
runs on the CPU, where attention takes K4's plain version and the scan
K5's.  Tolerances, with their reasons:

* float32 forward: 1e-4, as the other families
  (``tests/test_torch_models.py``; measured ~2e-5 at logits ~5);
* bf16 forward: the reference's bf16 criterion for an ssm path
  (``tests/test_models.py:126``: 1.5e-1 absolute, 5e-2 relative) and
  argmax agreement >= 0.9: the reference rounds the attention
  probabilities to bf16, the port keeps them in float32 (K4's
  arithmetic), and the scan sums in another order (measured 0.127 at
  logits ~4.8, relative RMS 0.015);
* loss 1e-5 relative, every gradient 1e-4 scaled by its largest
  magnitude, as the ssm and dense families
  (``tests/test_torch_train.py``), at an SSD chunk of 32: at the
  config's 256 the reference's own gradient is NaN past S = 64;
* the decode trajectory: the reference's ssm criteria against forward
  in bf16; in float32 (the ring buffers cast to float32) 1e-4 relative
  RMS; against the reference's own bf16 trajectory 2e-2 relative RMS;
* one train step with int8 moments: every payload within one code of
  the reference's, byte-equal when both are fed the same gradients;
* K4's plain version with a window, float32: 1e-5 against the
  reference's ``_sdpa`` with ``causal_mask(window=)`` and its
  ``blockwise_attention(window=)``, and its backward against
  ``jax.vjp`` of the former.
"""
import dataclasses
import functools
import re

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs import registry as ref_registry  # noqa: E402
from repro.configs.base import ParallelismConfig as RefParallel  # noqa: E402
from repro.models import layers as ref_layers  # noqa: E402
from repro.models.model import build as ref_build  # noqa: E402
from repro.train import optimizer as ref_opt  # noqa: E402
from repro.train.step import build_train_step as ref_step  # noqa: E402

from repro_torch.configs import registry  # noqa: E402
from repro_torch.configs.base import ParallelismConfig  # noqa: E402
from repro_torch.kernels.flash_attention import kernel as fa  # noqa: E402
from repro_torch.launch import serve as serve_cli  # noqa: E402
from repro_torch.launch import train as train_cli  # noqa: E402
from repro_torch.models.convert import (cache_from_jax,  # noqa: E402
                                        params_from_jax, params_to_numpy)
from repro_torch.models.model import build  # noqa: E402
from repro_torch.train.optimizer import AdamW, param_leaves  # noqa: E402
from repro_torch.train.step import build_train_step  # noqa: E402

ARCH = "zamba2-1.2b"
S = 160
#: the SSD chunk of the gradient tests (the reference's gradient is NaN
#: at the config's 256 past S = 64)
GRAD_CHUNK = 32
_JDT = {"float32": jnp.float32, "bfloat16": jnp.bfloat16}


def _with_chunk(cfg, chunk):
    return cfg if chunk is None else dataclasses.replace(
        cfg, ssm=dataclasses.replace(cfg.ssm, chunk=chunk))


@functools.lru_cache(maxsize=None)
def _ref(dtype, chunk):
    """The reference model and its (immutable) params, made once."""
    rm = ref_build(_with_chunk(ref_registry.get_reduced(ARCH), chunk))
    return rm, rm.init(jax.random.key(0), dtype=_JDT[dtype])


def _pair(dtype="float32", chunk=None):
    """(reference model, its params, the port's model with them), at the
    SSD scan's ``chunk`` when given."""
    rm, params = _ref(dtype, chunk)
    pm = params_from_jax(build(_with_chunk(registry.get_reduced(ARCH),
                                           chunk)),
                         jax.tree.map(np.asarray, params))
    return rm, params, pm


def _tokens(B, n, seed=1):
    return np.random.default_rng(seed).integers(0, 512, (B, n)).astype(
        np.int32)


def _batch(B=2, n=S, seed=3):
    toks = _tokens(B, n + 1, seed)
    return {"tokens": toks[:, :-1], "labels": toks[:, 1:]}


def _torch_batch(b):
    return {k: torch.from_numpy(v.astype(np.int64)) for k, v in b.items()}


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
    assert (cfg.family, cfg.n_layers, cfg.hybrid_attn_every,
            cfg.attn_window) == ("hybrid", 38, 6, 4096)


@pytest.mark.parametrize("reduced", [True, False])
def test_n_params_equals_reference(reduced):
    """The parameter count of the defs (nothing allocated) and the
    analytic count equal the reference's; at full size 1,173,459,072 in
    the defs (vocab padded to 32,768) and 1,170,310,912 analytic."""
    get, ref_get = ((registry.get_reduced, ref_registry.get_reduced)
                    if reduced else (registry.get, ref_registry.get))
    assert build(get(ARCH)).n_params() == ref_build(ref_get(ARCH)).n_params()
    assert get(ARCH).n_params() == ref_get(ARCH).n_params()
    if not reduced:
        assert build(get(ARCH)).n_params() == 1_173_459_072
        assert get(ARCH).n_params() == 1_170_310_912


# ------------------------------------------------------------ forward

@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_forward_matches_reference(dtype):
    rm, params, pm = _pair(dtype)
    toks = _tokens(2, S)
    ref = np.asarray(rm.forward(params, {"tokens": jnp.asarray(toks)})[0],
                     np.float32)
    out, aux = pm.forward({"tokens": torch.from_numpy(toks)})
    assert float(aux) == 0.0
    out = out.float().numpy()
    if dtype == "float32":
        np.testing.assert_allclose(out, ref, atol=1e-4, rtol=1e-4)
    else:
        np.testing.assert_allclose(out, ref, atol=1.5e-1, rtol=5e-2)
        assert np.mean(out.argmax(-1) == ref.argmax(-1)) >= 0.9


def test_the_window_bites_in_the_forward():
    """Without the window (attn_window 0) the forward at S = 160 is
    another function: the window is not a no-op at this length."""
    _, params, pm = _pair()
    toks = torch.from_numpy(_tokens(1, S))
    windowed = pm.forward({"tokens": toks})[0]
    pm.cfg = dataclasses.replace(pm.cfg, attn_window=0)
    full = pm.forward({"tokens": toks})[0]
    assert torch.equal(windowed[:, :64], full[:, :64])
    assert float((windowed[:, 64:] - full[:, 64:]).abs().max()) > 1e-3


def test_shared_block_runs_k4_with_the_window(monkeypatch):
    """Each of the n_layers // hybrid_attn_every sites reaches K4's
    autograd route once, causal with window ``attn_window``, forward and
    backward."""
    _, _, pm = _pair()
    seen = {"fwd": [], "bwd": []}
    fwd, bwd = fa.flash_attention, fa.flash_attention_backward

    def spy_fwd(*args, causal=True, window=0):
        seen["fwd"].append((causal, window))
        return fwd(*args, causal=causal, window=window)

    def spy_bwd(*args, causal=True, window=0):
        seen["bwd"].append((causal, window))
        return bwd(*args, causal=causal, window=window)

    monkeypatch.setattr(fa, "flash_attention", spy_fwd)
    monkeypatch.setattr(fa, "flash_attention_backward", spy_bwd)
    pm.requires_grad_(True)
    loss = pm.loss(_torch_batch(_batch(B=1, n=96)), remat="block")
    loss.backward()
    assert seen == {"fwd": [(True, 64)] * 2, "bwd": [(True, 64)] * 2}


@pytest.mark.parametrize("remat", ["none", "block"])
def test_loss_and_grads_match_reference(remat):
    """The loss and every gradient, the shared block's (summed over its
    sites) and the ssm weights' included.  At the config's chunk of 256
    the reference's own gradient is NaN past S = 64 (its segment sums
    over one long chunk overflow), so gradients are compared at chunk 32,
    as the ssm family's at 16 (``tests/test_torch_train.py``)."""
    rm, params, pm = _pair(chunk=GRAD_CHUNK)
    b = _batch(n=96)
    loss, g = jax.jit(jax.value_and_grad(rm.loss))(
        params, {k: jnp.asarray(v) for k, v in b.items()})
    pm.requires_grad_(True)
    mine = pm.loss(_torch_batch(b), remat=remat)
    names, ps = zip(*pm.named_parameters())
    grads = torch.autograd.grad(mine, ps)
    np.testing.assert_allclose(float(mine), float(loss), rtol=1e-5)
    want = _named_grads(g, pm.cfg)
    for n, gp in zip(names, grads):
        scale = float(want[n].abs().max())
        np.testing.assert_allclose(gp.numpy(), want[n].numpy(),
                                   atol=1e-4 * max(scale, 1.0), rtol=1e-4,
                                   err_msg=n)
    got = dict(zip(names, grads))
    for n in ("shared.attn.wq", "shared.attn.wk", "shared.attn.wv",
              "shared.attn.wo", "shared.mlp.wi_gate", "shared.mlp.wo",
              "shared.ln1", "blocks.3.ssm.wx", "blocks.0.ssm.A_log"):
        assert float(got[n].abs().max()) > 0, n


# ------------------------------------------------------------ prefill, decode

def test_prefill_is_forward_and_leaves_the_cache():
    _, _, pm = _pair("bfloat16")
    toks = torch.from_numpy(_tokens(2, S))
    cache = pm.init_cache(batch=2, s_max=S)
    logits, new_cache = pm.prefill({"tokens": toks}, cache)
    assert torch.equal(logits, pm.forward({"tokens": toks})[0])
    assert new_cache is cache and not any(t.any() for t in cache.values())


def test_cache_is_the_reference_ring():
    rm, _, pm = _pair("bfloat16")
    for s_max in (S, 32):
        ref = jax.tree.map(lambda a: (a.shape, a.dtype.name),
                           rm.init_cache(batch=2, s_max=s_max))
        mine = {k: (tuple(t.shape), str(t.dtype).split(".")[-1])
                for k, t in pm.init_cache(batch=2, s_max=s_max).items()}
        assert mine == ref
        assert mine["ak"][0] == (2, 2, min(s_max, 64), 4, 16)


@pytest.mark.parametrize("window", [0, 3])
def test_attention_decode_window_matches_reference(window):
    """``layers.attention_decode`` with and without a window (keys at or
    below ``index - window`` masked) against the reference's, on the
    same cache, at index 6 of 8 slots; the port writes the new key and
    value in place, as the reference's copy has them."""
    from repro_torch.models import layers as lyr
    _, params, pm = _pair()
    cfg = pm.cfg
    rng = np.random.default_rng(window)
    x = rng.standard_normal((2, 1, cfg.d_model)).astype(np.float32)
    ck, cv = (rng.standard_normal((2, 8, cfg.n_kv_heads, 16)).astype(
        np.float32) for _ in range(2))
    ref, rk, rv = ref_layers.attention_decode(
        params["shared"]["attn"], jnp.asarray(x), ref_registry.get_reduced(
            ARCH), cache_k=jnp.asarray(ck), cache_v=jnp.asarray(cv),
        index=jnp.int32(6), window=window)
    tk, tv = torch.from_numpy(ck), torch.from_numpy(cv)
    got, _, _ = lyr.attention_decode(pm["shared"]["attn"],
                                     torch.from_numpy(x), cfg, cache_k=tk,
                                     cache_v=tv, index=6, window=window)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), atol=1e-5,
                               rtol=1e-5)
    np.testing.assert_allclose(tk.numpy(), np.asarray(rk), atol=1e-6)
    np.testing.assert_allclose(tv.numpy(), np.asarray(rv), atol=1e-6)


def _port_decode(pm, toks, cache):
    outs = []
    for t in range(toks.shape[1]):
        logits, cache = pm.decode_step(cache, torch.from_numpy(
            toks[:, t:t + 1]), t)
        outs.append(logits[:, 0].float().numpy())
    return np.stack(outs, axis=1), cache


def _ref_decode(rm, params, toks, steps=None):
    step = jax.jit(rm.decode_step)
    cache = rm.init_cache(batch=toks.shape[0], s_max=toks.shape[1])
    outs = []
    for t in range(steps or toks.shape[1]):
        logits, cache = step(params, cache, jnp.asarray(toks[:, t:t + 1]),
                             jnp.int32(t))
        outs.append(np.asarray(logits[:, 0], np.float32))
    return np.stack(outs, axis=1), cache


def test_decode_trajectory_wraps_the_ring_and_matches_forward():
    """Token by token from zero state over 160 tokens (the 64-slot ring
    wraps twice): bf16 against the port's forward at the reference's ssm
    criteria and against the reference's own trajectory; float32, with
    the ring buffers cast to float32 (the reference's bf16 cache makes
    float32 decode raise), against forward at 1e-4."""
    rm, params, pm = _pair("bfloat16")
    toks = _tokens(2, S, seed=4)
    dec, cache = _port_decode(pm, toks, pm.init_cache(batch=2, s_max=S))
    assert cache["ak"].shape[2] == 64 and cache["ak"].any()
    full = pm.forward({"tokens": torch.from_numpy(toks)})[0].float().numpy()
    np.testing.assert_allclose(dec, full, atol=1.5e-1, rtol=5e-2)
    assert np.mean(dec.argmax(-1) == full.argmax(-1)) >= 0.9
    ref, _ = _ref_decode(rm, params, toks)
    assert np.linalg.norm(dec - ref) / np.linalg.norm(ref) <= 2e-2

    pm.float()
    cache = {k: v.float() for k, v in pm.init_cache(batch=2,
                                                   s_max=S).items()}
    dec, _ = _port_decode(pm, toks, cache)
    full = pm.forward({"tokens": torch.from_numpy(toks)})[0].numpy()
    assert np.linalg.norm(dec - full) / np.linalg.norm(full) <= 1e-4
    assert np.mean(dec.argmax(-1) == full.argmax(-1)) >= 0.9


def test_decode_on_reference_cache_matches_reference():
    """The reference's cache after 100 decode steps (the ring wrapped),
    converted, drives the port's decode step to the reference's logits
    (bf16: 5e-2 at logits ~4, two bf16 ulps, as the dense family)."""
    rm, params, pm = _pair("bfloat16")
    toks = _tokens(2, 101, seed=6)
    ref, rcache = _ref_decode(rm, params, toks, steps=100)
    want, _ = jax.jit(rm.decode_step)(params, rcache,
                                      jnp.asarray(toks[:, 100:]),
                                      jnp.int32(100))
    cache = cache_from_jax(jax.tree.map(np.asarray, rcache))
    assert cache["ak"].dtype == torch.bfloat16
    got, _ = pm.decode_step(cache, torch.from_numpy(toks[:, 100:]), 100)
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(want, np.float32), atol=5e-2,
                               rtol=5e-2)


def test_float32_decode_raises_like_the_reference():
    """The attention cache is bf16 whatever the parameter type; the
    reference's ``dynamic_update_slice`` then raises TypeError, and so
    does the port."""
    rm, params, pm = _pair("float32")
    tok = np.zeros((1, 1), np.int32)
    with pytest.raises(TypeError):
        rm.decode_step(params, rm.init_cache(batch=1, s_max=4),
                       jnp.asarray(tok), jnp.int32(0))
    with pytest.raises(TypeError):
        pm.decode_step(pm.init_cache(batch=1, s_max=4),
                       torch.from_numpy(tok), 0)


# ------------------------------------------------------------ training

def test_train_step_matches_reference():
    """One float32 step of each package with block remat and int8
    moments: loss, grad norm and parameters agree, every int8 payload
    within one code of the reference's, at most one in a thousand off
    (at ``GRAD_CHUNK``, as the gradients)."""
    rm, params, pm = _pair(chunk=GRAD_CHUNK)
    b = _batch(B=2, n=96, seed=5)
    ropt = ref_opt.AdamW(lr=1e-3, state_dtype="int8")
    popt = AdamW(lr=1e-3, state_dtype="int8")
    rstep = jax.jit(ref_step(rm, RefParallel(remat="block"), ropt))
    pstep = build_train_step(pm, ParallelismConfig(remat="block"), popt)
    params, rs, rmet = rstep(params, ropt.init(params),
                             {k: jnp.asarray(v) for k, v in b.items()})
    _, ps, pmet = pstep(pm, popt.init(pm), _torch_batch(b))
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


def test_adamw_payloads_equal_reference():
    """AdamW over the reduced hybrid's leaves, 3 steps with the same
    gradients on both sides: int8 payloads byte-equal, scales within
    float32 rounding, parameters equal."""
    _, params, pm = _pair()
    ropt, popt = (ref_opt.AdamW(lr=1e-2, state_dtype="int8"),
                  AdamW(lr=1e-2, state_dtype="int8"))
    rs, ps = ropt.init(params), popt.init(pm)
    rng = np.random.default_rng(0)
    for _ in range(3):
        g = jax.tree.map(lambda p: jnp.asarray(
            rng.standard_normal(p.shape).astype(np.float32) * 1e-3), params)
        params, rs, _ = ropt.update(g, rs, params)
        _, ps, _ = popt.update(_named_grads(g, pm.cfg), ps, pm)
    for leaf in param_leaves(pm):
        for mine, ref in ((ps.m[leaf.path], _leaf(rs.m, leaf.path)),
                          (ps.v[leaf.path], _leaf(rs.v, leaf.path))):
            np.testing.assert_array_equal(mine.q.numpy(), np.asarray(ref.q))
            np.testing.assert_allclose(mine.scale.numpy(),
                                       np.asarray(ref.scale), rtol=0,
                                       atol=1e-7)
    for r, mine in zip(jax.tree.leaves(params),
                       jax.tree.leaves(params_to_numpy(pm))):
        np.testing.assert_allclose(mine, np.asarray(r), rtol=0, atol=1e-7)


def test_shared_leaves_are_single_and_their_norms_not_decayed():
    """The optimizer sees the reference's leaves: one ``shared/...``
    leaf per weight of the tied block (not one per site), the stacked
    ``blocks/...`` leaves.  Decay follows the leaf's shape as in the
    reference (``p.ndim >= 2``): the stacked (L, d) ``blocks/ln1``
    decays, the shared block's 1-D norms and ``final_norm`` do not."""
    _, params, pm = _pair()
    flat = jax.tree_util.tree_flatten_with_path(params)[0]
    leaves = param_leaves(pm)
    assert [lf.path for lf in leaves] == [
        "/".join(p.key for p in path) for path, _ in flat]
    by_path = {lf.path: lf for lf in leaves}
    assert by_path["shared/attn/wq"].names == ("shared.attn.wq",)
    assert by_path["blocks/ln1"].shape == (4, 64)
    before = {n: p.detach().clone() for n, p in pm.named_parameters()}
    opt = AdamW(lr=0.5, weight_decay=0.1)
    opt.update({n: torch.zeros_like(p) for n, p in pm.named_parameters()},
               opt.init(pm), pm)
    kept = {"final_norm", "shared.ln1", "shared.ln2"}
    for n, p in pm.named_parameters():
        if n in kept:
            assert torch.equal(p, before[n]), n
        else:
            torch.testing.assert_close(p, before[n] * (1 - 0.5 * 0.1))


# ------------------------------------------------------------ K4's window

def _qkv(B, n, H, K, hd, seed=0):
    rng = np.random.default_rng(seed)
    return [rng.standard_normal(shape).astype(np.float32)
            for shape in ((B, n, H, hd), (B, n, K, hd), (B, n, K, hd),
                          (B, n, H, hd))]


@pytest.mark.parametrize("window", [1, 37, 64, 96, 1000])
def test_plain_window_matches_reference(window):
    """K4's plain version with a window against the reference's
    ``_sdpa`` with ``causal_mask(window=)`` and its
    ``blockwise_attention(window=)``; its backward against ``jax.vjp``
    of the former.  A window >= S is the causal mask alone, bit for
    bit."""
    n = 96
    q, k, v, do = _qkv(2, n, 4, 2, 16)
    mask = ref_layers.causal_mask(n, n, window=window)

    def ref_fn(q, k, v):
        return ref_layers._sdpa(q, k, v, mask, None)

    ref, vjp = jax.vjp(ref_fn, *(jnp.asarray(a) for a in (q, k, v)))
    blk = ref_layers.blockwise_attention(
        *(jnp.asarray(a) for a in (q, k, v)), causal=True, window=window,
        q_block=32)
    tq, tk, tv, tdo = (torch.from_numpy(a) for a in (q, k, v, do))
    out = fa.flash_attention_plain(tq, tk, tv, True, window)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), atol=1e-5,
                               rtol=1e-5)
    np.testing.assert_allclose(out.numpy(), np.asarray(blk), atol=1e-5,
                               rtol=1e-5)
    got = fa.flash_attention_backward_plain(tq, tk, tv, out, tdo, True,
                                            window)
    for g, w in zip(got, vjp(jnp.asarray(do))):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=1e-5,
                                   rtol=1e-5)
    if window >= n:
        assert torch.equal(out, fa.flash_attention_plain(tq, tk, tv, True))
        assert all(torch.equal(a, b) for a, b in zip(
            got, fa.flash_attention_backward_plain(tq, tk, tv, out, tdo,
                                                   True)))


def test_window_of_one_is_the_value_itself():
    """Window 1 leaves each query its own key: the output is v and the
    gradients reach only dv (dS is 0 for a single probability of 1)."""
    q, k, v, do = (torch.from_numpy(a) for a in _qkv(1, 40, 4, 4, 8))
    out = fa.flash_attention(q, k, v, causal=True, window=1).contiguous()
    torch.testing.assert_close(out, v, rtol=0, atol=1e-6)
    dq, dk, dv = fa.flash_attention_backward(q, k, v, out, do, causal=True,
                                             window=1)
    assert float(dq.abs().max()) <= 1e-6 and float(dk.abs().max()) <= 1e-6
    torch.testing.assert_close(dv, do, rtol=0, atol=1e-6)


@pytest.mark.parametrize("fn", ["forward", "backward", "mha"])
def test_window_without_causal_or_negative_raises(fn):
    q, k, v, do = (torch.from_numpy(a) for a in _qkv(1, 8, 2, 2, 8))
    call = {"forward": lambda **kw: fa.flash_attention(q, k, v, **kw),
            "backward": lambda **kw: fa.flash_attention_backward(
                q, k, v, q, do, **kw),
            "mha": lambda **kw: fa.FlashAttention.apply(
                q, k, v, kw["causal"], kw["window"])}[fn]
    with pytest.raises(ValueError):
        call(causal=False, window=4)
    with pytest.raises(ValueError):
        call(causal=True, window=-1)


# ------------------------------------------------------------ the CLIs

def test_cli_trains_zamba2_on_cpu(tmp_path, capsys):
    train_cli.main(["--arch", ARCH, "--steps", "3", "--batch", "2", "--seq",
                    "80", "--device", "cpu", "--ckpt-dir", str(tmp_path)])
    out = capsys.readouterr().out
    assert f"arch={ARCH}" in out and "3 steps in" in out
    losses = [float(x) for x in re.findall(r"loss ([0-9.eE+-]+)", out)]
    assert losses and all(np.isfinite(losses))


def test_cli_serves_zamba2_on_cpu(capsys):
    serve_cli.main(["--arch", ARCH, "--requests", "3", "--slots", "2",
                    "--prompt-len", "4", "--max-new", "3", "--device",
                    "cpu"])
    assert "3 requests, 21 tokens" in capsys.readouterr().out
