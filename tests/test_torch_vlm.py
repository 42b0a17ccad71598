"""The port's vlm family (internvl2-2b, reduced: 2 layers, d 64, 4 | 2
heads of 16, 8 patch tokens) against the JAX package.

Parameters come from the reference's ``init`` (loaded with
``params_from_jax``); tokens and patch embeddings are drawn with numpy
from a seed.  The batch holds P = 8 patch embeddings in front of the
text tokens, so positions and the causal mask run over P + S_text rows.
The port runs on the CPU, where attention takes K4's plain version.
Tolerances, with their reasons:

* float32 forward: 1e-4, as the other families
  (``tests/test_torch_models.py``);
* bf16 forward: the reference's bf16 criterion of
  ``tests/test_torch_hybrid.py`` (1.5e-1 absolute, 5e-2 relative, argmax
  agreement >= 0.9): the reference rounds the attention probabilities to
  bf16, the port keeps them in float32 (K4's arithmetic);
* loss 1e-5 relative, every gradient 1e-4 scaled by its largest
  magnitude, as ``tests/test_torch_hybrid.py``;
* prefill's keys and values against the reference's: the bf16 forward's
  criterion and a relative RMS of 2e-2, the hybrid family's bound
  against the reference's own bf16 trajectory (past the first layer they
  carry the attention's rounding difference); decode at index S on the
  reference's converted cache: 5e-2, as the dense family; decode against
  forward on the extended sequence: 1e-2, the reference's own
  (``tests/test_models.py:79``);
* one train step with int8 moments: every payload within one code of
  the reference's, byte-equal when both are fed the same gradients;
* ``lm_batch_source``: bitwise, three batches.
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
from repro.launch.train import lm_batch_source as ref_batches  # noqa: E402
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
from repro_torch.models.params import padded_vocab  # noqa: E402
from repro_torch.train.optimizer import AdamW, param_leaves  # noqa: E402
from repro_torch.train.step import build_train_step  # noqa: E402
from test_torch_serve import \
    test_server_matches_reference as _server_check  # noqa: E402

ARCH = "internvl2-2b"
P = 8                      # the reduced config's patch tokens
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


def _batch(B=2, S=24, seed=3, labels=True):
    """S rows: P patch embeddings, then S - P tokens; labels for all S."""
    rng = np.random.default_rng(seed)
    toks = rng.integers(0, 512, (B, S + 1)).astype(np.int32)
    b = {"tokens": toks[:, :S - P],
         "patch_embeds": rng.standard_normal((B, P, 64)).astype(np.float32)}
    if labels:
        b["labels"] = toks[:, 1:]
    return b


def _jax(b):
    return {k: jnp.asarray(v) for k, v in b.items()}


def _torch(b):
    return {k: torch.from_numpy(v.astype(np.int64) if v.dtype == np.int32
                                else v) for k, v in b.items()}


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
    assert (cfg.family, cfg.n_layers, cfg.d_model, cfg.n_heads,
            cfg.n_kv_heads, cfg.resolved_head_dim, cfg.frontend_tokens) == \
        ("vlm", 24, 2048, 16, 8, 128, 256)


@pytest.mark.parametrize("reduced", [True, False])
def test_n_params_equals_reference(reduced):
    """The defs' count (nothing allocated) and the analytic count equal
    the reference's; at full size 1,895,925,760 in the defs (vocab padded
    to 94,208) and 1,889,146,880 analytic."""
    get, ref_get = ((registry.get_reduced, ref_registry.get_reduced)
                    if reduced else (registry.get, ref_registry.get))
    assert build(get(ARCH)).n_params() == ref_build(ref_get(ARCH)).n_params()
    assert get(ARCH).n_params() == ref_get(ARCH).n_params()
    if not reduced:
        assert build(get(ARCH)).n_params() == 1_895_925_760
        assert get(ARCH).n_params() == 1_889_146_880


# ------------------------------------------------------------ forward

@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_forward_matches_reference(dtype):
    rm, params, pm = _pair(dtype)
    b = _batch(labels=False)
    ref = np.asarray(rm.forward(params, _jax(b))[0], np.float32)
    out, aux = pm.forward(_torch(b))
    assert out.shape == (2, 24, padded_vocab(pm.cfg.vocab_size))
    assert float(aux) == 0.0
    out = out.float().numpy()
    if dtype == "float32":
        np.testing.assert_allclose(out, ref, atol=1e-4, rtol=1e-4)
    else:
        np.testing.assert_allclose(out, ref, atol=1.5e-1, rtol=5e-2)
        assert np.mean(out.argmax(-1) == ref.argmax(-1)) >= 0.9


def test_patches_lead_the_causal_sequence():
    """The patch rows come first and see only each other: changing a
    token leaves the patch rows' logits alone, changing a patch moves
    every later row."""
    _, _, pm = _pair()
    b = _batch(labels=False)
    base = pm.forward(_torch(b))[0]
    tok = dict(b, tokens=b["tokens"].copy())
    tok["tokens"][:, 3] = (tok["tokens"][:, 3] + 1) % 512
    moved = pm.forward(_torch(tok))[0]
    assert torch.equal(moved[:, :P + 3], base[:, :P + 3])
    assert float((moved[:, P + 3] - base[:, P + 3]).abs().max()) > 1e-3
    pat = dict(b, patch_embeds=b["patch_embeds"].copy())
    pat["patch_embeds"][:, -1] += 1.0
    moved = pm.forward(_torch(pat))[0]
    assert torch.equal(moved[:, :P - 1], base[:, :P - 1])
    assert float((moved[:, -1] - base[:, -1]).abs().max()) > 1e-3


def test_k4_sees_the_whole_causal_sequence(monkeypatch):
    """Each layer's attention reaches K4 once forward and once backward,
    causal, over the P + S_text rows (Sq = Sk), without a window."""
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
    assert seen == {"fwd": [(24, 24, True, 0)] * 2,
                    "bwd": [(24, 24, True, 0)] * 2}


@pytest.mark.parametrize("remat", ["none", "block"])
def test_loss_and_grads_match_reference(remat):
    """The loss and every gradient, the embedding's rows of the text
    tokens and every layer's attention and MLP included."""
    rm, params, pm = _pair()
    b = _batch()
    loss, g = jax.jit(jax.value_and_grad(rm.loss))(params, _jax(b))
    pm.requires_grad_(True)
    mine = pm.loss(_torch(b), remat=remat)
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
    for n in ("blocks.0.attn.wq", "blocks.1.attn.wk", "blocks.1.attn.wv",
              "blocks.0.attn.wo", "blocks.1.mlp.wi_gate", "embed.tok"):
        assert float(got[n].abs().max()) > 0, n


# ------------------------------------------------------------ prefill, decode

def test_cache_is_the_dense_cache():
    rm, _, pm = _pair("bfloat16")
    ref = jax.tree.map(lambda a: (a.shape, a.dtype.name),
                       rm.init_cache(batch=2, s_max=30))
    mine = {k: (tuple(t.shape), str(t.dtype).split(".")[-1])
            for k, t in pm.init_cache(batch=2, s_max=30).items()}
    assert mine == ref == {"k": ((2, 2, 30, 2, 16), "bfloat16"),
                           "v": ((2, 2, 30, 2, 16), "bfloat16")}


def test_prefill_matches_forward_and_the_reference_cache():
    """Prefill's logits equal forward's bitwise; its keys and values (P +
    S_text rows, zero past them) match the reference's prefill."""
    rm, params, pm = _pair("bfloat16")
    b = _batch(labels=False)
    cache = pm.init_cache(batch=2, s_max=30)
    logits, new = pm.prefill(_torch(b), cache)
    assert torch.equal(logits, pm.forward(_torch(b))[0])
    _, rcache = rm.prefill(params, _jax(b), rm.init_cache(batch=2, s_max=30))
    for name in ("k", "v"):
        assert new[name].shape == cache[name].shape
        assert not new[name][:, :, 24:].any()
        got, want = new[name].float().numpy(), np.asarray(rcache[name],
                                                          np.float32)
        np.testing.assert_allclose(got, want, atol=1.5e-1, rtol=5e-2,
                                   err_msg=name)
        assert np.linalg.norm(got - want) / np.linalg.norm(want) <= 2e-2


def test_decode_matches_reference_and_forward():
    """The reference's own check (``tests/test_models.py:60``): decode at
    index S after prefill against forward on the extended sequence
    (1e-2); and the port's decode step on the reference's converted
    cache against the reference's decode step (5e-2)."""
    rm, params, pm = _pair("bfloat16")
    b = _batch(labels=False)
    S = P + b["tokens"].shape[1]
    nxt = np.full((2, 1), 3, np.int32)
    _, cache = pm.prefill(_torch(b), pm.init_cache(batch=2, s_max=S + 4))
    dec, _ = pm.decode_step(cache, torch.from_numpy(nxt), S)
    ext = dict(b, tokens=np.concatenate([b["tokens"], nxt], axis=1))
    full = pm.forward(_torch(ext))[0]
    np.testing.assert_allclose(dec[:, 0].float().numpy(),
                               full[:, -1].float().numpy(), atol=1e-2,
                               rtol=1e-2)
    _, rcache = rm.prefill(params, _jax(b),
                           rm.init_cache(batch=2, s_max=S + 4))
    want, _ = rm.decode_step(params, rcache, jnp.asarray(nxt), jnp.int32(S))
    got, _ = pm.decode_step(cache_from_jax(jax.tree.map(np.asarray, rcache)),
                            torch.from_numpy(nxt), S)
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(want, np.float32), atol=5e-2,
                               rtol=5e-2)


def test_server_matches_reference():
    """``Server`` prefills token by token through the decode step, as
    the reference's: it never sees a patch, and serves the text like the
    dense family (ROADMAP.md, Queue 3).  The port's tokens and per-step
    logits against the reference's, under ``tests/test_torch_serve.py``'s
    criteria."""
    _server_check(ARCH)


# ------------------------------------------------------------ batches

def test_lm_batch_source_equals_reference():
    """Three batches bitwise: the tokens cut to seq - P, the labels of
    all seq rows, the patch embeddings (bf16) drawn after the tokens."""
    cfg = registry.get_reduced(ARCH)
    pm = build(cfg).init(seed=0, device="cpu")
    mine = train_cli.lm_batch_source(pm, 3, 20, seed=7)
    ref = ref_batches(ref_build(ref_registry.get_reduced(ARCH)), 3, 20,
                      seed=7)
    for _ in range(3):
        got, want = mine(), ref()
        assert set(got) == set(want) == {"tokens", "labels", "patch_embeds"}
        assert got["tokens"].shape == (3, 20 - P)
        assert got["patch_embeds"].dtype == torch.bfloat16
        for k in want:
            np.testing.assert_array_equal(
                got[k].float().numpy() if k == "patch_embeds"
                else got[k].numpy(), np.asarray(want[k], np.float32)
                if k == "patch_embeds" else np.asarray(want[k]), err_msg=k)


# ------------------------------------------------------------ training

def test_train_step_matches_reference():
    """One float32 step of each package with block remat and int8
    moments: loss, grad norm and parameters agree, every int8 payload
    within one code of the reference's, at most one in a thousand off."""
    rm, params, pm = _pair()
    b = _batch(seed=5)
    ropt = ref_opt.AdamW(lr=1e-3, state_dtype="int8")
    popt = AdamW(lr=1e-3, state_dtype="int8")
    rstep = jax.jit(ref_step(rm, RefParallel(remat="block"), ropt))
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


def test_adamw_payloads_equal_reference():
    """AdamW over the reduced vlm's leaves, 3 steps with the same
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


# ------------------------------------------------------------ the CLIs

def test_cli_trains_internvl2_on_cpu(tmp_path, capsys):
    train_cli.main(["--arch", ARCH, "--steps", "3", "--batch", "2", "--seq",
                    "32", "--device", "cpu", "--ckpt-dir", str(tmp_path)])
    out = capsys.readouterr().out
    assert f"arch={ARCH}" in out and "3 steps in" in out
    losses = [float(x) for x in re.findall(r"loss ([0-9.eE+-]+)", out)]
    assert losses and all(np.isfinite(losses))


def test_cli_serves_internvl2_on_cpu(capsys):
    serve_cli.main(["--arch", ARCH, "--requests", "3", "--slots", "2",
                    "--prompt-len", "4", "--max-new", "3", "--device",
                    "cpu"])
    assert "3 requests, 21 tokens" in capsys.readouterr().out
