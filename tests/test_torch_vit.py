"""The port's encoder family (vit-huge, reduced) against the JAX package.

Parameters come from the reference's own ``Model.init`` and are loaded
into the port with ``params_from_jax``; patch embeddings and labels are
drawn with numpy from a seed.  The port runs on the CPU, where attention
takes K4's plain version (non-causal, no rotary).  Tolerances, as in
``tests/test_torch_models.py`` and ``tests/test_torch_train.py``:

* float32 forward: 1e-4 (class logits of magnitude ~2; K4's plain twin
  and XLA's ``_sdpa`` sum in other orders);
* bf16 forward: 5e-2, two bf16 ulps at logits ~2-4;
* loss 1e-5 relative, every gradient 1e-4 scaled by its largest
  magnitude;
* one train step (two microbatches, block remat, int8 moments): loss
  1e-5, grad norm 1e-4, parameters a tenth of lr.
"""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs import registry as ref_registry  # noqa: E402
from repro.configs import vit_huge as ref_vit  # noqa: E402
from repro.configs.base import ParallelismConfig as RefParallel  # noqa: E402
from repro.models.model import build as ref_build  # noqa: E402
from repro.train import optimizer as ref_opt  # noqa: E402
from repro.train.step import build_train_step as ref_step  # noqa: E402

from repro_torch.configs import registry  # noqa: E402
from repro_torch.configs import vit_huge  # noqa: E402
from repro_torch.configs.base import ParallelismConfig  # noqa: E402
from repro_torch.kernels.flash_attention import kernel as fa  # noqa: E402
from repro_torch.models.convert import (params_from_jax,  # noqa: E402
                                        params_to_numpy)
from repro_torch.models.model import build  # noqa: E402
from repro_torch.train.optimizer import AdamW, param_leaves  # noqa: E402
from repro_torch.train.step import build_train_step  # noqa: E402

ARCH = "vit-huge"
_JDT = {"float32": jnp.float32, "bfloat16": jnp.bfloat16}


def _pair(dtype="float32"):
    """(reference model, its params, the port's model with them)."""
    rm = ref_build(ref_registry.get_reduced(ARCH))
    params = rm.init(jax.random.key(0), dtype=_JDT[dtype])
    pm = params_from_jax(build(registry.get_reduced(ARCH)),
                         jax.tree.map(np.asarray, params))
    return rm, params, pm


def _batch(B=4, seed=1):
    cfg = registry.get_reduced(ARCH)
    rng = np.random.default_rng(seed)
    return {"patch_embeds": rng.standard_normal(
                (B, cfg.frontend_tokens, cfg.d_model)).astype(np.float32),
            "labels": rng.integers(0, cfg.n_classes, B).astype(np.int32)}


def _ref_batch(b):
    return {k: jnp.asarray(v) for k, v in b.items()}


def _torch_batch(b):
    return {"patch_embeds": torch.from_numpy(b["patch_embeds"]),
            "labels": torch.from_numpy(b["labels"].astype(np.int64))}


def _leaf(tree, path):
    for k in path.split("/"):
        tree = tree[k]
    return tree


def _named_grads(gtree):
    gm = params_from_jax(build(registry.get_reduced(ARCH)),
                         jax.tree.map(np.asarray, gtree))
    return {n: p.detach() for n, p in gm.named_parameters()}


# ------------------------------------------------------------------ config

def test_registry_resolves_vit_huge_as_the_reference():
    for mine, ref in ((registry.get(ARCH), ref_registry.get(ARCH)),
                      (registry.get_reduced(ARCH),
                       ref_registry.get_reduced(ARCH))):
        assert dataclasses.asdict(mine) == dataclasses.asdict(ref)
    cfg = registry.get(ARCH)
    assert (cfg.family, cfg.frontend, cfg.frontend_tokens,
            cfg.n_classes) == ("encoder", "vision_stub", 197, 1000)
    assert cfg.resolved_head_dim == 80
    assert dataclasses.asdict(vit_huge.TRAIN_224) == \
        dataclasses.asdict(ref_vit.TRAIN_224)
    assert [s.name for s in vit_huge.SHAPES] == ["train_224"]


@pytest.mark.parametrize("reduced", [True, False])
def test_n_params_equals_reference(reduced):
    get = registry.get_reduced if reduced else registry.get
    ref_get = ref_registry.get_reduced if reduced else ref_registry.get
    n = build(get(ARCH)).n_params()
    assert n == ref_build(ref_get(ARCH)).n_params()
    assert n == (84_352 if reduced else 840_476_160)


# ----------------------------------------------------------------- weights

@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_params_from_jax_round_trip_is_exact(dtype):
    _, params, pm = _pair(dtype)
    ref = jax.tree.map(lambda a: np.asarray(a, np.float32), params)
    back = params_to_numpy(pm)
    assert jax.tree.structure(ref) == jax.tree.structure(back)
    for r, b in zip(jax.tree.leaves(ref), jax.tree.leaves(back)):
        assert r.shape == b.shape
        np.testing.assert_array_equal(r, b)
    cfg = pm.cfg
    assert tuple(pm["pos_embed"].shape) == (cfg.frontend_tokens, cfg.d_model)
    assert tuple(pm["head"].shape) == (cfg.d_model, cfg.n_classes)
    assert pm["pos_embed"].dtype == pm["head"].dtype == getattr(torch, dtype)
    assert "embed" not in pm


# ----------------------------------------------------------------- forward

def test_forward_matches_reference_float32():
    rm, params, pm = _pair("float32")
    b = _batch(B=3)
    ref, raux = rm.forward(params, _ref_batch(b))
    out, aux = pm.forward(_torch_batch(b))
    assert out.shape == (3, pm.cfg.n_classes) and out.dtype == torch.float32
    assert float(aux) == 0.0 and float(raux) == 0.0
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), atol=1e-4,
                               rtol=1e-4)


def test_forward_matches_reference_bfloat16():
    rm, params, pm = _pair("bfloat16")
    b = _batch(B=3, seed=2)
    ref, _ = rm.forward(params, _ref_batch(b))
    out, aux = pm.forward(_torch_batch(b))
    assert out.dtype == torch.bfloat16 and float(aux) == 0.0
    np.testing.assert_allclose(out.float().numpy(),
                               np.asarray(ref, np.float32), atol=5e-2,
                               rtol=5e-2)


def test_attention_runs_k4_non_causal_through_its_backward(monkeypatch):
    """Every layer's attention reaches K4's autograd route once, with
    ``causal=False`` and no window in the forward and the backward."""
    _, _, pm = _pair("float32")
    seen = {"fwd": [], "bwd": []}
    fwd, bwd = fa.flash_attention, fa.flash_attention_backward

    def spy_fwd(*args, causal=True, window=0):
        seen["fwd"].append(causal or window)
        return fwd(*args, causal=causal, window=window)

    def spy_bwd(*args, causal=True, window=0):
        seen["bwd"].append(causal or window)
        return bwd(*args, causal=causal, window=window)

    monkeypatch.setattr(fa, "flash_attention", spy_fwd)
    monkeypatch.setattr(fa, "flash_attention_backward", spy_bwd)
    pm.requires_grad_(True)
    loss = pm.loss(_torch_batch(_batch(B=2)))
    torch.autograd.grad(loss, [p for _, p in pm.named_parameters()])
    L = pm.cfg.n_layers
    assert seen == {"fwd": [False] * L, "bwd": [False] * L}


# -------------------------------------------------------- loss, gradients

@pytest.mark.parametrize("remat", ["none", "block"])
def test_loss_and_grads_match_reference(remat):
    rm, params, pm = _pair("float32")
    b = _batch(B=4, seed=3)
    loss, g = jax.value_and_grad(rm.loss)(params, _ref_batch(b))
    pm.requires_grad_(True)
    mine = pm.loss(_torch_batch(b), remat=remat)
    names, ps = zip(*pm.named_parameters())
    grads = torch.autograd.grad(mine, ps)
    np.testing.assert_allclose(float(mine.detach()), float(loss), rtol=1e-5)
    want = _named_grads(g)
    assert set(want) == set(names)
    for n, gp in zip(names, grads):
        scale = float(want[n].abs().max())
        np.testing.assert_allclose(gp.numpy(), want[n].numpy(),
                                   atol=1e-4 * max(scale, 1.0), rtol=1e-4)
    got = dict(zip(names, grads))
    for n in ("pos_embed", "head", "blocks.0.attn.wq", "blocks.1.attn.wv"):
        assert float(got[n].abs().max()) > 0, n


def test_train_step_matches_reference():
    """One float32 step of each package, two microbatches, block remat,
    int8 moments: loss, grad norm and parameters agree.  As for mamba2
    (``tests/test_torch_train.py::test_ssm_train_step_matches_reference``)
    the two packages' gradients differ by float32 rounding, which moves a
    moment code across a rounding boundary now and then: every int8
    payload is within one code of the reference's, and at most one in a
    thousand differs.  Fed the same gradients, the payloads are
    byte-equal (``test_adamw_payloads_equal_reference``)."""
    rm, params, pm = _pair("float32")
    b = _batch(B=4, seed=5)
    ropt = ref_opt.AdamW(lr=1e-3, state_dtype="int8")
    popt = AdamW(lr=1e-3, state_dtype="int8")
    rstep = jax.jit(ref_step(rm, RefParallel(microbatches=2, remat="block"),
                             ropt))
    pstep = build_train_step(pm, ParallelismConfig(microbatches=2,
                                                   remat="block"), popt)
    params, rs, rmet = rstep(params, ropt.init(params), _ref_batch(b))
    _, ps, pmet = pstep(pm, popt.init(pm), _torch_batch(b))
    np.testing.assert_allclose(float(pmet["loss"]), float(rmet["loss"]),
                               rtol=1e-5)
    np.testing.assert_allclose(float(pmet["grad_norm"]),
                               float(rmet["grad_norm"]), rtol=1e-4)
    for r, mine in zip(jax.tree.leaves(params),
                       jax.tree.leaves(params_to_numpy(pm))):
        # as tests/test_torch_train.py: a tenth of lr
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
    """AdamW over reduced vit-huge's leaves, 3 steps with the same
    gradients (numpy, below the clip) on both sides: the int8 payloads
    byte-equal, scales within float32 rounding, parameters equal.  The
    (T, d) ``pos_embed`` and (d, n_classes) ``head`` leaves have trailing
    axes that 256 does not divide, so they are blocked flattened, as in
    the reference."""
    _, params, pm = _pair("float32")
    ropt, popt = (ref_opt.AdamW(lr=1e-2, state_dtype="int8"),
                  AdamW(lr=1e-2, state_dtype="int8"))
    rs, ps = ropt.init(params), popt.init(pm)
    rng = np.random.default_rng(0)
    for _ in range(3):
        g = jax.tree.map(lambda p: jnp.asarray(
            rng.standard_normal(p.shape).astype(np.float32) * 1e-3), params)
        params, rs, _ = ropt.update(g, rs, params)
        _, ps, _ = popt.update(_named_grads(g), ps, pm)
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


# ---------------------------------------------------- no decode state

def test_encoder_has_no_decode_state_as_the_reference():
    """The reference's encoder has no decode cache (ValueError), and its
    prefill and decode step index the ``embed`` table it does not have
    (KeyError); the port raises the same."""
    rm, params, pm = _pair("bfloat16")
    toks = np.zeros((1, 4), np.int32)
    with pytest.raises(ValueError, match="no decode cache"):
        rm.cache_defs(1, 8)
    with pytest.raises(ValueError, match="no decode cache"):
        pm.cache_defs(1, 8)
    with pytest.raises(ValueError, match="no decode cache"):
        pm.init_cache(1, 8)
    with pytest.raises(KeyError, match="embed"):
        rm.prefill(params, {"tokens": jnp.asarray(toks)}, {})
    with pytest.raises(KeyError, match="embed"):
        pm.prefill({"tokens": torch.from_numpy(toks)}, {})
    with pytest.raises(KeyError, match="embed"):
        rm.decode_step(params, {}, jnp.asarray(toks[:, :1]), jnp.int32(0))
    with pytest.raises(KeyError, match="embed"):
        pm.decode_step({}, torch.from_numpy(toks[:, :1]), 0)
