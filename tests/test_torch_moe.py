"""The port's moe family (``repro_torch.models.moe``, deepseek-moe-16b and
kimi-k2 reduced) and the configs registered with it (deepseek-7b,
qwen1.5-32b, llama3-405b) against the JAX package.

Parameters come from the reference's ``init`` (loaded with
``params_from_jax``), activations, tokens and gradients are drawn with
numpy from a seed.  Tolerances, with their reasons:

* ``moe_ffn`` in float32: 1e-5 (the expert products sum in other orders,
  measured ~2e-7); in bf16: 5e-2, and the routing (``top_e``) equal.  On
  the CPU the bf16 layer gives the reference's bits, its combine adding
  each token's rows in the reference's order (pinned separately);
* the auxiliary loss: 1e-6 absolute (a float32 mean over the tokens);
* loss and gradients in float32: as the dense family's
  (``tests/test_torch_train.py``): 1e-5 relative on the loss, 1e-4 on
  every gradient;
* one train step with int8 moments: every payload within one code of the
  reference's (as mamba2's and vit-huge's), byte-equal when both are fed
  the same gradients;
* decode at ``capacity_factor=100`` against forward on the extended
  sequence: the reference's own check (``tests/test_models.py:84``), at
  the dense port's 1e-2 (the port's decode takes K4's float32
  arithmetic, its forward K4's plain twin).
"""
import dataclasses
import re

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs import registry as ref_registry  # noqa: E402
from repro.configs.base import ParallelismConfig as RefParallel  # noqa: E402
from repro.models import moe as ref_moe  # noqa: E402
from repro.models.model import build as ref_build  # noqa: E402
from repro.train import optimizer as ref_opt  # noqa: E402
from repro.train.step import build_train_step as ref_step  # noqa: E402

from repro_torch.configs import registry  # noqa: E402
from repro_torch.configs.base import ParallelismConfig  # noqa: E402
from repro_torch.launch import serve as serve_cli  # noqa: E402
from repro_torch.launch import train as train_cli  # noqa: E402
from repro_torch.models import moe  # noqa: E402
from repro_torch.models.convert import (params_from_jax,  # noqa: E402
                                        params_to_numpy)
from repro_torch.models import transformer as tfm  # noqa: E402
from repro_torch.models.model import build  # noqa: E402
from repro_torch.train import optimizer as opt_mod  # noqa: E402
from repro_torch.train.optimizer import AdamW, param_leaves  # noqa: E402
from repro_torch.train.step import build_train_step  # noqa: E402

ARCH = "deepseek-moe-16b"
MOE_ARCHS = ["deepseek-moe-16b", "kimi-k2-1t-a32b"]
NEW_ARCHS = MOE_ARCHS + ["deepseek-7b", "qwen1.5-32b", "llama3-405b"]
_JDT = {"float32": jnp.float32, "bfloat16": jnp.bfloat16}
_TDT = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def _cfgs(arch=ARCH, **moe_kw):
    ref, mine = ref_registry.get_reduced(arch), registry.get_reduced(arch)
    if moe_kw:
        ref = dataclasses.replace(ref, moe=dataclasses.replace(ref.moe,
                                                               **moe_kw))
        mine = dataclasses.replace(mine, moe=dataclasses.replace(mine.moe,
                                                                 **moe_kw))
    return ref, mine


def _pair(dtype="float32", arch=ARCH, **moe_kw):
    ref_cfg, cfg = _cfgs(arch, **moe_kw)
    rm = ref_build(ref_cfg)
    params = rm.init(jax.random.key(0), dtype=_JDT[dtype])
    pm = params_from_jax(build(cfg), jax.tree.map(np.asarray, params))
    return rm, params, pm


def _layer(params, pm, i=0):
    """Layer ``i``'s moe params of both packages."""
    return (jax.tree.map(lambda a: a[i], params["blocks"]["moe"]),
            pm["blocks"][i]["moe"])


def _x(shape, dtype, seed=0):
    x = np.random.default_rng(seed).standard_normal(shape).astype(np.float32)
    return jnp.asarray(x).astype(_JDT[dtype]), torch.from_numpy(x).to(
        _TDT[dtype])


def _batch(B=2, S=16, seed=1, vocab=512):
    toks = np.random.default_rng(seed).integers(
        0, vocab, (B, S + 1)).astype(np.int32)
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


# ------------------------------------------------------------ the configs

@pytest.mark.parametrize("arch", NEW_ARCHS)
def test_registry_resolves_as_the_reference(arch):
    assert dataclasses.asdict(registry.get(arch)) == dataclasses.asdict(
        ref_registry.get(arch))
    assert dataclasses.asdict(registry.get_reduced(arch)) == \
        dataclasses.asdict(ref_registry.get_reduced(arch))


@pytest.mark.parametrize("arch", NEW_ARCHS)
@pytest.mark.parametrize("reduced", [True, False])
def test_n_params_equals_reference(arch, reduced):
    """The port's parameter count (its ParamDefs, nothing allocated)
    equals the reference model's, full configs included."""
    get, ref_get = ((registry.get_reduced, ref_registry.get_reduced)
                    if reduced else (registry.get, ref_registry.get))
    assert build(get(arch)).n_params() == ref_build(ref_get(arch)).n_params()
    if arch == ARCH and not reduced:
        assert build(get(arch)).n_params() == 16_879_568_896
        # half depth, as it trains on one card
        assert build(dataclasses.replace(get(arch), n_layers=14)
                     ).n_params() == 8_649_500_672


# ------------------------------------------------------------ the layer

@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("factor", [1.25, 0.5])
def test_moe_ffn_matches_reference(dtype, factor):
    """The layer at the published capacity factor and at 0.5, where
    assignments are dropped: routing equal, output and aux within
    tolerance."""
    ref_cfg, cfg = _cfgs(capacity_factor=factor)
    _, params, pm = _pair(dtype, capacity_factor=factor)
    rp, pp = _layer(params, pm)
    xj, xt = _x((2, 16, cfg.d_model), dtype)
    want, want_aux = ref_moe.moe_ffn(rp, xj, ref_cfg)
    got, aux = moe.moe_ffn(pp, xt, cfg)
    assert got.dtype == _TDT[dtype] and aux.dtype == torch.float32
    np.testing.assert_allclose(float(aux), float(want_aux), rtol=0,
                               atol=1e-6)
    tol = 1e-5 if dtype == "float32" else 5e-2
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(want, np.float32), atol=tol,
                               rtol=tol)
    x2d = xt.reshape(-1, cfg.d_model)
    top_e, _, _ = moe._route(x2d, pp["router"], cfg.moe.top_k)
    ref_e, _, _ = ref_moe._route(xj.reshape(-1, cfg.d_model), rp["router"],
                                 cfg.moe.top_k)
    np.testing.assert_array_equal(top_e.numpy(), np.asarray(ref_e))
    cap = moe._capacity(x2d.shape[0], cfg.moe.top_k, cfg.moe.n_experts,
                        factor)
    slot, _ = moe.dispatch_plan(top_e, cfg.moe.n_experts, cap)
    dropped = int((slot == cfg.moe.n_experts * cap).sum())
    if factor < 1:
        assert dropped > 0


@pytest.mark.parametrize("factor", [1.25, 0.5])
def test_bf16_moe_ffn_is_the_reference_bits(factor):
    """Each token's k weighted rows are added in the reference's order
    (ascending expert id, one bf16 add after another), and the rest of
    the layer rounds where the reference rounds: the bf16 output equals
    the reference's bit for bit on the CPU."""
    ref_cfg, cfg = _cfgs(capacity_factor=factor)
    _, params, pm = _pair("bfloat16", capacity_factor=factor)
    rp, pp = _layer(params, pm, 1)
    xj, xt = _x((4, 24, cfg.d_model), "bfloat16", seed=3)
    want, _ = ref_moe.moe_ffn(rp, xj, ref_cfg)
    got, _ = moe.moe_ffn(pp, xt, cfg)
    np.testing.assert_array_equal(got.float().numpy(),
                                  np.asarray(want, np.float32))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("tie", ["all", "pairs"])
def test_top_k_ties_break_as_the_reference(dtype, tie):
    """A router that ties on purpose: a zero router ties every expert,
    duplicated columns tie experts in pairs.  ``jax.lax.top_k`` puts the
    lower expert id first among equal probabilities, and so does the
    port; the layer's outputs then agree."""
    ref_cfg, cfg = _cfgs()
    _, params, pm = _pair(dtype)
    rp, pp = _layer(params, pm)
    w = np.asarray(rp["router"], np.float32)
    if tie == "all":
        w = np.zeros_like(w)
    else:
        w = w[:, [0, 0, 2, 2, 5, 5, 3, 3]]
    rp = dict(rp, router=jnp.asarray(w).astype(_JDT[dtype]))
    pp.router = torch.nn.Parameter(torch.from_numpy(w).to(_TDT[dtype]),
                                   requires_grad=False)
    xj, xt = _x((2, 16, cfg.d_model), dtype, seed=2)
    ref_e, _, _ = ref_moe._route(xj.reshape(-1, cfg.d_model), rp["router"],
                                 cfg.moe.top_k)
    top_e, _, _ = moe._route(xt.reshape(-1, cfg.d_model), pp["router"],
                             cfg.moe.top_k)
    np.testing.assert_array_equal(top_e.numpy(), np.asarray(ref_e))
    if tie == "all":
        assert (top_e.numpy() == [0, 1]).all()
    else:       # every token's two picks are one tied pair, lower id first
        assert (top_e[:, 1] - top_e[:, 0] == 1).all()
    want, _ = ref_moe.moe_ffn(rp, xj, ref_cfg)
    got, _ = moe.moe_ffn(pp, xt, cfg)
    tol = 1e-5 if dtype == "float32" else 5e-2
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(want, np.float32), atol=tol,
                               rtol=tol)


@pytest.mark.parametrize("T,k,E,factor", [(32, 2, 8, 1.25), (4, 6, 64, 1.25),
                                          (4096, 6, 64, 1.25),
                                          (256, 6, 64, 100.0),
                                          (5, 8, 384, 0.5)])
def test_capacity_is_the_reference(T, k, E, factor):
    assert moe._capacity(T, k, E, factor) == ref_moe._capacity(T, k, E,
                                                               factor)


def test_dispatch_plan_fills_experts_in_sorted_order():
    """Slots follow the reference's stable sort: within an expert, by
    token, and the overflow row takes what its capacity cannot hold."""
    top_e = torch.tensor([[1, 0], [0, 1], [1, 2], [0, 1]])
    slot, src = moe.dispatch_plan(top_e, 3, 2)
    # expert 0: tokens 0, 1 (token 3 dropped); expert 1: tokens 0, 1
    # (2, 3 dropped); expert 2: token 2
    assert slot.tolist() == [[2, 0], [1, 3], [6, 4], [6, 6]]
    assert src.tolist() == [0, 1, 0, 1, 2, 4]


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("factor", [1.0, 100.0])
def test_dispatch_backward_is_index_selects(dtype, factor, monkeypatch):
    """The dispatch's gather and the combine's (``moe.gather_rows``) give
    ``index_select``'s rows and, in their own backward, which adds each
    row's reads in ascending expert id without atomics, the bits of
    ``index_select``'s (``index_add_``) on the CPU: at the published
    capacity factor some assignments are dropped (their reads of the
    zero row and writes to the overflow row contribute nothing), at 100
    none are.  Also through a whole ``moe_ffn``: the gradients of its
    input and weights equal those of the same layer with ``index_select``
    gathers."""
    dt = _TDT[dtype]
    rng = np.random.default_rng(7)
    T, k, E, D = 48, 3, 8, 16
    x = torch.from_numpy(rng.standard_normal((T, D), np.float32)).to(dt)
    top_e = torch.sort(torch.from_numpy(rng.standard_normal(
        (T, E), np.float32)), dim=-1, descending=True,
        stable=True).indices[:, :k]
    cap = moe._capacity(T, k, E, factor)
    slot, src = moe.dispatch_plan(top_e, E, cap)
    assert (int((slot == E * cap).sum()) > 0) == (factor == 1.0)
    slot = torch.gather(slot, 1, torch.argsort(top_e, dim=1))
    g = torch.from_numpy(rng.standard_normal((E * cap, D), np.float32)
                         ).to(dt)
    xa = x.clone().requires_grad_(True)
    xb = x.clone().requires_grad_(True)
    none = slot.new_full((1, k), E * cap)
    got = moe.gather_rows(torch.cat([xa, xa.new_zeros(1, D)]), src,
                          torch.cat([slot, none]))
    want = torch.index_select(torch.cat([xb, xb.new_zeros(1, D)]), 0, src)
    assert torch.equal(got, want)
    ga, = torch.autograd.grad(got, xa, g)
    gb, = torch.autograd.grad(want, xb, g)
    assert torch.equal(ga, gb)

    cfg = registry.get_reduced(ARCH)
    cfg = dataclasses.replace(cfg, moe=dataclasses.replace(
        cfg.moe, capacity_factor=factor))
    p = build(cfg).init(dtype=dt, seed=1, device="cpu")["blocks"][0]["moe"]
    h = torch.from_numpy(rng.standard_normal((2, 24, cfg.d_model),
                                             np.float32)).to(dt)

    def grads():
        names, ps = zip(*[(n, q) for n, q in p.named_parameters()])
        hh = h.clone().requires_grad_(True)
        y, aux = moe.moe_ffn(p, hh, cfg)
        loss = (y.float() * torch.linspace(-1, 1, y.numel()).reshape(
            y.shape)).sum() + aux
        return torch.autograd.grad(loss, (hh,) + ps)

    p.requires_grad_(True)
    mine = grads()

    def plain(src, index, readers):
        return torch.index_select(src, 0, index)

    monkeypatch.setattr(moe, "gather_rows", plain)
    theirs = grads()
    for a, b in zip(mine, theirs, strict=True):
        assert torch.equal(a, b)


# ------------------------------------------------------------ the model

def test_decode_without_drops_matches_forward():
    """``capacity_factor=100`` keeps every assignment, so decode at index
    S continues forward on the extended sequence, as the reference's
    ``test_moe_decode_exact_without_drops``."""
    _, _, pm = _pair("bfloat16", capacity_factor=100.0)
    B, S = 2, 12
    toks = torch.from_numpy(_batch(B, S)["tokens"])
    cache = pm.init_cache(batch=B, s_max=S + 2)
    logits_pf, cache = pm.prefill({"tokens": toks}, cache)
    full, _ = pm.forward({"tokens": toks})
    assert torch.equal(logits_pf, full)
    nxt = torch.full((B, 1), 5, dtype=torch.int32)
    full2, _ = pm.forward({"tokens": torch.cat([toks, nxt], 1)})
    dec, _ = pm.decode_step(cache, nxt, S)
    np.testing.assert_allclose(full2[:, -1].float().numpy(),
                               dec[:, 0].float().numpy(), atol=1e-2,
                               rtol=1e-2)


@pytest.mark.parametrize("arch", MOE_ARCHS)
@pytest.mark.parametrize("remat", ["none", "block"])
def test_loss_and_grads_match_reference(arch, remat):
    """The loss (cross entropy plus the blocks' aux) and every gradient,
    the router's and the 3-D expert weights' included."""
    rm, params, pm = _pair("float32", arch)
    b = _batch()
    loss, g = jax.value_and_grad(rm.loss)(
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
    for w in ("router", "we_gate", "we_up", "we_out", "ws_gate", "ws_up",
              "ws_out"):
        assert float(got[f"blocks.1.moe.{w}"].abs().max()) > 0, w


def test_aux_loss_reaches_the_router_gradient():
    """The auxiliary loss alone has a router gradient, the reference's."""
    rm, params, pm = _pair("float32")
    toks = _batch()["tokens"]
    g = jax.grad(lambda p: rm.forward(p, {"tokens": jnp.asarray(toks)})[1])(
        params)
    pm.requires_grad_(True)
    _, aux = tfm.forward(pm, pm.cfg, {"tokens": torch.from_numpy(toks)})
    routers = [pm["blocks"][i]["moe"]["router"] for i in range(2)]
    grads = torch.autograd.grad(aux, routers)
    for i, gp in enumerate(grads):
        want = np.asarray(g["blocks"]["moe"]["router"][i])
        assert float(np.abs(want).max()) > 0
        np.testing.assert_allclose(gp.numpy(), want, rtol=1e-4,
                                   atol=1e-4 * float(np.abs(want).max()))


def test_train_step_matches_reference():
    """One float32 step of each package with block remat and int8
    moments: loss, grad norm and parameters agree, every int8 payload
    within one code of the reference's, at most one in a thousand off."""
    rm, params, pm = _pair("float32")
    b = _batch(B=2, S=32, seed=5)
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
    """AdamW over reduced deepseek-moe-16b's leaves, 3 steps with the
    same gradients on both sides: int8 payloads byte-equal, scales within
    float32 rounding, parameters equal.  The (L, E, d, f) expert leaves
    and the (L, d, E) router have trailing axes that 256 does not divide,
    so they are blocked flattened, as in the reference."""
    _, params, pm = _pair("float32")
    ropt, popt = (ref_opt.AdamW(lr=1e-2, state_dtype="int8"),
                  AdamW(lr=1e-2, state_dtype="int8"))
    rs, ps = ropt.init(params), popt.init(pm)
    rng = np.random.default_rng(0)
    for _ in range(3):
        g = jax.tree.map(lambda p: jnp.asarray(
            rng.standard_normal(p.shape).astype(np.float32) * 1e-3), params)
        params, rs, _ = ropt.update(g, rs, params)
        _, ps, _ = popt.update(_named_grads(g, pm.cfg), ps, pm)
    shapes = {lf.path: lf.shape for lf in param_leaves(pm)}
    assert shapes["blocks/moe/we_gate"] == (2, 8, 64, 96)
    assert shapes["blocks/moe/router"] == (2, 64, 8)
    for leaf in param_leaves(pm):
        for mine, ref in ((ps.m[leaf.path], _leaf(rs.m, leaf.path)),
                          (ps.v[leaf.path], _leaf(rs.v, leaf.path))):
            assert tuple(mine.q.shape) == tuple(ref.q.shape), leaf.path
            np.testing.assert_array_equal(mine.q.numpy(), np.asarray(ref.q))
            np.testing.assert_allclose(mine.scale.numpy(),
                                       np.asarray(ref.scale), rtol=0,
                                       atol=1e-7)
    for r, mine in zip(jax.tree.leaves(params),
                       jax.tree.leaves(params_to_numpy(pm))):
        np.testing.assert_allclose(mine, np.asarray(r), rtol=0, atol=1e-7)


def test_full_width_blocking_and_decay_follow_the_reference():
    """At deepseek-moe-16b's published widths (14 layers, the depth it
    trains at on one card) each leaf is blocked as the reference blocks
    it: ``d_ff_expert`` 1408 is not a multiple of 256, so ``we_gate`` and
    ``we_up`` take the flat form, as does the router (64 experts); the
    shared ``ws_gate``/``ws_up`` (2 x 1408 = 2816 = 11 x 256), ``we_out``
    and ``ws_out`` (trailing d_model 2048) the structured one.
    Every stacked leaf decays (ndim >= 2), final_norm does not."""
    cfg = dataclasses.replace(registry.get(ARCH), n_layers=14)
    leaves = {lf.path: lf for lf in param_leaves(build(cfg))}
    assert leaves["blocks/moe/we_gate"].shape == (14, 64, 2048, 1408)
    for path, leaf in leaves.items():
        want = jax.eval_shape(lambda a: ref_opt._blocks(a)[0],
                              jax.ShapeDtypeStruct(leaf.shape, jnp.float32))
        got = opt_mod._blocks(torch.empty(leaf.shape, device="meta"))
        assert tuple(got.shape) == tuple(want.shape), path
    flat = {p for p, lf in leaves.items() if not opt_mod._structured(
        lf.shape)}
    assert {"blocks/moe/we_gate", "blocks/moe/we_up",
            "blocks/moe/router"} <= flat
    assert not {"blocks/moe/we_out", "blocks/moe/ws_gate", "blocks/moe/ws_up",
                "blocks/moe/ws_out"} & flat
    _, _, pm = _pair("float32")
    before = {n: p.detach().clone() for n, p in pm.named_parameters()}
    opt = AdamW(lr=0.5, weight_decay=0.1)
    opt.update({n: torch.zeros_like(p) for n, p in pm.named_parameters()},
               opt.init(pm), pm)
    for n, p in pm.named_parameters():
        if n == "final_norm":
            assert torch.equal(p, before[n])
        else:
            torch.testing.assert_close(p, before[n] * (1 - 0.5 * 0.1))


def test_update_walks_expert_leaves_in_pieces(monkeypatch):
    """The (L, E, d, f) expert leaves are blocked flattened, but each
    layer holds whole blocks, so the int8 update walks them layer by
    layer in pieces of at most ``CHUNK`` elements, as every other leaf
    (at deepseek-moe-16b's widths one such leaf is 2.6 G elements, whose
    float32 moments whole would not fit beside the model), and gives the
    bits of one piece per layer."""
    outs = []
    for chunk in (1 << 24, 1024):
        monkeypatch.setattr(opt_mod, "CHUNK", chunk)
        _, _, pm = _pair("bfloat16")
        opt, sizes, step = AdamW(lr=1e-2, state_dtype="int8"), [], None
        step = opt._step

        def recording(p, *args, **kw):
            sizes.append(p.numel())
            return step(p, *args, **kw)

        monkeypatch.setattr(opt, "_step", recording)
        state = opt.init(pm)
        rng = np.random.default_rng(0)
        for _ in range(2):
            opt.update({n: torch.from_numpy(rng.standard_normal(
                tuple(p.shape)).astype(np.float32) * 1e-3).to(p.dtype)
                for n, p in pm.named_parameters()}, state, pm)
        outs.append((params_to_numpy(pm), state))
        if chunk == 1024:
            # a piece is at least one row: the (64, 2048) logits head's
            # rows are the widest
            assert max(sizes) <= 2048, max(sizes)
    for a, b in zip(jax.tree.leaves(outs[0][0]), jax.tree.leaves(outs[1][0])):
        np.testing.assert_array_equal(a, b)
    for path, m in outs[0][1].m.items():
        assert torch.equal(m.q, outs[1][1].m[path].q), path
        assert torch.equal(outs[0][1].v[path].q, outs[1][1].v[path].q), path


# ------------------------------------------------------------ the CLIs

def test_cli_trains_deepseek_moe_on_cpu(tmp_path, capsys):
    train_cli.main(["--arch", ARCH, "--steps", "3", "--batch", "2", "--seq",
                    "16", "--device", "cpu", "--ckpt-dir", str(tmp_path)])
    out = capsys.readouterr().out
    assert f"arch={ARCH}" in out and "3 steps in" in out
    losses = [float(x) for x in re.findall(r"loss ([0-9.eE+-]+)", out)]
    assert losses and all(np.isfinite(losses))


def test_cli_serves_deepseek_moe_on_cpu(capsys):
    serve_cli.main(["--arch", ARCH, "--requests", "3", "--slots", "2",
                    "--prompt-len", "4", "--max-new", "3", "--device",
                    "cpu"])
    assert "3 requests, 21 tokens" in capsys.readouterr().out
