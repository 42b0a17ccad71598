"""The port's training slice against the reference: optimizer, train
step, loss and gradients (``repro_torch.train``, ``Model.loss``), on
reduced qwen3-8b on the CPU.

The checks of ``tests/test_train.py`` run on the port, and the port is
held to the reference on the same inputs: parameters from the
reference's ``init`` (loaded with ``params_from_jax``), batches and
gradients drawn with numpy from a seed.  Tolerances, with reasons:

* AdamW, 3 steps, gradients below the clip: the int8 ``q`` payloads
  byte-equal, float32/bf16 moments equal, scales and parameters within
  float32 rounding (1e-7 absolute; both follow the same float32
  expressions, the port in row pieces).  Below the clip the scale is
  exactly 1 on both sides; above it the two gradient norms are summed in
  other orders and differ in the last bit, which can flip a payload
  code, so the clipped case is held to float32 rounding instead
  (parameters 1e-6); the norms, sums of ~3e5 squares in other orders,
  agree to 1e-5 relative;
* ``Model.loss`` and its gradients in float32: 1e-5 relative on the
  loss, 1e-4 on the gradients (K4's plain twin and XLA's ``_sdpa`` sum in
  other orders; measured ~2e-6);
* microbatch-accumulated against full-batch gradients in bf16: the
  reference's own 3e-2.

Reduced mamba2-1.3b (the ssm family) is held to the reference the same
way, its scan's chunk set to 16 on both sides so that S = 64 runs four
chunks (the reduced config's 256 would give one): the loss to 1e-5
relative and every gradient to 1e-4 (the scan's gradient is K5's
backward, the plain twin here, against XLA's autodiff of ``_ssd_core``),
and one float32 step with int8 moments, as for qwen3-8b.
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
from repro.models.model import build as ref_build  # noqa: E402
from repro.train import optimizer as ref_opt  # noqa: E402
from repro.train.step import build_train_step as ref_step  # noqa: E402

from repro_torch.configs import registry  # noqa: E402
from repro_torch.configs.base import ParallelismConfig  # noqa: E402
from repro_torch.launch import train as train_cli  # noqa: E402
from repro_torch.models.convert import (params_from_jax,  # noqa: E402
                                        params_to_numpy)
from repro_torch.models.model import build  # noqa: E402
from repro_torch.train import optimizer as opt_mod  # noqa: E402
from repro_torch.train.optimizer import (AdamW, _dequantize,  # noqa: E402
                                         _dequantize_pos, _quantize,
                                         _quantize_pos, param_leaves,
                                         warmup_cosine)
from repro_torch.train.step import (build_eval_step,  # noqa: E402
                                    build_train_step)

ARCH = "qwen3-8b"
_JDT = {"float32": jnp.float32, "bfloat16": jnp.bfloat16}


def _pair(dtype="bfloat16"):
    rm = ref_build(ref_registry.get_reduced(ARCH))
    params = rm.init(jax.random.key(0), dtype=_JDT[dtype])
    pm = params_from_jax(build(registry.get_reduced(ARCH)),
                         jax.tree.map(np.asarray, params))
    return rm, params, pm


def _batch(B=4, S=32, seed=1, vocab=512):
    toks = np.random.default_rng(seed).integers(
        0, vocab, (B, S + 1)).astype(np.int32)
    return {"tokens": toks[:, :-1], "labels": toks[:, 1:]}


def _torch_batch(b):
    return {k: torch.from_numpy(v.astype(np.int64)) for k, v in b.items()}


def _leaf(tree, path):
    for k in path.split("/"):
        tree = tree[k]
    return tree


def _named_grads(gtree, cfg=None):
    """A reference gradient tree as the port's name -> tensor dict."""
    gm = params_from_jax(build(cfg or registry.get_reduced(ARCH)),
                         jax.tree.map(np.asarray, gtree))
    return {n: p.detach() for n, p in gm.named_parameters()}


class _Capture(AdamW):
    """AdamW that keeps the gradients it is handed."""

    def update(self, grads, state, params):
        self.seen = {n: g.clone() for n, g in grads.items()}
        return super().update(grads, state, params)


# ---------------------------------------------------------------- the port

@pytest.mark.parametrize("state_dtype", ["float32", "bfloat16", "int8"])
def test_loss_decreases(state_dtype):
    _, _, pm = _pair()
    opt = AdamW(lr=1e-3, state_dtype=state_dtype, eps=1e-6)
    state = opt.init(pm)
    step = build_train_step(pm, ParallelismConfig(), opt)
    batch = _torch_batch(_batch())
    first = None
    for _ in range(15):
        pm, state, metrics = step(pm, state, batch)
        first = first if first is not None else float(metrics["loss"])
    assert float(metrics["loss"]) < first - 0.5


def test_microbatch_grads_match_full_batch():
    """Two microbatches accumulate in float32 buffers (never in the
    parameters' bf16 ``.grad``) and equal the full batch's gradients."""
    _, _, pm = _pair()
    batch = _torch_batch(_batch(B=4, S=16))
    grads = {}
    for n in (1, 2):
        opt = _Capture(lr=0.0)
        step = build_train_step(pm, ParallelismConfig(microbatches=n), opt)
        step(pm, opt.init(pm), batch)
        grads[n] = opt.seen
    assert all(g.dtype == torch.float32 for g in grads[2].values())
    assert all(g.dtype == torch.bfloat16 for g in grads[1].values())
    assert all(p.grad is None for p in pm.parameters())
    for name, g in grads[1].items():
        torch.testing.assert_close(grads[2][name], g.float(), atol=3e-2,
                                   rtol=3e-2)


def test_microbatch_split_must_divide_the_batch():
    _, _, pm = _pair()
    opt = AdamW(lr=0.0)
    step = build_train_step(pm, ParallelismConfig(microbatches=3), opt)
    with pytest.raises(ValueError, match="microbatches"):
        step(pm, opt.init(pm), _torch_batch(_batch(B=4, S=8)))


def test_grad_clip_limits_norm():
    _, _, pm = _pair()
    opt = AdamW(lr=0.0, grad_clip=0.5)
    step = build_train_step(pm, ParallelismConfig(), opt)
    _, _, metrics = step(pm, opt.init(pm), _torch_batch(_batch()))
    assert float(metrics["grad_norm"]) > 0


def test_warmup_cosine_shape_and_values():
    f = warmup_cosine(1.0, warmup=10, total=100)
    assert float(f(0)) == 0.0
    assert abs(float(f(10)) - 1.0) < 0.11
    assert float(f(100)) < 0.15
    assert float(f(5)) < float(f(10))
    g = ref_opt.warmup_cosine(3e-4, warmup=20, total=200)
    f = warmup_cosine(3e-4, warmup=20, total=200)
    for s in range(0, 220, 7):
        # jnp.cos and torch.cos of float32 may differ in the last bit
        np.testing.assert_allclose(float(f(s)), float(g(jnp.int32(s))),
                                   rtol=1e-6)


def test_quantize_roundtrip_signed():
    x = torch.from_numpy(np.random.default_rng(0).standard_normal(
        1000).astype(np.float32)) * 3.0
    err = (_dequantize(_quantize(x), x.shape) - x).abs().max()
    assert float(err) <= float(x.abs().max()) / 127 + 1e-6


def test_quantize_pos_dynamic_range():
    """Fourth-root coding must resolve values 6 decades below blockmax."""
    x = torch.cat([torch.full((128,), 1e-6), torch.full((128,), 1.0)])
    back = _dequantize_pos(_quantize_pos(x), x.shape)
    assert float(back[0]) > 0, "small v must not collapse to 0"
    np.testing.assert_allclose(float(back[-1]), 1.0, rtol=0.02)


@pytest.mark.parametrize("shape", [(3, 512), (2, 128), (1000,), (5, 7, 256)])
def test_quantizers_equal_reference_bytes(shape):
    """Both codes on one input, structured (trailing axis divides 256)
    and flattened: payloads byte-equal, scales equal."""
    x = np.random.default_rng(1).standard_normal(shape).astype(np.float32)
    for mine, ref, arr in ((_quantize, ref_opt._quantize, x),
                           (_quantize_pos, ref_opt._quantize_pos, x * x)):
        got, want = mine(torch.from_numpy(arr)), ref(jnp.asarray(arr))
        np.testing.assert_array_equal(got.q.numpy(), np.asarray(want.q))
        np.testing.assert_array_equal(got.scale.numpy(),
                                      np.asarray(want.scale))


def test_leaves_are_the_reference_stacked_leaves():
    rm, params, pm = _pair()
    leaves = param_leaves(pm)
    flat = jax.tree_util.tree_flatten_with_path(params)[0]
    assert [lf.path for lf in leaves] == [
        "/".join(p.key for p in path) for path, _ in flat]
    assert [lf.shape for lf in leaves] == [tuple(a.shape) for _, a in flat]
    named = dict(pm.named_parameters())
    assert sorted(n for lf in leaves for n in lf.names) == sorted(named)


def test_decay_follows_the_stacked_shape():
    """Zero gradients leave only the decay: every stacked leaf decays
    (the per-layer norms included, as in the reference), final_norm
    does not."""
    _, _, pm = _pair("float32")
    before = {n: p.detach().clone() for n, p in pm.named_parameters()}
    opt = AdamW(lr=0.5, weight_decay=0.1)
    opt.update({n: torch.zeros_like(p) for n, p in pm.named_parameters()},
               opt.init(pm), pm)
    for n, p in pm.named_parameters():
        if n == "final_norm":
            assert torch.equal(p, before[n])
        elif n.endswith("norm") or ".ln" in n:
            torch.testing.assert_close(p, before[n] * (1 - 0.5 * 0.1))


# ------------------------------------------------------ against the reference

def _run_adamw(state_dtype, dtype, grad_scale, steps=3, **kw):
    rm, params, pm = _pair(dtype)
    ropt = ref_opt.AdamW(lr=1e-2, state_dtype=state_dtype, **kw)
    popt = AdamW(lr=1e-2, state_dtype=state_dtype, **kw)
    rs, ps = ropt.init(params), popt.init(pm)
    rng = np.random.default_rng(0)
    norms = []
    for _ in range(steps):
        g = jax.tree.map(lambda p: jnp.asarray(
            rng.standard_normal(p.shape).astype(np.float32) * grad_scale
        ).astype(p.dtype), params)
        params, rs, rn = ropt.update(g, rs, params)
        _, ps, pn = popt.update(_named_grads(g), ps, pm)
        norms.append((float(rn), float(pn)))
    return params, rs, pm, ps, norms


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("state_dtype", ["int8", "float32", "bfloat16"])
def test_adamw_matches_reference(state_dtype, dtype):
    params, rs, pm, ps, norms = _run_adamw(state_dtype, dtype, 1e-3)
    for rn, pn in norms:
        assert rn < 1.0                 # below the clip: scale exactly 1
        np.testing.assert_allclose(pn, rn, rtol=1e-5)
    assert int(ps.step) == int(rs.step) == 3
    for leaf in param_leaves(pm):
        for mine, ref in ((ps.m[leaf.path], _leaf(rs.m, leaf.path)),
                          (ps.v[leaf.path], _leaf(rs.v, leaf.path))):
            if state_dtype == "int8":
                assert mine.q.dtype == getattr(torch, str(ref.q.dtype))
                np.testing.assert_array_equal(mine.q.numpy(),
                                              np.asarray(ref.q))
                np.testing.assert_allclose(mine.scale.numpy(),
                                           np.asarray(ref.scale), rtol=0,
                                           atol=1e-7)
            else:
                np.testing.assert_array_equal(
                    mine.float().numpy(), np.asarray(ref, np.float32))
    for r, b in zip(jax.tree.leaves(params),
                    jax.tree.leaves(params_to_numpy(pm))):
        np.testing.assert_allclose(b, np.asarray(r, np.float32), rtol=0,
                                   atol=1e-7 if dtype == "float32" else 0)


def test_adamw_clipped_matches_reference():
    params, _, pm, _, norms = _run_adamw("float32", "float32", 1e-2)
    for rn, pn in norms:
        assert rn > 1.0                 # the clip is active
        np.testing.assert_allclose(pn, rn, rtol=1e-5)
    for r, b in zip(jax.tree.leaves(params),
                    jax.tree.leaves(params_to_numpy(pm))):
        np.testing.assert_allclose(b, np.asarray(r), rtol=0, atol=1e-6)


@pytest.mark.parametrize("remat", ["none", "block"])
def test_model_loss_and_grads_match_reference(remat):
    rm, params, pm = _pair("float32")
    b = _batch(B=2, S=16)
    loss, g = jax.value_and_grad(rm.loss)(
        params, {k: jnp.asarray(v) for k, v in b.items()})
    pm.requires_grad_(True)
    mine = pm.loss(_torch_batch(b), remat=remat)
    names, ps = zip(*pm.named_parameters())
    grads = torch.autograd.grad(mine, ps)
    np.testing.assert_allclose(float(mine), float(loss), rtol=1e-5)
    want = _named_grads(g)
    for n, gp in zip(names, grads):
        scale = float(want[n].abs().max())
        np.testing.assert_allclose(gp.numpy(), want[n].numpy(),
                                   atol=1e-4 * max(scale, 1.0), rtol=1e-4)


def test_train_step_matches_reference():
    """One float32 step of each package with two microbatches and int8
    moments: loss, grad norm and parameters agree."""
    rm, params, pm = _pair("float32")
    b = _batch(B=4, S=16, seed=5)
    ropt = ref_opt.AdamW(lr=1e-3, state_dtype="int8")
    popt = AdamW(lr=1e-3, state_dtype="int8")
    rstep = jax.jit(ref_step(rm, RefParallel(microbatches=2, remat="block"),
                             ropt))
    pstep = build_train_step(pm, ParallelismConfig(microbatches=2,
                                                   remat="block"), popt)
    params, _, rmet = rstep(params, ropt.init(params),
                            {k: jnp.asarray(v) for k, v in b.items()})
    _, _, pmet = pstep(pm, popt.init(pm), _torch_batch(b))
    np.testing.assert_allclose(float(pmet["loss"]), float(rmet["loss"]),
                               rtol=1e-5)
    np.testing.assert_allclose(float(pmet["grad_norm"]),
                               float(rmet["grad_norm"]), rtol=1e-4)
    for r, mine in zip(jax.tree.leaves(params),
                       jax.tree.leaves(params_to_numpy(pm))):
        # a first Adam step moves a parameter by lr * g / (|g| + eps):
        # where |g| is near eps (1e-8) the gradients' float32 differences
        # (other summation orders) change that step by a share of lr;
        # 1e-4 is a tenth of lr (measured at most 2.6e-5)
        np.testing.assert_allclose(mine, np.asarray(r), rtol=0, atol=1e-4)


def test_eval_step_is_the_loss_without_grad():
    _, _, pm = _pair("float32")
    b = _torch_batch(_batch(B=2, S=8))
    ev = build_eval_step(pm)(pm, b)
    assert ev.grad_fn is None
    assert float(ev) == float(pm.loss(b))


def test_cli_trains_on_cpu(tmp_path, capsys):
    train_cli.main(["--steps", "3", "--batch", "2", "--seq", "16",
                    "--device", "cpu", "--ckpt-dir", str(tmp_path)])
    out = capsys.readouterr().out
    assert "3 steps in" in out and "loss" in out
    assert (tmp_path / "LATEST").read_text() == "step_00000003"
    # the vlm family trains too (every family is ported)
    train_cli.main(["--arch", "internvl2-2b", "--steps", "1", "--batch", "2",
                    "--seq", "16", "--device", "cpu", "--ckpt-dir",
                    str(tmp_path / "internvl2")])
    out = capsys.readouterr().out
    assert "arch=internvl2-2b" in out and "1 steps in" in out
    assert (tmp_path / "internvl2" / "LATEST").read_text() == "step_00000001"


def test_cli_rerun_over_its_checkpoints_trains_no_steps(tmp_path, capsys):
    """A second run with the same ``--ckpt-dir`` resumes from the first
    run's last checkpoint, already at ``--steps``: it trains 0 steps,
    says so, prints no loss and returns.  (The reference's CLI indexes
    the empty history there and raises IndexError; the port does not.)"""
    argv = ["--arch", SSM, "--steps", "2", "--batch", "2", "--seq", "16",
            "--device", "cpu", "--ckpt-dir", str(tmp_path)]
    train_cli.main(argv)
    assert "2 steps in" in capsys.readouterr().out
    train_cli.main(argv)
    out = capsys.readouterr().out
    assert "0 steps in" in out and "loss" not in out
    assert (tmp_path / "LATEST").read_text() == "step_00000002"


def test_train_steps_records_each_step():
    pm = build(registry.get_reduced(ARCH)).init(seed=0, device="cpu")
    parallel = ParallelismConfig(remat="block", opt_state_dtype="int8")
    source = train_cli.lm_batch_source(pm, 2, 16)
    hist = train_cli.train_steps(
        pm, AdamW(lr=1e-3, state_dtype=parallel.opt_state_dtype), parallel,
        source, 3)
    assert [h["step"] for h in hist] == [1, 2, 3]
    assert all(np.isfinite(h["loss"]) and h["seconds"] > 0 for h in hist)


def test_parallelism_config_is_the_reference_dataclass():
    assert dataclasses.asdict(ParallelismConfig()) == \
        dataclasses.asdict(RefParallel())
    assert ParallelismConfig().replace(remat="block").remat == "block"


def test_chunked_update_equals_whole(monkeypatch):
    """The update walks leaves in row pieces of CHUNK elements; a tiny
    CHUNK (many pieces) gives the same bits as one piece per layer."""
    outs = []
    for chunk in (1 << 24, 300):
        monkeypatch.setattr(opt_mod, "CHUNK", chunk)
        _, _, pm, ps, _ = _run_adamw("int8", "bfloat16", 1e-3, steps=2)
        outs.append((params_to_numpy(pm), ps))
    for a, b in zip(jax.tree.leaves(outs[0][0]), jax.tree.leaves(outs[1][0])):
        np.testing.assert_array_equal(a, b)
    for path, m in outs[0][1].m.items():
        assert torch.equal(m.q, outs[1][1].m[path].q)


# ------------------------------------------------ the ssm family (mamba2)

SSM = "mamba2-1.3b"


def _ssm_cfgs(chunk=16):
    """Reduced mamba2-1.3b of each package with the scan's chunk set."""
    ref, mine = ref_registry.get_reduced(SSM), registry.get_reduced(SSM)
    return (dataclasses.replace(ref, ssm=dataclasses.replace(ref.ssm,
                                                             chunk=chunk)),
            dataclasses.replace(mine, ssm=dataclasses.replace(mine.ssm,
                                                              chunk=chunk)))


def _ssm_pair():
    ref_cfg, cfg = _ssm_cfgs()
    rm = ref_build(ref_cfg)
    params = rm.init(jax.random.key(0), dtype=jnp.float32)
    pm = params_from_jax(build(cfg), jax.tree.map(np.asarray, params))
    return rm, params, pm, cfg


@pytest.mark.parametrize("remat", ["none", "block"])
def test_ssm_loss_and_grads_match_reference(remat):
    """Every parameter's gradient, the ssm weights that reach the scan
    (wx, wB, wC, wdt, A_log, dt_bias, conv_*) included."""
    rm, params, pm, cfg = _ssm_pair()
    b = _batch(B=2, S=64, seed=3)
    loss, g = jax.value_and_grad(rm.loss)(
        params, {k: jnp.asarray(v) for k, v in b.items()})
    pm.requires_grad_(True)
    mine = pm.loss(_torch_batch(b), remat=remat)
    names, ps = zip(*pm.named_parameters())
    grads = torch.autograd.grad(mine, ps)
    np.testing.assert_allclose(float(mine), float(loss), rtol=1e-5)
    want = _named_grads(g, cfg)
    for n, gp in zip(names, grads):
        scale = float(want[n].abs().max())
        np.testing.assert_allclose(gp.numpy(), want[n].numpy(),
                                   atol=1e-4 * max(scale, 1.0), rtol=1e-4)
    for n in ("wx", "wB", "wC", "wdt", "A_log", "dt_bias", "conv_x"):
        assert float(dict(zip(names, grads))[f"blocks.1.ssm.{n}"].abs()
                     .max()) > 0, n


def test_ssm_train_step_matches_reference():
    """One float32 step of each package with block remat and int8
    moments: loss, grad norm and parameters agree.  The two packages'
    gradients differ by float32 rounding (other summation orders), which
    moves a moment code across a rounding boundary now and then: every
    int8 payload is within one code of the reference's, and at most one
    in a thousand differs (5 of 638,976 measured).  Fed the same
    gradients, the payloads are byte-equal
    (``test_ssm_adamw_payloads_equal_reference``)."""
    rm, params, pm, _ = _ssm_pair()
    b = _batch(B=2, S=64, seed=5)
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
        # as test_train_step_matches_reference: a tenth of lr
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


def test_ssm_adamw_payloads_equal_reference():
    """AdamW over reduced mamba2's leaves, 3 steps with the same
    gradients (numpy, below the clip) on both sides: the int8 payloads
    byte-equal, scales within float32 rounding, parameters equal.  The
    stacked (L, nh) leaves A_log, dt_bias and D_skip are shorter than a
    256-value block, so their blocks span the layers, as in the
    reference."""
    _, params, pm, cfg = _ssm_pair()
    ropt, popt = (ref_opt.AdamW(lr=1e-2, state_dtype="int8"),
                  AdamW(lr=1e-2, state_dtype="int8"))
    rs, ps = ropt.init(params), popt.init(pm)
    rng = np.random.default_rng(0)
    for _ in range(3):
        g = jax.tree.map(lambda p: jnp.asarray(
            rng.standard_normal(p.shape).astype(np.float32) * 1e-3), params)
        params, rs, _ = ropt.update(g, rs, params)
        _, ps, _ = popt.update(_named_grads(g, cfg), ps, pm)
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


def test_ssm_leaves_and_decay_follow_the_stacked_shape():
    """The optimizer's leaves are the reference's stacked leaves, and the
    per-layer (nh,) A_log, dt_bias, D_skip and (d_in,) norm stack to
    ndim 2, so they decay as in the reference; final_norm does not."""
    _, params, pm, _ = _ssm_pair()
    flat = jax.tree_util.tree_flatten_with_path(params)[0]
    leaves = param_leaves(pm)
    assert [lf.path for lf in leaves] == [
        "/".join(p.key for p in path) for path, _ in flat]
    assert [lf.shape for lf in leaves] == [tuple(a.shape) for _, a in flat]
    before = {n: p.detach().clone() for n, p in pm.named_parameters()}
    opt = AdamW(lr=0.5, weight_decay=0.1)
    opt.update({n: torch.zeros_like(p) for n, p in pm.named_parameters()},
               opt.init(pm), pm)
    for n, p in pm.named_parameters():
        if n == "final_norm":
            assert torch.equal(p, before[n])
        else:
            torch.testing.assert_close(p, before[n] * (1 - 0.5 * 0.1))


def test_cli_trains_mamba2_on_cpu(tmp_path, capsys):
    train_cli.main(["--arch", SSM, "--steps", "3", "--batch", "2", "--seq",
                    "16", "--device", "cpu", "--ckpt-dir", str(tmp_path)])
    out = capsys.readouterr().out
    assert "arch=mamba2-1.3b" in out and "3 steps in" in out
    losses = [float(x) for x in re.findall(r"loss ([0-9.eE+-]+)", out)]
    assert losses and all(np.isfinite(losses))
