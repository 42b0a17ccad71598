"""The reference's sharded layout for the vlm, encdec and encoder families
under ``make_rules``: their attention heads, MLP and vocab tensor-parallel
over ``model`` as the dense family's; the vlm's patch embeddings in front
of the vocab-parallel token embedding; the encdec family's encoder blocks,
cross-attention (Sq != Sk, the encoder's output entering it as a partial)
and the cross cache ``ck``/``cv`` (the rank's kv heads, or its block of
rows where the cache's sequence is split, with the combine over them);
the encoder family's class loss over the global batch.

* One spawn of 4 gloo ranks (``tests/torch_world.py``, case
  ``layout_vlm_encdec``) runs four float32 cases: each trains
  ``build_train_step`` under the train rules (if it has steps), prefills
  a prompt on a placement of the initial parameters under the prefill
  rules, carries the cache to the decode rules' spec
  (``sharding.relayout``) and decodes under them:

  - ``vlm``: reduced internvl2-2b (4 heads, 2 kv heads) on ``data`` 1 x
    ``model`` 4, so that its kv heads stay whole as in production: 2
    steps, a prefill of 8 patches and 3 tokens, 6 decode steps with the
    cache's 32 positions on ``model`` (rank 2's block wholly masked
    until position 16, rank 3's throughout);
  - ``encdec``: reduced seamless-m4t-large-v2 on ``data`` 2 x ``model``
    2: 2 steps, a prefill that replaces the cache's 17 cross rows
    (``encdec_src_len(136)``) with its own 16, 6 decode steps on the
    rank's kv heads;
  - ``encdec_kv_seq``: the same with 2 kv heads on ``model`` 4 under the
    decode rules: the self cache's sequence and the cross cache's rows
    both split over ``model`` (the cross-attention's combine, no mask);
  - ``encoder``: reduced vit-huge on ``data`` 2 x ``model`` 2, 2 steps.

  The reference runs in a JAX subprocess with 8 fake CPU devices:
  ``build_train_step``, ``prefill`` and ``decode_step`` jitted with
  ``in_shardings`` on the same mesh shapes.  Its float32 encdec forward
  raises ``TypeError`` (``tests/test_torch_encdec.py``), so there its
  ``run_encoder`` is swapped for the unrolled encoder of
  ``tests/test_torch_encdec.py::_ref_encode``, inside the subprocess.
  Within 1e-4: every parameter and moment, the loss and gradient norm
  (relative), the prefill's and each decode step's logits and the final
  cache, against the reference and against the port's own single-device
  run.
* On a fake world of 16 ranks (``data`` 4 x ``model`` 4) rank 0 holds, of
  every moved internvl2 and seamless cell and of vit-huge's
  ``train_224`` (reduced), exactly the reference's
  ``analytic_bytes_per_device``; the pure data-parallel train cells keep
  the replicated program; K4's traced FLOPs on the production mesh are
  the rank's heads'; and the trace of two moved cells counts what rank 0
  of 4 gloo ranks does running them (``torch_world`` case ``dryrun``).
"""
import dataclasses
import os
import pickle
import subprocess
import sys
import textwrap

import numpy as np
import pytest

torch = pytest.importorskip("torch")


from repro.configs import registry as ref_registry  # noqa: E402

from repro_torch.configs import registry  # noqa: E402
from repro_torch.configs.base import (ParallelismConfig,  # noqa: E402
                                      ShapeConfig)
from repro_torch.distributed.sharding import (make_rules,  # noqa: E402
                                              runs_layout)
from repro_torch.launch import dryrun  # noqa: E402
from repro_torch.models.convert import params_from_jax  # noqa: E402
from repro_torch.models.model import build  # noqa: E402
from repro_torch.models.params import param_count  # noqa: E402
from repro_torch.models.transformer import encdec_src_len  # noqa: E402
from repro_torch.train.optimizer import AdamW  # noqa: E402
from repro_torch.train.step import build_train_step  # noqa: E402

import torch_world  # noqa: E402

SRC = os.path.join(os.path.dirname(__file__), "..", "src")
OPT = {"lr": 1e-2, "eps": 1e-3}
STEPS = 2
#: the training batch: B rows of S positions (the vlm's patches included)
B_TRAIN, S_TRAIN = 4, 40
#: case -> (arch, config overrides, mesh (data, model), train steps,
#: prompt (batch, tokens; None: no prefill), s_max, decode steps)
CASES = {
    "vlm": ("internvl2-2b", {}, (1, 4), STEPS, (2, 3), 32, 6),
    "encdec": ("seamless-m4t-large-v2", {}, (2, 2), STEPS, (2, 8), 136, 6),
    "encdec_kv_seq": ("seamless-m4t-large-v2", {"n_kv_heads": 2}, (1, 4), 0,
                      (2, 8), 160, 6),
    "encoder": ("vit-huge", {}, (2, 2), STEPS, None, 0, 0),
}
TOL = 1e-4
TP = dict(tp=True)


def _cfg(get, case):
    arch, over = CASES[case][:2]
    return dataclasses.replace(get(arch), **over)


def _embeds(rng, B, rows, cfg):
    return rng.standard_normal((B, rows, cfg.d_model)).astype(np.float32)


def _inputs(cfg, case):
    """The case's training batch, prompt and decode tokens (numpy)."""
    _, _, _, steps, prompt, _, n_dec = CASES[case]
    rng = np.random.default_rng(13)
    B, S = B_TRAIN, S_TRAIN
    if cfg.family == "encoder":
        batch = {"patch_embeds": _embeds(rng, B, cfg.frontend_tokens, cfg),
                 "labels": rng.integers(0, cfg.n_classes,
                                        (B,)).astype(np.int32)}
    else:
        toks = rng.integers(0, cfg.vocab_size, (B, S + 1)).astype(np.int32)
        batch = {"tokens": toks[:, :-1].copy(), "labels": toks[:, 1:].copy()}
        if cfg.family == "vlm":
            P = cfg.frontend_tokens
            batch["tokens"] = batch["tokens"][:, :S - P].copy()
            batch["patch_embeds"] = _embeds(rng, B, P, cfg)
        else:
            batch["src_embeds"] = _embeds(rng, B, encdec_src_len(S), cfg)
    out = {"batch": batch, "steps": steps, "prompt": None, "extra": {},
           "decode": []}
    if prompt is None:
        return out
    Bp, T = prompt
    out["prompt"] = rng.integers(0, cfg.vocab_size, (Bp, T)).astype(np.int32)
    if cfg.family == "vlm":
        out["extra"] = {"patch_embeds": _embeds(rng, Bp, cfg.frontend_tokens,
                                                cfg)}
    else:
        out["extra"] = {"src_embeds": _embeds(rng, Bp, encdec_src_len(T),
                                              cfg)}
    out["decode"] = [rng.integers(0, cfg.vocab_size, (Bp, 1)).astype(np.int32)
                     for _ in range(n_dec)]
    return out


def _positions(case, inp):
    """The prefill's positions: the vlm's patches, then the tokens."""
    return inp["prompt"].shape[1] + sum(
        v.shape[1] for k, v in inp["extra"].items() if k == "patch_embeds")


_REF = """
import dataclasses, pickle
import numpy as np, jax, jax.numpy as jnp
jax.devices()
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P
from repro.configs import registry
from repro.configs.base import ParallelismConfig, ShapeConfig
from repro.distributed.compat import set_mesh
from repro.distributed.sharding import make_rules, use_rules
from repro.launch.dryrun import _ns, _opt_specs
from repro.models import layers as ref_layers
from repro.models import transformer as ref_tfm
from repro.models.model import build
from repro.models.params import partition_specs
from repro.train.optimizer import AdamW
from repro.train.step import build_train_step


def run_encoder(params, src, cfg, remat="none"):
    # tests/test_torch_encdec.py::_ref_encode: the scan unrolled (the
    # reference's float32 scan raises on its bf16 -> float32 carry)
    x = jnp.asarray(src).astype(jnp.bfloat16)
    positions = jnp.arange(x.shape[1])
    for l in range(cfg.n_encoder_layers):
        lp = jax.tree.map(lambda a: a[l], params["enc_blocks"])
        x, _ = ref_tfm._attn_block(lp, x, cfg, positions, causal=False)
    return (ref_layers.rmsnorm(x, params["enc_norm"], cfg.norm_eps),
            jnp.zeros((), jnp.float32))


ref_tfm.run_encoder = run_encoder
cases = pickle.load(open({inp!r}, "rb"))
out = {{}}
tree = lambda t: jax.tree.map(np.asarray, t)
for key, c in cases.items():
    cfg = dataclasses.replace(registry.get_reduced(c["arch"]), **c["over"])
    dp, tp = c["mesh"]
    mesh = Mesh(np.asarray(jax.devices()[:dp * tp]).reshape(dp, tp),
                ("data", "model"))
    rm = build(cfg)
    params = rm.init(jax.random.key(0), dtype=jnp.float32)
    res = {{"init": tree(params)}}
    par = ParallelismConfig(**c["parallel"])
    if c["steps"]:
        B, S = c["train_shape"]
        shape = ShapeConfig("train_4k", S, B, "train")
        opt = AdamW(**c["opt"], state_dtype=par.opt_state_dtype)
        o = opt.init(params)
        rules = make_rules(cfg, shape, par, tp_size=tp, dp_size=dp,
                           mesh=mesh)
        p_specs = partition_specs(rm.param_defs(), rules.mapping)
        b_specs = {{k: rules.spec(*ax)
                   for k, ax in rm.batch_logical_axes(shape).items()}}
        m_specs = _opt_specs(p_specs, o.m, par.fsdp, dp)
        o_specs = type(o)(step=P(), m=m_specs, v=m_specs)
        hist = []
        with use_rules(rules), set_mesh(mesh):
            step = jax.jit(build_train_step(rm, par, opt),
                           in_shardings=(_ns(mesh, p_specs),
                                         _ns(mesh, o_specs),
                                         _ns(mesh, b_specs)),
                           out_shardings=(_ns(mesh, p_specs),
                                          _ns(mesh, o_specs), None))
            p = jax.device_put(params, _ns(mesh, p_specs))
            s = jax.device_put(o, _ns(mesh, o_specs))
            batch = jax.device_put(
                {{k: jnp.asarray(v) for k, v in c["batch"].items()}},
                _ns(mesh, b_specs))
            for _ in range(c["steps"]):
                p, s, m = step(p, s, batch)
                hist.append((float(m["loss"]), float(m["grad_norm"])))
        res.update(hist=hist, params=tree(p), m=tree(s.m), v=tree(s.v))
    if c["prompt"] is None:
        out[key] = res
        continue
    prompt = c["prompt"]
    B = prompt.shape[0]
    S = c["positions"]
    s_max = c["s_max"]
    pshape = ShapeConfig("prefill", S, B, "prefill")
    dshape = ShapeConfig("decode", s_max, B, "decode")
    prules = make_rules(cfg, pshape, par, tp_size=tp, dp_size=dp, mesh=mesh)
    drules = make_rules(cfg, dshape, par, tp_size=tp, dp_size=dp, mesh=mesh)
    c_defs = rm.cache_defs(B, s_max)
    zeros = {{k: jnp.zeros(d.shape, jnp.float32) for k, d in c_defs.items()}}
    pc_specs = partition_specs(c_defs, prules.mapping)
    dc_specs = partition_specs(c_defs, drules.mapping)
    with use_rules(prules), set_mesh(mesh):
        pp_specs = partition_specs(rm.param_defs(), prules.mapping)
        in_spec = {{"tokens": prules.spec("batch", None),
                   **{{k: prules.spec("batch", None, "act_embed")
                      for k in c["extra"]}}}}
        fn = jax.jit(lambda p, b, c: rm.prefill(p, b, c),
                     in_shardings=(_ns(mesh, pp_specs), _ns(mesh, in_spec),
                                   _ns(mesh, pc_specs)),
                     out_shardings=(None, _ns(mesh, pc_specs)))
        logits, cache = fn(jax.device_put(params, _ns(mesh, pp_specs)),
                           jax.device_put({{"tokens": jnp.asarray(prompt),
                                           **{{k: jnp.asarray(v) for k, v
                                              in c["extra"].items()}}}},
                                          _ns(mesh, in_spec)),
                           jax.device_put(zeros, _ns(mesh, pc_specs)))
    res["prefill"] = np.asarray(logits)
    res["prefill_cache"] = tree(cache)
    steps = []
    with use_rules(drules), set_mesh(mesh):
        dp_specs = partition_specs(rm.param_defs(), drules.mapping)
        dec = jax.jit(lambda p, c, t, i: rm.decode_step(p, c, t, i),
                      in_shardings=(_ns(mesh, dp_specs), _ns(mesh, dc_specs),
                                    NamedSharding(mesh, drules.spec(
                                        "batch", None)),
                                    NamedSharding(mesh, P())),
                      out_shardings=(None, _ns(mesh, dc_specs)))
        p = jax.device_put(params, _ns(mesh, dp_specs))
        cache = jax.device_put(cache, _ns(mesh, dc_specs))
        for i, tok in enumerate(c["decode"]):
            logits, cache = dec(p, cache, jnp.asarray(tok),
                                jnp.asarray(S + i, jnp.int32))
            steps.append(np.asarray(logits))
    res.update(decode=steps, cache=tree(cache))
    out[key] = res
pickle.dump(out, open({out!r}, "wb"))
print("ok")
"""


def _flat(tree, prefix=""):
    """A nested dict of arrays as {path: array}."""
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_flat(v, f"{prefix}{k}/"))
        else:
            out[f"{prefix}{k}"] = v
    return out


def _case_inputs(key, get):
    arch, over, mesh, _, _, s_max, _ = CASES[key]
    inp = _inputs(_cfg(get, key), key)
    labels = inp["batch"]["labels"]
    return {"arch": arch, "over": over, "mesh": mesh, "opt": OPT,
            "parallel": TP, "s_max": s_max,
            "train_shape": (labels.shape[0], labels.shape[-1]),
            "positions": _positions(key, inp) if inp["prompt"] is not None
            else 0, **inp}


@pytest.fixture(scope="module")
def ref(tmp_path_factory):
    d = tmp_path_factory.mktemp("layout_vlm_encdec_ref")
    cases = {key: _case_inputs(key, ref_registry.get_reduced)
             for key in CASES}
    with open(d / "in.pkl", "wb") as f:
        pickle.dump(cases, f)
    env = dict(os.environ, PYTHONPATH=SRC, JAX_PLATFORMS="cpu",
               OMP_NUM_THREADS="1",
               XLA_FLAGS="--xla_force_host_platform_device_count=8")
    code = _REF.format(inp=str(d / "in.pkl"), out=str(d / "out.pkl"))
    proc = subprocess.run([sys.executable, "-c", textwrap.dedent(code)],
                          capture_output=True, text=True, env=env,
                          timeout=900)
    assert proc.returncode == 0, proc.stderr[-4000:]
    with open(d / "out.pkl", "rb") as f:
        return cases, pickle.load(f)


def _port_model(case, tree):
    return params_from_jax(build(_cfg(registry.get_reduced, case)), tree)


def _tensor(v):
    t = torch.from_numpy(v)
    return t.long() if v.dtype.kind == "i" else t


@pytest.fixture(scope="module")
def world(ref, tmp_path_factory):
    cases, outs = ref
    inputs = {}
    for key in CASES:
        model = _port_model(key, outs[key]["init"])
        c = cases[key]
        prompt = c["prompt"]
        inputs[key] = {
            "cfg": model.cfg, "mesh": c["mesh"], "steps": c["steps"],
            "train_parallel": ParallelismConfig(**TP), "opt": OPT,
            "parallel": ParallelismConfig(**TP), "s_max": c["s_max"],
            "state": {n: p.detach().clone()
                      for n, p in model.named_parameters()},
            "batch": {k: _tensor(v) for k, v in c["batch"].items()},
            "prompt": None if prompt is None else _tensor(prompt),
            "prompt_inputs": {k: _tensor(v) for k, v in c["extra"].items()},
            "decode": [_tensor(t) for t in c["decode"]]}
    return torch_world.spawn("layout_vlm_encdec",
                             tmp_path_factory.mktemp("layout_vlm_encdec"),
                             {"cases": inputs}, deadline=400.0)


@pytest.fixture(scope="module")
def single(ref):
    """The port's single-device run (no rules) on the same weights and
    inputs: the training history, parameters and moments, the prefill's
    logits and cache, each decode step's logits and the final cache."""
    cases, outs = ref
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        return {key: _single_run(key, cases[key], outs[key])
                for key in CASES}
    finally:
        torch.set_num_threads(threads)


def _single_run(key, case, out):
    res = {}
    if case["steps"]:
        model = _port_model(key, out["init"])
        par = ParallelismConfig(**TP)
        opt = AdamW(**OPT)
        state = opt.init(model)
        step = build_train_step(model, par, opt)
        batch = {k: _tensor(v) for k, v in case["batch"].items()}
        hist = []
        for _ in range(case["steps"]):
            model, state, m = step(model, state, batch)
            hist.append((float(m["loss"]), float(m["grad_norm"])))
        res.update(hist=hist, params={n: p.detach() for n, p in
                                      model.named_parameters()},
                   moments={k: (state.m[k], state.v[k]) for k in state.m})
    if case["prompt"] is None:
        return res
    model = _port_model(key, out["init"])
    B = case["prompt"].shape[0]
    cache = {k: torch.zeros(d.shape, dtype=torch.float32)
             for k, d in model.cache_defs(B, case["s_max"]).items()}
    logits, cache = model.prefill(
        {"tokens": _tensor(case["prompt"]),
         **{k: _tensor(v) for k, v in case["extra"].items()}}, cache)
    pcache = {k: c.clone() for k, c in cache.items()}
    steps = []
    for i, tok in enumerate(case["decode"]):
        lg, cache = model.decode_step(cache, _tensor(tok),
                                      case["positions"] + i)
        steps.append(lg)
    return {**res, "prefill": logits, "prefill_cache": pcache,
            "decode": steps, "cache": cache}


def _close(got, want, what):
    got = np.asarray(got.detach().float().numpy() if hasattr(got, "detach")
                     else got, dtype=np.float32)
    want = np.asarray(want.detach().float().numpy() if hasattr(
        want, "detach") else want, dtype=np.float32)
    assert got.shape == want.shape, (what, got.shape, want.shape)
    np.testing.assert_allclose(got, want, rtol=0, atol=TOL, err_msg=what)


def _hist_close(got, want):
    for (gl, gn), (wl, wn) in zip(got, want, strict=True):
        assert abs(gl - wl) <= TOL * abs(wl), (gl, wl)
        assert abs(gn - wn) <= TOL * abs(wn), (gn, wn)


TRAIN_CASES = [k for k in CASES if CASES[k][3]]
SERVE_CASES = [k for k in CASES if CASES[k][4]]


@pytest.mark.parametrize("case", CASES)
def test_ranks_agree(world, case):
    """Every rank gathers the same logits, cache and parameters."""
    first = world[0][case]
    for out in world[1:]:
        got = out[case]
        assert got.get("hist") == first.get("hist")
        for n, p in first.get("params", {}).items():
            assert torch.equal(got["params"][n], p), n
        if case not in SERVE_CASES:
            continue
        assert torch.equal(got["prefill"], first["prefill"])
        for a, b in zip(got["decode"], first["decode"], strict=True):
            assert torch.equal(a, b)
        for k, c in first["cache"].items():
            assert torch.equal(got["cache"][k], c), k


@pytest.mark.parametrize("case", SERVE_CASES)
def test_prefill_and_decode_match_reference(world, ref, case):
    """The prefill's and every decode step's logits and the final cache
    (the cross rows the prefill wrote among them) within 1e-4 of the
    reference's jitted, sharded program."""
    want = ref[1][case]
    got = world[0][case]
    _close(got["prefill"], want["prefill"], "prefill logits")
    for i, (g, w) in enumerate(zip(got["decode"], want["decode"],
                                   strict=True)):
        _close(g, w, f"decode step {i}")
    for k, c in want["cache"].items():
        _close(got["cache"][k], c, f"cache {k}")


@pytest.mark.parametrize("case", SERVE_CASES)
def test_prefill_and_decode_match_single_device(world, single, case):
    want = single[case]
    got = world[0][case]
    _close(got["prefill"], want["prefill"], "prefill logits")
    for i, (g, w) in enumerate(zip(got["decode"], want["decode"],
                                   strict=True)):
        _close(g, w, f"decode step {i}")
    for k, c in want["cache"].items():
        _close(got["cache"][k], c, f"cache {k}")


@pytest.mark.parametrize("case", TRAIN_CASES)
def test_train_step_matches_reference(world, ref, case):
    """2 steps: the loss, the gradient norm, every parameter and both
    moments of every leaf (the encoder blocks' and the cross-attention's
    among them) within 1e-4 of the reference's jitted step."""
    want = ref[1][case]
    got = world[0][case]
    _hist_close(got["hist"], want["hist"])
    model = _port_model(case, want["params"])
    for n, p in model.named_parameters():
        _close(got["params"][n], p, n)
    for path, w in _flat(want["m"]).items():
        _close(got["moments"][path][0], w, f"m {path}")
    for path, w in _flat(want["v"]).items():
        _close(got["moments"][path][1], w, f"v {path}")


@pytest.mark.parametrize("case", TRAIN_CASES)
def test_train_step_matches_single_device(world, single, case):
    want = single[case]
    got = world[0][case]
    _hist_close(got["hist"], want["hist"])
    for n, p in want["params"].items():
        _close(got["params"][n], p, n)
    for path, (m, v) in want["moments"].items():
        _close(got["moments"][path][0], m, f"m {path}")
        _close(got["moments"][path][1], v, f"v {path}")


@pytest.mark.parametrize("case", TRAIN_CASES)
def test_the_steps_move_every_head_block(world, ref, case):
    """The steps train: the loss falls, and the attention's ``wq`` and
    ``wo`` move in every rank's block of heads (a rank that kept another
    block, or dropped its gradient, would not match the reference
    above; this says the comparison is not of two standing models): in
    the decoder's blocks and, for the encdec family, in its encoder
    blocks and cross-attention too."""
    got = world[0][case]
    assert got["hist"][1][0] < got["hist"][0][0], got["hist"]
    init = _port_model(case, ref[1][case]["init"])
    n_model = CASES[case][2][1]
    seen = set()
    for n, p in init.named_parameters():
        mod, _, leaf = n.rpartition(".")
        if leaf in ("wq", "wo") and mod.rpartition(".")[2] in ("attn",
                                                               "cross"):
            moved = (got["params"][n] - p.detach()).abs().chunk(
                n_model, 0 if leaf == "wo" else -1)
            assert all(float(b.max()) > 0 for b in moved), n
            seen.add(n.split(".")[0] + "." + mod.rpartition(".")[2])
    want = {"blocks.attn"} | ({"enc_blocks.attn", "blocks.cross"}
                              if case == "encdec" else set())
    assert seen == want, seen


def test_prefill_replaces_the_cross_rows(world, ref, single):
    """The encdec prefill writes its own ``encdec_src_len(8)`` = 16 cross
    rows in place of the cache's ``encdec_src_len(136)`` = 17, as the
    reference's; the decode cache keeps them, on the rank's kv heads."""
    cfg = _cfg(registry.get_reduced, "encdec")
    got = world[0]["encdec"]
    rows = (encdec_src_len(CASES["encdec"][5]), encdec_src_len(8))
    assert rows == (17, 16)
    for k in ("ck", "cv"):
        assert got["cache"][k].shape[2] == rows[1]
        assert ref[1]["encdec"]["prefill_cache"][k].shape[2] == rows[1]
        _close(got["cache"][k], ref[1]["encdec"]["cache"][k], k)
        # rank 0's block: its row of the batch (data 2), its 2 kv heads
        assert got["local"][k] == (cfg.n_layers, 1, rows[1],
                                   cfg.n_kv_heads // 2,
                                   cfg.resolved_head_dim)
    assert got["kv_seq"] is None and all(got["wrote"])


def test_cross_rows_split_over_model(world):
    """``encdec_kv_seq``: 2 kv heads do not divide ``model`` 4, so the
    decode rules put the cache's sequence there: each rank holds 40 of
    the self cache's 160 positions and 4 of the 16 cross rows of every
    kv head; the new keys (positions 8-13) all go to rank 0, whose block
    alone is unmasked."""
    cfg = _cfg(registry.get_reduced, "encdec_kv_seq")
    for r, out in enumerate(world):
        got = out["encdec_kv_seq"]
        assert got["kv_seq"] == "model"
        L, K, hd = cfg.n_layers, cfg.n_kv_heads, cfg.resolved_head_dim
        assert got["local"]["k"] == (L, 2, 40, K, hd)
        assert got["local"]["ck"] == (L, 2, 4, K, hd)
        assert got["wrote"] == [r == 0] * 6
        assert got["masked"] == [r != 0] * 6


def test_vlm_decode_combines_over_model(world):
    """internvl2's production mapping at a reduced width: its 2 kv heads
    whole (they do not divide ``model`` 4), the cache's 32 positions over
    ``model``; from position 11 the keys go to rank 1 (11-15) then rank 2
    (16), whose block is wholly masked before; rank 3's is throughout."""
    cfg = _cfg(registry.get_reduced, "vlm")
    assert cfg.frontend_tokens == 8
    wrote = {r: out["vlm"]["wrote"] for r, out in enumerate(world)}
    masked = {r: out["vlm"]["masked"] for r, out in enumerate(world)}
    assert world[0]["vlm"]["kv_seq"] == "model"
    assert wrote == {0: [False] * 6, 1: [True] * 5 + [False],
                     2: [False] * 5 + [True], 3: [False] * 6}
    assert masked == {0: [False] * 6, 1: [False] * 6,
                      2: [True] * 5 + [False], 3: [True] * 6}
    assert world[0]["vlm"]["local"]["k"] == (
        cfg.n_layers, 2, 8, cfg.n_kv_heads, cfg.resolved_head_dim)


def test_columns_that_do_not_divide_the_axis_raise():
    """A placed parameter must split evenly over ``model``: vit-huge at 5
    heads of 10 (``wq``'s 50 columns) over 4 ranks raises ``ValueError``
    where the parameters are placed (nothing falls back to replicating
    them)."""
    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh
    from torch.testing._internal.distributed.fake_pg import FakeStore
    from repro_torch.distributed.sharding import distribute_model
    cfg = dataclasses.replace(registry.get_reduced("vit-huge"), n_heads=5,
                              n_kv_heads=5, head_dim=10)
    dist.init_process_group("fake", store=FakeStore(), rank=0, world_size=4)
    try:
        mesh = init_device_mesh("cpu", (1, 4),
                                mesh_dim_names=("data", "model"))
        rules = make_rules(cfg, ShapeConfig("train_224", 17, 8, "train"),
                           ParallelismConfig(tp=True), tp_size=4, dp_size=1,
                           mesh=mesh)
        assert runs_layout(cfg.family, rules.mapping)
        with pytest.raises(ValueError, match="does not split"):
            distribute_model(build(cfg).init(seed=0, device="cpu"), rules)
    finally:
        dist.destroy_process_group()


# ------------------------------------------------ the dry-run's layout


SEQ = 64
ARCHS = ("internvl2-2b", "seamless-m4t-large-v2")
TRAIN_224 = ShapeConfig("train_224", 17, 64, "train")
#: the moved cells at reduced widths on a (4, 4) world: train with a batch
#: that does not divide the 16 ranks (tensor parallelism, the train
#: multi cells'), prefill and decode; vit-huge's train_224
MOVED = [(a, s) for a in ARCHS for s in (
    ShapeConfig("train_4k", SEQ, 8, "train"),
    ShapeConfig("prefill_32k", SEQ, 32, "prefill"),
    ShapeConfig("decode_32k", SEQ, 32, "decode"))] + [("vit-huge", TRAIN_224)]
#: the cells the reference also holds whole: pure data-parallel training
KEPT = [(a, ShapeConfig("train_4k", SEQ, 256, "train")) for a in ARCHS]


@pytest.fixture
def fake16():
    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh
    from torch.testing._internal.distributed.fake_pg import FakeStore
    dist.init_process_group("fake", store=FakeStore(), rank=0, world_size=16)
    try:
        yield init_device_mesh("cpu", (4, 4), mesh_dim_names=("data",
                                                              "model"))
    finally:
        dist.destroy_process_group()


@pytest.mark.parametrize("arch,shape", MOVED,
                         ids=[f"{a}-{s.name}" for a, s in MOVED])
def test_held_bytes_equal_analytic(arch, shape, fake16, monkeypatch):
    """Rank 0 of a (4, 4) fake world holds, of each moved cell (reduced),
    exactly the reference's analytic bytes per device of parameters and
    moments, or of parameters and cache (the cross cache's included)."""
    monkeypatch.setattr(registry, "get", registry.get_reduced)
    rec = dryrun.lower_cell(arch, shape, multi_pod=False, mesh=fake16)
    assert rec["trace"]["layout"] == "sharded"
    assert rec["trace"]["held_bytes"] == rec["analytic_bytes_per_device"]
    whole = 2 * param_count(build(registry.get(arch)).defs)   # bf16
    assert rec["trace"]["held_bytes"]["params"] < whole


@pytest.mark.parametrize("arch,shape", KEPT,
                         ids=[f"{a}-{s.name}-{s.global_batch}"
                              for a, s in KEPT])
def test_whole_parameter_cells_keep_the_replicated_program(arch, shape,
                                                           fake16,
                                                           monkeypatch):
    """Where the rules place no head (internvl2's and seamless's pure
    data-parallel train single cells) the cell runs the replicated
    program: the reference holds every parameter whole there too, and
    the rank holds its analytic bytes."""
    monkeypatch.setattr(registry, "get", registry.get_reduced)
    cfg = registry.get(arch)
    rules = make_rules(cfg, shape, registry.default_parallelism(cfg, shape),
                       tp_size=4, dp_size=4)
    assert not runs_layout(cfg.family, rules.mapping)
    rec = dryrun.lower_cell(arch, shape, multi_pod=False, mesh=fake16)
    assert rec["trace"]["layout"] == "replicated"
    assert rec["trace"]["held_bytes"] == rec["analytic_bytes_per_device"]


#: (arch, shape) on the production mesh (16 ranks of ``model``) at a
#: reduced width with 16 heads and 16 kv heads, one layer each: K4's
#: launches by (Sq, Sk, causal), forward and backward
SRC_LEN = encdec_src_len(SEQ)
FLOP_CELLS = {
    "seamless-m4t-large-v2": (ShapeConfig("prefill_32k", SEQ, 32, "prefill"),
                              {(SRC_LEN, SRC_LEN, False): (1, 0),
                               (SEQ, SEQ, True): (1, 0),
                               (SEQ, SRC_LEN, False): (1, 0)}),
    "vit-huge": (ShapeConfig("train_224", 17, 256, "train"),
                 {(17, 17, False): (1, 1)}),
}


@pytest.mark.parametrize("arch", FLOP_CELLS)
def test_k4_flops_are_the_ranks_heads(arch, monkeypatch):
    """Rank 0's K4 and its backward count the FLOPs of its one head of
    16 at each of the cell's shapes (seamless's prefill: the encoder,
    the decoder's self-attention and its cross-attention, Sq != Sk;
    vit-huge's training step, forward and backward), of its block of
    the batch, not of all 16 heads."""
    from torch.utils.flop_counter import FlopCounterMode
    from repro_torch.kernels.flash_attention.kernel import (
        flash_attention_backward_plain, flash_attention_plain)
    base = registry.get_reduced(arch)
    over = dict(n_heads=16, n_kv_heads=16, head_dim=16, n_layers=1)
    if base.n_encoder_layers:
        over["n_encoder_layers"] = 1
    cfg = dataclasses.replace(base, **over)
    monkeypatch.setattr(registry, "get", lambda a: cfg)
    shape, launches = FLOP_CELLS[arch]
    seen = []
    real = dryrun.Trace.result

    def result(self, out):
        ops = {torch.ops.repro_torch.flash_attention: "fwd",
               torch.ops.repro_torch.flash_attention_bwd: "bwd"}
        got = {"fwd": 0, "bwd": 0}
        for o, n in self.flops.flop_counts["Global"].items():
            if o in ops:
                got[ops[o]] += n
        seen.append(got)
        return real(self, out)

    monkeypatch.setattr(dryrun.Trace, "result", result)
    rec = dryrun.lower_cell(arch, shape, multi_pod=False)
    assert rec["trace"]["layout"] == "sharded"
    b = shape.global_batch // 16

    def flops(heads):
        want = {"fwd": 0, "bwd": 0}
        for (Sq, Sk, causal), (nf, nb) in launches.items():
            q = torch.empty(b, Sq, heads, 16, device="meta")
            k = torch.empty(b, Sk, heads, 16, device="meta")
            with FlopCounterMode(display=False) as fwd:
                flash_attention_plain(q, k, k, causal, 0)
            with FlopCounterMode(display=False) as bwd:
                flash_attention_backward_plain(q, k, k, q, q, causal, 0)
            want["fwd"] += nf * fwd.get_total_flops()
            want["bwd"] += nb * bwd.get_total_flops()
        return want

    one, whole = flops(1), flops(16)
    assert seen == [one], (seen, one)
    assert all(whole[k] == 16 * one[k] for k in one)


#: moved cells run for real on 4 gloo ranks against their trace:
#: seamless's tensor-parallel train step (the encoder, the
#: cross-attention) and internvl2's decode (the cache's sequence on
#: ``model``, the combine)
REAL_CELLS = [("seamless-m4t-large-v2", ("train_4k", 16, 8, "train"), (2, 2)),
              ("internvl2-2b", ("decode_32k", 32, 4, "decode"), (1, 4))]


@pytest.fixture(scope="module")
def real_cells(tmp_path_factory):
    return torch_world.spawn("dryrun", tmp_path_factory.mktemp("dryrun_vlm"),
                             {"cells": REAL_CELLS})


@pytest.mark.parametrize("cell", REAL_CELLS, ids=[c[0] for c in REAL_CELLS])
def test_trace_equals_execution(real_cells, cell, monkeypatch):
    """The dry-run's trace of a moved cell, as rank 0 of a fake world of
    4, counts what rank 0 of 4 gloo ranks does running the same step:
    FLOPs, bytes accessed and the collectives, per kind."""
    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh
    from torch.testing._internal.distributed.fake_pg import FakeStore
    arch, shape, mesh_shape = cell
    monkeypatch.setattr(registry, "get", registry.get_reduced)
    dist.init_process_group("fake", store=FakeStore(), rank=0, world_size=4)
    try:
        mesh = init_device_mesh("cpu", mesh_shape,
                                mesh_dim_names=("data", "model"))
        rec = dryrun.lower_cell(arch, ShapeConfig(*shape), multi_pod=False,
                                device="cpu", mesh=mesh)
    finally:
        dist.destroy_process_group()
    assert rec["trace"]["layout"] == "sharded"
    want = real_cells[0][arch]
    assert rec["trace"]["flops"] == want["flops"] > 0
    assert rec["trace"]["bytes"] == want["bytes"] > 0
    assert rec["collective_counts"] == want["collective_counts"]
    assert rec["collectives"] == want["collectives"]
    assert want["collective_counts"]["all-reduce"] > 0
