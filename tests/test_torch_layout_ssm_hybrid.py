"""The reference's sharded layout for the ssm and hybrid families under
``make_rules``: the SSD heads (``ssm_inner``) tensor-parallel over
``model`` in the full-sequence block and in decode, the gated norm's
mean square summed over ``model``, ``wo`` row-parallel or, with
``ssm_gather_out``, ``y`` gathered whole; the hybrid's shared block
through the dense family's tensor-parallel attention and MLP, its ring
buffers by their spec, and under the long_500k mapping the ring's slots
over ``data`` with the flash-decoding combine.

* One spawn of 4 gloo ranks (``tests/torch_world.py``, case
  ``layout_ssm_hybrid``, ``data`` 2 x ``model`` 2) runs five float32
  cases: each trains ``build_train_step`` under the train rules (if it
  has steps), prefills a prompt on a placement of the initial
  parameters under the prefill rules (ssm and hybrid prefill return
  forward's logits and the cache untouched, as the reference's) and
  decodes from that cache under the decode rules:

  - ``mamba2``: reduced mamba2-1.3b (8 heads, 4 a rank), 2 steps, 6
    decode steps;
  - ``mamba2_gather_out``: the same with ``ssm_gather_out``;
  - ``zamba2``: reduced zamba2-1.2b, 2 steps, then a prefill of 96
    tokens (past its 64-token window);
  - ``zamba2_ring``: 12 decode steps from position 3 on a ring of 8
    slots (it wraps at position 8), the kv heads on ``model``;
  - ``zamba2_long``: the long_500k mapping, batch 1: the ring's 8 slots
    over ``data`` (4 a rank, the combine), rank 1's block wholly masked
    until position 4, then wrapping.

  The training cases run at SSD chunk 32: the reference's gradient is
  NaN over one long chunk (``tests/test_torch_hybrid.py``,
  ``GRAD_CHUNK``).  The reference runs in a JAX subprocess with 8 fake
  CPU devices: ``build_train_step``, ``prefill`` and ``decode_step``
  jitted with ``in_shardings`` on the same mesh shapes.  Within 1e-4:
  every parameter and moment, the loss and gradient norm (relative),
  the prefill's and each decode step's logits and the final cache
  (``h``, ``conv``, ``ak``, ``av``), against the reference and against
  the port's own single-device run.
* On a fake world of 16 ranks (``data`` 4 x ``model`` 4) rank 0 holds,
  of every moved mamba2 and zamba2 cell (reduced), exactly the
  reference's ``analytic_bytes_per_device``; the cells the reference
  also holds whole (pure data-parallel training, mamba2's
  sequence-parallel prefill) keep the replicated program; K5's traced
  FLOPs on the production mesh are the rank's heads'; and the trace of
  two moved cells counts what rank 0 of 4 gloo ranks does running them
  (``torch_world`` case ``dryrun``).
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
from repro_torch.train.optimizer import AdamW  # noqa: E402
from repro_torch.train.step import build_train_step  # noqa: E402

import torch_world  # noqa: E402

SRC = os.path.join(os.path.dirname(__file__), "..", "src")
OPT = {"lr": 1e-2, "eps": 1e-3}
STEPS = 2
#: the training batch (B, S)
BATCH = (4, 96)
#: the SSD chunk of every case (the reference's gradient is NaN at the
#: reduced configs' 256 past S = 64)
CHUNK = 32
TP = dict(tp=True)
GATHER_OUT = dict(tp=True, ssm_gather_out=True)
#: case -> (arch, train layout (None: no steps), decode layout, decode
#: shape name, decode batch, prompt length, s_max, decode steps)
CASES = {
    "mamba2": ("mamba2-1.3b", TP, TP, "decode", 4, 3, 16, 6),
    "mamba2_gather_out": ("mamba2-1.3b", GATHER_OUT, GATHER_OUT, "decode",
                          4, 3, 16, 6),
    "zamba2": ("zamba2-1.2b", TP, TP, "decode", 4, 96, 128, 0),
    "zamba2_ring": ("zamba2-1.2b", None, TP, "decode", 4, 3, 8, 12),
    "zamba2_long": ("zamba2-1.2b", None, TP, "long_500k", 1, 3, 8, 12),
}
TOL = 1e-4
MESH = (2, 2)


def _cfg(get, case):
    cfg = get(CASES[case][0])
    return dataclasses.replace(cfg, ssm=dataclasses.replace(cfg.ssm,
                                                            chunk=CHUNK))


def _inputs(cfg, case):
    _, train, _, _, B, P, _, n_dec = CASES[case]
    rng = np.random.default_rng(11)
    tokens = rng.integers(0, cfg.vocab_size, BATCH).astype(np.int32)
    return {"batch": {"tokens": tokens, "labels": np.roll(tokens, -1,
                                                          axis=1)},
            "steps": STEPS if train else 0,
            "prompt": rng.integers(0, cfg.vocab_size,
                                   (B, P)).astype(np.int32),
            "decode": [rng.integers(0, cfg.vocab_size,
                                    (B, 1)).astype(np.int32)
                       for _ in range(n_dec)]}


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
from repro.models.model import build
from repro.models.params import partition_specs
from repro.train.optimizer import AdamW
from repro.train.step import build_train_step

cases = pickle.load(open({inp!r}, "rb"))
out = {{}}
tree = lambda t: jax.tree.map(np.asarray, t)
for key, c in cases.items():
    cfg = registry.get_reduced(c["arch"])
    cfg = dataclasses.replace(cfg, ssm=dataclasses.replace(
        cfg.ssm, chunk=c["chunk"]))
    dp, tp = c["mesh"]
    mesh = Mesh(np.asarray(jax.devices()[:dp * tp]).reshape(dp, tp),
                ("data", "model"))
    rm = build(cfg)
    params = rm.init(jax.random.key(0), dtype=jnp.float32)
    res = {{"init": tree(params)}}
    if c["steps"]:
        par = ParallelismConfig(**c["train_parallel"])
        B, S = c["batch"]["tokens"].shape
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
    par = ParallelismConfig(**c["parallel"])
    prompt = c["prompt"]
    B, S = prompt.shape
    s_max = c["s_max"]
    pshape = ShapeConfig("prefill", S, B, "prefill")
    dshape = ShapeConfig(c["decode_name"], s_max, B, "decode")
    prules = make_rules(cfg, pshape, par, tp_size=tp, dp_size=dp, mesh=mesh)
    drules = make_rules(cfg, dshape, par, tp_size=tp, dp_size=dp, mesh=mesh)
    c_defs = rm.cache_defs(B, s_max)
    zeros = {{k: jnp.zeros(d.shape, jnp.float32) for k, d in c_defs.items()}}
    pc_specs = partition_specs(c_defs, prules.mapping)
    dc_specs = partition_specs(c_defs, drules.mapping)
    with use_rules(prules), set_mesh(mesh):
        pp_specs = partition_specs(rm.param_defs(), prules.mapping)
        tok_spec = {{"tokens": prules.spec("batch", None)}}
        fn = jax.jit(lambda p, b, c: rm.prefill(p, b, c),
                     in_shardings=(_ns(mesh, pp_specs), _ns(mesh, tok_spec),
                                   _ns(mesh, pc_specs)),
                     out_shardings=(None, _ns(mesh, pc_specs)))
        logits, cache = fn(jax.device_put(params, _ns(mesh, pp_specs)),
                           jax.device_put({{"tokens": jnp.asarray(prompt)}},
                                          _ns(mesh, tok_spec)),
                           jax.device_put(zeros, _ns(mesh, pc_specs)))
    res["prefill"] = np.asarray(logits)
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
    arch, train, dec, name, _, _, s_max, _ = CASES[key]
    return {"arch": arch, "chunk": CHUNK, "mesh": MESH,
            "train_parallel": train, "opt": OPT, "parallel": dec,
            "decode_name": name, "s_max": s_max,
            **_inputs(_cfg(get, key), key)}


@pytest.fixture(scope="module")
def ref(tmp_path_factory):
    d = tmp_path_factory.mktemp("layout_ssm_hybrid_ref")
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


@pytest.fixture(scope="module")
def world(ref, tmp_path_factory):
    cases, outs = ref
    inputs = {}
    for key in CASES:
        model = _port_model(key, outs[key]["init"])
        c = cases[key]
        inputs[key] = {
            "cfg": model.cfg, "mesh": c["mesh"], "steps": c["steps"],
            "train_parallel": c["train_parallel"] and ParallelismConfig(
                **c["train_parallel"]),
            "opt": OPT, "parallel": ParallelismConfig(**c["parallel"]),
            "decode_name": c["decode_name"], "s_max": c["s_max"],
            "state": {n: p.detach().clone()
                      for n, p in model.named_parameters()},
            "batch": {k: torch.from_numpy(v).long()
                      for k, v in c["batch"].items()},
            "prompt": torch.from_numpy(c["prompt"]).long(),
            "decode": [torch.from_numpy(t).long() for t in c["decode"]]}
    return torch_world.spawn("layout_ssm_hybrid",
                             tmp_path_factory.mktemp("layout_ssm_hybrid"),
                             {"cases": inputs}, deadline=400.0)


@pytest.fixture(scope="module")
def single(ref):
    """The port's single-device run (no rules) on the same weights and
    inputs: the training history, parameters and moments, the prefill's
    and each decode step's logits and the final cache."""
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
        par = ParallelismConfig(**case["train_parallel"])
        opt = AdamW(**OPT)
        state = opt.init(model)
        step = build_train_step(model, par, opt)
        batch = {k: torch.from_numpy(v).long()
                 for k, v in case["batch"].items()}
        hist = []
        for _ in range(case["steps"]):
            model, state, m = step(model, state, batch)
            hist.append((float(m["loss"]), float(m["grad_norm"])))
        res.update(hist=hist, params={n: p.detach() for n, p in
                                      model.named_parameters()},
                   moments={k: (state.m[k], state.v[k]) for k in state.m})
    model = _port_model(key, out["init"])
    B, P = case["prompt"].shape
    cache = {k: torch.zeros(d.shape, dtype=torch.float32)
             for k, d in model.cache_defs(B, case["s_max"]).items()}
    logits, cache = model.prefill(
        {"tokens": torch.from_numpy(case["prompt"]).long()}, cache)
    steps = []
    for i, tok in enumerate(case["decode"]):
        lg, cache = model.decode_step(cache, torch.from_numpy(tok).long(),
                                      P + i)
        steps.append(lg)
    return {**res, "prefill": logits, "decode": steps, "cache": cache}


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


TRAIN_CASES = [k for k in CASES if CASES[k][1]]


@pytest.mark.parametrize("case", CASES)
def test_ranks_agree(world, case):
    """Every rank gathers the same logits, cache and parameters."""
    first = world[0][case]
    for out in world[1:]:
        got = out[case]
        assert torch.equal(got["prefill"], first["prefill"])
        for a, b in zip(got["decode"], first["decode"], strict=True):
            assert torch.equal(a, b)
        for k, c in first["cache"].items():
            assert torch.equal(got["cache"][k], c), k
        assert got.get("hist") == first.get("hist")
        for n, p in first.get("params", {}).items():
            assert torch.equal(got["params"][n], p), n


@pytest.mark.parametrize("case", CASES)
def test_prefill_and_decode_match_reference(world, ref, case):
    """The prefill's and every decode step's logits and the final cache
    within 1e-4 of the reference's jitted, sharded program."""
    want = ref[1][case]
    got = world[0][case]
    _close(got["prefill"], want["prefill"], "prefill logits")
    for i, (g, w) in enumerate(zip(got["decode"], want["decode"],
                                   strict=True)):
        _close(g, w, f"decode step {i}")
    for k, c in want["cache"].items():
        _close(got["cache"][k], c, f"cache {k}")


@pytest.mark.parametrize("case", CASES)
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
    moments of every leaf within 1e-4 of the reference's jitted step.
    The step's gradient sum over the batch axes (``train/step.py``) and
    the moments laid out as their parameters (``optimizer._opt_specs``'
    twin) cover the placed and the whole leaves alike."""
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


@pytest.mark.parametrize("case", ["mamba2", "mamba2_gather_out", "zamba2"])
def test_the_steps_move_the_parameters(world, ref, case):
    """The steps train: the loss falls and the SSD weights of both
    ``model`` blocks move from their initial values (a rank that kept
    the other's block whole, or dropped its gradient, would not match
    the reference above; this says the comparison is not of two
    standing models)."""
    got = world[0][case]
    assert got["hist"][1][0] < got["hist"][0][0], got["hist"]
    init = _port_model(case, ref[1][case]["init"])
    seen = 0
    for n, p in init.named_parameters():
        mod, _, leaf = n.rpartition(".")
        if mod.endswith("ssm") and leaf in ("wx", "wo", "A_log", "norm"):
            # wo's rows are the heads' channels, the others' columns
            moved = (got["params"][n] - p.detach()).abs().chunk(
                2, 0 if leaf == "wo" else -1)
            assert all(float(half.max()) > 0 for half in moved), n
            seen += 1
    assert seen == 4 * init.cfg.n_layers


def test_ssm_decode_holds_the_ranks_heads(world):
    """mamba2's decode state ``h`` is the rank's block of the batch and
    of the heads (``act_inner`` on ``model``); the conv buffer is whole
    over ``model``, every rank holding the same."""
    cfg = _cfg(registry.get_reduced, "mamba2")
    s = cfg.ssm
    nh = s.expand * cfg.d_model // s.head_dim
    B = CASES["mamba2"][4]
    got = world[0]["mamba2"]
    assert got["cache_local"] == (cfg.n_layers, B // 2, nh // 2,
                                  s.head_dim, s.d_state)
    assert got["kv_seq"] == "model"        # no kv cache: nothing reads it
    assert got["wrote"] == [None] * 6


def test_ring_wraps_with_the_heads_split(world):
    """zamba2's decode_32k mapping: its 4 kv heads divide ``model`` 2,
    so the ring's slots stay whole and its kv heads split; 12 steps from
    position 3 on 8 slots wrap at position 8."""
    cfg = _cfg(registry.get_reduced, "zamba2_ring")
    got = world[0]["zamba2_ring"]
    assert got["kv_seq"] is None and all(got["wrote"])
    assert not any(got["masked"])
    sites = cfg.n_layers // cfg.hybrid_attn_every
    assert got["cache_local"] == (sites, 2, 8, cfg.n_kv_heads // 2,
                                  cfg.resolved_head_dim)
    assert 3 + len(got["decode"]) > 8


def test_long_ring_splits_its_slots_over_data(world):
    """The long_500k mapping, batch 1: the ring's 8 slots over ``data``
    (4 a rank).  From position 3 the keys go to slots 3-7 then 0-6 (the
    wrap): data rank 0 writes at positions 3, 8-11, rank 1 at 4-7 and
    12-14; rank 1's block is wholly masked at position 3 only, before
    any of its slots holds a position."""
    got = {r: out["zamba2_long"] for r, out in enumerate(world)}
    assert got[0]["kv_seq"] == "data"
    # ranks (data, model): 0 = (0, 0), 1 = (0, 1), 2 = (1, 0), 3 = (1, 1)
    first = [True] + [False] * 4 + [True] * 4 + [False] * 3
    assert got[0]["wrote"] == got[1]["wrote"] == first
    assert got[2]["wrote"] == got[3]["wrote"] == [not w for w in first]
    assert got[2]["masked"] == [True] + [False] * 11
    assert not any(got[0]["masked"])
    cfg = _cfg(registry.get_reduced, "zamba2_long")
    assert got[0]["cache_local"][1:] == (1, 4, cfg.n_kv_heads // 2,
                                         cfg.resolved_head_dim)


def test_heads_that_do_not_divide_the_axis_raise():
    """The SSD heads must divide ``model``: 6 heads over 4 ranks raise
    ``ValueError`` where the parameters are placed (nothing falls back
    to replicating them)."""
    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh
    from torch.testing._internal.distributed.fake_pg import FakeStore
    from repro_torch.distributed.sharding import distribute_model
    base = registry.get_reduced("mamba2-1.3b")
    cfg = dataclasses.replace(base, d_model=48)    # d_in 96: 6 heads of 16
    dist.init_process_group("fake", store=FakeStore(), rank=0, world_size=4)
    try:
        mesh = init_device_mesh("cpu", (1, 4),
                                mesh_dim_names=("data", "model"))
        rules = make_rules(cfg, ShapeConfig("decode", 16, 4, "decode"),
                           ParallelismConfig(tp=True), tp_size=4, dp_size=1,
                           mesh=mesh)
        with pytest.raises(ValueError, match="does not split"):
            distribute_model(build(cfg).init(seed=0, device="cpu"), rules)
    finally:
        dist.destroy_process_group()


# ------------------------------------------------ the dry-run's layout


SEQ = 64
ARCHS = ("mamba2-1.3b", "zamba2-1.2b")
#: the moved cells at reduced widths on a (4, 4) world: train with a
#: batch that does not divide the 16 ranks (tensor parallelism), both
#: archs' decode and long_500k, zamba2's prefill (its heads split; the
#: ssm family's prefill is sequence-parallel)
MOVED = [(a, s) for a in ARCHS for s in (
    ShapeConfig("train_4k", SEQ, 8, "train"),
    ShapeConfig("decode_32k", SEQ, 32, "decode"),
    ShapeConfig("long_500k", SEQ, 1, "decode"))] + [
    ("zamba2-1.2b", ShapeConfig("prefill_32k", SEQ, 32, "prefill"))]
#: the cells the reference also holds whole: pure data-parallel training
#: (the batch divides every rank) and mamba2's sequence-parallel prefill
KEPT = [(a, ShapeConfig("train_4k", SEQ, 256, "train")) for a in ARCHS] \
    + [("mamba2-1.3b", ShapeConfig("prefill_32k", SEQ, 32, "prefill"))]


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
    moments, or of parameters and cache."""
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
    """Where the rules place no SSD head the cell runs the replicated
    program, as before this layout: the reference holds every parameter
    whole there too, and the rank holds its analytic bytes."""
    monkeypatch.setattr(registry, "get", registry.get_reduced)
    cfg = registry.get(arch)
    rules = make_rules(cfg, shape, registry.default_parallelism(cfg, shape),
                       tp_size=4, dp_size=4)
    assert not runs_layout(cfg.family, rules.mapping)
    rec = dryrun.lower_cell(arch, shape, multi_pod=False, mesh=fake16)
    assert rec["trace"]["layout"] == "replicated"
    assert rec["trace"]["held_bytes"] == rec["analytic_bytes_per_device"]


@pytest.mark.parametrize("arch", ARCHS)
def test_k5_flops_are_the_ranks_heads(arch, monkeypatch):
    """On the production mesh (16 ranks of ``model``), a reduced width
    with 64 SSD heads (mamba2-1.3b's and zamba2-1.2b's count): rank 0's
    K5 and its backward count the FLOPs of its 4 heads of its block of
    the batch in the training step, not of all 64 (the scan's C·B
    products, shared by the heads, keep the rank's count above a 16th
    of the whole's)."""
    from torch.utils.flop_counter import FlopCounterMode
    from repro_torch.kernels.ssd_scan.kernel import (ssd_scan_backward_plain,
                                                     ssd_scan_plain)
    base = registry.get_reduced(arch)
    cfg = dataclasses.replace(base, d_model=512, n_layers=2,
                              ssm=dataclasses.replace(base.ssm, chunk=CHUNK))
    s = cfg.ssm
    nh = s.expand * cfg.d_model // s.head_dim
    assert nh == 64
    monkeypatch.setattr(registry, "get", lambda a: cfg)
    shape = ShapeConfig("train_4k", SEQ, 32, "train")
    seen = []
    real = dryrun.Trace.result

    def result(self, out):
        ops = {torch.ops.repro_torch.ssd_scan,
               torch.ops.repro_torch.ssd_scan_bwd}
        seen.append({str(o): n for o, n in
                     self.flops.flop_counts["Global"].items() if o in ops})
        return real(self, out)

    monkeypatch.setattr(dryrun.Trace, "result", result)
    rec = dryrun.lower_cell(arch, shape, multi_pod=False)
    assert rec["trace"]["layout"] == "sharded"
    b = 32 // 16

    def flops(heads):
        x = torch.empty(b, SEQ, heads, s.head_dim, device="meta")
        dt = torch.empty(b, SEQ, heads, device="meta")
        A = torch.empty(heads, device="meta")
        Bm = torch.empty(b, SEQ, s.d_state, device="meta")
        with FlopCounterMode(display=False) as fwd:
            ssd_scan_plain(x, dt, A, Bm, Bm, CHUNK)
        with FlopCounterMode(display=False) as bwd:
            ssd_scan_backward_plain(x, dt, A, Bm, Bm, x, None, CHUNK)
        return fwd.get_total_flops(), bwd.get_total_flops()

    fwd, bwd = flops(4)
    whole = flops(nh)
    assert whole[0] > 8 * fwd and whole[1] > 8 * bwd
    got = seen[0]
    assert got == {"repro_torch.ssd_scan": cfg.n_layers * fwd,
                   "repro_torch.ssd_scan_bwd": cfg.n_layers * bwd}, got


#: moved cells run for real on 4 gloo ranks against their trace: mamba2's
#: tensor-parallel step and zamba2's long_500k decode (the ring's slots
#: over data, the combine)
REAL_CELLS = [("mamba2-1.3b", ("train_4k", 16, 8, "train"), (2, 2)),
              ("zamba2-1.2b", ("long_500k", 16, 1, "decode"), (2, 2))]


@pytest.fixture(scope="module")
def real_cells(tmp_path_factory):
    return torch_world.spawn("dryrun", tmp_path_factory.mktemp("dryrun_ssm"),
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
