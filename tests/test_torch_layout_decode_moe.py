"""The reference's sharded decode for the dense family and the moe
family's whole layout under ``make_rules``: the decode cache's sequence
on ``model`` where the kv heads do not divide it (the flash-decoding
combine of ``models/layers.py``), tensor parallelism beside expert
parallelism, kimi-k2's FSDP with int8 moments laid out by ``_opt_specs``.

* One spawn of 4 gloo ranks (``tests/torch_world.py``, case
  ``layout_decode_moe``) runs five float32 cases; each prefills a prompt
  on a placement of the initial parameters under the prefill rules,
  carries the cache to the decode rules' spec (``sharding.relayout``)
  and decodes on a placement under the decode rules:

  - ``kv_seq``: reduced qwen3-8b, its 2 kv heads on ``model`` 4, so the
    cache's sequence goes there: 3 prompt tokens, 16 positions, 6 decode
    steps (positions 3-8: the new key crosses from rank 0's block into
    rank 1's and reaches rank 2's; rank 3's block stays wholly masked);
  - ``kv_heads``: reduced deepseek-7b, its 4 kv heads on ``data`` 2 x
    ``model`` 2 (no combine);
  - ``heads_uneven``: 6 heads and 2 kv heads on ``model`` 4 (1.5 heads
    of ``wq``'s columns a rank, the sequence on ``model``);
  - ``moe``: reduced deepseek-moe-16b, expert and tensor parallel on
    ``data`` 2 x ``model`` 2: 2 steps of ``build_train_step``, then a
    prefill and 4 decode steps;
  - ``kimi``: reduced kimi-k2 with ``d_ff_expert`` 4,096 (the shared
    expert's trailing axis: 16 blocks of 256 over ``model``), FSDP and
    int8 moments on ``data`` 2 x ``model`` 2: 2 steps (its leaves reach
    every branch of ``_opt_specs``: blocks split with the parameter,
    blocks whole across a split trailing axis, flat blocks over
    ``data``, flat blocks replicated).

  The moe cases run at capacity factor 100 (no assignment dropped), so
  that the per-rank dispatch and the single device's keep the same
  assignments, and the single device's step takes the data blocks as
  microbatches (the aux loss is each block's, averaged over the data
  ranks).  The reference runs in a JAX subprocess with 8 fake CPU
  devices: ``prefill`` and ``decode_step`` jitted with ``in_shardings``
  on the same mesh shapes (the cache put into the decode specs between
  them), ``build_train_step`` likewise on the data axis alone (``data``
  2 x ``model`` 1): on a model axis of 2 its moe gradient is wrong, a
  fault pinned below.  Within 1e-4: every parameter and float32 moment,
  the loss and gradient norm (relative), each step's logits and the
  final cache, against the reference and against the port's own
  single-device run; int8 payloads within one code a step of both, at
  most one code in 1000 apart (and a parameter beside a payload one
  code apart within lr / 10, at most one element in 1000).
* On a fake world of 16 ranks (``data`` 4 x ``model`` 4) rank 0 holds,
  of every dense decode cell and every moe cell (reduced), exactly the
  reference's ``analytic_bytes_per_device``; the moe cells' attention
  FLOPs are the rank's heads' (deepseek-moe-16b 1 of 16, kimi-k2 4 of
  64, in a reduced width).
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
from repro_torch.launch import dryrun  # noqa: E402
from repro_torch.models.convert import params_from_jax  # noqa: E402
from repro_torch.models.model import build  # noqa: E402
from repro_torch.train.optimizer import AdamW  # noqa: E402
from repro_torch.train.step import build_train_step  # noqa: E402

import torch_world  # noqa: E402

SRC = os.path.join(os.path.dirname(__file__), "..", "src")
OPT = {"lr": 1e-2, "eps": 1e-3}
STEPS = 2
#: the training batch (B, S)
BATCH = (8, 16)
#: the decode's batch, prompt length and cache positions
DEC_B, PROMPT, S_MAX = 4, 3, 16
UNEVEN = dict(n_heads=6, n_kv_heads=2, head_dim=16)
NO_DROPS = 100.0
#: case -> (arch, config overrides, moe overrides, (data, model), train
#: steps, decode steps, train layout)
DECODE = dict(tp=True)
CASES = {
    "kv_seq": ("qwen3-8b", {}, None, (1, 4), 0, 6, None),
    "kv_heads": ("deepseek-7b", {}, None, (2, 2), 0, 6, None),
    "heads_uneven": ("qwen1.5-32b", UNEVEN, None, (1, 4), 0, 6, None),
    "moe": ("deepseek-moe-16b", {}, {"capacity_factor": NO_DROPS}, (2, 2),
            STEPS, 4, dict(ep=True)),
    "kimi": ("kimi-k2-1t-a32b", {},
             {"capacity_factor": NO_DROPS, "d_ff_expert": 4096}, (2, 2),
             STEPS, 0, dict(ep=True, fsdp=True, remat="block",
                            opt_state_dtype="int8")),
}
TOL = 1e-4


def _cfg(get, case):
    arch, over, moe_over, *_ = CASES[case]
    cfg = dataclasses.replace(get(arch), **over)
    if moe_over:
        cfg = dataclasses.replace(cfg, moe=dataclasses.replace(cfg.moe,
                                                               **moe_over))
    return cfg


def _inputs(cfg, case):
    rng = np.random.default_rng(5)
    tokens = rng.integers(0, cfg.vocab_size, BATCH).astype(np.int32)
    n_dec = CASES[case][5]
    return {"batch": {"tokens": tokens, "labels": np.roll(tokens, -1,
                                                          axis=1)},
            "prompt": rng.integers(0, cfg.vocab_size,
                                   (DEC_B, PROMPT)).astype(np.int32),
            "decode": [rng.integers(0, cfg.vocab_size,
                                    (DEC_B, 1)).astype(np.int32)
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
    cfg = dataclasses.replace(registry.get_reduced(c["arch"]), **c["over"])
    if c["moe_over"]:
        cfg = dataclasses.replace(cfg, moe=dataclasses.replace(
            cfg.moe, **c["moe_over"]))
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

        def run(mesh_shape, n):
            a, b = mesh_shape
            mesh = Mesh(np.asarray(jax.devices()[:a * b]).reshape(a, b),
                        ("data", "model"))
            rules = make_rules(cfg, shape, par, tp_size=b, dp_size=a,
                               mesh=mesh)
            p_specs = partition_specs(rm.param_defs(), rules.mapping)
            b_specs = {{k: rules.spec(*ax)
                       for k, ax in rm.batch_logical_axes(shape).items()}}
            m_specs = _opt_specs(p_specs, o.m, par.fsdp, a)
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
                for _ in range(n):
                    p, s, m = step(p, s, batch)
                    hist.append((float(m["loss"]), float(m["grad_norm"])))
            return hist, p, s, m_specs

        # the step on the data axis alone: on a model axis of more than
        # one device the reference's shard_map transposes the routing's
        # replicated inputs without their sum (test below)
        hist, p, s, _ = run((dp, 1), c["steps"])
        res.update(hist=hist, params=tree(p), m=tree(s.m), v=tree(s.v),
                   m_specs=run((dp, tp), 0)[3],
                   on_model=run((dp, tp), 1)[0] if c["fault"] else None)
    par = ParallelismConfig(**c["parallel"])
    prompt = c["prompt"]
    B, S = prompt.shape
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
    arch, over, moe_over, mesh, steps, n_dec, train = CASES[key]
    return {"arch": arch, "over": over, "moe_over": moe_over, "mesh": mesh,
            "steps": steps, "train_parallel": train, "opt": OPT,
            "parallel": dict(DECODE, ep=bool(train and train.get("ep"))),
            "s_max": S_MAX, "fault": key == "moe",
            **_inputs(_cfg(get, key), key)}


@pytest.fixture(scope="module")
def ref(tmp_path_factory):
    d = tmp_path_factory.mktemp("layout_decode_moe_ref")
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


def _par(fields):
    return ParallelismConfig(**fields) if fields else None


@pytest.fixture(scope="module")
def world(ref, tmp_path_factory):
    cases, outs = ref
    inputs = {}
    for key in CASES:
        model = _port_model(key, outs[key]["init"])
        c = cases[key]
        inputs[key] = {
            "cfg": model.cfg, "mesh": c["mesh"], "steps": c["steps"],
            "train_parallel": _par(c["train_parallel"]), "opt": OPT,
            "parallel": ParallelismConfig(**c["parallel"]),
            "s_max": S_MAX,
            "state": {n: p.detach().clone()
                      for n, p in model.named_parameters()},
            "batch": {k: torch.from_numpy(v).long()
                      for k, v in c["batch"].items()},
            "prompt": torch.from_numpy(c["prompt"]).long(),
            "decode": [torch.from_numpy(t).long() for t in c["decode"]]}
    return torch_world.spawn("layout_decode_moe",
                             tmp_path_factory.mktemp("layout_decode_moe"),
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
        # the data blocks as microbatches: each its own aux loss, averaged,
        # as the expert-parallel program's mean over the data ranks
        par = ParallelismConfig(**case["train_parallel"]).replace(
            microbatches=case["mesh"][0])
        opt = AdamW(**OPT, state_dtype=par.opt_state_dtype)
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
    cache = {k: torch.zeros(d.shape, dtype=torch.float32)
             for k, d in model.cache_defs(DEC_B, S_MAX).items()}
    logits, cache = model.prefill(
        {"tokens": torch.from_numpy(case["prompt"]).long()}, cache)
    steps = []
    for i, tok in enumerate(case["decode"]):
        lg, cache = model.decode_step(cache, torch.from_numpy(tok).long(),
                                      PROMPT + i)
        steps.append(lg)
    return {**res, "prefill": logits, "decode": steps, "cache": cache}


def _close(got, want, what):
    got = np.asarray(got.detach().float().numpy() if hasattr(got, "detach")
                     else got, dtype=np.float32)
    want = np.asarray(want.detach().float().numpy() if hasattr(
        want, "detach") else want, dtype=np.float32)
    assert got.shape == want.shape, (what, got.shape, want.shape)
    np.testing.assert_allclose(got, want, rtol=0, atol=TOL, err_msg=what)


def _param_close(got, want, what, case):
    """A parameter after the steps within ``TOL``; under int8 moments an
    element whose moment came out one code apart (rounding, as ROADMAP's
    Queue 3 pins it) moves by a fraction of a step: within lr / 10
    there, at most one element in 1000."""
    if CASES[case][6] is None or \
            CASES[case][6].get("opt_state_dtype") != "int8":
        return _close(got, want, what)
    got = got.detach().float().numpy()
    want = np.asarray(want.detach().float().numpy() if hasattr(
        want, "detach") else want, dtype=np.float32)
    assert got.shape == want.shape, what
    diff = np.abs(got - want)
    off = diff > TOL
    assert (diff[off] <= OPT["lr"] / 10).all(), (what, diff.max())
    assert off.sum() <= max(1, want.size // 1000), (what, int(off.sum()))


def _hist_close(got, want):
    for (gl, gn), (wl, wn) in zip(got, want, strict=True):
        assert abs(gl - wl) <= TOL * abs(wl), (gl, wl)
        assert abs(gn - wn) <= TOL * abs(wn), (gn, wn)


def _moment_close(got, want, what):
    """A moment: float32 within ``TOL``; an int8 one's codes within one
    code a step (each step rounds once more, and an earlier step's code
    one apart carries into the next through ``b1 * m``), at most one
    code in 1000 apart, and its scales (a block's largest magnitude over
    127) within ``TOL`` relative, or, for a block whose largest element
    came out codes apart, within as many 127ths, at most one in 1000."""
    if isinstance(got, tuple) and len(got) == 2 and not hasattr(
            got, "shape"):
        q, s = (np.asarray(t.numpy() if hasattr(t, "numpy") else t)
                for t in got)
        wq, ws = (np.asarray(t.numpy() if hasattr(t, "numpy") else t)
                  for t in want)
        assert q.shape == wq.shape, (what, q.shape, wq.shape)
        apart = np.abs(q.astype(np.int32) - wq.astype(np.int32))
        assert apart.max() <= STEPS, (what, int(apart.max()))
        assert (apart > 0).sum() <= max(1, apart.size // 1000), \
            (what, int((apart > 0).sum()))
        rel = np.abs(s - ws) / np.maximum(np.abs(ws), 1e-30)
        off = rel > TOL
        assert (rel[off] <= STEPS / 127).all(), (what, float(rel.max()))
        assert off.sum() <= max(1, rel.size // 1000), (what, int(off.sum()))
        return
    _close(got, want, what)


DECODE_CASES = [k for k in CASES if CASES[k][5]]
TRAIN_CASES = [k for k in CASES if CASES[k][4]]


@pytest.mark.parametrize("case", CASES)
def test_ranks_agree(world, case):
    """Every rank gathers the same logits, cache and parameters."""
    first = world[0][case]
    for out in world[1:]:
        got = out[case]
        for a, b in zip(got["decode"], first["decode"], strict=True):
            assert torch.equal(a, b)
        for k, c in first["cache"].items():
            assert torch.equal(got["cache"][k], c), k
        assert got.get("hist") == first.get("hist")
        for n, p in first.get("params", {}).items():
            assert torch.equal(got["params"][n], p), n


@pytest.mark.parametrize("case", CASES)
def test_decode_matches_reference(world, ref, case):
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
def test_decode_matches_single_device(world, single, case):
    want = single[case]
    got = world[0][case]
    _close(got["prefill"], want["prefill"], "prefill logits")
    for i, (g, w) in enumerate(zip(got["decode"], want["decode"],
                                   strict=True)):
        _close(g, w, f"decode step {i}")
    for k, c in want["cache"].items():
        _close(got["cache"][k], c, f"cache {k}")


@pytest.mark.parametrize("case", ["kv_seq", "heads_uneven"])
def test_kv_seq_decode_crosses_blocks_and_masks_whole_ones(world, case):
    """The cache's sequence is on ``model`` (4 blocks of 4 positions):
    the keys of positions 3-8 go to ranks 0, 1, 1, 1, 1, 2 only, and
    rank 3's block (and rank 2's until position 8) is wholly masked."""
    assert world[0][case]["kv_seq"] == "model"
    wrote = [out[case]["wrote"] for out in world]
    assert wrote == [[True] + [False] * 5, [False] + [True] * 4 + [False],
                     [False] * 5 + [True], [False] * 6]
    masked = [out[case]["masked"] for out in world]
    assert masked[3] == [True] * 6 and masked[2] == [True] * 5 + [False]
    assert world[0][case]["cache_local"][2] == S_MAX // 4


def test_kv_heads_decode_keeps_the_sequence_whole(world):
    """deepseek-7b's 4 kv heads divide ``model`` 2: the decode rules keep
    the sequence whole and split the heads."""
    got = world[0]["kv_heads"]
    assert got["kv_seq"] is None and all(got["wrote"])
    cfg = _cfg(registry.get_reduced, "kv_heads")
    assert got["cache_local"] == (cfg.n_layers, DEC_B // 2, S_MAX,
                                  cfg.n_kv_heads // 2,
                                  cfg.resolved_head_dim)


@pytest.mark.parametrize("case", TRAIN_CASES)
def test_train_step_matches_reference(world, ref, case):
    want = ref[1][case]
    got = world[0][case]
    _hist_close(got["hist"], want["hist"])
    model = _port_model(case, want["params"])
    for n, p in model.named_parameters():
        _param_close(got["params"][n], p, n, case)
    for path, w in _flat(want["m"]).items():
        _moment_close(got["moments"][path][0], w, f"m {path}")
    for path, w in _flat(want["v"]).items():
        _moment_close(got["moments"][path][1], w, f"v {path}")


@pytest.mark.parametrize("case", TRAIN_CASES)
def test_train_step_matches_single_device(world, single, case):
    want = single[case]
    got = world[0][case]
    _hist_close(got["hist"], want["hist"])
    for n, p in want["params"].items():
        _param_close(got["params"][n], p, n, case)
    for path, (m, v) in want["moments"].items():
        _moment_close(got["moments"][path][0], m, f"m {path}")
        _moment_close(got["moments"][path][1], v, f"v {path}")


def test_reference_moe_gradient_on_the_model_axis_is_pinned(world, ref):
    """A fault of the reference that the port does not keep: its jitted
    moe step on ``data`` 2 x ``model`` 2 has the loss of its step on
    ``data`` 2 x ``model`` 1, but not its gradient.  Its ``shard_map``
    (``moe.py``) takes the tokens and the router replicated over
    ``model`` and marks no ``pvary``, so their cotangents come back
    without their sum over the expert ranks (the experts' own gradients
    are right).  The port's step on (2, 2) has the (2, 1) step's
    gradient, which is its own single device's with the data blocks as
    microbatches: the tests above hold the training steps to that
    step."""
    want = ref[1]["moe"]
    good, fault = want["hist"][0], want["on_model"][0]
    assert abs(fault[0] - good[0]) <= TOL * abs(good[0])
    assert abs(fault[1] - good[1]) > 0.01 * good[1], (fault, good)
    got = world[0]["moe"]["hist"][0]
    assert abs(got[1] - good[1]) <= TOL * good[1]


def test_int8_moments_take_opt_specs(world, ref):
    """kimi-k2's int8 payloads: each rank holds its block of the
    reference's ``_opt_specs`` (the rank's block of the reference's
    payload), and the leaves reach every branch: blocks split with the
    parameter (``ws_gate``'s 16 blocks over ``model``), whole blocks
    across a split trailing axis (``embed/head``: 8 blocks), flat blocks
    over ``data`` and flat blocks replicated."""
    from repro.train.optimizer import Quantized as RefQuantized
    got = world[0]["kimi"]
    specs = _flat(ref[1]["kimi"]["m_specs"])
    payload = _flat(ref[1]["kimi"]["m"])
    sizes = {"data": 2, "model": 2}
    for path, spec in specs.items():
        assert isinstance(spec, RefQuantized)
        want = list(np.asarray(payload[path].q).shape)
        for d, ax in enumerate(tuple(spec.q)):
            if ax is not None:
                want[d] //= sizes[ax]
        assert got["moment_local"][path] == tuple(want), path
    modes = got["moment_modes"]
    assert modes["blocks/moe/ws_gate"] == "local"
    assert tuple(specs["blocks/moe/ws_gate"].q)[-2] == "model"
    assert modes["embed/head"] == "trailing"
    flat = {p: tuple(s.q) for p, s in specs.items()
            if modes[p] == "whole"}
    assert ("data", None) in flat.values() and () in flat.values()


# ------------------------------------------------ the dry-run's layout


MOVED = tuple(a for a in registry.ASSIGNED_ARCHS
              if registry.get(a).family in ("dense", "moe"))
SEQ = 64


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


def _moved_shapes(arch):
    dec = ShapeConfig("decode_32k", SEQ, 32, "decode")
    if registry.get(arch).family == "dense":
        return (dec,)
    return (ShapeConfig("train_4k", SEQ, 256, "train"),
            ShapeConfig("prefill_32k", SEQ, 32, "prefill"), dec)


@pytest.mark.parametrize("arch", MOVED)
def test_held_bytes_equal_analytic(arch, fake16, monkeypatch):
    """Rank 0 of a (4, 4) fake world holds, of the reduced dense decode
    cells and of every moe cell, exactly the reference's analytic bytes
    per device of parameters and cache, or of parameters and moments
    (kimi-k2's int8 ones by ``_opt_specs``)."""
    monkeypatch.setattr(registry, "get", registry.get_reduced)
    assert len(MOVED) == 6
    for shape in _moved_shapes(arch):
        rec = dryrun.lower_cell(arch, shape, multi_pod=False, mesh=fake16)
        assert rec["trace"]["layout"] == "sharded"
        assert rec["trace"]["held_bytes"] == \
            rec["analytic_bytes_per_device"], (arch, shape.name)


@pytest.mark.parametrize("arch,heads,kv", [("deepseek-moe-16b", 16, 16),
                                           ("kimi-k2-1t-a32b", 64, 8)])
def test_moe_attention_flops_are_the_ranks_heads(arch, heads, kv,
                                                 monkeypatch):
    """The moe cells' attention on the production mesh (16 ranks of
    ``model``, a reduced width with the published heads): rank 0's K4
    counts 1 head with its kv head (deepseek-moe-16b) or 4 of 64 heads
    beside the replicated kv heads they read (kimi-k2), in the training
    step's forward and backward and in the prefill."""
    from torch.utils.flop_counter import FlopCounterMode
    from repro_torch.kernels.flash_attention.kernel import \
        flash_attention_plain
    base = registry.get_reduced(arch)
    cfg = dataclasses.replace(base, n_heads=heads, n_kv_heads=kv,
                              head_dim=16, n_layers=1,
                              moe=dataclasses.replace(base.moe,
                                                      n_experts=16))
    monkeypatch.setattr(registry, "get", lambda a: cfg)
    shape = ShapeConfig("prefill_32k", SEQ, 32, "prefill")
    seen = []
    real = dryrun.Trace.result

    def result(self, out):
        op = torch.ops.repro_torch.flash_attention
        seen.append(sum(n for ops in self.flops.flop_counts.values()
                        for o, n in ops.items() if o == op))
        return real(self, out)

    monkeypatch.setattr(dryrun.Trace, "result", result)
    rec = dryrun.lower_cell(arch, shape, multi_pod=False)
    assert rec["trace"]["layout"] == "sharded"
    b = 32 // 16
    mine = heads // 16
    with FlopCounterMode(display=False) as fc:
        q = torch.empty(b, SEQ, mine, 16, device="meta")
        k = torch.empty(b, SEQ, max(1, kv // 16 if kv % 16 == 0 else 1),
                        16, device="meta")
        flash_attention_plain(q, k, k, True, 0)
    assert seen == [fc.get_total_flops()]
    with FlopCounterMode(display=False) as fc:
        q = torch.empty(b, SEQ, heads, 16, device="meta")
        flash_attention_plain(q, q, q, True, 0)
    assert heads * seen[0] == mine * fc.get_total_flops()
