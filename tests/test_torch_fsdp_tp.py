"""The reference's sharded layout for the dense family: FSDP and tensor
parallelism of parameters, moments and activations under ``make_rules``
(``repro_torch.distributed.sharding.distribute_model``, the
tensor-parallel layers of ``models/layers.py``, the vocab-parallel CE of
``models/transformer.py``, ``train/step.py`` under rules with a mesh).

* One spawn of 4 gloo ranks (``tests/torch_world.py``, case
  ``fsdp_tp``) runs three float32 cases, each 2 steps of
  ``build_train_step`` at microbatches 2 and remat "block" on the placed
  model, then a prefill of the initial parameters: FSDP and TP together
  on ``data`` 2 x ``model`` 2 (reduced qwen3-8b: its 2 kv heads
  sharded); kv heads replicated beside sharded q heads (reduced
  qwen3-8b on ``model`` 4); q heads that do not divide the model axis
  (6 heads, 2 kv heads, qkv bias, on ``model`` 4: 1.5 heads of columns
  a rank, regrouped by an all-to-all).  The reference runs in a JAX
  subprocess with 8 fake CPU devices: ``jax.jit(build_train_step,
  in_shardings=...)`` by ``partition_specs`` and ``_opt_specs`` on the
  same mesh shape, and its prefill jitted likewise.  Every parameter and
  moment within 1e-4 absolute, loss and gradient norm within 1e-4
  relative, of the reference's and of the port's own single-device
  step; the prefill's logits and cache within 1e-4 of the reference's.
* On a fake world of 16 ranks (``data`` 4 x ``model`` 4), the bytes of
  parameters and moments (train) or of parameters and cache (prefill)
  that rank 0 holds equal ``analytic_bytes_per_device`` exactly, for
  every dense arch's reduced train and prefill cells.
* The dry-run's microbatches traced once and counted for the rest
  (``MicrobatchOnceStep``) count what a trace of every microbatch
  counts; the attention FLOPs of a rank are its heads' share (40 heads
  over 16 ranks: 3 on rank 0, not 40).
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
#: the step's layout and optimizer; ``eps`` at the scale of the
#: gradients' elements, so that their values, and not only their signs,
#: reach the updated parameters
PARALLEL = dict(fsdp=True, tp=True, microbatches=2, remat="block")
OPT = {"lr": 1e-2, "eps": 1e-3}
STEPS = 2
#: global batch (B, S)
BATCH = (8, 16)
UNEVEN = dict(n_heads=6, n_kv_heads=2, head_dim=16)
#: case -> (arch, config overrides, (data, model))
CASES = {"fsdp_tp": ("qwen3-8b", {}, (2, 2)),
         "kv_replicated": ("qwen3-8b", {}, (1, 4)),
         "heads_uneven": ("qwen1.5-32b", UNEVEN, (1, 4))}
TOL = 1e-4


def _cfg(get, case):
    arch, over, _ = CASES[case]
    return dataclasses.replace(get(arch), **over)


def _batch(cfg):
    rng = np.random.default_rng(3)
    tokens = rng.integers(0, cfg.vocab_size, BATCH).astype(np.int32)
    return {"tokens": tokens, "labels": np.roll(tokens, -1, axis=1)}


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
for key, c in cases.items():
    cfg = dataclasses.replace(registry.get_reduced(c["arch"]), **c["over"])
    dp, tp = c["mesh"]
    mesh = Mesh(np.asarray(jax.devices()[:dp * tp]).reshape(dp, tp),
                ("data", "model"))
    par = ParallelismConfig(**c["parallel"])
    rm = build(cfg)
    params = rm.init(jax.random.key(0), dtype=jnp.float32)
    batch = {{k: jnp.asarray(v) for k, v in c["batch"].items()}}
    B, S = c["batch"]["tokens"].shape
    shape = ShapeConfig("train_4k", S, B, "train")
    rules = make_rules(cfg, shape, par, tp_size=tp, dp_size=dp, mesh=mesh)
    p_specs = partition_specs(rm.param_defs(), rules.mapping)
    b_specs = {{k: rules.spec(*a)
               for k, a in rm.batch_logical_axes(shape).items()}}
    hist = []
    with use_rules(rules), set_mesh(mesh):
        opt = AdamW(**c["opt"])
        o = opt.init(params)
        m_specs = _opt_specs(p_specs, o.m, par.fsdp, dp)
        o_specs = type(o)(step=P(), m=m_specs, v=m_specs)
        step = jax.jit(build_train_step(rm, par, opt),
                       in_shardings=(_ns(mesh, p_specs), _ns(mesh, o_specs),
                                     _ns(mesh, b_specs)),
                       out_shardings=(_ns(mesh, p_specs),
                                      _ns(mesh, o_specs), None))
        p = jax.device_put(params, _ns(mesh, p_specs))
        s = jax.device_put(o, _ns(mesh, o_specs))
        batch = jax.device_put(batch, _ns(mesh, b_specs))
        for _ in range(c["steps"]):
            p, s, m = step(p, s, batch)
            hist.append((float(m["loss"]), float(m["grad_norm"])))
    pshape = ShapeConfig("prefill", S, B, "prefill")
    prules = make_rules(cfg, pshape, par, tp_size=tp, dp_size=dp, mesh=mesh)
    pp_specs = partition_specs(rm.param_defs(), prules.mapping)
    c_specs = partition_specs(rm.cache_defs(B, S), prules.mapping)
    with use_rules(prules), set_mesh(mesh):
        fn = jax.jit(lambda p, b, c: rm.prefill(p, b, c),
                     in_shardings=(_ns(mesh, pp_specs),
                                   _ns(mesh, {{"tokens": prules.spec(
                                       "batch", "act_seq")}}),
                                   _ns(mesh, c_specs)),
                     out_shardings=(None, _ns(mesh, c_specs)))
        logits, cache = fn(
            jax.device_put(params, _ns(mesh, pp_specs)),
            jax.device_put({{"tokens": batch["tokens"]}}, _ns(mesh, {{
                "tokens": prules.spec("batch", "act_seq")}})),
            jax.device_put(rm.init_cache(B, S), _ns(mesh, c_specs)))
    tree = lambda t: jax.tree.map(np.asarray, t)
    out[key] = {{"init": tree(params), "hist": hist, "params": tree(p),
                "m": tree(s.m), "v": tree(s.v), "logits": np.asarray(
                    logits.astype(jnp.float32)), "cache": tree(cache)}}
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


@pytest.fixture(scope="module")
def ref(tmp_path_factory):
    d = tmp_path_factory.mktemp("fsdp_tp_ref")
    cases = {}
    for key, (arch, over, mesh) in CASES.items():
        cfg = _cfg(ref_registry.get_reduced, key)
        cases[key] = {"arch": arch, "over": over, "mesh": mesh,
                      "parallel": PARALLEL, "opt": OPT, "steps": STEPS,
                      "batch": _batch(cfg)}
    with open(d / "in.pkl", "wb") as f:
        pickle.dump(cases, f)
    env = dict(os.environ, PYTHONPATH=SRC, JAX_PLATFORMS="cpu",
               OMP_NUM_THREADS="1",
               XLA_FLAGS="--xla_force_host_platform_device_count=8")
    code = _REF.format(inp=str(d / "in.pkl"), out=str(d / "out.pkl"))
    proc = subprocess.run([sys.executable, "-c", textwrap.dedent(code)],
                          capture_output=True, text=True, env=env,
                          timeout=600)
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
        inputs[key] = {
            "cfg": model.cfg, "mesh": CASES[key][2],
            "parallel": ParallelismConfig(**PARALLEL), "opt": OPT,
            "steps": STEPS,
            "state": {n: p.detach().clone()
                      for n, p in model.named_parameters()},
            "batch": {k: torch.from_numpy(v)
                      for k, v in cases[key]["batch"].items()}}
    return torch_world.spawn("fsdp_tp", tmp_path_factory.mktemp("fsdp_tp"),
                             {"cases": inputs})


@pytest.fixture(scope="module")
def single(ref):
    """The port's single-device step (no rules) on the same weights and
    batch: (history, parameters, moments)."""
    cases, outs = ref
    res = {}
    # one thread: the models are tiny, and the test workers share cores
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        for key in CASES:
            res[key] = _single_run(key, cases[key], outs[key])
    finally:
        torch.set_num_threads(threads)
    return res


def _single_run(key, case, out):
    model = _port_model(key, out["init"])
    opt = AdamW(**OPT)
    state = opt.init(model)
    step = build_train_step(model, ParallelismConfig(**PARALLEL), opt)
    batch = {k: torch.from_numpy(v).long() for k, v in case["batch"].items()}
    hist = []
    for _ in range(STEPS):
        model, state, m = step(model, state, batch)
        hist.append((float(m["loss"]), float(m["grad_norm"])))
    return (hist, {n: p.detach() for n, p in model.named_parameters()},
            {k: (state.m[k], state.v[k]) for k in state.m})


def _close(got, want, what):
    got = got.detach().float().numpy()
    want = np.asarray(want, dtype=np.float32)
    assert got.shape == want.shape, (what, got.shape, want.shape)
    np.testing.assert_allclose(got, want, rtol=0, atol=TOL, err_msg=what)


def _hist_close(got, want):
    for (gl, gn), (wl, wn) in zip(got, want, strict=True):
        assert abs(gl - wl) <= TOL * abs(wl), (gl, wl)
        assert abs(gn - wn) <= TOL * abs(wn), (gn, wn)


@pytest.mark.parametrize("case", CASES)
def test_ranks_agree(world, case):
    """Every rank gathers the same parameters and history."""
    first = world[0][case]
    for out in world[1:]:
        assert out[case]["hist"] == first["hist"]
        for n, p in out[case]["params"].items():
            assert torch.equal(p, first["params"][n]), n


@pytest.mark.parametrize("case", CASES)
def test_train_step_matches_reference(world, ref, case):
    _, outs = ref
    want = outs[case]
    got = world[0][case]
    _hist_close(got["hist"], want["hist"])
    model = _port_model(case, want["params"])
    for n, p in model.named_parameters():
        _close(got["params"][n], p, n)
    for path, w in _flat(want["m"]).items():
        _close(got["moments"][path][0], w, f"m {path}")
    for path, w in _flat(want["v"]).items():
        _close(got["moments"][path][1], w, f"v {path}")


@pytest.mark.parametrize("case", CASES)
def test_train_step_matches_single_device(world, single, case):
    hist, params, moments = single[case]
    got = world[0][case]
    _hist_close(got["hist"], hist)
    for n, p in params.items():
        _close(got["params"][n], p, n)
    for path, (m, v) in moments.items():
        _close(got["moments"][path][0], m, f"m {path}")
        _close(got["moments"][path][1], v, f"v {path}")


def _bf16_close(got, want, what):
    """A bf16 tensor (the cache, bf16 whatever the parameters' type) of
    float32 values within ``TOL`` of the reference's: equal within
    ``TOL``, or one bf16 ulp apart where the float32 value lay within
    ``TOL`` of a rounding boundary, at most one element in 1000."""
    got = got.float().numpy()
    want = np.asarray(want, dtype=np.float32)
    assert got.shape == want.shape, what
    diff = np.abs(got - want)
    ulp = np.abs(want) * 2.0 ** -7 + 1e-30
    off = diff > TOL
    assert (diff[off] <= ulp[off]).all(), (what, diff.max())
    assert off.sum() <= max(1, want.size // 1000), (what, int(off.sum()))


@pytest.mark.parametrize("case", CASES)
def test_prefill_matches_reference(world, ref, case):
    want = ref[1][case]
    got = world[0][case]
    _close(got["logits"], want["logits"], "logits")
    for k, c in want["cache"].items():
        _bf16_close(got["cache"][k], c, k)


@pytest.mark.parametrize("case", CASES)
def test_ranks_hold_their_blocks(world, case):
    """Each rank holds its spec's block: ``wq``'s columns over ``model``
    (1.5 heads of the uneven case), ``embed`` rows over ``data``, the
    vocab over ``model``; the cache's kv heads over ``model`` only when
    they divide it."""
    cfg = _cfg(registry.get_reduced, case)
    dp, tp = CASES[case][2]
    hd = cfg.resolved_head_dim
    shapes = world[0][case]["local_shapes"]
    assert shapes["blocks.0.attn.wq"] == (cfg.d_model // dp,
                                          cfg.n_heads * hd // tp)
    kv = cfg.n_kv_heads * hd // (tp if cfg.n_kv_heads % tp == 0 else 1)
    assert shapes["blocks.0.attn.wk"] == (cfg.d_model // dp, kv)
    assert shapes["embed.tok"][0] == world[0][case]["logits"].shape[-1] // tp
    K = cfg.n_kv_heads // (tp if cfg.n_kv_heads % tp == 0 else 1)
    assert world[0][case]["cache_local"]["k"] == (
        cfg.n_layers, BATCH[0] // dp, BATCH[1], K, hd)


# ------------------------------------------------ the dry-run's layout


DENSE = tuple(a for a in registry.ASSIGNED_ARCHS
              if registry.get(a).family == "dense")
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


@pytest.mark.parametrize("arch", DENSE)
def test_held_bytes_equal_analytic(arch, fake16, monkeypatch):
    """Rank 0 of a (4, 4) fake world holds, of the reduced train and
    prefill cells, exactly the reference's analytic bytes per device of
    parameters and moments, or of parameters and cache."""
    monkeypatch.setattr(registry, "get", registry.get_reduced)
    assert len(DENSE) == 4
    for shape in (ShapeConfig("train_4k", SEQ, 256, "train"),
                  ShapeConfig("prefill_32k", SEQ, 32, "prefill")):
        rec = dryrun.lower_cell(arch, shape, multi_pod=False, mesh=fake16)
        assert rec["trace"]["layout"] == "sharded"
        assert rec["trace"]["held_bytes"] == \
            rec["analytic_bytes_per_device"], (arch, shape.name)


@pytest.mark.parametrize("arch", ["qwen1.5-32b", "llama3-405b"])
def test_microbatches_traced_once_count_as_every_microbatch(arch,
                                                            monkeypatch):
    """``lower_cell`` traces the first of an FSDP arch's 4 microbatches
    and counts it for the rest (``MicrobatchOnceStep``): its FLOPs, bytes
    accessed, kernel calls, collectives and memory equal a trace of
    every microbatch (``TrainStep``)."""
    from repro_torch.train.step import TrainStep
    monkeypatch.setattr(registry, "get", registry.get_reduced)
    shape = ShapeConfig("train_4k", SEQ, 256, "train")
    assert registry.default_parallelism(registry.get(arch),
                                        shape).microbatches == 4
    once = dryrun.lower_cell(arch, shape, multi_pod=False)
    monkeypatch.setattr(dryrun, "MicrobatchOnceStep", TrainStep)
    every = dryrun.lower_cell(arch, shape, multi_pod=False)
    for k in ("trace", "memory_analysis", "collectives",
              "collective_counts", "wire_bytes_per_dev"):
        assert once[k] == every[k], k
    assert every["trace"]["kernel_calls"]["flash_attention"] == \
        2 * 4 * registry.get(arch).n_layers     # remat recomputes


def test_attention_flops_are_the_ranks_heads(monkeypatch):
    """qwen1.5-32b's 40 heads over the 16 ranks of ``model`` (a reduced
    width, the heads kept): rank 0's K4 counts its 3 heads' FLOPs, 3/40
    of the attention, not all 40 heads."""
    from torch.utils.flop_counter import FlopCounterMode
    from repro_torch.kernels.flash_attention.kernel import \
        flash_attention_plain
    cfg = dataclasses.replace(registry.get_reduced("qwen1.5-32b"),
                              n_heads=40, n_kv_heads=40, head_dim=16,
                              n_layers=1)
    monkeypatch.setattr(registry, "get", lambda arch: cfg)
    shape = ShapeConfig("prefill_32k", SEQ, 32, "prefill")
    seen = []
    real = dryrun.Trace.result

    def result(self, out):
        op = torch.ops.repro_torch.flash_attention     # counted by packet
        seen.append(sum(n for ops in self.flops.flop_counts.values()
                        for o, n in ops.items() if o == op))
        return real(self, out)

    monkeypatch.setattr(dryrun.Trace, "result", result)
    dryrun.lower_cell("qwen1.5-32b", shape, multi_pod=False)
    b = 32 // 16
    with FlopCounterMode(display=False) as fc:
        q = torch.empty(b, SEQ, 3, 16, device="meta")
        flash_attention_plain(q, q, q, True, 0)
    three = fc.get_total_flops()
    assert seen == [three]
    with FlopCounterMode(display=False) as fc:
        q = torch.empty(b, SEQ, 40, 16, device="meta")
        flash_attention_plain(q, q, q, True, 0)
    assert 40 * three == 3 * fc.get_total_flops()
