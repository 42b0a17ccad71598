"""The port's pipeline parallelism and elastic resharding against the
reference (``repro_torch.distributed.{pp,elastic}``,
``repro_torch.models.params.partition_specs``).

One world of 4 gloo ranks (``tests/torch_world.py``, case
``pp_elastic``), one JAX subprocess on 256 fake CPU devices
(``XLA_FLAGS=--xla_force_host_platform_device_count=256``, as
``tests/test_distributed.py`` runs the mesh) and one subprocess on
torch's fake process group of 256 ranks serve every test here:

* ``pipeline_forward`` on a 4-stage ``pipe`` mesh against the
  reference's on 4 fake devices: the reference test's tanh stack (L 8,
  B 8, D 16; ``tests/test_distributed.py:103``) at M 2, 4 and 8 within
  its 1e-5; a reduced qwen3-8b (4 layers, float32) on 4 stages and on 2
  against the port's ``run_decoder`` (1e-6, and per microbatch bitwise)
  and the reference's ``pipeline_forward`` of its ``_attn_block`` (atol =
  rtol = 1e-4, as ``tests/test_torch_models.py``); every rank returns the
  same output, and the one-process schedule
  (``pipeline_forward_local``) gives the ranks' bits;
* the refusals of an uneven split (``ValueError``);
* ``reshard``: the reference test's case (``tests/test_distributed.py
  :132``) — the demotion paths equal as strings, each rank's block equal
  to the reference's shard on the same device bitwise — then onto the
  mesh with rank 3 failed in a ``LivenessRegistry`` (``shrunk_mesh``),
  from the DTensors of the first; and the plan at the production size,
  256 -> 240 ranks, over each reduced arch's ``partition_specs``: the
  port on the fake process group, its demotions equal to the
  reference's;
* the collectives of the 4-stage pipeline: the port's
  ``hlo_collectives.record()`` per-kind counts and wire bytes equal the
  reference's ``hlo_collectives.analyze`` of its compiled
  ``pipeline_forward``.
"""
import dataclasses
import json
import os
import subprocess
import sys
import textwrap

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs import registry as ref_registry  # noqa: E402
from repro.configs.base import ALL_SHAPES as REF_SHAPES  # noqa: E402
from repro.distributed.sharding import make_rules as ref_rules  # noqa: E402
from repro.models import transformer as ref_tfm  # noqa: E402
from repro.models.model import build as ref_build  # noqa: E402
from repro.models.params import partition_specs as ref_specs  # noqa: E402

from repro_torch.configs import registry  # noqa: E402
from repro_torch.configs.base import ALL_SHAPES  # noqa: E402
from repro_torch.distributed.elastic import shrunk_mesh  # noqa: E402
from repro_torch.distributed.sharding import make_rules  # noqa: E402
from repro_torch.models import transformer as tfm  # noqa: E402
from repro_torch.models.convert import params_from_jax  # noqa: E402
from repro_torch.models.model import build  # noqa: E402
from repro_torch.models.params import partition_specs  # noqa: E402

import torch_world  # noqa: E402

SRC = os.path.join(os.path.dirname(__file__), "..", "src")
#: the reference test's tanh stack
L, B, D = 8, 8, 16
#: the reduced qwen3-8b stack: layers, batch, sequence
Q_LAYERS, QB, QS = 4, 8, 16
MICROBATCHES = (2, 4, 8)
#: the production plan: 256 ranks, 240-255 failed
N_PROD, N_LIVE = 256, 240
PLAN_SHAPES = ("train_4k", "prefill_32k")
ARCHS = registry.list_archs()


def _configs():
    return (dataclasses.replace(registry.get_reduced("qwen3-8b"),
                                n_layers=Q_LAYERS),
            dataclasses.replace(ref_registry.get_reduced("qwen3-8b"),
                                n_layers=Q_LAYERS))


@pytest.fixture(scope="module")
def setup(tmp_path_factory):
    """The inputs (numpy, from seeds), the reference's float32 qwen3
    parameters, and the port's model loaded from them."""
    rng = np.random.default_rng(0)
    cfg, ref_cfg = _configs()
    params = ref_build(ref_cfg).init(jax.random.key(0), dtype=jnp.float32)
    model = params_from_jax(build(cfg), jax.tree.map(np.asarray, params))
    arrays = {
        "w": (rng.standard_normal((L, D, D)) * 0.3).astype(np.float32),
        "x": rng.standard_normal((B, D)).astype(np.float32),
        "qx": rng.standard_normal((QB, QS, cfg.d_model)).astype(np.float32),
        # the reference test's w (16, 8) and b (7,), and v, sharded on
        # both axes; values that tell the blocks apart
        "rw": np.arange(16 * 8, dtype=np.float32).reshape(16, 8),
        "rb": np.arange(7, dtype=np.float32),
        "rv": np.arange(24 * 4, dtype=np.float32).reshape(24, 4)}
    leaves = jax.tree.leaves(params["blocks"])
    d = tmp_path_factory.mktemp("pp_elastic")
    np.savez(d / "in.npz", **arrays,
             **{f"p{i}": np.asarray(a) for i, a in enumerate(leaves)})
    return d, arrays, cfg, model


@pytest.fixture(scope="module")
def world(setup):
    d, a, cfg, model = setup
    t = torch.from_numpy
    inputs = {
        "tanh": {"w": t(a["w"]), "x": t(a["x"])},
        "qwen": {"cfg": cfg, "x": t(a["qx"]),
                 "state": {n: p.detach().clone()
                           for n, p in model.named_parameters()}},
        "reshard": {"w": t(a["rw"]), "b": t(a["rb"]), "v": t(a["rv"])}}
    return torch_world.spawn("pp_elastic", d / "world", inputs)


_REFERENCE = """
import dataclasses, json, sys
import jax, jax.numpy as jnp, numpy as np
from jax.sharding import Mesh, PartitionSpec as P
from repro.configs import registry
from repro.configs.base import ALL_SHAPES
from repro.distributed.elastic import make_mesh, reshard, shrunk_mesh
from repro.distributed.pp import pipeline_forward
from repro.distributed.sharding import make_rules
from repro.faults.liveness import LivenessRegistry
from repro.models import transformer as tfm
from repro.models.model import build
from repro.models.params import abstract_params, partition_specs
from repro.roofline import hlo_collectives

src, dst, q_layers, n_prod, n_live, plan_shapes = sys.argv[1:7]
d = dict(np.load(src))
out, meta = {}, {}
devs = jax.devices()
mesh4 = Mesh(np.asarray(devs[:4]), ("pipe",))
mesh2 = Mesh(np.asarray(devs[:2]), ("pipe",))

def block(wl, h):
    return jnp.tanh(h @ wl)

w, x = jnp.asarray(d["w"]), jnp.asarray(d["x"])
for M in (2, 4, 8):
    out[f"tanh{M}"] = np.asarray(pipeline_forward(block, w, x, mesh4,
                                                  microbatches=M))
text = jax.jit(lambda w, x: pipeline_forward(
    block, w, x, mesh4, microbatches=4)).lower(w, x).compile().as_text()
st = hlo_collectives.analyze(text)
meta["collectives"] = [dict(st.per_kind_count), dict(st.per_kind_bytes)]
meta["collective_lines"] = [
    ln.strip() for ln in text.splitlines()
    if hlo_collectives._OP_RE.search(ln)]

cfg = dataclasses.replace(registry.get_reduced("qwen3-8b"),
                          n_layers=int(q_layers))
params = build(cfg).init(jax.random.key(0), dtype=jnp.float32)
leaves, treedef = jax.tree.flatten(params["blocks"])
blocks = jax.tree.unflatten(treedef, [jnp.asarray(d[f"p{i}"])
                                      for i in range(len(leaves))])
qx = jnp.asarray(d["qx"])
positions = jnp.arange(qx.shape[1])

def attn(lp, h):
    return tfm._attn_block(lp, h, cfg, positions, causal=True)[0]

for n, mesh in ((4, mesh4), (2, mesh2)):
    out[f"qwen{n}"] = np.asarray(pipeline_forward(attn, blocks, qx, mesh))

def shards(tag, tree):
    for k, arr in tree.items():
        for s in arr.addressable_shards:
            out[f"{tag}_{k}_{s.device.id}"] = np.asarray(s.data)

# the reference test's case, 8 -> 4, then 4 -> the mesh without rank 3
params = {"w": jnp.asarray(d["rw"]), "b": jnp.asarray(d["rb"])}
specs = {"w": P("data", None), "b": P("data")}
p8, plan8 = reshard(params, specs, make_mesh(8, model_parallel=2))
p4, plan4 = reshard(p8, specs, make_mesh(4, model_parallel=2))
shards("r4", p4)
meta["plan8"], meta["plan4"] = plan8.demotions, plan4.demotions
specs3 = dict(specs, v=P("data", "model"))
pv4, _ = reshard(dict(params, v=jnp.asarray(d["rv"])), specs3,
                 make_mesh(4, model_parallel=2))
reg = LivenessRegistry()
reg.mark_dead(3)
m3 = shrunk_mesh(4, reg, model_parallel=2)
p3, plan3 = reshard(pv4, specs3, m3)
shards("r3", p3)
meta["plan3"], meta["shape3"] = plan3.demotions, list(m3.devices.shape)

# the production size: 256 -> 240 live
reg = LivenessRegistry()
for r in range(int(n_live), int(n_prod)):
    reg.mark_dead(r)
m = shrunk_mesh(int(n_prod), reg)
meta["shape_live"] = list(m.devices.shape)
shapes = {s.name: s for s in ALL_SHAPES}
for arch in registry.list_archs():
    cfg = registry.get_reduced(arch)
    defs = tfm.param_defs(cfg)
    tree = jax.tree.map(lambda s: jnp.zeros(s.shape, s.dtype),
                        abstract_params(defs))
    for name in plan_shapes.split(","):
        shape = shapes[name]
        rules = make_rules(cfg, shape,
                           registry.default_parallelism(cfg, shape))
        _, plan = reshard(tree, partition_specs(defs, rules.mapping), m)
        meta[f"plan/{arch}/{name}"] = plan.demotions
np.savez(dst + "/out.npz", **out)
with open(dst + "/meta.json", "w") as f:
    json.dump(meta, f)
print("ok")
"""


@pytest.fixture(scope="module")
def ref(setup):
    d = setup[0]
    env = dict(os.environ, PYTHONPATH=SRC, JAX_PLATFORMS="cpu",
               XLA_FLAGS=f"--xla_force_host_platform_device_count={N_PROD}")
    proc = subprocess.run(
        [sys.executable, "-c", textwrap.dedent(_REFERENCE), str(d / "in.npz"),
         str(d), str(Q_LAYERS), str(N_PROD), str(N_LIVE),
         ",".join(PLAN_SHAPES)],
        capture_output=True, text=True, env=env, timeout=300)
    assert proc.returncode == 0, proc.stderr[-4000:]
    with open(d / "meta.json") as f:
        meta = json.load(f)
    return dict(np.load(d / "out.npz")), meta


_FAKE_WORLD = """
import json, sys
import torch.distributed as dist
from torch.testing._internal.distributed.fake_pg import FakeStore
from repro_torch.configs import registry
from repro_torch.configs.base import ALL_SHAPES
from repro_torch.distributed.elastic import make_mesh, reshard, shrunk_mesh
from repro_torch.distributed.sharding import make_rules
from repro_torch.faults.liveness import LivenessRegistry
from repro_torch.models import transformer as tfm
from repro_torch.models.model import build
from repro_torch.models.params import partition_specs

n_prod, n_live, plan_shapes = sys.argv[1:4]
dist.init_process_group("fake", store=FakeStore(), rank=0,
                        world_size=int(n_prod))
import torch
meta = {}
m8 = make_mesh(8, model_parallel=2, device="cpu")
_, plan8 = reshard({"w": torch.ones(16, 8), "b": torch.ones(7)},
                   {"w": ("data", None), "b": ("data",)}, m8)
meta["plan8"] = plan8.demotions
reg = LivenessRegistry()
for r in range(int(n_live), int(n_prod)):
    reg.mark_dead(r)
m = shrunk_mesh(int(n_prod), reg, device="cpu")
meta["shape_live"] = list(m.shape)
shapes = {s.name: s for s in ALL_SHAPES}
for arch in registry.list_archs():
    cfg = registry.get_reduced(arch)
    model = build(cfg).init(seed=0, device="cpu")
    for name in plan_shapes.split(","):
        shape = shapes[name]
        rules = make_rules(cfg, shape,
                           registry.default_parallelism(cfg, shape))
        out, plan = reshard(model, partition_specs(tfm.param_defs(cfg),
                                                   rules), m)
        assert out["blocks"][0]["ln1"].device_mesh is m
        meta[f"plan/{arch}/{name}"] = plan.demotions
dist.destroy_process_group()
print(json.dumps(meta))
"""


@pytest.fixture(scope="module")
def fake_world():
    env = dict(os.environ, PYTHONPATH=SRC, OMP_NUM_THREADS="1")
    proc = subprocess.run(
        [sys.executable, "-c", textwrap.dedent(_FAKE_WORLD), str(N_PROD),
         str(N_LIVE), ",".join(PLAN_SHAPES)],
        capture_output=True, text=True, env=env, timeout=300)
    assert proc.returncode == 0, proc.stderr[-4000:]
    return json.loads(proc.stdout.strip().splitlines()[-1])


# ---------------------------------------------------------- pipeline


@pytest.mark.parametrize("M", MICROBATCHES)
def test_pipeline_forward_matches_reference(world, ref, M):
    want = ref[0][f"tanh{M}"]
    for out in world:
        got = out[("tanh", M)].numpy()
        assert got.shape == (B, D)
        assert float(np.abs(got - want).max()) < 1e-5


@pytest.mark.parametrize("M", MICROBATCHES)
def test_ranks_and_one_process_schedule_agree_bitwise(world, M):
    first = world[0][("tanh", M)]
    for out in world:
        assert torch.equal(out[("tanh", M)], first)
        assert torch.equal(out[("tanh_local", M)], first)
    for key in ("qwen4", "qwen2"):
        assert all(torch.equal(out[key], world[0][key]) for out in world)


def _run_decoder(model, cfg, x):
    return tfm.run_decoder(model, x, cfg, torch.arange(x.shape[1]))[0]


@pytest.mark.parametrize("stages", [4, 2])
def test_reduced_qwen3_stack_matches_run_decoder(setup, world, stages):
    _, a, cfg, model = setup
    x = torch.from_numpy(a["qx"])
    got = world[0][f"qwen{stages}"]
    with torch.no_grad():
        whole = _run_decoder(model, cfg, x)
        per_mb = torch.cat([_run_decoder(model, cfg, xm)
                            for xm in x.chunk(4)])
    assert float((got - whole).abs().max()) <= 1e-6
    assert torch.equal(got, per_mb)
    if stages == 4:
        # the reference's stacked (L, ...) leaves give the same bits
        assert torch.equal(world[0]["qwen4_stacked"], got)


@pytest.mark.parametrize("stages", [4, 2])
def test_reduced_qwen3_stack_matches_reference(world, ref, stages):
    np.testing.assert_allclose(world[0][f"qwen{stages}"].numpy(),
                               ref[0][f"qwen{stages}"], atol=1e-4,
                               rtol=1e-4)


def test_uneven_splits_raise(world):
    for out in world:
        assert out["errors"]["layers"] == "6 layers do not split into 4 " \
            "stages"
        assert out["errors"]["batch"] == "batch 8 does not split into 3 " \
            "microbatches"


def test_pipeline_collectives_match_reference_hlo(world, ref):
    """7 hand-offs of (2, 16) float32 and one all-reduce of the (4, 2, 16)
    output over 4 ranks, on every rank, as the reference's compiled
    program holds them (its loop body's permute times the trip count)."""
    want_count, want_bytes = ref[1]["collectives"]
    assert want_count == {"all-reduce": 1, "collective-permute": 7}, \
        ref[1]["collective_lines"]
    for out in world:
        count, nbytes, records = out["collectives"]
        assert count == want_count
        assert nbytes == want_bytes
        assert sorted(set(records)) == [("all-reduce", 4 * 2 * 16 * 4, 4),
                                        ("collective-permute", 2 * 16 * 4, 4)]


# ---------------------------------------------------------- reshard


def test_reshard_reference_case(world, ref, fake_world):
    want, meta = ref
    assert fake_world["plan8"] == meta["plan8"] == ["['b']"]
    for rank, out in enumerate(world):
        blocks, demotions, shape = out["reshard4"]
        assert demotions == meta["plan4"] == ["['b']"]
        assert shape == (2, 2)
        for k, v in blocks.items():
            assert v.numpy().tobytes() == want[f"r4_{k}_{rank}"].tobytes(), \
                (rank, k)


def test_reshard_onto_the_shrunk_mesh(world, ref):
    want, meta = ref
    from torch.distributed.tensor import Replicate, Shard
    for rank, out in enumerate(world):
        blocks, placements, demotions, shape, count = out["reshard3"]
        assert demotions == meta["plan3"] == ["['b']", "['w']"]
        assert list(shape) == meta["shape3"] == [3, 1]
        # made whole on the (2, 2) mesh: w over data, v over data and
        # over model; b was replicated there
        assert count == {"all-gather": 3}
        assert placements["v"] == (Shard(0), Shard(1))
        assert placements["w"] == (Replicate(), Replicate())
        for k, v in blocks.items():
            if rank == 3:                 # outside the new mesh
                assert v.numel() == 0
                continue
            assert v.numpy().tobytes() == want[f"r3_{k}_{rank}"].tobytes(), \
                (rank, k)


@pytest.mark.parametrize("shape", PLAN_SHAPES)
def test_reshard_plan_at_production_size(ref, fake_world, shape):
    meta = ref[1]
    assert fake_world["shape_live"] == meta["shape_live"] == [15, 16]
    demoted = 0
    for arch in ARCHS:
        key = f"plan/{arch}/{shape}"
        assert fake_world[key] == meta[key], arch
        demoted += len(meta[key])
    assert demoted > 0                    # the plan is not trivially empty


def test_shrunk_mesh_with_no_live_rank_raises():
    with pytest.raises(ValueError, match=r"no live devices left of 2 "
                       r"\(failed: \[0, 1\]\)"):
        shrunk_mesh(2, [0, 1], device="cpu")


@pytest.mark.parametrize("arch", ARCHS)
def test_partition_specs_match_reference(arch):
    """Every arch x shape: the port's specs over its ``ParamDef`` tree are
    the reference's ``PartitionSpec`` s as tuples, stacked leaves with
    their ``layers`` entry in front."""
    cfg, ref_cfg = registry.get(arch), ref_registry.get(arch)
    for shape, ref_shape in zip(ALL_SHAPES, REF_SHAPES):
        rules = make_rules(cfg, shape,
                           registry.default_parallelism(cfg, shape))
        want = ref_specs(ref_tfm.param_defs(ref_cfg), ref_rules(
            ref_cfg, ref_shape, ref_registry.default_parallelism(
                ref_cfg, ref_shape)).mapping)
        got = partition_specs(tfm.param_defs(cfg), rules)
        flat, _ = jax.tree_util.tree_flatten_with_path(
            want, is_leaf=lambda s: isinstance(s, jax.sharding.PartitionSpec))
        assert len(flat) == len(jax.tree.leaves(
            got, is_leaf=lambda s: isinstance(s, tuple)))
        for path, spec in flat:
            node = got
            for k in path:
                node = node[k.key]
            assert node == tuple(spec), (arch, shape.name, path)
