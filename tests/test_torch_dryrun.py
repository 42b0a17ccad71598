"""The port's dry-run against the reference's (``repro_torch.launch.dryrun``,
``repro_torch.models.model`` ``input_specs``, ``repro_torch.configs.registry``
``ASSIGNED_ARCHS``): the spec arithmetic, the inputs and the CLI.

One JAX subprocess imports the reference's ``repro.launch.dryrun``, which
forces 512 fake host devices, and computes, with no lowering:

* ``_bytes_per_device`` of the parameters and of the optimizer state
  (``eval_shape(opt.init)``) or the decode cache over their specs, for
  every assigned arch x shape x {single, multi}: the port's
  ``analytic_bytes_per_device`` is **equal**, float for float;
* ``_opt_specs`` of every arch's train cell, leaf by leaf;
* ``input_specs`` (shapes, dtypes) and ``batch_logical_axes`` of every
  arch x shape, in the reference's key order;
* ``param_bytes`` of every arch, bf16 and float32, equal to the
  reference's (in this process);
* ``main()`` with ``lower_cell`` stubbed, over every arch x shape x mesh:
  the records, ``{"skipped": why}``, an error record, the cache (a second
  run traces nothing), ``--force``, and ``--set`` parsing; the port's
  ``main()`` with the same stub prints the same lines (``[trace]`` for
  the reference's ``[lower+compile]``) and writes the same records;
* then it compiles one reduced mamba2-1.3b train cell (global batch 256,
  seq 64: pure data parallelism over 256 devices) with the reference's
  ``lower_cell`` and keeps its HLO's all-reduces.  The port traces the
  same cell on a fake world of 256 ranks.  Their all-reduce wire bytes
  differ by the reference's own HLO, pinned term by term in
  ``test_pure_dp_allreduce_matches_reference_hlo``.
"""
import json
import os
import re
import subprocess
import sys
import textwrap

import pytest

torch = pytest.importorskip("torch")

from repro_torch.configs import registry  # noqa: E402
from repro_torch.configs.base import ALL_SHAPES, ShapeConfig  # noqa: E402
from repro_torch.launch import dryrun  # noqa: E402
from repro_torch.models.model import build  # noqa: E402
from repro_torch.train.optimizer import param_leaves  # noqa: E402

SRC = os.path.join(os.path.dirname(__file__), "..", "src")
MESHES = ("single", "multi")
#: the CLI runs: (argv, a cell the stub fails)
CLI_RUNS = (
    ["--out", "results/dryrun.json"],
    ["--out", "results/dryrun.json"],
    ["--out", "results/dryrun.json", "--force"],
    ["--out", "results/set.json", "--arch", "qwen3-8b,mamba2-1.3b",
     "--shape", "train_4k,decode_32k", "--mesh", "single", "--set",
     "microbatches=8", "--set", "fsdp=1", "--set", "remat=full"],
)
FAILING = ("deepseek-7b", "decode_32k", True)
#: the pure data-parallel cell: reduced mamba2-1.3b, batch 256, seq 64
PURE_DP = ("mamba2-1.3b", 64, 256)

_REF = """
import contextlib, io, json, os, re, sys
import repro.launch.dryrun as dr          # forces 512 fake host devices
import jax
import jax.numpy as jnp
from jax.sharding import PartitionSpec as P
from repro.configs import registry
from repro.configs.base import ALL_SHAPES, ShapeConfig, shape_applicable
from repro.distributed.sharding import make_rules
from repro.launch.mesh import make_production_mesh
from repro.models.model import build
from repro.models.params import abstract_params, partition_specs
from repro.roofline import hlo_collectives
from repro.train.optimizer import AdamW

workdir, cli_runs, failing, pure_dp = (sys.argv[1], json.loads(sys.argv[2]),
                                       json.loads(sys.argv[3]),
                                       json.loads(sys.argv[4]))
assert len(jax.devices()) == 512


def spec(s):
    return [list(e) if isinstance(e, tuple) else e for e in s]


out = {"bytes": {}, "opt_specs": {}, "inputs": {}}
for arch in registry.ASSIGNED_ARCHS:
    cfg = registry.get(arch)
    model = build(cfg)
    defs = model.param_defs()
    for shape in ALL_SHAPES:
        axes = model.batch_logical_axes(shape)
        out["inputs"][f"{arch}|{shape.name}"] = [
            [k, list(v.shape), str(v.dtype), list(axes[k])]
            for k, v in model.input_specs(shape).items()]
        par = registry.default_parallelism(cfg, shape)
        for kind in ("single", "multi"):
            mesh = make_production_mesh(multi_pod=kind == "multi")
            rules = make_rules(cfg, shape, par, multi_pod=kind == "multi",
                               tp_size=mesh.shape["model"],
                               dp_size=mesh.shape["data"], mesh=mesh)
            key = f"{arch}|{shape.name}|{kind}"
            try:
                p_abs = abstract_params(defs, jnp.dtype(par.param_dtype))
                p_specs = partition_specs(defs, rules.mapping)
                if shape.is_train:
                    opt = AdamW(state_dtype=par.opt_state_dtype)
                    o_abs = jax.eval_shape(opt.init, p_abs)
                    m_specs = dr._opt_specs(p_specs, o_abs.m, par.fsdp,
                                            mesh.shape["data"])
                    o_specs = type(o_abs)(step=P(), m=m_specs, v=m_specs)
                    extra = dr._bytes_per_device(o_abs, o_specs, mesh)
                    if kind == "single":
                        out["opt_specs"][arch] = [spec(s) for s in jax.tree.leaves(
                            m_specs, is_leaf=lambda x: isinstance(x, P))]
                else:
                    c_defs = model.cache_defs(shape.global_batch,
                                              shape.seq_len)
                    extra = dr._bytes_per_device(
                        abstract_params(c_defs),
                        partition_specs(c_defs, rules.mapping), mesh)
                params = dr._bytes_per_device(p_abs, p_specs, mesh)
                out["bytes"][key] = [params, extra, params + extra]
            except Exception as e:
                out["bytes"][key] = type(e).__name__


def stub(arch, shape, *, multi_pod, parallel=None):
    if [arch, shape.name, multi_pod] == failing:
        raise RuntimeError("planted failure")
    return {"arch": arch, "shape": shape.name, "multi_pod": multi_pod,
            "parallel": None if parallel is None else parallel.__dict__,
            "bottleneck": "compute", "roofline_fraction": 0.5}


real_lower = dr.lower_cell
dr.lower_cell = stub
os.chdir(workdir)
out["cli"] = []
for argv in cli_runs:
    sys.argv = ["dryrun", *argv]
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        dr.main()
    with open(argv[1]) as f:
        out["cli"].append({"stdout": buf.getvalue(), "records": json.load(f)})

dr.lower_cell = real_lower
registry.get = registry.get_reduced
hlo = []
analyze = hlo_collectives.analyze
dr.hlo_collectives.analyze = lambda text: hlo.append(text) or analyze(text)
arch, seq, batch = pure_dp
rec = dr.lower_cell(arch, ShapeConfig("train_4k", seq, batch, "train"),
                    multi_pod=False)
out["pure_dp"] = {
    "collectives": rec["collectives"],
    "counts": rec["collective_counts"],
    "parallelism": rec["parallelism"],
    "all_reduce_ops": [m.group(1) for m in re.finditer(
        r"= (.*?) all-reduce\\(", hlo[0])],
}
print(json.dumps(out))
"""


@pytest.fixture(scope="module")
def ref(tmp_path_factory):
    work = tmp_path_factory.mktemp("ref_cli")
    env = dict(os.environ, PYTHONPATH=SRC, JAX_PLATFORMS="cpu",
               OMP_NUM_THREADS="1")
    env.pop("XLA_FLAGS", None)
    proc = subprocess.run(
        [sys.executable, "-c", textwrap.dedent(_REF), str(work),
         json.dumps(CLI_RUNS), json.dumps(list(FAILING)),
         json.dumps(list(PURE_DP))],
        capture_output=True, text=True, env=env, timeout=600)
    assert proc.returncode == 0, proc.stderr[-4000:]
    return json.loads(proc.stdout.strip().splitlines()[-1])


def _spec(s):
    """A spec as the reference's ``PartitionSpec`` prints in JSON."""
    return [list(e) if isinstance(e, tuple) else e for e in s]


# ---------------------------------------------------------- spec arithmetic


@pytest.mark.parametrize("mesh", MESHES)
@pytest.mark.parametrize("arch", registry.ASSIGNED_ARCHS)
def test_bytes_per_device_matches_reference(ref, arch, mesh):
    for shape in ALL_SHAPES:
        want = ref["bytes"][f"{arch}|{shape.name}|{mesh}"]
        try:
            got = dryrun.analytic_bytes_per_device(
                arch, shape, multi_pod=mesh == "multi")
        except Exception as e:           # where the reference raises
            assert type(e).__name__ == want, (arch, shape.name)
            continue
        assert [got["params"], got["state_or_cache"], got["total"]] == \
            want, (arch, shape.name)


@pytest.mark.parametrize("arch", registry.list_archs())
def test_param_bytes_match_reference(arch):
    import jax.numpy as jnp
    from repro.configs import registry as ref_registry
    from repro.models.model import build as ref_build
    from repro.models.params import param_bytes as ref_param_bytes
    from repro_torch.models.params import param_bytes
    defs = build(registry.get(arch)).defs
    ref_defs = ref_build(ref_registry.get(arch)).param_defs()
    for dtype, ref_dtype in ((torch.bfloat16, jnp.bfloat16),
                             (torch.float32, jnp.float32)):
        assert param_bytes(defs, dtype) == ref_param_bytes(ref_defs,
                                                           ref_dtype)


def test_assigned_archs_are_the_reference_s():
    from repro.configs import registry as ref_registry
    assert registry.ASSIGNED_ARCHS == ref_registry.ASSIGNED_ARCHS


@pytest.mark.parametrize("arch", registry.ASSIGNED_ARCHS)
def test_opt_specs_match_reference(ref, arch):
    cfg = registry.get(arch)
    shape = next(s for s in ALL_SHAPES if s.is_train)
    par = registry.default_parallelism(cfg, shape)
    rules = dryrun.make_rules(cfg, shape, par, tp_size=16, dp_size=16)
    model = build(cfg)
    p_specs = dryrun.partition_specs(model.defs, rules.mapping)
    flat = {leaf.path: s for leaf, s in zip(
        param_leaves(model), dryrun._leaves(p_specs), strict=True)}
    state = dryrun.AdamW(state_dtype=par.opt_state_dtype).init(model)
    m_specs = dryrun._opt_specs(flat, state.m, par.fsdp, 16)
    got = [_spec(s) for v in m_specs.values() for s in dryrun._leaves(v)]
    assert got == ref["opt_specs"][arch]


@pytest.mark.parametrize("arch", registry.ASSIGNED_ARCHS)
def test_input_specs_match_reference(ref, arch):
    model = build(registry.get(arch))
    for shape in ALL_SHAPES:
        axes = model.batch_logical_axes(shape)
        got = [[k, list(dims), str(dtype).replace("torch.", ""),
                list(axes[k])]
               for k, (dims, dtype) in model.input_specs(shape).items()]
        assert got == ref["inputs"][f"{arch}|{shape.name}"], shape.name


# ---------------------------------------------------------------- the CLI


def _stub(arch, shape, *, multi_pod, parallel=None, **_):
    if [arch, shape.name, multi_pod] == list(FAILING):
        raise RuntimeError("planted failure")
    return {"arch": arch, "shape": shape.name, "multi_pod": multi_pod,
            "parallel": None if parallel is None else parallel.__dict__,
            "bottleneck": "compute", "roofline_fraction": 0.5}


def _records(records):
    """Records with an error's traceback (its file paths) left out."""
    return {k: {f: v for f, v in r.items() if f != "traceback"}
            for k, r in records.items()}


def test_cli_matches_reference(ref, tmp_path, monkeypatch, capsys):
    monkeypatch.setattr(dryrun, "lower_cell", _stub)
    monkeypatch.chdir(tmp_path)
    for argv, want in zip(CLI_RUNS, ref["cli"], strict=True):
        dryrun.main(argv)
        stdout = capsys.readouterr().out
        assert stdout == want["stdout"].replace("[lower+compile]",
                                                "[trace]"), argv
        with open(argv[1]) as f:
            assert _records(json.load(f)) == _records(want["records"])
    first, cached, forced, _ = ref["cli"]
    lines = first["stdout"].splitlines()
    assert lines[-1].startswith("done: ") and "1 failed" in lines[-1]
    assert any(line.startswith("[skip n/a]") for line in lines)
    # the second run retries only the failed cell; --force traces all
    assert sum(line.startswith("[lower+compile]")
               for line in cached["stdout"].splitlines()) == 1
    assert forced["stdout"].count("[lower+compile]") == \
        first["stdout"].count("[lower+compile]")


def test_set_parsing_matches_reference():
    assert dryrun._overrides(["microbatches=8", "fsdp=1", "remat=full",
                              "tp=False"]) == {
        "microbatches": 8, "fsdp": True, "remat": "full", "tp": False}


# ----------------------------------------------------- pure data parallel


def test_pure_dp_allreduce_matches_reference_hlo(ref, monkeypatch):
    """The reduced mamba2-1.3b train cell, batch 256 over all 256 ranks:
    the port all-reduces each parameter's gradient in its bfloat16 and
    the loss in float32.  The reference's wire bytes differ from the
    port's by three behaviours of its own HLO and parser, pinned here
    term by term (``ROADMAP.md`` Queue 3):

    * ``all-reduce.176 = (f32[64], f32[2048,64], f32[2048,64], f32[])``:
      the gradients reach the all-reduce in float32 (``final_norm``, the
      token table's, the head's, the latter laid out transposed), beside
      the loss;
    * the per-layer gradients' all-reduce sits in the layer scan's
      ``while`` body, which the reference's ``hlo_collectives.analyze``
      does not count (2 of the HLO's 3 all-reduce ops);
    * ``all-reduce.23 = f32[] all-reduce(...)``: a second float32 scalar
      of the loss.
    """
    arch, seq, batch = PURE_DP
    monkeypatch.setattr(registry, "get", registry.get_reduced)
    got = dryrun.lower_cell(arch, ShapeConfig("train_4k", seq, batch,
                                              "train"),
                            multi_pod=False, device="cpu")
    want = ref["pure_dp"]
    assert want["parallelism"] == got["parallelism"]
    assert got["parallelism"]["dp_over_model"] and not \
        got["parallelism"]["tp"]
    cfg = registry.get_reduced(PURE_DP[0])
    g = 256
    factor = 2.0 * (g - 1) / g
    model = build(cfg)
    n_params = sum(p.numel() for p in model.parameters())
    # the port: every gradient in bf16, one float32 loss
    assert got["collectives"] == {"all-reduce": factor * (2 * n_params + 4)}
    assert got["collective_counts"]["all-reduce"] == \
        len(list(model.parameters())) + 1
    # the reference: the counted all-reduces hold the token table, the
    # head and the final norm in float32, and two float32 scalars
    outside = sum(p.numel() for n, p in model.named_parameters()
                  if not n.startswith("blocks."))
    assert outside == 2 * 2048 * 64 + 64
    assert want["collectives"] == {"all-reduce": factor * (4 * outside + 8)}
    assert want["counts"] == {"all-reduce": 2}
    assert len(want["all_reduce_ops"]) == 3
    assert all(re.fullmatch(r"\(?f32\[.*", op)
               for op in want["all_reduce_ops"])
    ratio = want["collectives"]["all-reduce"] / \
        got["collectives"]["all-reduce"]
    assert ratio == pytest.approx((4 * outside + 8) / (2 * n_params + 4),
                                  rel=1e-12)
