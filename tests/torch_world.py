"""Small worlds of ranks for the port's multi-rank tests (not a test
module: the ``test_torch_{mesh,dp,ep_sp,pp_elastic,dryrun_trace,
fsdp_tp,layout_decode_moe,layout_ssm_hybrid}.py`` files import it).

:func:`spawn` starts ``world`` Python processes of this file, one per
rank.  Each joins a process group that meets on a file store under the
test's ``tmp_path`` (never a fixed port: several test workers run at
once), gloo on the CPU or NCCL on the card, with a 60 s collective
timeout; loads the inputs the parent saved with ``torch.save``; runs one
case of :data:`CASES` (several checks that share a world run in one
case, so one spawn serves them); saves what the case returns; and
leaves the group.  The parent waits for its ranks against a deadline,
kills them all on overrun and fails the test, and fails it with the
rank's error output when a rank exits with another code than 0.

The ranks import ``repro_torch`` and torch only.  The tests compute the
reference's numbers in their own process and hold the ranks' results to
them.
"""
from __future__ import annotations

import os
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
#: seconds a spawned world may take in all
DEADLINE = 240.0


def spawn(case: str, tmp_path, inputs=None, world: int = 4,
          device: str = "cpu", deadline: float = DEADLINE):
    """Run ``CASES[case]`` on ``world`` ranks; returns each rank's result,
    in rank order."""
    import pytest
    import torch
    d = Path(tmp_path)
    d.mkdir(parents=True, exist_ok=True)
    torch.save(inputs or {}, d / "inputs.pt")
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"),
               OMP_NUM_THREADS="1")
    logs = [open(d / f"rank{r}.log", "w+") for r in range(world)]
    procs = [subprocess.Popen(
        [sys.executable, __file__, case, str(r), str(world), str(d), device],
        cwd=str(ROOT), env=env, stdout=logs[r], stderr=subprocess.STDOUT)
        for r in range(world)]
    end = time.monotonic() + deadline
    try:
        for p in procs:
            p.wait(timeout=max(0.0, end - time.monotonic()))
    except subprocess.TimeoutExpired:
        for p in procs:
            p.kill()
        for p in procs:
            p.wait()
        pytest.fail(f"world of {world} ranks for {case!r} overran its "
                    f"{deadline:.0f} s deadline; killed")
    finally:
        for f in logs:
            f.close()
    for r, p in enumerate(procs):
        if p.returncode != 0:
            tail = (d / f"rank{r}.log").read_text()[-4000:]
            pytest.fail(f"rank {r} of {case!r} exited {p.returncode}:\n"
                        f"{tail}")
    return [torch.load(d / f"out{r}.pt", weights_only=False)
            for r in range(world)]


# ---------------------------------------------------------------------------
# Cases, run in each rank: (rank, world, inputs, device) -> result
# ---------------------------------------------------------------------------

def _model(arch: str, state, dtype=None, device="cpu", cfg=None):
    """The port's reduced ``arch`` with the parameters of ``state`` (a
    ``{name: tensor}`` the parent took from the reference's tree)."""
    from torch import nn
    from repro_torch.configs import registry
    from repro_torch.models.model import build
    model = build(cfg or registry.get_reduced(arch))
    for name, t in state.items():
        *path, leaf = name.split(".")
        tree = model
        for part in path:
            tree = tree[int(part)] if part.isdigit() else getattr(tree, part)
        t = t.to(device) if dtype is None else t.to(device, dtype)
        setattr(tree, leaf, nn.Parameter(t.clone(), requires_grad=False))
    return model


def _gather(t, mesh, placements):
    """The full tensor of this rank's block ``t`` laid out by
    ``placements`` on ``mesh``."""
    from torch.distributed.tensor import DTensor
    return DTensor.from_local(t, mesh, placements,
                              run_check=False).full_tensor()


def case_mesh(rank, world, inputs, device):
    import torch
    from torch.distributed.device_mesh import init_device_mesh
    from torch.distributed.tensor import DTensor, Replicate
    from repro_torch.configs import registry
    from repro_torch.configs.base import TRAIN_4K, ParallelismConfig
    from repro_torch.distributed.sharding import (distribute_model,
                                                  local_block, make_rules,
                                                  shard, use_rules)
    from repro_torch.launch.mesh import make_debug_mesh, make_production_mesh
    from repro_torch.models.model import build

    out = {}
    m = make_debug_mesh(device=device)
    out["debug"] = (tuple(m.shape), m.mesh_dim_names, m.get_coordinate())
    sub = make_debug_mesh(2, device=device)
    out["debug2"] = (tuple(sub.shape), sub.get_coordinate())
    for multi in (False, True):
        try:
            make_production_mesh(multi_pod=multi, device=device)
            out[f"prod{multi}"] = None
        except RuntimeError as e:
            out[f"prod{multi}"] = str(e)

    mesh = init_device_mesh(device, (2, 2), mesh_dim_names=("data", "model"))
    cfg = registry.get_reduced("deepseek-moe-16b")
    rules = make_rules(cfg, TRAIN_4K, ParallelismConfig(ep=True), tp_size=2,
                       dp_size=2, mesh=mesh)
    out["placements"] = {
        "act": rules.placements(mesh, "batch", "act_seq", "act_embed"),
        "expert": rules.placements(mesh, "expert", "embed", None),
        "router": rules.placements(mesh, "embed", "expert")}
    x = torch.arange(4 * 6, dtype=torch.float32).reshape(4, 6)
    out["block"] = local_block(x, rules, "batch", None)
    out["block_no_rules"] = local_block(x, make_rules(
        cfg, TRAIN_4K, ParallelismConfig(ep=True), tp_size=2, dp_size=2),
        "batch", None)
    rep = DTensor.from_local(x, mesh, (Replicate(), Replicate()),
                             run_check=False)
    with use_rules(rules):
        moved = shard(rep, "batch", None)
        out["shard_plain_is_same"] = shard(x, "batch", None) is x
    out["shard"] = (moved.placements, moved.to_local())
    out["shard_no_rules_is_same"] = shard(rep, "batch", None) is rep

    model = build(cfg).init(seed=0, device=device)
    full = {n: p.detach().clone() for n, p in model.named_parameters()}
    distribute_model(model, rules, experts_only=True)
    kinds = {}
    for n, p in model.named_parameters():
        if isinstance(p, DTensor):
            kinds[n] = (tuple(p.placements), tuple(p.to_local().shape),
                        bool(torch.equal(p.full_tensor(), full[n])),
                        bool(torch.equal(p.to_local(), full[n].narrow(
                            0, mesh.get_local_rank("model")
                            * p.to_local().shape[0], p.to_local().shape[0]))))
        else:
            kinds[n] = bool(torch.equal(p, full[n]))
    out["distributed"] = kinds
    return out


def case_dp(rank, world, inputs, device):
    import torch
    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh
    from repro_torch.train import compression
    from repro_torch.train.dp_shard import build_dp_train_step
    from repro_torch.train.optimizer import AdamW

    out = {}
    # ---- allreduce_compressed, with the shared scales and code sums seen
    seen = []
    real = dist.all_reduce

    def recording(t, *a, **k):
        res = real(t, *a, **k)
        seen.append(t.clone())
        return res

    ar = inputs["allreduce"]
    compression.dist.all_reduce = recording
    try:
        mean, ef = compression.allreduce_compressed(
            ar["grads"][rank], compression.EFState(ar["residuals"][rank]))
    finally:
        compression.dist.all_reduce = real
    out["allreduce"] = {"mean": mean, "residual": ef.residual,
                        "seen": seen}

    mesh = init_device_mesh(device, (world,), mesh_dim_names=("data",))
    for key, run in inputs["runs"].items():
        model = _model(run["arch"], run["state"], device=device)
        opt = AdamW(lr=1e-3)
        step = build_dp_train_step(model, opt, mesh,
                                   compress_grads=run["compress"])
        state = opt.init(model)
        ef = compression.init_ef(model)
        batch = {k: v.to(device) for k, v in run["batch"].items()}
        hist = []
        for _ in range(run["steps"]):
            model, state, ef, metrics = step(model, state, ef, batch)
            hist.append({k: float(v) for k, v in metrics.items()})
        params = {n: p.detach().cpu() for n, p in model.named_parameters()}
        digest = torch.stack([p.double().sum() for p in params.values()])
        out[key] = {"hist": hist, "digest": digest,
                    "params": params if rank == 0 else None}
    return out


def _grads(model, loss):
    """{name: (this rank's gradient, its placements or None)}: a DTensor
    parameter's gradient is its local block."""
    import torch
    from torch.distributed.tensor import DTensor
    names, params = zip(*model.named_parameters())
    out = {}
    for n, g in zip(names, torch.autograd.grad(loss, params)):
        out[n] = (g.to_local(), g.placements) if isinstance(g, DTensor) \
            else (g, None)
    return out


def case_ep_sp(rank, world, inputs, device):
    import copy
    import torch
    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh
    from torch.distributed.tensor import Replicate, Shard
    from repro_torch.configs.base import PREFILL_32K, TRAIN_4K, \
        ParallelismConfig
    from repro_torch.distributed.sharding import (distribute_model,
                                                  local_block, make_rules,
                                                  use_rules)
    from repro_torch.models.ssm_sp import ssm_block_seq_parallel

    out = {}
    ep = inputs["ep"]
    base = _model("deepseek-moe-16b", ep["state"], device=device,
                  cfg=ep["cfg"])
    tokens = ep["tokens"].to(device)
    labels = ep["labels"].to(device)
    for shape in ((2, 2), (1, 4)):
        mesh = init_device_mesh(device, shape,
                                mesh_dim_names=("data", "model"))
        rules = make_rules(ep["cfg"], TRAIN_4K, ParallelismConfig(ep=True),
                           tp_size=shape[1], dp_size=shape[0], mesh=mesh)
        model = distribute_model(copy.deepcopy(base).requires_grad_(True),
                                 rules, experts_only=True)
        local = local_block(tokens, rules, "batch", None)
        with use_rules(rules):
            logits, aux = model.forward({"tokens": local})
            loss = model.loss({"tokens": local, "labels": local_block(
                labels, rules, "batch", None)})
        # the data ranks' gradients averaged, as the data-parallel step
        # averages them; an expert weight's blocks gathered over model
        grads = {}
        for n, (g, placements) in _grads(model, loss).items():
            g = g.contiguous()
            dist.all_reduce(g, group=mesh.get_group("data"))
            g = g / shape[0]
            if placements is not None:
                g = _gather(g, mesh, placements)
            grads[n] = g.cpu()
        out[shape] = {
            "logits": _gather(logits, mesh, (Shard(0), Replicate())).cpu(),
            "aux": float(aux), "n_local": model.blocks[0].moe.we_gate
            .to_local().shape[0], "grads": grads}

    sp = inputs["sp"]
    mesh = init_device_mesh(device, (1, world),
                            mesh_dim_names=("data", "model"))
    p = {k: v.to(device).requires_grad_(True) for k, v in sp["block"].items()}
    S_loc = sp["x"].shape[1] // world
    seg = slice(rank * S_loc, (rank + 1) * S_loc)
    x = sp["x"][:, seg].to(device).requires_grad_(True)
    y = ssm_block_seq_parallel(p, x, sp["cfg"], mesh)
    # each rank's loss term is its segment's; the replicated weights'
    # gradients summed over the ranks are the summed loss's
    gx, *gp = torch.autograd.grad((y * sp["w"][:, seg].to(device)).sum(),
                                  [x, *p.values()])
    # the conv weights' gradients are views of their concatenation's:
    # a collective takes them dense
    gp = [g.contiguous() for g in gp]
    for g in gp:
        dist.all_reduce(g, group=mesh.get_group("model"))
    out["sp_block"] = _gather(y.detach(), mesh, (Replicate(), Shard(1))).cpu()
    out["sp_grads"] = dict(zip(p, (g.cpu() for g in gp)),
                           x=_gather(gx, mesh, (Replicate(), Shard(1))).cpu())

    from repro_torch.configs.registry import default_parallelism
    model = _model("mamba2-1.3b", sp["state"], device=device, cfg=sp["cfg"])
    rules = make_rules(sp["cfg"], PREFILL_32K,
                       default_parallelism(sp["cfg"], PREFILL_32K),
                       tp_size=world, dp_size=1, mesh=mesh)
    tokens = sp["tokens"].to(device)
    with use_rules(rules):
        logits, _ = model.forward(
            {"tokens": local_block(tokens, rules, "batch", "act_seq")})
    out["act_seq"] = rules.mapping["act_seq"]
    out["sp_forward"] = _gather(logits, mesh, (Replicate(), Shard(1))).cpu()
    out["local_forward"] = model.forward({"tokens": tokens})[0].cpu()
    return out


def _stack(trees):
    """Per-layer trees as one tree of stacked (L, ...) leaves, the
    reference's layout."""
    import torch
    if isinstance(trees[0], torch.Tensor):
        return torch.stack(trees)
    return {k: _stack([t[k] for t in trees]) for k in trees[0].keys()}


def _tanh_block(w, h):
    import torch
    return torch.tanh(h @ w)


def case_pp_elastic(rank, world, inputs, device):
    """Pipeline parallelism and elastic resharding on 4 ranks: the
    reference test's tanh stack at M in (2, 4, 8) on a 4-stage ``pipe``
    mesh (with its collectives recorded at M 4), the same schedule run in
    one process, a reduced qwen3-8b stack on 4 stages and on 2 (a (2, 2)
    ``("data", "pipe")`` mesh), the refusals, and ``reshard`` onto
    ``make_mesh(4, model_parallel=2)`` and then onto the mesh with rank 3
    failed."""
    import dataclasses
    import torch
    from torch.distributed.device_mesh import init_device_mesh
    from repro_torch.distributed.elastic import (make_mesh, reshard,
                                                 shrunk_mesh)
    from repro_torch.distributed.pp import (pipeline_forward,
                                            pipeline_forward_local)
    from repro_torch.faults.liveness import LivenessRegistry
    from repro_torch.models.transformer import _attn_block
    from repro_torch.roofline import hlo_collectives

    out = {}
    pipe4 = init_device_mesh(device, (world,), mesh_dim_names=("pipe",))
    t = inputs["tanh"]
    for M in (2, 4, 8):
        with hlo_collectives.record() as rec:
            out[("tanh", M)] = pipeline_forward(_tanh_block, t["w"], t["x"],
                                                pipe4, microbatches=M)
        out[("tanh_local", M)] = pipeline_forward_local(
            _tanh_block, t["w"], t["x"], world, microbatches=M)
        if M == 4:
            st = rec.analyze()
            out["collectives"] = (dict(st.per_kind_count),
                                  dict(st.per_kind_bytes),
                                  [dataclasses.astuple(r)
                                   for r in rec.records])
    errors = {}
    for key, (w, M) in {"layers": (t["w"][:6], 4),
                        "batch": (t["w"], 3)}.items():
        try:
            pipeline_forward(_tanh_block, w, t["x"], pipe4, microbatches=M)
            errors[key] = None
        except ValueError as e:
            errors[key] = str(e)
    out["errors"] = errors

    q = inputs["qwen"]
    cfg = q["cfg"]
    model = _model("qwen3-8b", q["state"], device=device, cfg=cfg)
    positions = torch.arange(q["x"].shape[1])

    def block(lp, h):
        return _attn_block(lp, h, cfg, positions, causal=True)[0]

    out["qwen4"] = pipeline_forward(block, model.blocks, q["x"], pipe4)
    out["qwen4_stacked"] = pipeline_forward(block, _stack(list(model.blocks)),
                                            q["x"], pipe4)
    mesh22 = init_device_mesh(device, (2, 2),
                              mesh_dim_names=("data", "pipe"))
    out["qwen2"] = pipeline_forward(block, model.blocks, q["x"], mesh22)

    r = inputs["reshard"]
    m4 = make_mesh(4, model_parallel=2, device=device)
    specs = {"w": ("data", None), "b": ("data",)}
    p4, plan4 = reshard({"w": r["w"], "b": r["b"]}, specs, m4)
    out["reshard4"] = ({k: v.to_local() for k, v in p4.items()},
                       plan4.demotions, tuple(m4.shape))
    specs3 = dict(specs, v=("data", "model"))
    p4v, _ = reshard(r, specs3, m4)
    registry = LivenessRegistry()
    registry.mark_dead(3)
    m3 = shrunk_mesh(4, registry, model_parallel=2, device=device)
    with hlo_collectives.record() as rec:
        p3, plan3 = reshard(p4v, specs3, m3)
    out["reshard3"] = ({k: v.to_local() for k, v in p3.items()},
                       {k: v.placements for k, v in p3.items()},
                       plan3.demotions, tuple(m3.shape),
                       dict(rec.analyze().per_kind_count))
    return out


def case_nccl_world_of_one(rank, world, inputs, device):
    """On the card, a world of one over NCCL: each collective path against
    its single-device path (data-, sequence- and expert-parallel, the
    pipeline at one stage, a reshard onto ``make_mesh(1)``), compared
    bitwise in the test."""
    import torch
    from torch.distributed.device_mesh import init_device_mesh
    from repro_torch.configs import registry
    from repro_torch.configs.base import PREFILL_32K, ParallelismConfig
    from repro_torch.configs.registry import default_parallelism
    from repro_torch.distributed.elastic import make_mesh, reshard
    from repro_torch.distributed.pp import (pipeline_forward,
                                            pipeline_forward_local)
    from repro_torch.distributed.sharding import (distribute_model,
                                                  make_rules, use_rules)
    from repro_torch.kernels.ssd_scan.kernel import ssd_scan
    from repro_torch.kernels.flash_attention.kernel import flash_attention
    from repro_torch.models import transformer as tfm
    from repro_torch.models.model import build
    from repro_torch.models.params import load_tree, partition_specs
    from repro_torch.train import compression
    from repro_torch.train.dp_shard import build_dp_train_step
    from repro_torch.train.optimizer import AdamW
    from repro_torch.train.step import build_train_step

    dev = torch.device("cuda")
    mesh = init_device_mesh("cuda", (1, 1), mesh_dim_names=("data", "model"))
    gen = torch.Generator(device=dev).manual_seed(0)
    toks = torch.randint(0, 512, (2, 64), generator=gen, device=dev)
    batch = {"tokens": toks, "labels": toks.roll(-1, 1)}
    out = {}

    runs = {}
    for how in ("single", "dp", "dp_compressed"):
        model = build(registry.get_reduced("qwen3-8b")).init(seed=0,
                                                             device=dev)
        opt = AdamW(lr=1e-3)
        state = opt.init(model)
        if how == "single":
            step = build_train_step(model, ParallelismConfig(), opt)
            for _ in range(2):
                model, state, m = step(model, state, batch)
        else:
            step = build_dp_train_step(model, opt, mesh,
                                       compress_grads=how != "dp")
            ef = compression.init_ef(model)
            for _ in range(2):
                model, state, ef, m = step(model, state, ef, batch)
        runs[how] = ({n: p.detach().cpu()
                      for n, p in model.named_parameters()},
                     float(m["loss"]))
    out["dp"] = runs

    g = torch.randn(3, 1000, generator=gen, device=dev)
    r = torch.randn(3, 1000, generator=gen, device=dev) * 1e-3
    q, scale, two = compression.compress(g, r)
    mean, ef = compression.allreduce_compressed(
        {"g": g}, compression.EFState({"g": r}))
    cq, cscale, _ = compression.compress(g.cpu(), r.cpu())
    # at one rank the mean is the dequantized payload; the residual,
    # rounded once, is within one float32 rounding of the product of
    # compress's (rounded twice, its difference exact); and compress's
    # codes and scales on the card are the CPU's
    deq = compression.decompress(q, scale, g.shape)
    eps = torch.finfo(torch.float32).eps
    out["compressed"] = (
        torch.equal(mean["g"], deq),
        bool(((ef.residual["g"] - two).abs()
              <= eps * (deq.abs() + two.abs())).all()),
        torch.equal(q.cpu(), cq) and torch.equal(scale.cpu(), cscale))

    cfg = registry.get_reduced("mamba2-1.3b")
    model = build(cfg).init(seed=0, device=dev)
    local, _ = model.forward({"tokens": toks})
    rules = make_rules(cfg, PREFILL_32K, default_parallelism(cfg, PREFILL_32K),
                       tp_size=1, dp_size=1, mesh=mesh)
    n0 = ssd_scan.launches
    with use_rules(rules):
        sp, _ = model.forward({"tokens": toks})
    out["sp"] = (torch.equal(sp, local), ssd_scan.launches - n0)

    cfg = registry.get_reduced("deepseek-moe-16b")
    model = build(cfg).init(seed=0, device=dev)
    local, aux = model.forward({"tokens": toks})
    rules = make_rules(cfg, PREFILL_32K, default_parallelism(cfg, PREFILL_32K),
                       tp_size=1, dp_size=1, mesh=mesh)
    distribute_model(model, rules, experts_only=True)
    n0 = flash_attention.launches
    with use_rules(rules):
        ep, ep_aux = model.forward({"tokens": toks})
    out["ep"] = (torch.equal(ep, local), torch.equal(ep_aux, aux),
                 flash_attention.launches - n0)

    # the pipeline at one stage, against run_decoder per microbatch; the
    # schedule on 2 stages in one process; a reshard onto make_mesh(1)
    cfg = registry.get_reduced("qwen3-8b")
    model = build(cfg).init(seed=0, device=dev)
    x = tfm._embed_inputs(model, cfg, {"tokens": toks})
    positions = torch.arange(toks.shape[1], device=dev)

    def block(lp, h):
        return tfm._attn_block(lp, h, cfg, positions, causal=True)[0]

    pipe = init_device_mesh("cuda", (1,), mesh_dim_names=("pipe",))
    with torch.no_grad():
        want = torch.cat([tfm.run_decoder(model, xm, cfg, positions)[0]
                          for xm in x.chunk(2)])
        n0 = flash_attention.launches
        got = pipeline_forward(block, model.blocks, x, pipe, microbatches=2)
        launches = flash_attention.launches - n0
        two = pipeline_forward_local(block, model.blocks, x, 2,
                                     microbatches=2)
    out["pp"] = (torch.equal(got, want), launches, torch.equal(two, want))
    rules = make_rules(cfg, PREFILL_32K, default_parallelism(cfg, PREFILL_32K))
    tree, plan = reshard(model, partition_specs(tfm.param_defs(cfg), rules),
                         make_mesh(1))
    fresh = build(cfg)
    load_tree(fresh, tree)
    same = all(torch.equal(a, b) for a, b in zip(fresh.parameters(),
                                                 model.parameters()))
    out["reshard"] = (plan.demotions, same, torch.equal(
        fresh.forward({"tokens": toks})[0], model.forward({"tokens": toks})[0]))
    return out


def case_dryrun(rank, world, inputs, device):
    """The dry-run's step run for real: each cell of ``inputs["cells"]``
    (arch, (shape name, seq, batch, kind), mesh shape), on the reduced
    config with seeded weights, through ``launch.dryrun.trace_step``
    under the cell's rules on a ``("data", "model")`` mesh; returns each
    cell's counts (FLOPs, bytes accessed, collectives, kernel calls).
    Then, given ``inputs["ep_batch"]``, one data-parallel step of the
    reduced deepseek-moe-16b, expert parallel on a (2, 2) mesh, on it with
    ``AdamW(**inputs["ep_opt"])``: its gradient norm, its replicated
    parameters and its experts (gathered over ``model``) after the
    step."""
    from torch.distributed.device_mesh import init_device_mesh
    from repro_torch.configs import registry
    from repro_torch.configs.base import ShapeConfig
    from repro_torch.distributed.sharding import distribute_model, make_rules
    from repro_torch.launch.dryrun import trace_step
    from repro_torch.models.model import build

    out = {}
    for arch, shape, mesh_shape in inputs["cells"]:
        cfg = registry.get_reduced(arch)
        shape = ShapeConfig(*shape)
        parallel = registry.default_parallelism(cfg, shape)
        mesh = init_device_mesh(device, tuple(mesh_shape),
                                mesh_dim_names=("data", "model"))
        rules = make_rules(cfg, shape, parallel, tp_size=mesh_shape[1],
                           dp_size=mesh_shape[0], mesh=mesh)
        model = distribute_model(build(cfg).init(seed=rank, device=device),
                                 rules)
        res = trace_step(model, shape, parallel, rules, device)
        out[arch] = {k: res[k] for k in ("flops", "bytes", "collectives",
                                         "collective_counts",
                                         "kernel_calls")}

    # one data-parallel step of the expert-parallel moe (when asked): the
    # same weights on every rank, each model rank its own experts
    if "ep_batch" not in inputs:
        return out
    import torch
    from torch.distributed.tensor import DTensor
    from repro_torch.configs.base import TRAIN_4K, ParallelismConfig
    from repro_torch.distributed.sharding import use_rules
    from repro_torch.train.dp_shard import build_dp_train_step
    from repro_torch.train.optimizer import AdamW
    cfg = registry.get_reduced("deepseek-moe-16b")
    mesh = init_device_mesh(device, (2, 2), mesh_dim_names=("data", "model"))
    rules = make_rules(cfg, TRAIN_4K, ParallelismConfig(ep=True), tp_size=2,
                       dp_size=2, mesh=mesh)
    model = distribute_model(build(cfg).init(seed=0, dtype=torch.float32,
                                             device=device), rules,
                             experts_only=True)
    opt = AdamW(**inputs["ep_opt"])
    step = build_dp_train_step(model, opt, mesh, rules.batch_axes)
    with use_rules(rules):
        _, _, _, metrics = step(model, opt.init(model), None,
                                inputs["ep_batch"])
    out["ep_step"] = {
        "grad_norm": float(metrics["grad_norm"]),
        "replicated": {n: p.detach().clone() for n, p in
                       model.named_parameters()
                       if not isinstance(p, DTensor)},
        # the experts whole: every model rank's updated blocks
        "experts": {n: p.detach().full_tensor() for n, p in
                    model.named_parameters() if isinstance(p, DTensor)},
        "n_local": model.blocks[0].moe.we_gate.to_local().shape[0]}
    return out


def _gather_placed(t, mesh, placements):
    """The whole tensor of a local block ``t`` under ``placements``."""
    from torch.distributed.tensor import Shard
    if not any(isinstance(p, Shard) for p in placements):
        return t.detach().clone()
    return _gather(t.detach().contiguous(), mesh, placements)


def case_fsdp_tp(rank, world, inputs, device):
    """The reference's sharded program: for each case of ``inputs`` (a
    config, a ``("data", "model")`` mesh shape, the reference's initial
    parameters, a global batch), ``build_train_step`` under the cell's
    rules on the placed model (FSDP and TP, the case's microbatches and
    remat) for ``steps`` steps on this rank's block of each microbatch,
    then ``Model.prefill`` of the initial parameters on the rank's blocks
    of the batch and the cache.  Returns the losses and gradient norms,
    the parameters and moments after the steps, the prefill's logits
    and cache, each gathered whole, and the rank's local shapes."""
    import torch
    from torch.distributed.device_mesh import init_device_mesh
    from torch.distributed.tensor import DTensor, Shard
    from repro_torch.configs.base import ShapeConfig
    from repro_torch.distributed.sharding import (distribute_model,
                                                  local_block, make_rules,
                                                  placements_of, use_rules)
    from repro_torch.models.params import partition_specs
    from repro_torch.train.optimizer import AdamW, param_leaves
    from repro_torch.train.step import build_train_step

    out = {}
    for key, case in inputs["cases"].items():
        dp, tp = case["mesh"]
        mesh = init_device_mesh(device, (dp, tp),
                                mesh_dim_names=("data", "model"))
        cfg = case["cfg"]
        par = case["parallel"]
        B, S = case["batch"]["tokens"].shape
        shape = ShapeConfig("train_4k", S, B, "train")
        rules = make_rules(cfg, shape, par, tp_size=tp, dp_size=dp,
                           mesh=mesh)
        model = distribute_model(_model(None, case["state"], cfg=cfg,
                                        device=device), rules)
        opt = AdamW(**case["opt"])
        state = opt.init(model)
        step = build_train_step(model, par, opt)
        n = par.microbatches
        mbs = [{k: v.reshape(n, B // n, *v.shape[1:])[i]
                for k, v in case["batch"].items()} for i in range(n)]
        batch = {k: torch.cat([local_block(mb[k], rules, "batch", "act_seq")
                               for mb in mbs]) for k in case["batch"]}
        hist = []
        for _ in range(case["steps"]):
            with use_rules(rules):
                model, state, m = step(model, state, batch)
            hist.append((float(m["loss"]), float(m["grad_norm"])))
        placed = dict(model.named_parameters())
        params = {n_: (p.detach().full_tensor() if isinstance(p, DTensor)
                       else p.detach().clone()) for n_, p in placed.items()}
        moments = {}
        for leaf in param_leaves(model):
            p = placed[leaf.names[0]]
            pl = p.placements if isinstance(p, DTensor) else ()
            if leaf.stacked and pl:
                pl = tuple(Shard(x.dim + 1) if isinstance(x, Shard) else x
                           for x in pl)
            moments[leaf.path] = tuple(
                _gather_placed(s[leaf.path], mesh, pl) if pl else
                s[leaf.path].detach().clone() for s in (state.m, state.v))
        local_shapes = {n_: tuple(p.to_local().shape) if isinstance(
            p, DTensor) else tuple(p.shape) for n_, p in placed.items()}

        # the prefill of the initial parameters
        pshape = ShapeConfig("prefill", S, B, "prefill")
        prules = make_rules(cfg, pshape, par, tp_size=tp, dp_size=dp,
                            mesh=mesh)
        model = distribute_model(_model(None, case["state"], cfg=cfg,
                                        device=device), prules)
        cdefs = model.cache_defs(B, S)
        cspecs = partition_specs(cdefs, prules.mapping)
        cache = {k: torch.zeros(d.shape, dtype=d.dtype, device=device)
                 for k, d in cdefs.items()}
        cache = {k: local_block(c, prules, *cdefs[k].axes).clone()
                 for k, c in cache.items()}
        tokens = local_block(case["batch"]["tokens"], prules, "batch",
                             "act_seq")
        with use_rules(prules):
            logits, new_cache = model.prefill({"tokens": tokens}, cache)
        logits = _gather_placed(logits, mesh, prules.placements(
            mesh, "batch", "act_seq", "act_vocab"))
        new_cache = {k: _gather_placed(c, mesh, placements_of(mesh,
                                                              cspecs[k]))
                     for k, c in new_cache.items()}
        out[key] = {"hist": hist, "params": params, "moments": moments,
                    "local_shapes": local_shapes, "logits": logits,
                    "cache": new_cache,
                    "cache_local": {k: tuple(c.shape)
                                    for k, c in cache.items()}}
    return out


def _moments_whole(model, state, mesh):
    """Every leaf's moments gathered whole, by its path: a float32
    moment by its parameter's placements, an int8 one (codes, scales) by
    its payload's spec (``optimizer.moment_layouts``)."""
    from torch.distributed.tensor import DTensor, Shard
    from repro_torch.distributed.sharding import unblock
    from repro_torch.train.optimizer import (Quantized, moment_layouts,
                                             param_leaves)
    placed = dict(model.named_parameters())
    layouts = moment_layouts(model)
    out = {}
    for leaf in param_leaves(model):
        lay = layouts.get(leaf.path)
        m, v = state.m[leaf.path], state.v[leaf.path]
        if isinstance(m, Quantized):
            out[leaf.path] = tuple(Quantized(*(
                unblock(t.contiguous(), mesh, lay.qspec) if lay else t
                for t in st)) for st in (m, v))
            continue
        p = placed[leaf.names[0]]
        pl = p.placements if isinstance(p, DTensor) else ()
        if leaf.stacked and pl:
            pl = tuple(Shard(x.dim + 1) if isinstance(x, Shard) else x
                       for x in pl)
        out[leaf.path] = tuple(_gather_placed(st, mesh, pl) if pl else
                               st.detach().clone() for st in (m, v))
    return out


def case_layout(rank, world, inputs, device):
    """The reference's sharded layout, train, prefill and decode: for
    each case of ``inputs`` (a config, a ``("data", "model")`` mesh
    shape, the reference's initial parameters, a global batch):
    ``steps`` steps of ``build_train_step`` under the train rules on the
    placed model (if any), then on a fresh placement of the initial
    parameters a prefill of ``prompt`` under the prefill rules, its
    cache carried to the decode layout (``sharding.relayout``), and
    ``decode`` steps of ``Model.decode_step`` under the decode rules
    (of the shape ``decode_name``, default ``"decode"``) at ``s_max``
    positions.  Returns the history, parameters and moments (gathered
    whole), the prefill's and each decode step's logits, the final
    cache, and per decode step whether this rank wrote the key and
    whether its block of positions was wholly masked (of the dense
    cache ``k``, or of the hybrid's ring ``ak``; for the ssm family,
    which has neither, both lists hold None).  The dense decode and moe
    cases (``layout_decode_moe``) and the ssm and hybrid ones
    (``layout_ssm_hybrid``) run this one program."""
    import torch
    from torch.distributed.device_mesh import init_device_mesh
    from torch.distributed.tensor import DTensor
    from repro_torch.configs.base import ShapeConfig
    from repro_torch.distributed.sharding import (distribute_model,
                                                  local_block, make_rules,
                                                  placements_of, relayout,
                                                  seq_split, use_rules)
    from repro_torch.models.layers import _decode_mask
    from repro_torch.models.params import partition_specs
    from repro_torch.models.transformer import cache_defs
    from repro_torch.train.optimizer import AdamW, moment_layouts
    from repro_torch.train.step import build_train_step

    out = {}
    for name, case in inputs["cases"].items():
        dp, tp = case["mesh"]
        mesh = init_device_mesh(device, (dp, tp),
                                mesh_dim_names=("data", "model"))
        cfg = case["cfg"]
        res = {}
        if case["steps"]:
            par = case["train_parallel"]
            B, S = case["batch"]["tokens"].shape
            rules = make_rules(cfg, ShapeConfig("train_4k", S, B, "train"),
                               par, tp_size=tp, dp_size=dp, mesh=mesh)
            model = distribute_model(_model(None, case["state"], cfg=cfg,
                                            device=device), rules)
            opt = AdamW(**case["opt"], state_dtype=par.opt_state_dtype)
            state = opt.init(model)
            step = build_train_step(model, par, opt)
            batch = {k: local_block(v, rules, "batch", "act_seq")
                     for k, v in case["batch"].items()}
            hist = []
            for _ in range(case["steps"]):
                with use_rules(rules):
                    model, state, m = step(model, state, batch)
                hist.append((float(m["loss"]), float(m["grad_norm"])))
            res.update(
                hist=hist,
                params={n: (p.detach().full_tensor()
                            if isinstance(p, DTensor) else p.detach().clone())
                        for n, p in model.named_parameters()},
                moments=_moments_whole(model, state, mesh),
                moment_local={path: tuple(st.q.shape) for path, st
                              in state.m.items() if hasattr(st, "q")},
                moment_modes={path: lay.mode for path, lay
                              in moment_layouts(model).items()})
        par = case["parallel"]
        prompt = case["prompt"]
        B, P = prompt.shape
        s_max = case["s_max"]
        pshape = ShapeConfig("prefill", P, B, "prefill")
        dshape = ShapeConfig(case.get("decode_name", "decode"), s_max, B,
                             "decode")
        prules = make_rules(cfg, pshape, par, tp_size=tp, dp_size=dp,
                            mesh=mesh)
        drules = make_rules(cfg, dshape, par, tp_size=tp, dp_size=dp,
                            mesh=mesh)
        cdefs = cache_defs(cfg, B, s_max)
        pspecs = partition_specs(cdefs, prules.mapping)
        dspecs = partition_specs(cdefs, drules.mapping)
        model = distribute_model(_model(None, case["state"], cfg=cfg,
                                        device=device), prules)
        cache = {k: local_block(torch.zeros(d.shape, dtype=torch.float32,
                                            device=device),
                                prules, *d.axes).clone()
                 for k, d in cdefs.items()}
        with use_rules(prules):
            logits, cache = model.prefill(
                {"tokens": local_block(prompt, prules, "batch", None)},
                cache)
        vocab = prules.placements(mesh, "batch", None, "act_vocab")
        res["prefill"] = _gather_placed(logits, mesh, vocab)
        # the re-lay: the prefill's cache spec to the decode layout's
        cache = {k: relayout(c, mesh, pspecs[k], dspecs[k])
                 for k, c in cache.items()}
        model = distribute_model(_model(None, case["state"], cfg=cfg,
                                        device=device), drules)
        seq = seq_split(drules)
        key = next((k for k in ("k", "ak") if k in cache), None)
        S_l = cache[key].shape[2] if key else 0
        start = seq.rank * S_l if seq is not None else 0
        total = S_l * (seq.size if seq is not None else 1)
        steps, wrote, masked = [], [], []
        for i, tok in enumerate(case["decode"]):
            index = P + i
            with use_rules(drules):
                logits, cache = model.decode_step(
                    cache, local_block(tok, drules, "batch", None), index)
            steps.append(_gather_placed(logits, mesh, vocab))
            if key is None:
                wrote.append(None)
                masked.append(None)
                continue
            ring = key == "ak"
            slot = index % total if ring else index
            wrote.append(start <= slot < start + S_l)
            masked.append(not bool(_decode_mask(
                S_l, start, total, index, 0, ring, device).any()))
        res.update(decode=steps, wrote=wrote, masked=masked,
                   kv_seq=drules.mapping["kv_seq"],
                   cache_local=tuple(cache[key or "h"].shape),
                   cache={k: _gather_placed(c, mesh, placements_of(
                       mesh, dspecs[k])) for k, c in cache.items()})
        out[name] = res
    return out


CASES = {"mesh": case_mesh, "dp": case_dp, "ep_sp": case_ep_sp,
         "pp_elastic": case_pp_elastic,
         "nccl_world_of_one": case_nccl_world_of_one,
         "dryrun": case_dryrun, "fsdp_tp": case_fsdp_tp,
         "layout_decode_moe": case_layout,
         "layout_ssm_hybrid": case_layout}


def _main(case: str, rank: int, world: int, d: str, device: str) -> int:
    sys.path.insert(0, str(ROOT / "src"))
    import torch
    import torch.distributed as dist
    from repro_torch.launch.mesh import init_world
    torch.set_num_threads(1)
    init_world(f"file://{d}/store", rank, world,
               device=None if device == "cuda" else device)
    try:
        inputs = torch.load(Path(d) / "inputs.pt", weights_only=False)
        out = CASES[case](rank, world, inputs, device)
        torch.save(out, Path(d) / f"out{rank}.pt")
    finally:
        dist.destroy_process_group()
    return 0


if __name__ == "__main__":
    sys.exit(_main(sys.argv[1], int(sys.argv[2]), int(sys.argv[3]),
                   sys.argv[4], sys.argv[5]))
