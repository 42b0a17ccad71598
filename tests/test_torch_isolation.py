"""The port stands alone: no ``jax``, no ``jaxlib``, no ``repro``.

The test process already holds jax (the parity tests import both
packages), so the import check runs in a subprocess under a meta-path
finder that refuses those packages, imports ``repro_torch``, drives one
CPU device-executor batch, again over two sim shards of the sharded data
plane, imports the fault and workload layers and
runs a 2-job VirtualClock trace with a worker crash on the "torch" ODS
engine, imports the serving path (models, server, CLI), runs one reduced
qwen3-8b prefill and decode step, imports the simulator, the baselines,
the training step and the trainer (with the training CLI), runs one
simulation and two resilient training steps with a checkpoint restore,
differentiates a reduced mamba2-1.3b loss through K5's backward (its
plain twin), a reduced deepseek-moe-16b loss (its router included) and
a reduced vit-huge loss on a batch of the image path, joins a gloo
world of one and takes a compressed data-parallel step, a
sequence-parallel mamba2 forward and an expert-parallel moe forward
under the mesh layer's rules, runs a one-stage pipeline with its
collectives recorded, reshards the qwen3-8b model onto a one-rank mesh,
computes a roofline term and a memory ledger, traces one reduced qwen3-8b
prefill with the dry-run (``launch/dryrun.py``) on a fake world of 4
ranks, and exits 0.  A static scan of the port's sources backs it up for
modules the run does not import, the dry-run's named.
"""
import ast
import os
import subprocess
import sys
from pathlib import Path

import pytest

pytest.importorskip("torch")

ROOT = Path(__file__).resolve().parents[1]
BLOCKED = ("jax", "jaxlib", "repro")

_CHILD = '''
import importlib.abc, sys

class Refuse(importlib.abc.MetaPathFinder):
    def find_spec(self, name, path=None, target=None):
        if name.split(".")[0] in {blocked!r}:
            raise ImportError(f"{{name}} is refused in this process")
        return None

sys.meta_path.insert(0, Refuse())

import numpy as np
import repro_torch.api
from repro_torch.api import SenecaServer
from repro_torch.data.pipeline import DSIPipeline
from repro_torch.data.storage import RemoteStorage
from repro_torch.data.synthetic import tiny

ds = tiny(n=16)
server = SenecaServer.for_dataset(
    ds, use_ods=False, split=(0.5, 0.0, 0.5),
    device_cache_bytes=16 * ds.augmented_bytes(),
    hbm_split=(0.0, 0.0, 1.0), device="cpu")
pipe = DSIPipeline(server.open_session(batch_size=8), RemoteStorage(ds),
                   executor="device", sync_refills=True)
batch = pipe.next_batch()
assert tuple(batch["images"].shape) == (8, *ds.crop_hw, 3)
assert np.isfinite(batch["images"].numpy()).all()
pipe.stop()
server.close()

import repro_torch.service
server = SenecaServer.for_dataset(
    ds, use_ods=False, split=(0.5, 0.0, 0.5), shards=2,
    device_cache_bytes=16 * ds.augmented_bytes(),
    hbm_split=(0.0, 0.0, 1.0), device="cpu")
pipe = DSIPipeline(server.open_session(batch_size=8), RemoteStorage(ds),
                   executor="device", sync_refills=True)
batch = pipe.next_batch()
assert tuple(batch["images"].shape) == (8, *ds.crop_hw, 3)
assert np.isfinite(batch["images"].numpy()).all()
assert [s["shard"] for s in server.stats()["shards"]] == [0, 1]
pipe.stop()
server.close()

import repro_torch.faults
import repro_torch.workload
from repro_torch.api import FaultSpec, JobSpec, VirtualClock

ds = tiny(n=32)
server = SenecaServer.for_dataset(ds, backend="torch", cache_frac=0.4,
                                  device="cpu")
res = server.run_workload(
    [JobSpec("a", epochs=1, batch_size=8, gpu_rate=1000),
     JobSpec("b", arrival_s=0.01, epochs=1, batch_size=8, gpu_rate=500)],
    RemoteStorage(ds), clock=VirtualClock(),
    faults=[FaultSpec("worker-crash", at_s=0.005, job="a")])
assert res.ok and res.stats["backend"] == "torch"
assert all(sorted(j.sample_ids) == list(range(32)) for j in res.jobs)
assert res.stats["faults"]["counts"]["fault.worker-crash"] == 1
server.close()

import torch
import repro_torch.launch.serve
import repro_torch.models
import repro_torch.serve
from repro_torch.configs import registry
from repro_torch.models.model import build

model = build(registry.get_reduced("qwen3-8b")).init(seed=0, device="cpu")
tokens = torch.randint(0, 512, (2, 8), generator=torch.Generator().manual_seed(0))
logits, cache = model.prefill({{"tokens": tokens}}, model.init_cache(2, 12))
step, _ = model.decode_step(cache, tokens[:, :1], 8)
assert logits.shape[:2] == (2, 8) and step.shape[:2] == (2, 1)
assert torch.isfinite(step.float()).all()

import tempfile
import repro_torch.baselines
import repro_torch.distributed
import repro_torch.launch.train
import repro_torch.sim
import repro_torch.train
from repro_torch.api import AZURE_NC96, GB, SENECA, DSISimulator, SimJob
from repro_torch.core.perf_model import DatasetProfile
from repro_torch.distributed.ft import FTConfig, ResilientTrainer
from repro_torch.train.optimizer import AdamW
from repro_torch.train.step import build_train_step
from repro_torch.configs.base import ParallelismConfig

sim = DSISimulator(AZURE_NC96, DatasetProfile("tiny", 2_000, 1e5), SENECA,
                   cache_bytes=0.1 * GB, seed=0)
assert sim.run([SimJob(0, gpu_rate=1000, batch_size=128)]).throughput > 0
model.requires_grad_(True)
opt = AdamW(lr=1e-3, state_dtype="int8")
step = build_train_step(model, ParallelismConfig(remat="block"), opt)
batch = {{"tokens": tokens, "labels": tokens}}
with tempfile.TemporaryDirectory() as d:
    trainer = ResilientTrainer(step, model, opt.init(model),
                               FTConfig(ckpt_dir=d, ckpt_every=1),
                               batch_source=lambda: batch)
    hist = trainer.run(2)
    trainer._restart()
    assert trainer.step == 2 and len(hist) == 2
assert all(np.isfinite(h["loss"]) for h in hist)

ssm = build(registry.get_reduced("mamba2-1.3b")).init(seed=0, device="cpu")
ssm.requires_grad_(True)
loss = ssm.loss({{"tokens": tokens, "labels": tokens}}, remat="block")
grads = torch.autograd.grad(loss, list(ssm.parameters()))
assert all(bool(torch.isfinite(g.float()).all()) for g in grads)

import repro_torch.models.moe
moe = build(registry.get_reduced("deepseek-moe-16b")).init(seed=0,
                                                           device="cpu")
moe.requires_grad_(True)
loss = moe.loss({{"tokens": tokens, "labels": tokens}}, remat="block")
names, params = zip(*moe.named_parameters())
grads = dict(zip(names, torch.autograd.grad(loss, params)))
assert all(bool(torch.isfinite(g.float()).all()) for g in grads.values())
assert float(grads["blocks.0.moe.router"].float().abs().max()) > 0

from repro_torch.launch.train import image_batch_source
vit = build(registry.get_reduced("vit-huge")).init(seed=0, device="cpu")
vit.requires_grad_(True)
source, pipe, server = image_batch_source(vit, 4)
loss = vit.loss(source(), remat="block")
pipe.stop()
server.close()
grads = torch.autograd.grad(loss, list(vit.parameters()))
assert all(bool(torch.isfinite(g.float()).all()) for g in grads)

import torch.distributed as dist
from repro_torch.configs.base import PREFILL_32K
from repro_torch.configs.registry import default_parallelism
from repro_torch.distributed.sharding import (distribute_model, make_rules,
                                              use_rules)
from repro_torch.launch.mesh import init_world, make_debug_mesh
from repro_torch.train.compression import init_ef
from repro_torch.train.dp_shard import build_dp_train_step
with tempfile.TemporaryDirectory() as d:
    init_world(f"file://{{d}}/store", 0, 1, device="cpu")
    mesh = make_debug_mesh(device="cpu")
    step = build_dp_train_step(model, opt, mesh, compress_grads=True)
    _, _, _, metrics = step(model, opt.init(model), init_ef(model), batch)
    assert np.isfinite(float(metrics["loss"]))
    for m in (ssm, moe):
        rules = make_rules(m.cfg, PREFILL_32K,
                           default_parallelism(m.cfg, PREFILL_32K),
                           tp_size=1, dp_size=1, mesh=mesh)
        distribute_model(m, rules)
        with use_rules(rules):
            logits, _ = m.forward({{"tokens": tokens}})
        assert bool(torch.isfinite(logits.float()).all())
    from torch.distributed.device_mesh import init_device_mesh
    from repro_torch.distributed.elastic import make_mesh, reshard
    from repro_torch.distributed.pp import pipeline_forward
    from repro_torch.models.params import partition_specs
    from repro_torch.models.transformer import param_defs
    from repro_torch.roofline import analysis, hlo_collectives, memory_ledger
    pipe = init_device_mesh("cpu", (1,), mesh_dim_names=("pipe",))
    with hlo_collectives.record() as rec:
        y = pipeline_forward(lambda w, h: torch.tanh(h @ w),
                             torch.ones(2, 3, 3), torch.ones(4, 3), pipe,
                             microbatches=2)
    assert y.shape == (4, 3) and rec.analyze().per_kind_count["all-reduce"] == 1
    rules = make_rules(model.cfg, PREFILL_32K,
                       default_parallelism(model.cfg, PREFILL_32K))
    _, plan = reshard(model, partition_specs(param_defs(model.cfg), rules),
                      make_mesh(1, device="cpu"))
    assert plan.demotions == []
    assert analysis.model_flops(model.cfg, PREFILL_32K) > 0
    assert memory_ledger.build_ledger(
        model.cfg, PREFILL_32K, default_parallelism(model.cfg, PREFILL_32K)
    ).fits()
    dist.destroy_process_group()

from torch.distributed.device_mesh import init_device_mesh
from torch.testing._internal.distributed.fake_pg import FakeStore
from repro_torch.configs.base import ShapeConfig
from repro_torch.launch import dryrun
dist.init_process_group("fake", store=FakeStore(), rank=0, world_size=4)
fake_mesh = init_device_mesh("cpu", (2, 2), mesh_dim_names=("data", "model"))
registry.get = registry.get_reduced
rec = dryrun.lower_cell("qwen3-8b", ShapeConfig("prefill_32k", 32, 4,
                                                "prefill"),
                        multi_pod=False, mesh=fake_mesh)
assert rec["trace"]["kernel_calls"] == {{
    "flash_attention": registry.get("qwen3-8b").n_layers}}, rec["trace"]
dist.destroy_process_group()
held = sorted(m for m in sys.modules if m.split(".")[0] in {blocked!r})
assert not held, held
print("ok")
'''


def test_port_runs_with_jax_and_reference_refused():
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    proc = subprocess.run(
        [sys.executable, "-c", _CHILD.format(blocked=BLOCKED)],
        cwd=str(ROOT), env=env, capture_output=True, text=True,
        timeout=300)
    assert proc.returncode == 0, proc.stderr[-4000:]
    assert proc.stdout.strip().endswith("ok")


def _imports(path: Path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module or ""


@pytest.mark.parametrize("where", ["src/repro_torch", "chip_smoke.py",
                                   "src/repro_torch/launch/dryrun.py"])
def test_sources_import_nothing_of_jax_or_reference(where):
    target = ROOT / where
    files = sorted(target.rglob("*.py")) if target.is_dir() else [target]
    assert files
    bad = [(str(f.relative_to(ROOT)), mod) for f in files
           for mod in _imports(f) if mod.split(".")[0] in BLOCKED]
    assert not bad, bad
