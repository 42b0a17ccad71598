"""The port's roofline arithmetic against the reference
(``repro_torch.roofline``).

* ``attention_flops``, ``model_flops``, every field of ``build_record``
  and of ``build_ledger(...).as_dict()``, ``fits`` and ``pods_needed``
  equal the reference's exactly, for every arch x shape of the registry,
  under the reference's own device figures (its module constants, passed
  in as a ``Profile``); where the reference raises, the port raises the
  same;
* the ring factors of ``tests/test_roofline.py:56``, the port's records
  built from the same HLO lines;
* the loop test of ``tests/test_roofline.py:17``: 5 iterations, each one
  all-reduce of 64 x 64 float32 over 4 ranks, give all-reduce count 5 and
  5 x 16384 x 1.5 wire bytes; and each collective the port issues maps to
  its kind, bytes and group (one subprocess on torch's fake process
  group, which moves no data);
* no source file of ``repro_torch/roofline`` holds a TPU v5e figure.
"""
import ast
import dataclasses
import json
import os
import subprocess
import sys
import textwrap
from pathlib import Path

import pytest

torch = pytest.importorskip("torch")

from repro.configs import registry as ref_registry  # noqa: E402
from repro.configs.base import ALL_SHAPES as REF_SHAPES  # noqa: E402
from repro.roofline import analysis as ref_analysis  # noqa: E402
from repro.roofline import hlo_collectives as ref_hlo  # noqa: E402
from repro.roofline import memory_ledger as ref_ledger  # noqa: E402

from repro_torch.configs import registry  # noqa: E402
from repro_torch.configs.base import ALL_SHAPES  # noqa: E402
from repro_torch.roofline import analysis, hlo_collectives  # noqa: E402
from repro_torch.roofline import memory_ledger  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
ARCHS = registry.list_archs()
#: the reference's device, from its own module constants
REF_PROFILE = analysis.Profile(
    name="reference", peak_bf16_flops=ref_analysis.PEAK_FLOPS,
    hbm_bytes_per_s=ref_analysis.HBM_BW,
    link_bytes_per_s=ref_analysis.ICI_BW,
    slow_bytes_per_s=ref_analysis.DCN_BW,
    hbm_bytes_per_chip=ref_ledger.HBM_PER_CHIP,
    chips_per_pod=ref_ledger.CHIPS_PER_POD)
#: per-chip costs: the reference test's, and one under half the analytic
#: FLOPs (the analytic count takes its place)
COSTS = ({"flops": 1e15, "bytes accessed": 1e12},
         {"flops": 1.0, "bytes accessed": 3e9})


def _cells(arch):
    cfg, ref_cfg = registry.get(arch), ref_registry.get(arch)
    for shape, ref_shape in zip(ALL_SHAPES, REF_SHAPES):
        assert shape.name == ref_shape.name
        yield cfg, ref_cfg, shape, ref_shape


@pytest.mark.parametrize("arch", ARCHS)
def test_flops_and_records_equal_reference(arch):
    for cfg, ref_cfg, shape, ref_shape in _cells(arch):
        assert analysis.attention_flops(cfg, shape) == \
            ref_analysis.attention_flops(ref_cfg, ref_shape)
        assert analysis.model_flops(cfg, shape) == \
            ref_analysis.model_flops(ref_cfg, ref_shape)
        for cost in COSTS:
            kw = dict(arch=arch, mesh_name="16x16", chips=256, cost=cost,
                      wire_bytes=1e11, collectives={"all-reduce": 1e11})
            got = analysis.build_record(shape=shape, cfg=cfg,
                                        profile=REF_PROFILE, **kw)
            want = ref_analysis.build_record(shape=ref_shape, cfg=ref_cfg,
                                             **kw)
            assert dataclasses.asdict(got) == dataclasses.asdict(want), \
                (arch, shape.name, cost)
            assert 0 < got.roofline_fraction <= 1.0


@pytest.mark.parametrize("arch", ARCHS)
def test_ledgers_equal_reference(arch):
    for cfg, ref_cfg, shape, ref_shape in _cells(arch):
        par = registry.default_parallelism(cfg, shape)
        ref_par = ref_registry.default_parallelism(ref_cfg, ref_shape)
        try:
            want = ref_ledger.build_ledger(ref_cfg, ref_shape, ref_par)
        except AttributeError:
            # the reference sizes no state cache for an encoder's
            # prefill and decode cells; neither does the port
            with pytest.raises(AttributeError):
                memory_ledger.build_ledger(cfg, shape, par)
            continue
        got = memory_ledger.build_ledger(cfg, shape, par)
        assert got.as_dict() == want.as_dict(), (arch, shape.name)
        assert got.fits(profile=REF_PROFILE) == want.fits()
        assert got.fits(1e9) == want.fits(1e9)
        assert got.pods_needed(REF_PROFILE) == want.pods_needed()


def test_ledger_on_the_h100_profile():
    """The reference test's cases on the H100's 80 GB: kimi-k2's train
    cell (about 28 GB a chip over 256) outgrows the reference's chip but
    fits one H100, in one pod; internvl2-2b's decode fits."""
    cfg = registry.get("kimi-k2-1t-a32b")
    shape = ALL_SHAPES[0]
    led = memory_ledger.build_ledger(
        cfg, shape, registry.default_parallelism(cfg, shape))
    assert led.params > 7e9 and 20e9 < led.total < 80e9
    assert led.fits() and not led.fits(profile=REF_PROFILE)
    assert led.pods_needed() == 1
    cfg = registry.get("internvl2-2b")
    shape = ALL_SHAPES[2]
    assert memory_ledger.build_ledger(
        cfg, shape, registry.default_parallelism(cfg, shape)).fits()


def test_ring_factors():
    """The reference test's two HLO lines, and the port's records of the
    same ops: an all-reduce of f32[100] and an all-gather of f32[400],
    each over one group of 4."""
    line_ar = ("%x = f32[100]{0} all-reduce(%y), "
               "replica_groups=[1,4]<=[4]")
    line_ag = ("%x = f32[400]{0} all-gather(%y), "
               "replica_groups=[1,4]<=[4]")
    want = ref_hlo.analyze(line_ar + "\n" + line_ag)
    got = hlo_collectives.analyze([
        hlo_collectives.Record("all-reduce", 100 * 4, 4),
        hlo_collectives.Record("all-gather", 400 * 4, 4)])
    assert dict(got.per_kind_bytes) == dict(want.per_kind_bytes) == {
        "all-reduce": 600.0, "all-gather": 1200.0}
    assert dict(got.per_kind_count) == dict(want.per_kind_count)
    assert got.summary() == want.summary()


def test_wire_bytes_by_kind():
    """The reference's remaining factors at a group of 8, and a group of
    one, which sends nothing."""
    rec = hlo_collectives.Record
    assert hlo_collectives.wire_bytes(rec("reduce-scatter", 64, 8)) == 448
    assert hlo_collectives.wire_bytes(rec("all-to-all", 64, 8)) == 56
    assert hlo_collectives.wire_bytes(rec("collective-permute", 64, 8)) == 64
    assert hlo_collectives.wire_bytes(rec("all-reduce", 64, 1)) == 0


_FAKE_WORLD = """
import json
import torch
import torch.distributed as dist
import torch.distributed.nn.functional as F
from torch.distributed.device_mesh import init_device_mesh
from torch.distributed.tensor import DTensor, Shard
from torch.testing._internal.distributed.fake_pg import FakeStore
from repro_torch.roofline import hlo_collectives

dist.init_process_group("fake", store=FakeStore(), rank=0, world_size=4)
out = {}
# the reference's loop test: 5 iterations of one all-reduce of the
# 64 x 64 float32 gradient over 4 ranks
with hlo_collectives.record() as rec:
    for _ in range(5):
        dist.all_reduce(torch.zeros(64, 64))
st = rec.analyze()
out["loop"] = [dict(st.per_kind_count), st.total_wire_bytes]
pair = dist.new_group([0, 1])
mesh = init_device_mesh("cpu", (2, 2), mesh_dim_names=("data", "model"))
with hlo_collectives.record() as rec:
    dist.all_gather_into_tensor(torch.zeros(8), torch.zeros(2))
    F.all_gather(torch.zeros(3), group=pair)
    dist.reduce_scatter_tensor(torch.zeros(2), torch.zeros(8))
    dist.all_to_all_single(torch.zeros(8), torch.zeros(8))
    F.all_reduce(torch.zeros(5), group=pair)
    DTensor.from_local(torch.zeros(3, 2), mesh, (Shard(0), Shard(1)),
                       run_check=False).full_tensor()
    for req in dist.batch_isend_irecv([
            dist.P2POp(dist.isend, torch.zeros(6), 1),
            dist.P2POp(dist.irecv, torch.zeros(6), 3)]):
        req.wait()
    dist.broadcast(torch.zeros(4), 0)
out["records"] = [[r.kind, r.nbytes, r.group] for r in rec.records]
dist.destroy_process_group()
print(json.dumps(out))
"""


@pytest.fixture(scope="module")
def fake_world():
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"), OMP_NUM_THREADS="1")
    proc = subprocess.run([sys.executable, "-c", textwrap.dedent(_FAKE_WORLD)],
                          capture_output=True, text=True, env=env,
                          timeout=300)
    assert proc.returncode == 0, proc.stderr[-4000:]
    return json.loads(proc.stdout.strip().splitlines()[-1])


def test_loop_collective_bytes_exact(fake_world):
    count, wire = fake_world["loop"]
    assert count == {"all-reduce": 5}
    assert wire == 5 * 16384 * 1.5 == 122_880


def test_record_maps_each_collective(fake_world):
    assert fake_world["records"] == [
        ["all-gather", 32, 4],            # the gathered output
        ["all-gather", 24, 2],            # F.all_gather's list of outputs
        ["reduce-scatter", 8, 4],         # the shard
        ["all-to-all", 32, 4],
        ["all-reduce", 20, 2],
        # DTensor's full_tensor: over model, then over data
        ["all-gather", 48, 2],
        ["all-gather", 96, 2],
        ["collective-permute", 24, 4],    # the send; its recv is not counted
    ]                                     # broadcast: not a counted kind


#: the reference's TPU v5e figures (``repro/roofline/analysis.py:25-28``,
#: ``memory_ledger.py:17-18``)
TPU_FIGURES = {197e12, 819e9, 50e9, 25e9, 16e9, 256}


def test_port_roofline_holds_no_tpu_figure():
    files = sorted((ROOT / "src" / "repro_torch" / "roofline").glob("*.py"))
    assert len(files) == 4
    found = [(f.name, node.value) for f in files
             for node in ast.walk(ast.parse(f.read_text()))
             if isinstance(node, ast.Constant)
             and isinstance(node.value, (int, float))
             and not isinstance(node.value, bool)
             and node.value in TPU_FIGURES]
    assert not found, found
    assert analysis.H100.peak_bf16_flops == 989e12
    assert analysis.H100.hbm_bytes_per_s == 3.35e12
