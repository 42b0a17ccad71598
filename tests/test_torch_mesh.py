"""The port's mesh and sharding rules against the reference
(``repro_torch.launch.mesh``, ``repro_torch.distributed.sharding``, the
registry's ``default_parallelism``).

* ``default_parallelism`` and ``make_rules`` equal the reference's, field
  by field and key by key, for every arch x every shape x ``multi_pod``
  (in process: ``make_rules`` needs no mesh in either package);
* a world of 4 gloo ranks on the CPU (``tests/torch_world.py``): the
  debug mesh's layout, the production mesh's refusal, DTensor
  placements of the rules' specs, each rank's block of a batch,
  ``shard`` on plain tensors and DTensors, and ``distribute_model``
  with ``experts_only`` (the data-parallel step's expert-parallel
  program) holding each rank's experts only.

The card's world of one over NCCL is tested in
``tests/test_torch_cuda.py`` (``-k nccl``), which imports no jax.
"""
import dataclasses

import pytest

torch = pytest.importorskip("torch")

from repro.configs import registry as ref_registry  # noqa: E402
from repro.configs.base import ALL_SHAPES as REF_SHAPES  # noqa: E402
from repro.distributed import sharding as ref_sharding  # noqa: E402

from repro_torch.configs import registry  # noqa: E402
from repro_torch.configs.base import ALL_SHAPES  # noqa: E402
from repro_torch.distributed import sharding  # noqa: E402

import torch_world  # noqa: E402

ARCHS = registry.list_archs()


def test_arch_lists_agree():
    assert sorted(ARCHS) == sorted(ref_registry.list_archs())
    assert [s.name for s in ALL_SHAPES] == [s.name for s in REF_SHAPES]


@pytest.mark.parametrize("arch", ARCHS)
def test_default_parallelism_matches_reference(arch):
    for shape, ref_shape in zip(ALL_SHAPES, REF_SHAPES):
        got = registry.default_parallelism(registry.get(arch), shape)
        want = ref_registry.default_parallelism(ref_registry.get(arch),
                                                ref_shape)
        assert dataclasses.asdict(got) == dataclasses.asdict(want), \
            (arch, shape.name)


@pytest.mark.parametrize("arch", ARCHS)
def test_make_rules_matches_reference(arch):
    for shape, ref_shape in zip(ALL_SHAPES, REF_SHAPES):
        cfg, ref_cfg = registry.get(arch), ref_registry.get(arch)
        par = registry.default_parallelism(cfg, shape)
        ref_par = ref_registry.default_parallelism(ref_cfg, ref_shape)
        for multi_pod in (False, True):
            for sizes in (dict(), dict(tp_size=4, dp_size=2)):
                got = sharding.make_rules(cfg, shape, par,
                                          multi_pod=multi_pod, **sizes)
                want = ref_sharding.make_rules(ref_cfg, ref_shape, ref_par,
                                               multi_pod=multi_pod, **sizes)
                where = (arch, shape.name, multi_pod, sizes)
                assert got.mapping == want.mapping, where
                assert list(got.mapping) == list(want.mapping), where
                assert (got.enabled, got.mesh, got.ep_axis,
                        got.batch_axes) == (want.enabled, want.mesh,
                                            want.ep_axis,
                                            want.batch_axes), where
                for axes in (("batch", "act_seq", "act_embed"),
                             ("expert", "embed", None),
                             ("embed", "q_heads"), ("batch", "kv_seq",
                                                    "act_kv", None)):
                    assert got.spec(*axes) == tuple(want.spec(*axes)), \
                        (where, axes)


def test_rules_context_and_axis_names():
    assert not sharding.current_rules().enabled
    rules = sharding.ShardingRules(mapping={"batch": ("pod", "data")})
    x = torch.ones(2, 3)
    with sharding.use_rules(rules):
        assert sharding.current_rules() is rules
        assert sharding.shard(x, "batch", None) is x
        assert rules.spec("batch", None, "nope") == (("pod", "data"),
                                                     None, None)
    assert not sharding.current_rules().enabled
    for multi in (False, True):
        assert sharding.data_axis_names(multi) == \
            ref_sharding.data_axis_names(multi)
    assert sharding.PARAM_AXES == ref_sharding.PARAM_AXES
    assert sharding.ACT_AXES == ref_sharding.ACT_AXES


@pytest.fixture(scope="module")
def mesh_world(tmp_path_factory):
    return torch_world.spawn("mesh", tmp_path_factory.mktemp("mesh"))


def test_debug_and_production_meshes(mesh_world):
    for rank, out in enumerate(mesh_world):
        # 4 ranks: model takes 4, as the reference's make_debug_mesh
        assert out["debug"] == ((1, 4), ("data", "model"), (0, rank))
        # a debug mesh over the first 2 ranks; the others lie outside it
        assert out["debug2"] == ((1, 2), (0, rank) if rank < 2 else None)
        assert "need 256 devices" in out["prodFalse"] \
            and "have 4" in out["prodFalse"]
        assert "need 512 devices" in out["prodTrue"]


def test_placements_blocks_and_shard(mesh_world):
    from torch.distributed.tensor import Replicate, Shard
    x = torch.arange(4 * 6, dtype=torch.float32).reshape(4, 6)
    for rank, out in enumerate(mesh_world):
        data = rank // 2                       # (2, 2) mesh, row major
        assert out["placements"] == {
            "act": (Shard(0), Replicate()),
            "expert": (Replicate(), Shard(0)),
            "router": (Replicate(), Shard(1))}
        assert torch.equal(out["block"], x[2 * data:2 * data + 2])
        assert torch.equal(out["block_no_rules"], x)
        placements, local = out["shard"]
        assert placements == (Shard(0), Replicate())
        assert torch.equal(local, x[2 * data:2 * data + 2])
        assert out["shard_plain_is_same"] and out["shard_no_rules_is_same"]


def test_distribute_model_keeps_each_ranks_experts(mesh_world):
    from torch.distributed.tensor import Replicate, Shard
    cfg = registry.get_reduced("deepseek-moe-16b")
    n_local = cfg.moe.n_experts // 2
    for out in mesh_world:
        kinds = out["distributed"]
        sharded = {n for n, k in kinds.items() if isinstance(k, tuple)}
        assert sharded == {f"blocks.{l}.moe.{w}"
                           for l in range(cfg.n_layers)
                           for w in ("we_gate", "we_up", "we_out")}
        for n in sharded:
            placements, shape, whole, block = kinds[n]
            assert placements == (Replicate(), Shard(0))
            assert shape[0] == n_local and whole and block, n
        # the router and every other parameter stay whole and plain
        assert all(kinds[n] is True for n in set(kinds) - sharded)
