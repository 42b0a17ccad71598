"""Property sweeps for the port's consistent-hash ShardRouter.

Twins of ``tests/test_service_properties.py`` on
``repro_torch.service.router``: over random (shard-count, seed,
key-population) draws the ring stays balanced, growing N -> N+1 moves
keys only onto the new shard, and shrinking N+1 -> N moves only the
removed shard's keys.  Each draw also holds the port's assignment equal
to the reference's, since client and shard processes of either package
must agree on the ring.

Strategies stick to the subset the conftest hypothesis fallback shim
implements (integers/floats/lists/tuples/sampled_from).
"""
import numpy as np
import pytest
from hypothesis import given, settings
from hypothesis import strategies as st

pytest.importorskip("torch")

from repro.service.router import ShardRouter as RefRouter  # noqa: E402

from repro_torch.service.router import ShardRouter  # noqa: E402

# the balance/remap sweeps are tier-1's slow half, as in the reference:
# deselected by pytest.ini, run by the CI stress job
pytestmark = pytest.mark.slow


@settings(max_examples=30)
@given(n_shards=st.integers(2, 8), seed=st.integers(0, 10_000),
       n_keys=st.integers(2_000, 6_000))
def test_router_load_stays_balanced(n_shards, seed, n_keys):
    r = ShardRouter(n_shards, vnodes=64, seed=seed)
    keys = np.arange(n_keys, dtype=np.int64)
    loads = r.load(keys)
    assert loads.sum() == n_keys
    assert (loads > 0).all(), loads
    assert loads.max() / loads.min() < 3.0, loads
    np.testing.assert_array_equal(
        r.shard_of_many(keys),
        RefRouter(n_shards, vnodes=64, seed=seed).shard_of_many(keys))


@settings(max_examples=30)
@given(n_shards=st.integers(1, 8), seed=st.integers(0, 10_000))
def test_router_grow_remaps_minimally(n_shards, seed):
    keys = np.arange(4_000, dtype=np.int64)
    small = ShardRouter(n_shards, vnodes=64, seed=seed)
    large = ShardRouter(n_shards + 1, vnodes=64, seed=seed)
    before = small.shard_of_many(keys)
    after = large.shard_of_many(keys)
    moved = before != after
    assert (after[moved] == n_shards).all()
    frac = moved.sum() / len(keys)
    assert 0.0 < frac <= min(1.0, 2.5 / (n_shards + 1)), frac


@settings(max_examples=30)
@given(n_shards=st.integers(1, 8), seed=st.integers(0, 10_000))
def test_router_shrink_remaps_minimally(n_shards, seed):
    keys = np.arange(4_000, dtype=np.int64)
    large = ShardRouter(n_shards + 1, vnodes=64, seed=seed)
    small = ShardRouter(n_shards, vnodes=64, seed=seed)
    before = large.shard_of_many(keys)
    after = small.shard_of_many(keys)
    moved = before != after
    assert (before[moved] == n_shards).all()
    assert (after[~moved] == before[~moved]).all()
