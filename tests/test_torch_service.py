"""The port's sharded data plane (``repro_torch.service``), sim transport.

Twins of the sim-transport tests of ``tests/test_service.py`` with
``device="cpu"`` — the router, the shard protocol, ``ShardedCache``'s
``TieredCache`` surface, the server's sharded branch and the determinism
gate — plus parity with the reference on the same inputs:

* ``splitmix64``, ``_splitmix64_np``, ``shard_of_many`` and ``group``
  equal the reference's bit for bit on 10**5 keys (client and shard
  processes must agree on the ring);
* a shard's produce path gives the reference ``CacheShard``'s bytes;
* ``ShardedCache`` answers as the reference's after the same
  insert/evict sequence;
* the 2-job VirtualClock trace on ``shards=2`` serves the reference's
  per-job sample ids.

Tolerance: exact everywhere.  Device values: a tensor admitted over the
sim transport is stored without a copy and comes back as itself, and
the device executor runs an all-HBM epoch over four shards with no h2d
bytes.  The process transport's twins are in
``tests/test_torch_service_process.py``.
"""
import os
import tempfile

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import repro.api as ref_api  # noqa: E402
from repro.data.storage import RemoteStorage as RefStorage  # noqa: E402
from repro.data.synthetic import tiny as ref_tiny  # noqa: E402
from repro.service import CacheShard as RefShard  # noqa: E402
from repro.service import ShardConfig as RefShardConfig  # noqa: E402
from repro.service import router as ref_router  # noqa: E402
from repro.workload.runner import \
    deterministic_runner as ref_deterministic_runner  # noqa: E402

from repro_torch.api import (JobSpec, SenecaServer, ShardedCache,  # noqa: E402
                             ShardRouter)
from repro_torch.cache.store import FORMS, TieredCache  # noqa: E402
from repro_torch.data.augment import augment_np  # noqa: E402
from repro_torch.data.pipeline import DSIPipeline, _aug_seed  # noqa: E402
from repro_torch.data.storage import RemoteStorage  # noqa: E402
from repro_torch.data.synthetic import tiny  # noqa: E402
from repro_torch.service import (CacheShard, Request, Response,  # noqa: E402
                                 ShardConfig)
from repro_torch.service.router import (_splitmix64_np,  # noqa: E402
                                        splitmix64)
from repro_torch.service.shard import produce_seed  # noqa: E402
from repro_torch.workload.runner import deterministic_runner  # noqa: E402

SPLIT = (0.2, 0.4, 0.4)


# ----------------------------------------------------------------------
# router
def test_router_scalar_vector_agree():
    r = ShardRouter(5, vnodes=32, seed=3)
    keys = np.arange(512, dtype=np.int64)
    vec = r.shard_of_many(keys)
    assert [r.shard_of(int(k)) for k in keys] == list(vec)
    assert splitmix64(12345) == int(_splitmix64_np(
        np.asarray([12345], np.uint64))[0])


def test_router_group_partitions_exactly():
    r = ShardRouter(4, seed=1)
    keys = list(range(300))
    groups = r.group(keys)
    seen = sorted(int(keys[i]) for idx in groups.values() for i in idx)
    assert seen == keys
    for sid, idx in groups.items():
        assert all(r.shard_of(int(keys[int(i)])) == sid for i in idx)


def test_router_balance_and_range():
    r = ShardRouter(4, vnodes=64, seed=0)
    loads = r.load(np.arange(4000, dtype=np.int64))
    assert loads.sum() == 4000 and (loads > 0).all()
    assert loads.max() / loads.min() < 3.0


def test_router_single_shard_fast_path():
    r = ShardRouter(1, seed=9)
    assert r.shard_of(123) == 0
    assert (r.shard_of_many(np.arange(50)) == 0).all()


def test_router_grow_moves_keys_only_to_new_shard():
    keys = np.arange(3000, dtype=np.int64)
    before = ShardRouter(4, seed=7).shard_of_many(keys)
    after = ShardRouter(5, seed=7).shard_of_many(keys)
    moved = before != after
    assert 0 < moved.sum() < len(keys)
    assert (after[moved] == 4).all()


@pytest.mark.parametrize("n_shards,vnodes,seed",
                         [(1, 64, 0), (2, 64, 0), (4, 32, 3), (7, 16, 11),
                          (8, 64, 2**31 + 5)])
def test_router_equals_reference_bit_for_bit(n_shards, vnodes, seed):
    """Hashes, ring points, owners and groups of 10**5 keys (contiguous
    ids and random 63-bit keys) equal the reference's exactly."""
    rng = np.random.default_rng(seed % 2**32)
    keys = np.concatenate([np.arange(50_000, dtype=np.int64),
                           rng.integers(0, 2**63 - 1, 50_000,
                                        dtype=np.int64)])
    u = keys.astype(np.uint64)
    np.testing.assert_array_equal(_splitmix64_np(u),
                                  ref_router._splitmix64_np(u))
    assert [splitmix64(int(k)) for k in keys[::97]] == \
        [ref_router.splitmix64(int(k)) for k in keys[::97]]
    ours = ShardRouter(n_shards, vnodes=vnodes, seed=seed)
    ref = ref_router.ShardRouter(n_shards, vnodes=vnodes, seed=seed)
    np.testing.assert_array_equal(ours._points, ref._points)
    np.testing.assert_array_equal(ours._owners, ref._owners)
    np.testing.assert_array_equal(ours.shard_of_many(keys),
                                  ref.shard_of_many(keys))
    assert [ours.shard_of(int(k)) for k in keys[::997]] == \
        [ref.shard_of(int(k)) for k in keys[::997]]
    got, want = ours.group(keys), ref.group(keys)
    assert sorted(got) == sorted(want)
    for s in want:
        np.testing.assert_array_equal(got[s], want[s])
    np.testing.assert_array_equal(ours.load(keys), ref.load(keys))


# ----------------------------------------------------------------------
# shard protocol
def _shard(**kw) -> CacheShard:
    cfg = ShardConfig(shard_id=0, n_shards=1, cache_bytes=200_000,
                      split=SPLIT, device="cpu", **kw)
    return CacheShard(cfg)


def test_shard_handles_unknown_op_and_bad_args():
    shard = _shard()
    resp = shard.handle(Request("warp"))
    assert not resp.ok and "warp" in resp.error
    resp = shard.handle(Request("lookup", ()))   # missing args -> error
    assert not resp.ok and isinstance(resp, Response)
    shard.close()
    shard.close()


def test_shard_roundtrip_and_stats():
    shard = _shard()
    arr = np.arange(12, dtype=np.float32)
    ok = shard.handle(Request("insert",
                              (5, "decoded", arr, arr.nbytes, False)))
    assert ok.ok and ok.value
    form, value, tier = shard.handle(Request("lookup", (5,))).value
    assert form == "decoded" and tier == "dram"
    assert np.array_equal(value, arr)
    stats = shard.handle(Request("stats", ())).value
    assert stats["shard"] == 0 and stats["entries"] == 1
    assert stats["bytes_used"] == arr.nbytes
    assert stats["hbm_device"] is None           # no HBM tier
    shard.close()


def test_shard_hbm_tier_on_its_device_and_freed_on_close():
    shard = _shard(hbm_bytes=100_000, hbm_split=(0.0, 0.5, 0.5))
    row = torch.arange(24, dtype=torch.float32)
    assert shard.handle(Request("insert", (3, "augmented", row,
                                           row.numel() * 4, False))).value
    form, value, tier = shard.handle(Request("lookup", (3,))).value
    assert (form, tier) == ("augmented", "hbm") and value is row
    stats = shard.handle(Request("stats", ())).value
    assert stats["hbm_device"] == "cpu" and stats["hbm_bytes_used"] == 96
    shard.handle(Request("close", ()))
    assert shard.cache.hbm_bytes_used() == 0


@pytest.mark.parametrize("hbm", [False, True])
def test_shard_produce_equals_reference_bytes(hbm):
    """The shard-side produce path (fetch, host decode, ``augment_np``
    seeded by ``produce_seed``) gives the reference shard's bytes, for a
    cold sample and again from its cached decoded form (a tensor in the
    HBM tier when ``hbm``)."""
    n = 24
    kw = dict(shard_id=0, n_shards=1, cache_bytes=400_000,
              split=(0.2, 0.8, 0.0), seed=0)
    if hbm:
        kw.update(hbm_bytes=200_000, hbm_split=(0.0, 1.0, 0.0))
    ours = CacheShard(ShardConfig(dataset=tiny(n=n), device="cpu", **kw))
    ref = RefShard(RefShardConfig(dataset=ref_tiny(n=n), **kw))
    ds = tiny(n=n)
    for tag in (0, 5):              # tag 5 hits the cached decoded form
        for sid in (0, 7, 23):
            got = ours._produce(sid, tag)
            want = ref._produce(sid, tag)
            assert isinstance(got, np.ndarray)
            np.testing.assert_array_equal(got, np.asarray(want))
            host = augment_np(ds.decode(ds.encoded(sid), sid), ds.crop_hw,
                              np.random.default_rng(produce_seed(tag, sid)))
            np.testing.assert_array_equal(got, host)
    tier = ours.cache.lookup_tiered(7)[2]
    assert tier == ("hbm" if hbm else "dram")
    assert produce_seed(3, 11) == _aug_seed(3, 11)
    ours.close()
    ref.close()


# ----------------------------------------------------------------------
# ShardedCache over the sim transport
def test_sharded_cache_surface_matches_local():
    c = ShardedCache(400_000, SPLIT, shards=3, seed=0, device="cpu")
    arr = np.arange(24, dtype=np.float32)
    for k in range(12):
        assert c.insert(k, "decoded", arr, arr.nbytes)
    assert c.form_of(3) == "decoded" and c.form_of(99) is None
    assert c.contains("decoded", 3) and not c.contains("encoded", 3)
    assert c.contains_many("decoded", range(12)) == [True] * 12
    assert c.serving_forms([3, 99]) == ["decoded", None]
    form, value, tier = c.lookup_tiered(3)
    assert form == "decoded" and tier == "dram"
    assert np.array_equal(value, arr)
    assert c.total_capacity("decoded") > 0
    assert sum(c.total_capacity(f) for f in FORMS) <= 400_000
    assert c.bytes_used() == 12 * arr.nbytes
    status = c.status_array(16)
    assert (status[:12] > 0).all() and (status[12:] == 0).all()
    assert c.evict(3, "decoded") and c.form_of(3) is None
    assert c.hit_rate() > 0
    v0 = c.version
    c.resize((0.1, 0.45, 0.45))
    assert c.split == (0.1, 0.45, 0.45)
    assert c.version >= v0
    c.close()
    c.close()       # idempotent


def _surface_trace(cache_cls, root, **kw):
    """One insert/evict/lookup/resize sequence; every answer recorded."""
    pol = {"encoded": "lru", "decoded": "lru", "augmented": "lru"}
    c = cache_cls(60_000, SPLIT, evict_policies=pol, spill_bytes=20_000,
                  spill_dir=root, spill_split=SPLIT,
                  hbm_bytes=30_000, hbm_split=(0.0, 0.5, 0.5),
                  shards=3, seed=4, **kw)
    out = []
    rng = np.random.default_rng(0)
    for k in range(90):
        form = FORMS[k % 3]
        nb = int(rng.integers(200, 1_500))
        value = (bytes(nb) if form == "encoded"
                 else np.full(nb, k % 251, np.uint8))
        out.append(("insert", k, c.insert(k, form, value, nb)))
        if k % 7 == 0:
            out.append(("evict", k, c.evict(k - 3, FORMS[(k - 3) % 3])))
    out.append(("batch", c.insert_batch_gated(
        "decoded", [(k, np.zeros(300, np.uint8), 300)
                    for k in range(100, 120)])))
    for k in range(0, 120, 5):
        form, value, tier = c.lookup_tiered(k)
        out.append(("lookup", k, form, tier,
                    None if value is None else bytes(np.asarray(value))))
    out.append(("serving", c.serving_forms(range(120))))
    out.append(("contains", [c.contains_many(f, range(120))
                             for f in FORMS]))
    out.append(("status", c.status_array(130).tolist()))
    out.append(("residency", c.residency_array(130).tolist()))
    out.append(("caps", [c.total_capacity(f) for f in FORMS]))
    out.append(("free", [c.chain_free_bytes(f) for f in FORMS]))
    out.append(("bytes", c.bytes_used(), c.disk_bytes_used(),
                c.hbm_bytes_used()))
    out.append(("evicted", sorted(c.take_evicted())))
    out.append(("resize", {f: sorted(v) for f, v in
                           c.resize((0.1, 0.3, 0.6)).items()}))
    out.append(("hit_rate", c.hit_rate()))
    out.append(("spill", c.spill_stats(), "hbm", c.hbm_stats()))
    out.append(("version", c.version))
    c.close()
    return out


def test_sharded_cache_answers_as_reference(tmp_path):
    from repro.service import ShardedCache as RefShardedCache
    (tmp_path / "ref").mkdir()
    (tmp_path / "port").mkdir()
    want = _surface_trace(RefShardedCache, str(tmp_path / "ref"))
    got = _surface_trace(ShardedCache, str(tmp_path / "port"),
                         device="cpu")
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert g == w, (g[:2], w[:2])


def test_sharded_cache_piggybacks_evictions():
    root = tempfile.mkdtemp(prefix="seneca-piggyback-")
    pol = {"encoded": "lru", "decoded": "lru", "augmented": "lru"}
    c = ShardedCache(3_000, SPLIT, evict_policies=pol,
                     spill_bytes=2_000, spill_dir=root, spill_split=SPLIT,
                     shards=2, seed=0, device="cpu")
    for k in range(64):
        c.insert(k, "decoded", np.full(64, k, np.uint8), 64)
    assert c.has_pending_evicted()
    dropped = set(c.take_evicted())
    assert dropped and not c.has_pending_evicted()
    assert not any(c.contains_many("decoded", sorted(dropped)))
    c.close()
    os.rmdir(root)


def test_sharded_cache_spill_subdirs_cleaned():
    root = tempfile.mkdtemp(prefix="seneca-shard-spill-")
    pol = {"encoded": "lru", "decoded": "lru", "augmented": "lru"}
    c = ShardedCache(4_000, SPLIT, evict_policies=pol,
                     spill_bytes=200_000, spill_dir=root,
                     spill_split=SPLIT, shards=2, seed=0, device="cpu")
    assert c.has_spill
    for k in range(64):
        c.insert(k, "decoded", np.full(64, k, np.uint8), 64)
    assert c.disk_bytes_used() > 0
    spill = c.spill_stats()
    assert spill and sum(d.get("disk_entries", 0)
                         for d in spill.values()) > 0
    c.close()
    assert os.listdir(root) == []
    os.rmdir(root)


def test_sharded_cache_needs_split_or_profiles():
    with pytest.raises(ValueError, match="split or profiles"):
        ShardedCache(1_000, None, shards=2, device="cpu")
    with pytest.raises(ValueError, match="shards"):
        ShardedCache(1_000, SPLIT, shards=0, device="cpu")


def test_sharded_produce_and_ingest_sim():
    ds = tiny(n=48)
    c = ShardedCache(2 * 48 * ds.augmented_bytes(), SPLIT, shards=2,
                     seed=0, dataset=ds, device="cpu")
    out = np.asarray(c.produce(7, epoch_tag=2))
    img = ds.decode(ds.encoded(7), 7)
    ref = augment_np(img, ds.crop_hw,
                     np.random.default_rng(produce_seed(2, 7)))
    assert np.array_equal(out, ref)
    assert c.ingest(range(48), epoch_tag=2) == 48
    ss = c.shard_stats()
    assert sum(s["produced"] for s in ss) == 49
    assert all(s["produced"] > 0 for s in ss)
    c.close()


def test_sim_hbm_hit_returns_the_admitted_tensor():
    """Over the sim transport a device row reaches its shard's HBM tier
    without a copy, and a lookup gives back that very tensor."""
    c = ShardedCache(200_000, SPLIT, hbm_bytes=200_000,
                     hbm_split=(0.0, 0.0, 1.0), shards=2, seed=0,
                     device="cpu")
    rows = {k: torch.full((8, 8, 3), float(k)) for k in range(10)}
    assert all(c.insert_batch_gated(
        "augmented", [(k, r, r.numel() * 4) for k, r in rows.items()]))
    for k, r in rows.items():
        form, value, tier = c.lookup_tiered(k)
        assert (form, tier) == ("augmented", "hbm") and value is r
    assert c.hbm_bytes_used() == 10 * 8 * 8 * 3 * 4
    assert {s["hbm_device"] for s in c.shard_stats()} == {"cpu"}
    c.close()
    assert c.hbm_bytes_used() == 0        # freed on close


# ----------------------------------------------------------------------
# server integration
def test_server_sharded_session_and_stats():
    ds = tiny(n=64)
    server = SenecaServer.for_dataset(ds, cache_frac=0.5, seed=0,
                                      shards=2, device="cpu")
    with server.open_session(batch_size=16) as sess:
        pipe = DSIPipeline(sess, RemoteStorage(ds), n_workers=2)
        for _ in range(6):
            batch = pipe.next_batch()
            assert batch["images"].shape[0] == 16
        stats = sess.stats()
        pipe.stop()
    assert len(stats["shards"]) == 2
    assert {s["shard"] for s in stats["shards"]} == {0, 1}
    assert sum(s["entries"] for s in stats["shards"]) > 0
    server.close()
    server.close()


def test_unsharded_server_refuses_shard_faults():
    server = SenecaServer.for_dataset(tiny(n=16), device="cpu")
    with pytest.raises(ValueError, match="sharded data plane"):
        server.service.fail_shard(0)
    with pytest.raises(ValueError, match="sharded data plane"):
        server.service.restore_shard(0)
    assert "shards" not in server.stats()
    server.close()


def test_device_executor_over_four_sim_shards():
    """The device executor over four sim shards with an HBM tier on the
    service's device: a cold epoch through the fused decode+augment,
    then an all-HBM epoch whose rows are the shards' tensors, with no
    h2d bytes; every shard holds rows and their sum is every row."""
    n, bs = 64, 8
    ds = tiny(n=n)
    load = ShardRouter(4, 64, 0).load(np.arange(n))
    server = SenecaServer.for_dataset(
        ds, use_ods=False, admission="capacity", eviction="lru",
        device_cache_bytes=int(1.2 * n * ds.augmented_bytes()
                               * load.max() / load.mean()),
        hbm_split=(0.0, 0.0, 1.0), shards=4, seed=0, device="cpu")
    sess = server.open_session(batch_size=bs)
    pipe = DSIPipeline(sess, RemoteStorage(ds), executor="device",
                       sync_refills=True)
    tel = server.service.telemetry
    for epoch in range(2):
        h2d = tel.channel_total_bytes("h2d")
        seen = []
        for _ in range(n // bs):
            tag = sess.epoch
            b = pipe.next_batch()
            ids = b["ids"].tolist()
            for row, s in zip(b["images"].numpy(), ids):
                img = ds.decode(ds.encoded(s), s)
                # this epoch's crop, or the background refill's (an HBM
                # hit keeps the crop it was cached with)
                assert any(np.array_equal(row, augment_np(
                    img, ds.crop_hw, np.random.default_rng(seed)))
                    for seed in (_aug_seed(tag, s), _aug_seed(0, s),
                                 s ^ 0x5EED)), s
            seen.extend(ids)
        assert sorted(seen) == list(range(n))
    assert tel.channel_total_bytes("h2d") == h2d     # epoch 2: all HBM
    shards = server.stats()["shards"]
    assert [s["shard"] for s in shards] == [0, 1, 2, 3]
    assert all(s["hbm_bytes_used"] > 0 for s in shards)
    assert sum(s["hbm_bytes_used"] for s in shards) == \
        n * ds.augmented_bytes()
    assert all(s["hbm_device"] == "cpu" for s in shards)
    pipe.stop()
    server.close()


def _sharded_workload_ids(server_cls, runner_fn, storage_cls, ds, shards,
                          job_cls, seed=0, **kw):
    server = server_cls.for_dataset(
        ds, cache_bytes=2 * ds.n_samples * ds.augmented_bytes(),
        split=SPLIT, seed=seed, shards=shards, **kw)
    runner = runner_fn(server, storage_cls(ds), seed=seed)
    res = runner.run([
        job_cls("a", arrival_s=0.0, epochs=1, batch_size=16,
                gpu_rate=1000),
        job_cls("b", arrival_s=0.05, epochs=1, batch_size=8,
                gpu_rate=500),
    ], timeout=120)
    ids = {j.spec.name: list(j.sample_ids) for j in res.jobs}
    ends = {j.spec.name: j.end_s for j in res.jobs}
    server.close()
    return ids, ends, res.makespan


def _port_ids(shards):
    return _sharded_workload_ids(SenecaServer, deterministic_runner,
                                 RemoteStorage, tiny(n=64), shards, JobSpec,
                                 device="cpu")


def test_sharded_sim_runs_are_deterministic():
    """The tier-1 acceptance gate: shards=1 and shards=2 (sim) give
    identical per-job sample-id sequences, and shards=2 reruns
    identically."""
    one, _, _ = _port_ids(1)
    two, _, _ = _port_ids(2)
    two_again, _, _ = _port_ids(2)
    assert two == two_again
    assert one == two
    assert all(len(v) == 64 for v in one.values())


def test_sharded_sim_trace_equals_reference():
    """The same 2-job VirtualClock trace on shards=2 (sim) through the
    reference (numpy ODS) and the port: equal per-job ids, ends and
    makespan."""
    want = _sharded_workload_ids(ref_api.SenecaServer,
                                 ref_deterministic_runner, RefStorage,
                                 ref_tiny(n=64), 2, ref_api.JobSpec)
    got = _port_ids(2)
    assert got == want


# ----------------------------------------------------------------------
# close() idempotence on the classic engine
def test_tiered_cache_close_idempotent_with_spill():
    root = tempfile.mkdtemp(prefix="seneca-close-")
    cache = TieredCache(4_000, SPLIT, spill_bytes=50_000, spill_dir=root,
                        spill_split=SPLIT, device="cpu")
    cache.insert(1, "decoded", np.zeros(900, np.uint8), 900)
    cache.insert(2, "decoded", np.zeros(900, np.uint8), 900)
    cache.close()
    assert not any(files for _p, _d, files in os.walk(root))
    cache.close()
    assert not any(files for _p, _d, files in os.walk(root))
    os.rmdir(root)
