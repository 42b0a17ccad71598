"""The port's cache engine against the JAX package, HBM tier on the CPU.

The port's :class:`HbmTier` holds tensors on an explicit device; these
tests pass ``device="cpu"``.  The same operation sequences run on the
reference ``TieredCache`` (whose HBM tier holds ``jax.Array``) and on
the port's: the per-tier ledgers and residency must agree exactly.
Demotion copies a device tensor to a host array with ``.cpu().numpy()``
(``np.asarray`` cannot read CUDA memory), and admitted device rows must
own exactly their bytes.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.cache.store import TieredCache as RefCache  # noqa: E402

from repro_torch.api import SenecaServer  # noqa: E402
from repro_torch.cache.store import CachePartition, TieredCache  # noqa: E402
from repro_torch.cache.tiers import DiskTier, HbmTier  # noqa: E402
from repro_torch.core.ods import EpochSampler, ODSState  # noqa: E402
from repro_torch.data.pipeline import DSIPipeline  # noqa: E402
from repro_torch.data.storage import RemoteStorage  # noqa: E402
from repro_torch.data.synthetic import tiny  # noqa: E402

FORMS = ("encoded", "decoded", "augmented")


def _ledgers(c):
    out = {"used": c.bytes_used(), "hbm": c.hbm_bytes_used(),
           "disk": c.disk_bytes_used(),
           "residency": c.residency_array(40).tolist(),
           "status": c.status_array(40).tolist()}
    for form in FORMS:
        p = c.parts[form]
        out[form] = (p.dram.stats.bytes_used, p.hbm.stats.bytes_used,
                     p.spill.stats.bytes_used, sorted(p.dram.keys()),
                     sorted(p.hbm.keys()), sorted(p.spill.keys()),
                     p.hbm_promotions, p.hbm_demotions, p.demotions,
                     p.promotions)
    return out


@pytest.mark.parametrize("seed", range(3))
def test_tier_ledgers_match_reference(tmp_path, seed):
    """A random insert/lookup/resize sequence over an HBM->DRAM->disk
    cache gives identical per-tier ledgers, residency and content in
    the port and the reference."""
    kw = dict(split=(0.3, 0.3, 0.4), spill_bytes=60_000,
              spill_split=(0.3, 0.3, 0.4), hbm_bytes=8_000,
              hbm_split=(0.0, 0.5, 0.5),
              evict_policies={f: "lru" for f in FORMS})
    ref = RefCache(12_000, spill_dir=str(tmp_path / "ref"), **kw)
    port = TieredCache(12_000, spill_dir=str(tmp_path / "port"),
                       device="cpu", **kw)
    rng = np.random.default_rng(seed)
    values = {}
    for step in range(200):
        op = rng.integers(0, 10)
        key = int(rng.integers(0, 40))
        form = FORMS[int(rng.integers(0, 3))]
        if op < 5:
            if form == "encoded":
                v = bytes(rng.integers(0, 256, 500, dtype=np.uint8))
                nb = len(v)
            elif form == "decoded":
                v = rng.integers(0, 256, (8, 8, 3), dtype=np.uint8)
                nb = v.nbytes
            else:
                v = rng.random((6, 6, 3)).astype(np.float32)
                nb = v.nbytes
            assert ref.insert(key, form, v, nb) == \
                port.insert(key, form, v, nb)
            values[(key, form)] = v
        elif op < 9:
            rf, rv, rt = ref.lookup_tiered(key)
            pf, pv, pt = port.lookup_tiered(key)
            assert (rf, rt) == (pf, pt)
            if pf == "encoded":
                assert bytes(pv) == bytes(rv)
            elif pf is not None:
                got = pv.numpy() if isinstance(pv, torch.Tensor) \
                    else np.asarray(pv)
                np.testing.assert_array_equal(got, np.asarray(rv))
                np.testing.assert_array_equal(got, values[(key, pf)])
        else:
            split = tuple(rng.dirichlet([1, 1, 1]).round(2))
            split = (split[0], split[1], 1.0 - split[0] - split[1])
            hsplit = (0.0, 0.5, 0.5) if step % 2 else (0.0, 0.2, 0.8)
            ref.resize(split, hbm_split=hsplit)
            port.resize(split, hbm_split=hsplit)
        assert _ledgers(port) == _ledgers(ref), f"diverged at step {step}"
    assert sorted(ref.take_evicted()) == sorted(port.take_evicted())
    ref.close()
    port.close()


def test_demote_promote_keeps_tensor_content(tmp_path):
    """HBM demotion lands a host copy (numpy) in DRAM and on disk; a hot
    DRAM entry promotes back up as a tensor; content never changes."""
    hbm = HbmTier(1_000, "lru", device="cpu")
    spill = DiskTier(10_000, str(tmp_path), "augmented")
    part = CachePartition(500, "lru", spill, hbm)
    rows = {k: torch.rand(4, 4, 3) + k for k in range(4)}   # 192 B each
    for k, row in rows.items():
        part.put(k, row, row.numel() * 4)
    assert sorted(hbm.keys()) == [0, 1, 2, 3]
    assert part.set_hbm_capacity(200) == []      # 3 rows demote
    assert part.hbm_demotions == 3 and len(part.dram) + len(spill) == 3
    for k in part.dram.keys():
        assert isinstance(part.dram.peek(k), np.ndarray)
    for k, row in rows.items():
        np.testing.assert_array_equal(np.asarray(part.peek(k)), row.numpy())
    hbm.set_capacity(1_000)
    dram_key = part.dram.keys()[-1]
    part.get(dram_key)
    part.get(dram_key)                           # second hit promotes
    assert part.tier_of(dram_key) == "hbm" and part.hbm_promotions == 1
    got = part.get(dram_key)
    assert isinstance(got, torch.Tensor)
    assert torch.equal(got, rows[dram_key])
    assert hbm.stats.bytes_used == 2 * 192
    spill.clear()


def test_dram_holds_host_arrays_and_hbm_rejects_bytes():
    hbm = HbmTier(100, "none", device="cpu")
    part = CachePartition(1_000, "none", None, hbm)
    row = torch.ones(8, 8)                       # 256 B > HBM capacity
    part.put(1, row, 256)
    assert part.tier_of(1) == "dram"
    assert isinstance(part.dram.peek(1), np.ndarray)
    assert not HbmTier.wants_value(b"raw")
    part.put(2, b"x" * 50, 50)
    assert part.tier_of(2) == "dram"
    small = np.arange(10, dtype=np.float32)
    part.put(3, small, small.nbytes)
    assert part.tier_of(3) == "hbm"
    assert isinstance(hbm.peek(3), torch.Tensor)
    assert hbm.peek(3).device == torch.device("cpu")


def test_chain_capacity_matches_reference(tmp_path):
    """The admission gate's chain capacity keeps the reference's
    semantics: a tier counts only while it is truthy, so an empty HBM
    or spill tier adds nothing until it holds an entry.  A form with no
    DRAM share therefore never admits into its empty HBM tier, in the
    port as in the reference."""
    from repro.cache.store import CachePartition as RefPartition
    from repro.cache.tiers import DiskTier as RefDisk
    from repro.cache.tiers import HbmTier as RefHbm
    ref = RefPartition(0, "lru", RefDisk(500, str(tmp_path / "r"), "augmented"),
                       RefHbm(300, "lru"))
    spill = DiskTier(500, str(tmp_path / "p"), "augmented")
    part = CachePartition(0, "lru", spill, HbmTier(300, "lru", device="cpu"))
    assert part.total_capacity == ref.total_capacity == 0
    for p, row in ((ref, np.zeros(50, np.float32)), (part, torch.zeros(50))):
        p.hbm.put(1, row, 200)
    assert part.total_capacity == ref.total_capacity == 300
    assert part.total_hits == ref.total_hits
    spill.clear()
    ref.spill.clear()


def test_ods_prefers_hbm_resident_candidates():
    state = ODSState.create(64, seed=1)
    state.register_job(0)
    state.status[:32] = 3                      # cached (augmented)
    residency = np.zeros(64, np.uint8)
    residency[:8] = 3                          # HBM (device-resident)
    residency[8:16] = 2                        # DRAM
    residency[16:32] = 1                       # disk
    state.set_residency(residency)
    batch, _ = state.sample_batch(0, np.arange(40, 48))
    subs = batch[np.isin(batch, np.arange(32))]
    assert len(subs) == 8
    assert set(subs) == set(range(8))


def test_service_pushes_hbm_residency_to_ods():
    """Through the port's service: rows admitted into the CPU "HBM"
    tier are reported at residency 3 and preferred by substitution."""
    ds = tiny(n=64)
    server = SenecaServer.for_dataset(
        ds, cache_bytes=64 * ds.augmented_bytes(), split=(0.0, 0.0, 1.0),
        device_cache_bytes=8 * ds.augmented_bytes(),
        hbm_split=(0.0, 0.0, 1.0), device="cpu")
    sess = server.open_session(batch_size=8)
    svc = server.service
    aug = np.zeros((*ds.crop_hw, 3), np.float32)
    for k in range(24):
        assert sess.admit(k, "augmented", aug + k, aug.nbytes)
    on_hbm = sorted(svc.cache.parts["augmented"].hbm.keys())
    assert len(on_hbm) == 8                    # LRU keeps the newest 8
    res = svc.cache.residency_array(64)
    assert (res[on_hbm] == 3).all() and (res[:24] >= 2).all()
    assert server.stats()["residency_counts"]["hbm"] == 8
    requested = EpochSampler(64, 8, 97 * (sess.job_id + 1)).next_request()
    ids, _forms = sess.next_batch_ids()
    subs = set(ids.tolist()) - set(requested.tolist())
    assert subs and subs <= set(on_hbm), \
        "substitution picked a DRAM resident over an HBM one"
    server.close()


def test_admitted_device_rows_own_their_bytes():
    """The device executor admits clones: each HBM entry's storage is
    exactly its declared bytes.  A row of the batch tensor is a view
    whose storage is the whole batch, which the tier's ledger would not
    see."""
    ds = tiny(n=32)
    server = SenecaServer.for_dataset(
        ds, use_ods=False, split=(0.5, 0.0, 0.5),
        device_cache_bytes=int(1.2 * 32 * ds.augmented_bytes()),
        hbm_split=(0.0, 0.0, 1.0), device="cpu")
    sess = server.open_session(batch_size=8)
    pipe = DSIPipeline(sess, RemoteStorage(ds), executor="device",
                       sync_refills=True)
    batch = pipe.next_batch()
    hbm = server.service.cache.parts["augmented"].hbm
    assert len(hbm) >= 8
    for key in hbm.keys():
        t = hbm.peek(key)
        assert t.untyped_storage().nbytes() == hbm._sizes[key]
    view = batch["images"][0]
    assert view.untyped_storage().nbytes() == 8 * hbm._sizes[key]
    pipe.stop()
    server.close()
