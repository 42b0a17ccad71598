"""The ODS step on tensors (``repro_torch.core.ods_torch``) and the "torch"
ODS backend, against the reference's JAX step and "jax" backend.

The same states, made from a seed with numpy, go through
``repro.core.ods_jax`` (JAX on the CPU) and through the port with
``device="cpu"``.  Tolerances:

- **exact** where the choice is forced — every requested id is a cached,
  unseen direct hit, or the best class holds exactly as many free
  candidates as there are slots to fill: the batch (as a set where slots
  are substitutes), ``status``, ``refcount``, ``seen``, ``served`` and
  the evict mask equal the reference's;
- **invariant-level** otherwise, the contract the reference documents
  (``ods_jax.py:9-12``): ids in a batch are unique and unseen, direct
  hits keep their slots, every substitute comes from the best class that
  still has a free candidate, and rollover happens at the same step;
- backend aggregates (coverage, augmented entries left, hits) over the
  same request stream: **exact**.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.api import SenecaConfig as RefConfig  # noqa: E402
from repro.api import SenecaServer as RefServer  # noqa: E402
from repro.core import ods_jax  # noqa: E402

from repro_torch.api import (AZURE_NC96, DatasetProfile,  # noqa: E402
                             SenecaConfig, SenecaServer, TorchOdsBackend,
                             backend_names, resolve_backend)
from repro_torch.core import ods_torch  # noqa: E402

VARIANTS = ("plain", "tiered", "inflight", "tiered_inflight")
BACKENDS = ("numpy", "torch")


def _state_np(rng, N, p_cached=0.5, p_seen=0.2):
    status = np.where(rng.random(N) < p_cached,
                      rng.integers(1, 4, N), 0).astype(np.uint8)
    refcount = np.where(status == 3, rng.integers(0, 2, N), 0) \
        .astype(np.int32)
    seen = rng.random(N) < p_seen
    return status, refcount, seen


def _extras(rng, N, variant, status):
    residency = inflight = None
    if "tiered" in variant:
        residency = np.where(status != 0, rng.integers(1, 4, N), 0) \
            .astype(np.uint8)
    if "inflight" in variant:
        inflight = rng.random(N) < 0.3
    return residency, inflight


def _port_step(status, refcount, seen, served, requested, n_jobs,
               residency=None, inflight=None, seed=0):
    st = ods_torch.ODSTorchState(
        torch.from_numpy(status.copy()), torch.from_numpy(refcount.copy()),
        torch.from_numpy(seen.copy()), served)
    g = torch.Generator().manual_seed(seed)
    req = torch.from_numpy(np.asarray(requested, np.int64))
    res = None if residency is None else torch.from_numpy(residency)
    inf = None if inflight is None else torch.from_numpy(inflight)
    st, batch, ev = ods_torch._substitute_core(st, req, g, n_jobs, res, inf)
    return (st.status.numpy(), st.refcount.numpy(), st.seen.numpy(),
            st.served, batch.numpy(), ev.numpy())


def _ref_step(status, refcount, seen, served, requested, n_jobs,
              residency=None, inflight=None, seed=0):
    st = ods_jax.ODSJaxState(jnp.asarray(status), jnp.asarray(refcount),
                             jnp.asarray(seen), jnp.asarray(served,
                                                            jnp.int32))
    req = jnp.asarray(np.asarray(requested, np.int32))
    key = jax.random.key(seed)
    if residency is not None and inflight is not None:
        out = ods_jax.substitute_tiered_inflight_jit(
            st, req, key, n_jobs, jnp.asarray(residency),
            jnp.asarray(inflight))
    elif residency is not None:
        out = ods_jax.substitute_tiered_jit(st, req, key, n_jobs,
                                            jnp.asarray(residency))
    elif inflight is not None:
        out = ods_jax.substitute_inflight_jit(st, req, key, n_jobs,
                                              jnp.asarray(inflight))
    else:
        out = ods_jax.substitute_jit(st, req, key, n_jobs)
    st, batch, ev = out
    return (np.asarray(st.status), np.asarray(st.refcount),
            np.asarray(st.seen), int(st.served), np.asarray(batch),
            np.asarray(ev))


def _classes(status, seen, requested, residency, inflight):
    """Each sample's candidate score under the reference's scoring
    (0 = not a candidate), recomputed in numpy."""
    N = len(status)
    cached = status != 0
    direct = cached[requested] & ~seen[requested]
    in_batch = np.zeros(N, bool)
    in_batch[requested[direct]] = True
    free = ~seen & ~in_batch
    if residency is None:
        score = np.where(free & cached, 2, 0)
    else:
        score = np.select([free & cached & (residency >= 3),
                           free & cached & (residency == 2),
                           free & cached & (residency < 2)], [4, 3, 2], 0)
    score = np.where(free & ~cached, 1, score)
    if inflight is not None:
        score = np.where(inflight & (score > 0), 2 * score - 1, 2 * score)
    return score, direct


def _check_invariants(status, seen, served, requested, residency, inflight,
                      batch):
    N, B = len(status), len(requested)
    if N - served < B:                       # rollover clears seen
        seen = np.zeros_like(seen)
    score, direct = _classes(status, seen, requested, residency, inflight)
    assert len(set(batch.tolist())) == B, "duplicate ids in a batch"
    assert not seen[batch].any(), "a seen id was served again"
    np.testing.assert_array_equal(batch[direct], requested[direct])
    subs = batch[~direct]
    if len(subs):
        taken = np.zeros(N, bool)
        taken[subs] = True
        left = score[(score > 0) & ~taken]
        # best class first: no free candidate left behind outranks a pick
        assert (score[subs] > 0).all()
        if len(left):
            assert score[subs].min() >= left.max()


# ----------------------------------------------------------------------
# the core, invariant level
@pytest.mark.parametrize("variant", VARIANTS)
@pytest.mark.parametrize("seed", range(3))
def test_invariants_against_reference(variant, seed):
    """Random states through both steps: both hold every invariant, and
    their batches are the same multiset of classes slot by slot."""
    rng = np.random.default_rng(seed)
    N, B = 256, 16
    status, refcount, seen = _state_np(rng, N)
    residency, inflight = _extras(rng, N, variant, status)
    requested = rng.choice(N, B, replace=False)
    served = int(seen.sum())
    port = _port_step(status, refcount, seen, served, requested, 2,
                      residency, inflight, seed)
    ref = _ref_step(status, refcount, seen, served, requested, 2,
                    residency, inflight, seed)
    for out in (port, ref):
        _check_invariants(status, seen, served, requested, residency,
                          inflight, out[4])
        assert out[0].dtype == np.uint8 and out[1].dtype == np.int32
    score, _ = _classes(status, seen, requested, residency, inflight)
    # same class in every slot (the pick within a class is random)
    np.testing.assert_array_equal(np.sort(score[port[4]]),
                                  np.sort(score[ref[4]]))
    assert port[3] == ref[3] == served + B


@pytest.mark.parametrize("variant", VARIANTS)
def test_trajectory_invariants_and_rollover(variant):
    """The reference's test_invariants_under_jit over two epochs, for
    every variant: unique unseen ids per epoch, and the rollover (seen
    cleared, served back to 0) at the same step as the reference's."""
    N, B = 256, 16
    rng = np.random.default_rng(7)
    status = np.zeros(N, np.uint8)
    status[np.arange(0, N, 3)] = 3
    residency, inflight = _extras(rng, N, variant, status)
    p = (status, np.zeros(N, np.int32), np.zeros(N, bool), 0)
    r = p
    seen_ids = set()
    for i in range(2 * (N // B) + 3):
        req = np.arange(i * B, i * B + B) % N
        *p_st, batch, _ = _port_step(*p, req, 2, residency, inflight, i)
        *r_st, _, _ = _ref_step(*r, req, 2, residency, inflight, i)
        _check_invariants(p[0], p[2], p[3], req, residency, inflight, batch)
        assert p_st[3] == r_st[3], f"served diverged at step {i}"
        if p[3] + B > N:
            seen_ids = set()
        assert not seen_ids & set(batch.tolist())
        seen_ids |= set(batch.tolist())
        p, r = tuple(p_st), tuple(r_st)


def test_prefers_cached_unseen():
    """The reference's test_prefers_cached_unseen: every substitute is
    cached when cached candidates outnumber the slots."""
    N, B = 128, 8
    status = np.zeros(N, np.uint8)
    status[:64] = 1
    req = np.arange(64, 64 + B)                       # all uncached
    st, _, _, _, batch, _ = _port_step(
        status, np.zeros(N, np.int32), np.zeros(N, bool), 0, req, 1)
    assert np.all(st[batch] == 1)


# ----------------------------------------------------------------------
# the core, exact where the choice is forced
@pytest.mark.parametrize("n_jobs", [1, 2])
def test_all_direct_hits_equal_reference_exactly(n_jobs):
    """The reference's test_eviction_mask_threshold: every requested id
    is a cached, unseen, augmented direct hit.  Nothing is chosen, so the
    batch, status, refcount, seen, served and evict mask are the
    reference's exactly — and at threshold 1 every served augmented
    sample evicts at once."""
    N, B = 64, 8
    status = np.zeros(N, np.uint8)
    status[:16] = 3
    refcount = np.zeros(N, np.int32)
    refcount[4:8] = 1
    args = (status, refcount, np.zeros(N, bool), 0, np.arange(0, B), n_jobs)
    port, ref = _port_step(*args), _ref_step(*args)
    for got, want in zip(port, ref):
        np.testing.assert_array_equal(got, want)
    _, _, _, _, batch, ev = port
    if n_jobs == 1:
        assert ev[batch].all() and (port[0][batch] == 0).all()
    else:
        np.testing.assert_array_equal(ev[batch], refcount[batch] + 1 >= 2)


@pytest.mark.parametrize("variant", VARIANTS)
def test_forced_fill_equals_reference_exactly(variant):
    """The best class holds exactly as many free candidates as there are
    slots: the filled set is forced, so the batch's set and every table
    equal the reference's (the slot order of the fills is random)."""
    N, B = 128, 8
    rng = np.random.default_rng(11)
    status = np.zeros(N, np.uint8)
    req = np.arange(100, 100 + B)                     # all uncached
    best = rng.choice(np.arange(0, 96), B, replace=False)
    others = np.setdiff1d(np.arange(0, 96), best)[:30]
    status[best] = 3
    status[others] = 2
    residency = inflight = None
    if "tiered" in variant:
        # best = the only HBM entries; the others sit in DRAM
        residency = np.zeros(N, np.uint8)
        residency[best] = 3
        residency[others] = 2
    if "inflight" in variant:
        # in flight: every other cached entry, and some storage ids
        inflight = np.zeros(N, bool)
        inflight[others] = True
        inflight[110:120] = True
        if residency is None:
            status[others] = 3          # same class as best, in flight
    elif residency is None:
        status[others] = 0              # plain: best = the only cached
    refcount = np.where(status == 3, 1, 0).astype(np.int32)
    args = (status, refcount, np.zeros(N, bool), 0, req, 2, residency,
            inflight)
    port, ref = _port_step(*args, seed=3), _ref_step(*args, seed=3)
    assert sorted(port[4].tolist()) == sorted(ref[4].tolist()) \
        == sorted(best.tolist())
    for got, want in zip(port[:4] + port[5:], ref[:4] + ref[5:]):
        np.testing.assert_array_equal(got, want)


def test_rollover_step_equals_reference_exactly():
    """When fewer than B unseen remain the step clears seen first: a
    forced step right at the boundary equals the reference's."""
    N, B = 32, 8
    status = np.full(N, 3, np.uint8)
    seen = np.ones(N, bool)
    seen[:4] = False                                  # 4 < B left
    req = np.arange(8, 16)
    args = (status, np.zeros(N, np.int32), seen, N - 4, req, 3)
    port, ref = _port_step(*args), _ref_step(*args)
    for got, want in zip(port, ref):
        np.testing.assert_array_equal(got, want)
    assert port[3] == B and port[2].sum() == B


def test_core_is_pure():
    """No input tensor is written (the backend uploads host tables that
    may alias CPU tensors)."""
    rng = np.random.default_rng(0)
    N = 64
    status, refcount, seen = _state_np(rng, N)
    st = ods_torch.ODSTorchState(torch.from_numpy(status.copy()),
                                 torch.from_numpy(refcount.copy()),
                                 torch.from_numpy(seen.copy()), 3)
    before = [t.clone() for t in st[:3]]
    ods_torch.substitute_tiered_inflight(
        st, torch.arange(8), torch.Generator().manual_seed(0), 1,
        torch.from_numpy(np.full(N, 2, np.uint8)),
        torch.from_numpy(rng.random(N) < 0.5))
    for a, b in zip(st[:3], before):
        assert torch.equal(a, b)


def test_create_matches_reference_layout():
    st, ref = ods_torch.create(16), ods_jax.create(16)
    for got, want in zip(st[:3], ref[:3]):
        assert got.numpy().dtype == np.asarray(want).dtype
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    assert st.served == int(ref.served) == 0


# ----------------------------------------------------------------------
# the backend
def _server(n=200, cache_bytes=None, split=(0.0, 0.0, 1.0), seed=3,
            **kw):
    profile = DatasetProfile("synth", n, 1000, decoded_bytes=1000,
                             augmented_bytes=1000)
    return SenecaServer(SenecaConfig(
        cache_bytes=cache_bytes if cache_bytes is not None else 1000 * n,
        hardware=AZURE_NC96, dataset=profile, split=split, seed=seed),
        device="cpu", **kw)


def _ref_server(n, backend, seed=3):
    from repro.api import AZURE_NC96 as RA
    from repro.api import DatasetProfile as RP
    profile = RP("synth", n, 1000, decoded_bytes=1000, augmented_bytes=1000)
    return RefServer(RefConfig(cache_bytes=1000 * n, hardware=RA,
                               dataset=profile, split=(0.0, 0.0, 1.0),
                               seed=seed), backend=backend)


def _drive_epoch(server, n, B, n_cached):
    s1 = server.open_session(batch_size=B)
    s2 = server.open_session(batch_size=B)
    for sid in range(n_cached):
        assert s1.admit(sid, "augmented", b"v", 1000)
    first = {}
    seen = {0: [], 1: []}
    for step in range(n // B):
        for jid, sess in ((0, s1), (1, s2)):
            ids, forms = sess.next_batch_ids()
            if step == 0:
                first[jid] = forms
            seen[jid].extend(ids.tolist())
    s1.close()
    s2.close()
    return seen, first


def _aggregates(server, n, B, n_cached):
    seen, _ = _drive_epoch(server, n, B, n_cached)
    st = server.stats()
    return {"coverage": {j: sorted(seen[j]) for j in seen},
            "aug_left": int((server.service.backend.status_of(
                np.arange(n)) == 3).sum()),
            "hits": st["hits"], "total": st["hits"] + st["misses"]}


def test_torch_backend_registered_and_jax_refused():
    assert "torch" in backend_names()
    be = resolve_backend("torch", 16, device="cpu")
    assert isinstance(be, TorchOdsBackend) and be.device.type == "cpu"
    with pytest.raises(ValueError, match="'torch'"):
        resolve_backend("jax", 16)


@pytest.mark.skipif(torch.cuda.is_available(), reason="needs a CPU-only box")
def test_torch_backend_defaults_to_cuda_and_raises_without_it():
    with pytest.raises(RuntimeError, match="CUDA"):
        TorchOdsBackend(16)
    with pytest.raises(RuntimeError, match="CUDA"):
        resolve_backend("torch", 16)


@pytest.mark.parametrize("backend", BACKENDS)
def test_parity_invariants_per_backend(backend):
    """tests/test_api.py's test_parity_invariants_per_backend on the
    port's engines."""
    n, B, n_cached = 96, 8, 48
    server = _server(n=n, backend=backend)
    assert server.stats()["backend"] == backend
    seen, first = _drive_epoch(server, n, B, n_cached)
    for jid in (0, 1):
        assert sorted(seen[jid]) == list(range(n)), backend
    assert np.all(first[0] != 0), (backend, first[0])
    status = server.service.backend.status_of(np.arange(n))
    assert int((status == 3).sum()) == 0, backend
    stats = server.stats()
    assert stats["hits"] > 0 and stats["substitutions"] > 0


def test_parity_numpy_vs_torch_vs_reference_jax_same_aggregates():
    """Same config, same seeds, same request stream: the port's "numpy"
    and "torch" engines and the reference's "jax" engine agree exactly on
    coverage, full eviction and hit counts."""
    n, B, n_cached = 96, 8, 48
    out = {b: _aggregates(_server(n=n, backend=b), n, B, n_cached)
           for b in BACKENDS}
    out["jax"] = _aggregates(_ref_server(n, "jax"), n, B, n_cached)
    full = {0: list(range(n)), 1: list(range(n))}
    for b, agg in out.items():
        assert agg["coverage"] == full, b
        assert agg["aug_left"] == 0, b
        assert agg["total"] == 2 * n, b
        assert agg["hits"] == 2 * n_cached, b


@pytest.mark.parametrize("backend", BACKENDS)
def test_backend_selectable_from_server_kwarg(backend):
    server = _server(n=64, backend=backend, split=(0.0, 0.0, 1.0))
    assert server.stats()["backend"] == backend
    with server.open_session(batch_size=8) as sess:
        ids, _ = sess.next_batch_ids()
        assert len(ids) == 8


def test_torch_backend_host_tables_own_their_memory():
    """After a step the host tables are writable arrays that alias no
    tensor: mark_cached/mark_evicted write them between batches."""
    be = TorchOdsBackend(32, device="cpu")
    be.register_job(0)
    be.mark_cached(np.arange(8), 3)
    batch, _ = be.sample_batch(0, np.arange(8, 16))
    for arr in (be.status, be.refcount, be.seen[0]):
        assert arr.flags.writeable and arr.flags.owndata
    be.mark_evicted(batch)
    assert (be.status_of(batch) == 0).all()


def test_torch_backend_checkpoint_restore_roundtrip():
    """checkpoint_job records the generator's state for inspection and
    does not restore it; seen/epoch/served round-trip."""
    be = TorchOdsBackend(64, seed=5, device="cpu")
    be.register_job(0)
    for i in range(3):
        be.sample_batch(0, np.arange(i * 8, i * 8 + 8))
    snap = be.checkpoint_job(0)
    assert snap["served"] == 24 and snap["epoch"] == 0
    assert snap["rng_state"] == be.generator.get_state().tolist()
    other = TorchOdsBackend(64, device="cpu")
    other.register_job(7)
    other.restore_job(7, snap)
    np.testing.assert_array_equal(other.seen[7], be.seen[0])
    assert other.served[7] == 24 and other.epoch[7] == 0
    with pytest.raises(ValueError):
        TorchOdsBackend(32, device="cpu").restore_job(0, snap)
    with pytest.raises(KeyError):
        other.restore_job(99, snap)
    with pytest.raises(KeyError):
        be.checkpoint_job(99)


def test_torch_backend_epoch_counting_matches_reference_jax():
    """The host-side rollover predicate counts epochs exactly as the
    reference's "jax" backend does over the same request stream."""
    n, B = 40, 8
    port = TorchOdsBackend(n, device="cpu")
    ref = _ref_server(n, "jax").service.backend
    for be in (port, ref):
        be.register_job(0)
        be.mark_cached(np.arange(0, n, 2), 3)
    rng = np.random.default_rng(0)
    for _ in range(12):
        req = rng.choice(n, B, replace=False)
        port.sample_batch(0, req, evict_threshold=2)
        ref.sample_batch(0, req, evict_threshold=2)
        assert port.epoch_of(0) == ref.epoch_of(0)
        assert port.served[0] == ref.served[0]
    assert port.epoch_of(0) >= 2
