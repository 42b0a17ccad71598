"""The port's fault layer (``repro_torch.faults``) against the reference.

Mirrors ``tests/test_faults.py``: the FaultSpec and LivenessRegistry
contracts, session checkpoint/restore over the "numpy" and "torch" ODS
engines, storage bandwidth collapse, spill-file corruption, worker-crash
recovery, shard failover and ring re-expansion on the sharded data
plane, and two acceptance traces — a VirtualClock workload surviving
spill corruption, a bandwidth collapse and a job preemption (unsharded),
and the reference's own trace on two sim shards: a shard kill, spill
corruption and a preemption — with exactly-once-per-epoch coverage.  An
unsharded server refuses shard faults, as the reference's does.

Tolerance: exact.  The same trace through the reference and the port
gives equal per-job sample ids, epoch ends and makespans, and equal
fault counters; the shard-kill test's answers equal the reference's.
"""
import numpy as np
import pytest

pytest.importorskip("torch")

from repro.api import FaultSpec as RefFaultSpec  # noqa: E402
from repro.api import JobSpec as RefJobSpec  # noqa: E402
from repro.api import SenecaServer as RefServer  # noqa: E402
from repro.api import VirtualClock as RefClock  # noqa: E402
from repro.api import WorkloadRunner as RefRunner  # noqa: E402
from repro.data.storage import RemoteStorage as RefStorage  # noqa: E402
from repro.data.synthetic import tiny as ref_tiny  # noqa: E402
from repro.faults import FAULT_KINDS as REF_FAULT_KINDS  # noqa: E402

from repro_torch.api import (FaultSpec, JobSpec, SenecaServer,  # noqa: E402
                             VirtualClock, WorkloadRunner)
from repro_torch.data.storage import RemoteStorage  # noqa: E402
from repro_torch.data.synthetic import tiny  # noqa: E402
from repro_torch.faults import (FAULT_KINDS, FaultInjector,  # noqa: E402
                                LivenessRegistry)
from repro_torch.faults.injector import corrupt_spill_files  # noqa: E402

PORT = dict(server=SenecaServer, job=JobSpec, fault=FaultSpec,
            clock=VirtualClock, runner=WorkloadRunner,
            storage=RemoteStorage, tiny=tiny, kw={"device": "cpu"})
REF = dict(server=RefServer, job=RefJobSpec, fault=RefFaultSpec,
           clock=RefClock, runner=RefRunner, storage=RefStorage,
           tiny=ref_tiny, kw={})


def _server(ds, **kw):
    kw.setdefault("cache_frac", 0.4)
    kw.setdefault("seed", 0)
    kw.setdefault("device", "cpu")
    return SenecaServer.for_dataset(ds, **kw)


def _coverage_exact(sample_ids, n):
    ids = np.asarray(sample_ids)
    if len(ids) % n:
        return False
    want = np.arange(n)
    return all(np.array_equal(np.sort(ids[e * n:(e + 1) * n]), want)
               for e in range(len(ids) // n))


# ----------------------------------------------------------------------
# FaultSpec validation
def test_fault_spec_kinds_and_validation():
    assert FAULT_KINDS == REF_FAULT_KINDS
    assert "shard-kill" in FAULT_KINDS and "preempt" in FAULT_KINDS
    with pytest.raises(ValueError):
        FaultSpec("no-such-kind", at_s=0.0)
    with pytest.raises(ValueError):
        FaultSpec("preempt", at_s=0.1)            # job required
    with pytest.raises(ValueError):
        FaultSpec("worker-crash", at_s=0.1)       # job required
    with pytest.raises(ValueError):
        FaultSpec("shard-kill", at_s=0.1)         # shard required
    with pytest.raises(ValueError):
        FaultSpec("bandwidth-collapse", at_s=0.1, factor=0.0)
    with pytest.raises(ValueError):
        FaultSpec("spill-corrupt", at_s=0.1, n_files=0)
    with pytest.raises(ValueError):
        FaultSpec("preempt", at_s=-1.0, job="a")
    s = FaultSpec("shard-kill", at_s=0.5, shard=1, duration_s=0.2)
    assert (s.kind, s.at_s, s.shard, s.duration_s) == \
        ("shard-kill", 0.5, 1, 0.2)


def test_injector_requires_targets():
    with pytest.raises(ValueError, match="server"):
        FaultInjector([FaultSpec("shard-kill", at_s=0.0, shard=0)])
    with pytest.raises(ValueError, match="RemoteStorage"):
        FaultInjector([FaultSpec("bandwidth-collapse", at_s=0.0)],
                      server=object())
    with pytest.raises(TypeError):
        FaultInjector([("preempt", 0.1)])


def test_injector_timeline_equals_reference():
    """Derived restore events sit at at_s + duration_s, ordered by time
    then insertion: the same timeline as the reference's injector."""
    from repro.faults import FaultInjector as RefInjector

    def specs(F):
        return [F("bandwidth-collapse", at_s=0.2, duration_s=0.3),
                F("preempt", at_s=0.5, job="a", duration_s=1.0),
                F("shard-kill", at_s=0.1, shard=0, duration_s=0.4)]

    inj = FaultInjector(specs(FaultSpec), server=object(), storage=object())
    ref = RefInjector(specs(RefFaultSpec), server=object(),
                      storage=object())
    got = [(t, s, kind) for t, s, kind, _ in inj._timeline]
    assert got == [(t, s, kind) for t, s, kind, _ in ref._timeline]
    assert [kind for _, _, kind in got] == [
        "shard-kill", "bandwidth-collapse", "bandwidth-restore", "preempt",
        "shard-restart"]


# ----------------------------------------------------------------------
# LivenessRegistry
def test_liveness_registry_expiry_and_overrides():
    t = [0.0]

    class FakeClock:
        def now(self):
            return t[0]

    reg = LivenessRegistry(dead_after_s=5.0, clock=FakeClock())
    reg.beat("h0")
    reg.beat("h1")
    assert reg.failed() == []
    t[0] = 6.0
    assert sorted(reg.failed()) == ["h0", "h1"]
    assert not reg.is_dead("h0")
    reg.beat("h0")
    assert reg.failed() == ["h1"]
    reg.mark_dead("h0")
    assert reg.is_dead("h0")
    reg.mark_alive("h0")
    assert not reg.is_dead("h0") and reg.failed() == ["h1"]
    reg.forget("h1")
    assert reg.failed() == []
    reg.mark_dead("ghost")                 # marked but never beat
    assert reg.failed() == ["ghost"]


# ----------------------------------------------------------------------
# Shard failover + ring re-expansion
def _shard_kill_trace(pkg):
    """The reference's shard-kill test as a record of every answer."""
    ds = pkg["tiny"](n=96)
    server = pkg["server"].for_dataset(ds, cache_frac=0.4, seed=0,
                                       shards=2, **pkg["kw"])
    out = {}
    try:
        svc = server.service
        cache = svc.cache
        n = ds.n_samples
        owners = cache.router.shard_of_many(np.arange(n))
        owned = np.flatnonzero(owners == 1)
        other = np.flatnonzero(owners == 0)
        assert len(owned) > 0
        data = np.zeros(64, np.uint8)
        cache.insert(int(owned[0]), "decoded", data, data.nbytes)
        out["before"] = cache.lookup_tiered(int(owned[0]))[0]

        svc.fail_shard(1)
        # dead shard degrades: lookups miss, inserts are dropped, the
        # failover counter moves, and stats carry the dead marker
        out["dead_lookup"] = cache.lookup_tiered(int(owned[0]))[0]
        out["dead_insert"] = cache.insert(int(owned[1]), "decoded", data,
                                          data.nbytes)
        out["failovers"] = cache.failovers
        out["dead"] = [s["shard"] for s in cache.shard_stats()
                       if s.get("dead")]
        out["ods_owned"] = svc.backend.status_of(owned).tolist()
        # surviving shard still serves its own keys
        out["alive_insert"] = cache.insert(int(other[0]), "decoded", data,
                                           data.nbytes)
        out["alive_lookup"] = cache.lookup_tiered(int(other[0]))[0]
        out["residency_owned"] = cache.residency_array(n)[owned].tolist()

        v_dead = cache.version
        svc.restore_shard(1)
        out["version_moved"] = cache.version != v_dead
        out["dead_after"] = [s.get("dead", False)
                             for s in cache.shard_stats()]
        out["restored_insert"] = cache.insert(int(owned[2]), "decoded",
                                              data, data.nbytes)
        out["restored_lookup"] = cache.lookup_tiered(int(owned[2]))[0]
        out["faults"] = svc.stats()["faults"]
    finally:
        server.close()
    return out


def test_shard_kill_failover_and_restart():
    got = _shard_kill_trace(PORT)
    assert got["before"] == "decoded"
    assert got["dead_lookup"] is None and got["dead_insert"] is False
    assert got["failovers"] > 0 and got["dead"] == [1]
    assert set(got["ods_owned"]) == {0}           # IN_STORAGE
    assert got["alive_insert"] and got["alive_lookup"] == "decoded"
    assert not any(got["residency_owned"])
    assert got["version_moved"] and not any(got["dead_after"])
    assert got["restored_insert"] and got["restored_lookup"] == "decoded"
    counts = got["faults"]["counts"]
    assert counts["fault.shard-kill"] == 1
    assert counts["recovery.shard-restart"] == 1
    assert got["faults"]["shard_failovers"] > 0
    assert got == _shard_kill_trace(REF)


# ----------------------------------------------------------------------
# Session sampler checkpoint/restore
@pytest.mark.parametrize("backend", ["numpy", "torch"])
def test_session_checkpoint_restore_roundtrip(backend):
    ds = tiny(n=64)
    server = _server(ds, backend=backend)
    try:
        sess = server.open_session(batch_size=8)
        pre = [sess.next_batch_ids()[0] for _ in range(3)]
        snap = sess.checkpoint_state()
        assert snap["format"] == 1
        cont = [sess.next_batch_ids()[0] for _ in range(5)]
        sess.close()

        sess2 = server.open_session(batch_size=8)
        sess2.restore_state(snap)
        resumed = [sess2.next_batch_ids()[0] for _ in range(5)]
        if backend == "numpy":
            assert [list(b) for b in resumed] == [list(b) for b in cont]
        # the torch engine's generator is shared and deliberately not
        # restored, so its post-restore order may differ — coverage may not
        ids = [i for b in pre + resumed for i in b]
        assert _coverage_exact(ids, 64)
        sess2.close()
    finally:
        server.close()


def test_session_restore_rejects_mismatched_shape():
    ds = tiny(n=64)
    server = _server(ds)
    try:
        sess = server.open_session(batch_size=8)
        snap = sess.checkpoint_state()
        other = server.open_session(batch_size=16)
        with pytest.raises(ValueError):
            other.restore_state(snap)       # batch_size mismatch
        with pytest.raises(ValueError):
            sess.restore_state({**snap, "format": 99})
        sess.close()
        other.close()
    finally:
        server.close()


# ----------------------------------------------------------------------
# Storage bandwidth collapse
def test_storage_degrade_and_restore():
    ds = tiny(n=16)
    storage = RemoteStorage(ds, bandwidth=1e9)
    storage.fetch(0)
    assert storage.degraded_fetches == 0
    storage.degrade(0.5)
    assert storage.degraded and storage.budget.rate == 0.5e9
    storage.fetch(1)
    assert storage.degraded_fetches == 1
    storage.restore_bandwidth()
    assert not storage.degraded and storage.budget.rate == 1e9
    with pytest.raises(ValueError):
        storage.degrade(0.0)
    unl = RemoteStorage(ds)
    unl.degrade(0.1)
    assert unl.degraded and unl.budget.rate is None


# ----------------------------------------------------------------------
# Spill corruption helper
def test_corrupt_spill_files_truncates_deterministically(tmp_path):
    for name in ("b.bin", "a.bin", "c.bin"):
        (tmp_path / name).write_bytes(b"x" * 64)
    hit = corrupt_spill_files(str(tmp_path), 2)
    assert [p.rsplit("/", 1)[1] for p in hit] == ["a.bin", "b.bin"]
    assert (tmp_path / "a.bin").stat().st_size == 1
    assert (tmp_path / "c.bin").stat().st_size == 64


# ----------------------------------------------------------------------
# End-to-end acceptance trace (unsharded): spill corruption + bandwidth
# collapse + preemption, through either package
def _acceptance_run(pkg, policy, tmp_path, tag, seed=0, backend="numpy"):
    ds = pkg["tiny"](n=128)
    spill = tmp_path / f"spill-{tag}"
    spill.mkdir()
    kw = dict(pkg["kw"])
    if backend != "numpy":
        kw["backend"] = backend
    server = pkg["server"].for_dataset(
        ds, cache_frac=0.3, seed=0, spill_dir=str(spill),
        spill_bytes=int(0.2 * 128 * ds.augmented_bytes()), **kw)
    clock = pkg["clock"]()
    storage = pkg["storage"](ds, bandwidth=2e7, clock=clock)
    F = pkg["fault"]
    faults = [F("bandwidth-collapse", at_s=0.05, factor=0.25,
                duration_s=0.1),
              F("spill-corrupt", at_s=0.08, n_files=2),
              F("preempt", at_s=0.10, job="a", duration_s=0.06)]
    runner = pkg["runner"](server, storage, clock=clock, seed=seed,
                           faults=faults, fault_policy=policy)
    J = pkg["job"]
    res = runner.run([J("a", arrival_s=0.0, epochs=2, batch_size=16,
                        gpu_rate=1000),
                      J("b", arrival_s=0.02, epochs=2, batch_size=16,
                        gpu_rate=700)], timeout=300)
    stats = res.stats
    server.close()
    return res, stats


def test_acceptance_trace_coverage_and_determinism(tmp_path):
    r1, stats = _acceptance_run(PORT, "checkpoint", tmp_path, "r1")
    r2, _ = _acceptance_run(PORT, "checkpoint", tmp_path, "r2")
    assert r1.makespan == r2.makespan
    for a, b in zip(r1.jobs, r2.jobs):
        assert a.sample_ids == b.sample_ids
        assert a.epoch_ends == b.epoch_ends
    for job in r1.jobs:
        assert _coverage_exact(job.sample_ids, 128), job.spec.name
    assert sum(j.preemptions for j in r1.jobs) == 1
    counts = stats["faults"]["counts"]
    assert counts["fault.spill-corrupt"] == 1
    assert counts["fault.bandwidth-collapse"] == 1
    assert counts["fault.preempt"] == 1
    assert counts["recovery.bandwidth-restore"] == 1
    assert counts["recovery.preempt-readmit"] == 1
    assert stats["faults"]["injected"] == 3
    assert stats["faults"]["recovered"] == 2
    assert stats["faults"]["shard_failovers"] == 0


@pytest.mark.parametrize("policy", ["checkpoint", "restart"])
def test_acceptance_trace_equals_reference(tmp_path, policy):
    """The same faulted trace through the reference and the port: equal
    per-job ids, epoch ends, ends and makespan, and equal counters."""
    ref, ref_stats = _acceptance_run(REF, policy, tmp_path, "ref")
    port, port_stats = _acceptance_run(PORT, policy, tmp_path, "port")
    assert port.makespan == ref.makespan
    for a, b in zip(ref.jobs, port.jobs):
        assert a.sample_ids == b.sample_ids, a.spec.name
        assert a.epoch_ends == b.epoch_ends, a.spec.name
        assert a.end_s == b.end_s
        assert (a.preemptions, a.worker_restarts) == \
            (b.preemptions, b.worker_restarts)
    assert port_stats["faults"] == ref_stats["faults"]
    assert port_stats["ods_hit_rate"] == ref_stats["ods_hit_rate"]
    assert port_stats["substitutions"] == ref_stats["substitutions"]


def test_acceptance_trace_on_torch_engine(tmp_path):
    """The faulted trace with the ODS step on tensors: coverage holds
    and two runs agree byte for byte (the generator is seeded)."""
    r1, stats = _acceptance_run(PORT, "checkpoint", tmp_path, "t1",
                                backend="torch")
    r2, _ = _acceptance_run(PORT, "checkpoint", tmp_path, "t2",
                            backend="torch")
    assert stats["backend"] == "torch"
    for a, b in zip(r1.jobs, r2.jobs):
        assert a.sample_ids == b.sample_ids
        assert _coverage_exact(a.sample_ids, 128), a.spec.name
    assert r1.makespan == r2.makespan
    assert stats["faults"]["counts"]["recovery.preempt-readmit"] == 1


def test_naive_restart_replays_but_still_covers(tmp_path):
    rec, _ = _acceptance_run(PORT, "checkpoint", tmp_path, "c")
    naive, _ = _acceptance_run(PORT, "restart", tmp_path, "n")
    for job in naive.jobs:
        assert _coverage_exact(job.sample_ids, 128), job.spec.name
    a_rec = next(j for j in rec.jobs if j.spec.name == "a")
    a_naive = next(j for j in naive.jobs if j.spec.name == "a")
    assert a_naive.samples == a_rec.samples
    assert a_naive.duration_s > a_rec.duration_s


# ----------------------------------------------------------------------
# The reference's acceptance trace: shard kill + spill corruption +
# preempt on two sim shards
def _sharded_acceptance_run(pkg, policy, tmp_path, tag, seed=0):
    ds = pkg["tiny"](n=128)
    spill = tmp_path / f"spill-{tag}"
    spill.mkdir()
    server = pkg["server"].for_dataset(
        ds, shards=2, cache_frac=0.3, seed=0, spill_dir=str(spill),
        spill_bytes=int(0.2 * 128 * ds.augmented_bytes()), **pkg["kw"])
    F = pkg["fault"]
    faults = [F("shard-kill", at_s=0.05, shard=1, duration_s=0.1),
              F("spill-corrupt", at_s=0.08, n_files=2),
              F("preempt", at_s=0.10, job="a", duration_s=0.06)]
    runner = pkg["runner"](server, pkg["storage"](ds), clock=pkg["clock"](),
                           seed=seed, faults=faults, fault_policy=policy)
    J = pkg["job"]
    res = runner.run([J("a", arrival_s=0.0, epochs=2, batch_size=16,
                        gpu_rate=1000),
                      J("b", arrival_s=0.02, epochs=2, batch_size=16,
                        gpu_rate=700)], timeout=300)
    stats = res.stats
    server.close()
    return res, stats


@pytest.mark.parametrize("policy", ["checkpoint", "restart"])
def test_sharded_acceptance_trace_equals_reference(tmp_path, policy):
    """The reference's faulted trace on ``shards=2`` (sim): coverage
    holds in the port, and its per-job ids, epoch ends, ends, makespan
    and fault counters equal the reference's."""
    ref, ref_stats = _sharded_acceptance_run(REF, policy, tmp_path, "ref")
    port, stats = _sharded_acceptance_run(PORT, policy, tmp_path, "port")
    for job in port.jobs:
        assert _coverage_exact(job.sample_ids, 128), job.spec.name
    assert sum(j.preemptions for j in port.jobs) == 1
    counts = stats["faults"]["counts"]
    assert counts["fault.shard-kill"] == 1
    assert counts["fault.spill-corrupt"] == 1
    assert counts["fault.preempt"] == 1
    assert counts["recovery.shard-restart"] == 1
    assert counts["recovery.preempt-readmit"] == 1
    assert stats["faults"]["shard_failovers"] > 0
    assert len(stats["shards"]) == 2
    assert port.makespan == ref.makespan
    for a, b in zip(ref.jobs, port.jobs):
        assert a.sample_ids == b.sample_ids, a.spec.name
        assert a.epoch_ends == b.epoch_ends, a.spec.name
        assert a.end_s == b.end_s
        assert (a.preemptions, a.worker_restarts) == \
            (b.preemptions, b.worker_restarts)
    assert stats["faults"] == ref_stats["faults"]
    assert stats["ods_hit_rate"] == ref_stats["ods_hit_rate"]


def _crash_run(pkg):
    ds = pkg["tiny"](n=64)
    server = pkg["server"].for_dataset(ds, cache_frac=0.4, seed=0,
                                       **pkg["kw"])
    runner = pkg["runner"](
        server, pkg["storage"](ds), clock=pkg["clock"](), seed=0,
        faults=[pkg["fault"]("worker-crash", at_s=0.03, job="a")])
    res = runner.run([pkg["job"]("a", arrival_s=0.0, epochs=2,
                                 batch_size=8, gpu_rate=1000)], timeout=300)
    server.close()
    return res


def test_worker_crash_recovery():
    res = _crash_run(PORT)
    job = res.jobs[0]
    assert job.worker_restarts == 1
    assert _coverage_exact(job.sample_ids, 64)
    ref = _crash_run(REF).jobs[0]
    assert job.sample_ids == ref.sample_ids
    assert job.end_s == ref.end_s


def test_unknown_fault_job_rejected():
    ds = tiny(n=32)
    server = _server(ds)
    runner = WorkloadRunner(
        server, RemoteStorage(ds), clock=VirtualClock(), seed=0,
        faults=[FaultSpec("preempt", at_s=0.1, job="ghost",
                          duration_s=0.1)])
    with pytest.raises(ValueError, match="ghost"):
        runner.run([JobSpec("a", arrival_s=0.0, epochs=1, batch_size=8,
                            gpu_rate=1000)], timeout=60)
    server.close()


@pytest.mark.parametrize("kind", ["shard-kill", "shard-restart"])
def test_shard_fault_needs_sharded_server(kind):
    """Shard faults on an unsharded server are refused up front, as the
    reference refuses them."""
    ds = tiny(n=32)
    server = _server(ds)
    runner = WorkloadRunner(
        server, RemoteStorage(ds), clock=VirtualClock(), seed=0,
        faults=[FaultSpec(kind, at_s=0.1, shard=0)])
    with pytest.raises(ValueError, match="shard faults need a shared "
                                         "sharded server"):
        runner.run([JobSpec("a", arrival_s=0.0, epochs=1, batch_size=8,
                            gpu_rate=1000)], timeout=60)
    assert server.n_sessions == 0
    server.close()


def test_bad_fault_policy_rejected():
    ds = tiny(n=32)
    server = _server(ds)
    with pytest.raises(ValueError):
        WorkloadRunner(server, RemoteStorage(ds), clock=VirtualClock(),
                       fault_policy="yolo")
    server.close()


def test_stats_carry_no_faults_block_without_faults():
    ds = tiny(n=32)
    server = _server(ds)
    with server.open_session(batch_size=8) as sess:
        sess.next_batch_ids()
    assert "faults" not in server.stats()
    server.close()
