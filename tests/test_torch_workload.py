"""The port's workload layer (``repro_torch.workload``) against the
reference.

Mirrors ``tests/test_workload.py`` (the VirtualClock contract, the runner
on real and virtual clocks, private-server baselines, pipeline hooks,
accounting) and the request-sampler half of ``tests/test_concurrency.py``,
then holds the port to the reference on the same inputs:

- request samplers (Zipfian, phase-shift) give equal request streams for
  equal seeds, and their state dicts round-trip across packages;
- the same VirtualClock trace (numpy ODS, per-sample executor, with and
  without the HBM tier) gives, per job, equal ``sample_ids``,
  ``epoch_ends`` and ``end_s``, an equal ``makespan``, and equal
  ``ods_hit_rate`` and ``substitutions``.

Tolerance: exact, except the live-vs-simulator hit rate, which keeps the
reference's 0.12 (a modelling tolerance, not noise).  The "torch" ODS
engine and the device executor run on the CPU here (``device="cpu"``).
"""
import threading
import time

import numpy as np
import pytest

pytest.importorskip("torch")

from repro.api import (AZURE_NC96, DSISimulator, DatasetProfile,  # noqa: E402
                       SENECA, SimJob)
from repro.api import JobSpec as RefJobSpec  # noqa: E402
from repro.api import SenecaServer as RefServer  # noqa: E402
from repro.api import VirtualClock as RefClock  # noqa: E402
from repro.data.storage import RemoteStorage as RefStorage  # noqa: E402
from repro.data.synthetic import tiny as ref_tiny  # noqa: E402
from repro.workload import PhaseShiftSampler as RefPhaseShift  # noqa: E402
from repro.workload import ZipfianSampler as RefZipfian  # noqa: E402

from repro_torch.api import (JobSpec, SenecaServer,  # noqa: E402
                             VirtualClock, WorkloadRunner)
from repro_torch.data.pipeline import DSIPipeline  # noqa: E402
from repro_torch.data.storage import RemoteStorage  # noqa: E402
from repro_torch.data.synthetic import tiny  # noqa: E402
from repro_torch.workload import (PhaseShiftSampler,  # noqa: E402
                                  ZipfianSampler, make_request_sampler)
from repro_torch.workload.clock import RealClock  # noqa: E402


def _server(ds, **kw):
    kw.setdefault("cache_frac", 0.4)
    kw.setdefault("seed", 0)
    kw.setdefault("device", "cpu")
    return SenecaServer.for_dataset(ds, **kw)


# ----------------------------------------------------------------------
# VirtualClock semantics
def test_virtual_clock_serializes_in_wake_order():
    clock = VirtualClock()
    t0, t1, t2 = clock.register(), clock.register(), clock.register()
    order = []
    lock = threading.Lock()

    def body(ticket, wakes):
        for w in wakes:
            now = clock.sleep_until(ticket, w)
            with lock:
                order.append((now, ticket))
        clock.unregister(ticket)

    threads = [threading.Thread(target=body, args=args) for args in
               ((t0, [1.0, 3.0]), (t1, [1.0, 2.0]), (t2, [0.5, 5.0]))]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=30.0)
    assert not any(t.is_alive() for t in threads)
    assert order == [(0.5, t2), (1.0, t0), (1.0, t1), (2.0, t1),
                     (3.0, t0), (5.0, t2)]
    assert clock.now() == 5.0


def test_virtual_clock_never_goes_backwards():
    clock = VirtualClock(start=10.0)
    t = clock.register()
    done = []

    def body():
        done.append(clock.sleep_until(t, 3.0))
        clock.unregister(t)

    th = threading.Thread(target=body)
    th.start()
    th.join(timeout=10.0)
    assert done == [10.0]


def test_virtual_clock_unregistered_ticket_rejected():
    clock = VirtualClock()
    with pytest.raises(RuntimeError, match="not registered"):
        clock.sleep_until(99, 1.0)


def test_virtual_clock_interrupt_unblocks():
    clock = VirtualClock()
    t0, t1 = clock.register(), clock.register()   # t1 never sleeps
    stop = threading.Event()
    out = []

    def body():
        out.append(clock.sleep_until(t0, 1.0, interrupt=stop))
        clock.unregister(t0)

    th = threading.Thread(target=body)
    th.start()
    time.sleep(0.1)
    stop.set()
    th.join(timeout=10.0)
    assert not th.is_alive(), "interrupted sleep must not deadlock"
    clock.unregister(t1)


def test_real_clock_sleep_until_interruptible():
    clock = RealClock()
    t = clock.register()
    stop = threading.Event()
    stop.set()
    t0 = time.monotonic()
    clock.sleep_until(t, time.monotonic() + 5.0, interrupt=stop)
    assert time.monotonic() - t0 < 1.0
    clock.unregister(t)


# ----------------------------------------------------------------------
# runner basics (real clock)
def test_runner_epochs_coverage_and_arrival_order():
    ds = tiny(n=96)
    server = _server(ds, use_ods=False)
    runner = WorkloadRunner(server, RemoteStorage(ds))
    res = runner.run([
        JobSpec("a", arrival_s=0.0, epochs=2, batch_size=12,
                gpu_rate=4000, n_workers=2),
        JobSpec("b", arrival_s=0.2, epochs=1, batch_size=12,
                gpu_rate=4000, n_workers=2),
    ], timeout=120)
    server.close()
    assert res.ok
    a, b = res.job("a"), res.job("b")
    assert a.samples == 2 * 96 and a.epochs_completed == 2
    assert b.samples == 96 and b.epochs_completed == 1
    assert b.start_s >= 0.2 > a.start_s
    for job in (a, b):
        for e in range(job.epochs_completed):
            epoch_ids = job.sample_ids[e * 96:(e + 1) * 96]
            assert sorted(epoch_ids) == list(range(96))
    assert res.makespan >= max(a.end_s, b.end_s)
    assert res.stats["n_sessions"] == 0


def test_runner_gpu_rate_paces_consumption():
    ds = tiny(n=64)
    server = _server(ds)
    runner = WorkloadRunner(server, RemoteStorage(ds))
    res = runner.run([JobSpec("slow", epochs=1, batch_size=16,
                              gpu_rate=160, n_workers=2)], timeout=120)
    server.close()
    assert res.ok
    assert res.jobs[0].duration_s >= 0.35
    assert res.wall_s >= 0.35


def test_runner_cancel_joins_promptly():
    ds = tiny(n=256)
    server = _server(ds)
    runner = WorkloadRunner(server, RemoteStorage(ds), record_ids=False)
    trace = [JobSpec(f"j{i}", epochs=50, batch_size=16, gpu_rate=300,
                     n_workers=2) for i in range(2)]
    threading.Timer(0.4, runner.cancel).start()
    res = runner.run(trace, timeout=60, raise_on_error=False)
    server.close()
    assert all(j.cancelled for j in res.jobs)
    assert res.wall_s < 30.0
    assert not res.ok


def test_runner_validates_trace_and_construction():
    ds = tiny(n=32)
    server = _server(ds)
    storage = RemoteStorage(ds)
    with pytest.raises(ValueError, match="exactly one"):
        WorkloadRunner(server, storage, server_factory=lambda s: server)
    with pytest.raises(ValueError, match="exactly one"):
        WorkloadRunner(storage=storage)
    with pytest.raises(TypeError, match="RemoteStorage"):
        WorkloadRunner(server)
    runner = WorkloadRunner(server, storage)
    with pytest.raises(ValueError, match="empty workload"):
        runner.run([])
    with pytest.raises(ValueError, match="duplicate job names"):
        runner.run([JobSpec("x"), JobSpec("x")])
    with pytest.raises(ValueError, match="epochs"):
        JobSpec("bad", epochs=0)
    with pytest.raises(ValueError, match="gpu_rate"):
        JobSpec("bad", gpu_rate=0.0)
    with pytest.raises(ValueError, match="unknown executor"):
        JobSpec("bad", executor="warp-speed")
    vrunner = WorkloadRunner(server, storage, clock=VirtualClock())
    for executor in ("stage-parallel", "device"):
        with pytest.raises(ValueError, match="per-sample"):
            vrunner.run([JobSpec("sp", executor=executor)])
    assert server.n_sessions == 0
    server.close()


def test_runner_job_error_surfaces_after_join():
    ds = tiny(n=64)
    server = _server(ds)

    class BrokenStorage(RemoteStorage):
        def fetch(self, sample_id):
            raise IOError("storage down")

    runner = WorkloadRunner(server, BrokenStorage(ds))
    with pytest.raises(RuntimeError, match="workload jobs failed"):
        runner.run([JobSpec("a", epochs=1, batch_size=8, n_workers=1)],
                   timeout=60)
    res = runner.run([JobSpec("a", epochs=1, batch_size=8, n_workers=1)],
                     timeout=60, raise_on_error=False)
    assert res.jobs[0].error is not None and not res.ok
    server.close()
    assert server.service.backend.n_jobs >= 1


def test_server_run_workload_convenience():
    ds = tiny(n=64)
    server = _server(ds)
    res = server.run_workload(
        [JobSpec("a", epochs=1, batch_size=16, n_workers=2)],
        RemoteStorage(ds), record_ids=False, timeout=120,
        raise_on_error=True)
    server.close()
    assert res.ok and res.total_samples == 64
    assert res.stats is not None and res.clock == "real"
    assert res.shard_stats is None


def test_pipeline_construction_failure_closes_session(monkeypatch):
    import repro_torch.workload.runner as runner_mod
    ds = tiny(n=64)
    server = _server(ds)

    def boom(*a, **kw):
        raise RuntimeError("pipeline ctor boom")

    monkeypatch.setattr(runner_mod, "DSIPipeline", boom)
    runner = WorkloadRunner(server, RemoteStorage(ds))
    res = runner.run([JobSpec("a", epochs=1, batch_size=8)],
                     timeout=60, raise_on_error=False)
    assert res.jobs[0].error is not None
    assert server.n_sessions == 0, "leaked session after ctor failure"
    server.close()


# ----------------------------------------------------------------------
# virtual-clock determinism, and the same trace through both packages
TRACE = (("a", 0.0, 2, 16, 1000), ("b", 0.05, 2, 16, 500),
         ("c", 0.10, 1, 8, 2000))


def _virtual_run(ref=False, n=128, seed=0, hbm=False, backend="numpy",
                 trace=TRACE):
    mk_tiny, Server, Job, Clock, Storage = \
        (ref_tiny, RefServer, RefJobSpec, RefClock, RefStorage) if ref \
        else (tiny, SenecaServer, JobSpec, VirtualClock, RemoteStorage)
    ds = mk_tiny(n=n)
    kw = {} if ref else {"device": "cpu"}
    if backend != "numpy":
        kw["backend"] = backend
    if hbm:
        kw["device_cache_bytes"] = int(0.3 * n * ds.augmented_bytes())
    server = Server.for_dataset(ds, cache_frac=0.4, seed=seed, **kw)
    res = server.run_workload([Job(*spec) for spec in trace], Storage(ds),
                              clock=Clock(), seed=seed, timeout=300)
    stats = res.stats
    server.close()
    return res, stats


def _assert_same_run(res1, stats1, res2, stats2):
    for j1, j2 in zip(res1.jobs, res2.jobs):
        assert j1.sample_ids == j2.sample_ids, j1.spec.name
        assert j1.epoch_ends == j2.epoch_ends, j1.spec.name
        assert j1.end_s == j2.end_s
    assert res1.makespan == res2.makespan
    assert stats1["ods_hit_rate"] == stats2["ods_hit_rate"]
    assert stats1["substitutions"] == stats2["substitutions"]


def test_virtual_clock_runs_are_deterministic():
    res1, stats1 = _virtual_run()
    res2, stats2 = _virtual_run()
    _assert_same_run(res1, stats1, res2, stats2)
    assert res1.clock == "virtual"


@pytest.mark.parametrize("hbm", [False, True], ids=["dram", "hbm"])
def test_virtual_trace_equals_reference(hbm):
    """The reference's determinism traces (tests/test_workload.py:256 and
    :271) through both packages: equal per-job ids, epoch ends and ends,
    equal makespan, hit rate and substitutions."""
    ref = _virtual_run(ref=True, hbm=hbm)
    port = _virtual_run(hbm=hbm)
    _assert_same_run(*ref, *port)
    if hbm:
        assert port[1]["hbm_bytes_used"] == ref[1]["hbm_bytes_used"]
        assert port[1]["residency_counts"] == ref[1]["residency_counts"]


def test_virtual_clock_deterministic_with_hbm_tier():
    trace = TRACE[:2]
    _assert_same_run(*_virtual_run(hbm=True, trace=trace),
                     *_virtual_run(hbm=True, trace=trace))


def test_virtual_clock_deterministic_on_torch_engine():
    """The ODS step on tensors under the VirtualClock: a seeded
    generator drawn in a reproducible order gives byte-identical runs,
    every job covers every id per epoch, and the run lands in the same
    hit-rate regime as the numpy engine's."""
    res1, stats1 = _virtual_run(backend="torch", hbm=True)
    res2, stats2 = _virtual_run(backend="torch", hbm=True)
    _assert_same_run(res1, stats1, res2, stats2)
    assert stats1["backend"] == "torch"
    for j in res1.jobs:
        for e in range(j.spec.epochs):
            assert sorted(j.sample_ids[e * 128:(e + 1) * 128]) == \
                list(range(128))
    ref = _virtual_run(hbm=True)[1]
    assert stats1["substitutions"] > 0
    assert stats1["ods_hit_rate"] == pytest.approx(ref["ods_hit_rate"],
                                                   abs=0.1)


def test_virtual_clock_interleaving_respects_rates():
    res, _stats = _virtual_run()
    a, b, c = res.job("a"), res.job("b"), res.job("c")
    assert res.ok
    assert b.end_s == res.makespan > a.end_s
    for j in res.jobs:
        assert j.epoch_ends == sorted(j.epoch_ends)
        assert j.samples == j.spec.epochs * 128
    assert b.end_s == pytest.approx(0.05 + 256 / 500, abs=1e-9)


def test_live_virtual_run_matches_simulator_hit_rate():
    """The port's live stack (virtual clock) and the reference's
    DSISimulator on the same 2-job trace agree on the serve-level cache
    hit rate (the reference's own 0.12 modelling tolerance), and the
    port's rate equals the reference's live one exactly."""
    n, batch, epochs, rate = 256, 16, 2, 2000
    rates = []
    for Server, mk_tiny, Job, Clock, Storage, kw in (
            (SenecaServer, tiny, JobSpec, VirtualClock, RemoteStorage,
             {"device": "cpu"}),
            (RefServer, ref_tiny, RefJobSpec, RefClock, RefStorage, {})):
        ds = mk_tiny(n=n)
        cache_bytes = int(0.35 * n * ds.augmented_bytes())
        server = Server.for_dataset(ds, cache_bytes=cache_bytes, seed=0,
                                    **kw)
        res = server.run_workload(
            [Job("a", 0.0, epochs, batch, rate),
             Job("b", 0.0, epochs, batch, rate)], Storage(ds),
            clock=Clock(), record_ids=False, timeout=300)
        hit_rates = res.stats["telemetry"]["hit_rates"]
        rates.append(1.0 - hit_rates.get("storage", 0.0))
        server.close()
        assert res.ok
    live, ref_live = rates
    assert live == ref_live
    profile = DatasetProfile(ds.name, n, ds.mean_encoded_bytes,
                             decoded_bytes=ds.decoded_bytes(),
                             augmented_bytes=ds.augmented_bytes())
    sim = DSISimulator(AZURE_NC96, profile, SENECA,
                       cache_bytes=cache_bytes, seed=0)
    sim_res = sim.run([SimJob(0, gpu_rate=rate, batch_size=batch,
                              epochs=epochs),
                       SimJob(1, gpu_rate=rate, batch_size=batch,
                              epochs=epochs)])
    assert live == pytest.approx(sim_res.hit_rate, abs=0.12), \
        f"live={live:.3f} sim={sim_res.hit_rate:.3f}"
    assert live > 0.5 and sim_res.hit_rate > 0.5


# ----------------------------------------------------------------------
# the card's path, on the CPU: the device executor and the torch engine
def test_real_clock_device_executor_on_torch_engine():
    """Three jobs on one shared cache under a real clock, each running
    the device executor, with the ODS step on tensors: every job serves
    every id exactly once (the generator is drawn only under the
    service's lock while the job threads race), and substitutions
    happen."""
    ds = tiny(n=96)
    server = _server(ds, backend="torch",
                     device_cache_bytes=int(0.5 * 96 * ds.augmented_bytes()),
                     split=(0.0, 0.0, 1.0), hbm_split=(0.0, 0.0, 1.0),
                     cache_frac=0.25)
    res = server.run_workload(
        [JobSpec(f"j{i}", arrival_s=0.02 * i, epochs=1, batch_size=16,
                 executor="device") for i in range(3)],
        RemoteStorage(ds), timeout=120)
    server.close()
    assert res.ok and res.stats["backend"] == "torch"
    for j in res.jobs:
        assert sorted(j.sample_ids) == list(range(96)), j.spec.name
    assert res.stats["substitutions"] > 0


# ----------------------------------------------------------------------
# private-server baseline mode
def test_private_server_factory_mode():
    ds = tiny(n=64)
    storage = RemoteStorage(ds)
    made = []

    def factory(spec):
        srv = _server(ds, use_ods=False, split=(1.0, 0.0, 0.0),
                      eviction="lru")
        made.append(srv)
        return srv

    runner = WorkloadRunner(server_factory=factory, storage=storage)
    res = runner.run([JobSpec("a", epochs=1, batch_size=16, n_workers=2),
                      JobSpec("b", epochs=1, batch_size=16, n_workers=2)],
                     timeout=120)
    assert res.ok and len(made) == 2
    assert res.stats is None
    for j in res.jobs:
        assert j.stats is not None
        assert j.stats["n_sessions"] == 0
    assert all(s.n_sessions == 0 for s in made)


# ----------------------------------------------------------------------
# pipeline hooks + accounting
def test_pipeline_consume_hook_fires_per_batch():
    ds = tiny(n=32)
    server = _server(ds)
    calls = []
    pipe = DSIPipeline(server.open_session(batch_size=8),
                       RemoteStorage(ds), n_workers=1,
                       consume_hook=lambda b: calls.append(
                           b["ids"].tolist()))
    got = [pipe.next_batch()["ids"].tolist() for _ in range(3)]
    assert calls == got
    pipe.stop()
    server.close()
    assert np.asarray(got).shape == (3, 8)


def test_pipeline_consume_hook_fires_on_stage_parallel_get():
    ds = tiny(n=48)
    server = _server(ds)
    calls = []
    pipe = DSIPipeline(server.open_session(batch_size=8),
                       RemoteStorage(ds), n_workers=2,
                       executor="stage-parallel",
                       consume_hook=lambda b: calls.append(
                           b["ids"].tolist()))
    got = [pipe.get(timeout=60.0)["ids"].tolist() for _ in range(3)]
    assert calls == got
    pipe.stop()
    server.close()


def test_non_dividing_batch_size_exact_accounting():
    ds = tiny(n=96)
    server = _server(ds, use_ods=False)
    runner = WorkloadRunner(server, RemoteStorage(ds))
    res = runner.run([JobSpec("odd", epochs=2, batch_size=20,
                              gpu_rate=5_000, n_workers=2)], timeout=120)
    server.close()
    job = res.jobs[0]
    epoch_size = (96 // 20) * 20
    assert job.samples == 2 * epoch_size
    assert job.batches == 2 * epoch_size // 20
    assert job.epochs_completed == 2
    server2 = _server(ds)
    runner2 = WorkloadRunner(server2, RemoteStorage(ds))
    with pytest.raises(RuntimeError, match="exceeds the dataset"):
        runner2.run([JobSpec("huge", batch_size=200)], timeout=60)
    server2.close()


def test_timeout_expiry_raises_instead_of_truncating():
    ds = tiny(n=256)
    server = _server(ds)
    storage = RemoteStorage(ds)
    trace = [JobSpec("long", epochs=100, batch_size=16, gpu_rate=200,
                     n_workers=2)]
    with pytest.raises(RuntimeError, match="timed out"):
        WorkloadRunner(server, storage,
                       record_ids=False).run(trace, timeout=0.4)
    res = WorkloadRunner(server, storage, record_ids=False).run(
        trace, timeout=0.4, raise_on_error=False)
    assert res.timed_out and res.jobs[0].cancelled and not res.ok
    server.close()


# ----------------------------------------------------------------------
# request samplers (tests/test_concurrency.py's TestRequestSamplers) and
# their equality with the reference's
def test_zipfian_distinct_deterministic_and_skewed():
    a = ZipfianSampler(256, 32, seed=1)
    b = ZipfianSampler(256, 32, seed=1)
    counts = np.zeros(256, np.int64)
    for _ in range(40):
        ra, rb = a.next_request(), b.next_request()
        assert np.array_equal(ra, rb)
        assert len(set(ra.tolist())) == len(ra)
        assert ra.min() >= 0 and ra.max() < 256
        counts[ra] += 1
    hot = a._ranks[:32]
    cold = a._ranks[-32:]
    assert counts[hot].sum() > counts[cold].sum()


def test_zipfian_state_roundtrip():
    a = ZipfianSampler(128, 16, seed=7)
    for _ in range(5):
        a.next_request()
    snap = a.state_dict()
    expect = [a.next_request() for _ in range(3)]
    b = ZipfianSampler(128, 16, seed=99)
    b.load_state_dict(snap)
    got = [b.next_request() for _ in range(3)]
    for e, g in zip(expect, got):
        assert np.array_equal(e, g)
    with pytest.raises(ValueError):
        ZipfianSampler(64, 16, seed=0).load_state_dict(snap)


def test_phase_shift_slides_window():
    s = PhaseShiftSampler(256, 16, seed=3, window_frac=0.25,
                          period=4, shift_frac=0.5)
    first_phase = np.concatenate([s.next_request() for _ in range(4)])
    assert first_phase.max() < s.window
    s.next_request()
    assert s._offset == s.shift
    snap = s.state_dict()
    expect = [s.next_request() for _ in range(3)]
    r = PhaseShiftSampler(256, 16, seed=8, window_frac=0.25,
                          period=4, shift_frac=0.5)
    r.load_state_dict(snap)
    for e in expect:
        assert np.array_equal(e, r.next_request())


def test_factory_and_jobspec_validation():
    s = make_request_sampler("zipfian", 64, 8, seed=0)
    assert isinstance(s, ZipfianSampler)
    assert make_request_sampler(None, 64, 8, seed=0).n == 64
    with pytest.raises(ValueError, match="unknown request sampler"):
        make_request_sampler("nope", 64, 8, seed=0)
    spec = JobSpec(name="j", batch_size=4, sampler="phase-shift")
    assert spec.sampler == "phase-shift"
    with pytest.raises(ValueError):
        JobSpec(name="j", batch_size=4, sampler="bogus")


@pytest.mark.parametrize("port_cls,ref_cls", [
    (ZipfianSampler, RefZipfian), (PhaseShiftSampler, RefPhaseShift)],
    ids=["zipfian", "phase-shift"])
def test_request_samplers_equal_reference(port_cls, ref_cls):
    """Equal seeds give equal request streams, and a state dict taken
    from one package resumes the same stream in the other."""
    port, ref = port_cls(200, 16, seed=4), ref_cls(200, 16, seed=4)
    for _ in range(20):
        np.testing.assert_array_equal(port.next_request(),
                                      ref.next_request())
    resumed = port_cls(200, 16, seed=0)
    resumed.load_state_dict(ref.state_dict())
    back = ref_cls(200, 16, seed=0)
    back.load_state_dict(port.state_dict())
    for _ in range(5):
        want = ref.next_request()
        np.testing.assert_array_equal(resumed.next_request(), want)
        np.testing.assert_array_equal(back.next_request(), want)


@pytest.mark.parametrize("sampler", ["zipfian", "phase-shift"])
def test_named_sampler_sessions_equal_reference(sampler):
    """open_session(sampler=...) in both packages: equal served ids
    batch by batch (numpy ODS), and the same checkpoint format."""
    out = []
    for Server, mk_tiny, kw in ((SenecaServer, tiny, {"device": "cpu"}),
                                (RefServer, ref_tiny, {})):
        ds = mk_tiny(n=96)
        server = Server.for_dataset(ds, cache_frac=0.4, seed=0, **kw)
        with server.open_session(batch_size=8, sampler=sampler) as sess:
            ids = [sess.next_batch_ids()[0].tolist() for _ in range(6)]
            kind = sess.checkpoint_state()["sampler"]["kind"]
        out.append((ids, kind))
        server.close()
    assert out[0] == out[1]
    assert out[0][1] == sampler
