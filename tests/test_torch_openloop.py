"""The port's open-loop serving (``repro_torch.workload.openloop``)
against the reference.

Mirrors ``tests/test_openloop.py``: exact nearest-rank percentiles,
seed-reproducible arrival schedules, a VirtualClock burst trace whose
per-request latencies are identical across runs, SLO admission control
under overload, and the clock-correctness fixes (token-bucket pacing on
the pluggable clock, repartition cooldown on the service clock, sub-poll
``get`` timeouts).  Then the port is held to the reference:

- ``poisson_arrivals``, ``bursty_arrivals`` and ``diurnal_arrivals``
  give equal arrays for equal seeds;
- the VirtualClock burst trace gives equal per-request outcomes and
  latencies, equal outcome counts and an equal p99.

Tolerance: exact (the reference's own ``approx`` checks of rates and
virtual stall seconds are kept as they are).
"""
import queue
import time

import numpy as np
import pytest

pytest.importorskip("torch")

from repro.api import SLO as RefSLO  # noqa: E402
from repro.api import SenecaServer as RefServer  # noqa: E402
from repro.data.storage import RemoteStorage as RefStorage  # noqa: E402
from repro.data.synthetic import tiny as ref_tiny  # noqa: E402
from repro.workload import OpenLoopGenerator as RefGenerator  # noqa: E402
from repro.workload import VirtualClock as RefClock  # noqa: E402
from repro.workload import make_arrivals as ref_make_arrivals  # noqa: E402

from repro_torch.api import SLO, SenecaServer  # noqa: E402
from repro_torch.api.telemetry import quantile  # noqa: E402
from repro_torch.data.pipeline import DSIPipeline  # noqa: E402
from repro_torch.data.storage import (BandwidthBudget,  # noqa: E402
                                      RemoteStorage)
from repro_torch.data.synthetic import SyntheticDataset, tiny  # noqa: E402
from repro_torch.workload import (ARRIVAL_PROCESSES,  # noqa: E402
                                  OpenLoopGenerator, VirtualClock,
                                  bursty_arrivals, diurnal_arrivals,
                                  make_arrivals, poisson_arrivals)


def _server(ds, **kw):
    kw.setdefault("cache_frac", 0.3)
    kw.setdefault("seed", 0)
    kw.setdefault("device", "cpu")
    return SenecaServer.for_dataset(ds, **kw)


# ----------------------------------------------------------------------
# percentile math
def test_quantile_exact_on_known_samples():
    xs = list(range(1, 101))
    assert quantile(xs, 0.50) == 50
    assert quantile(xs, 0.99) == 99
    assert quantile(xs, 0.999) == 100
    assert quantile(xs, 1.0) == 100
    assert quantile(xs, 0.0) == 1


def test_quantile_is_always_an_observed_sample():
    xs = [3.0, 1.0, 4.0, 1.5, 9.0]
    for q in (0.0, 0.25, 0.5, 0.9, 0.99, 1.0):
        assert quantile(xs, q) in xs
    assert quantile([7.5], 0.99) == 7.5


def test_quantile_rejects_bad_input():
    with pytest.raises(ValueError):
        quantile([], 0.5)
    with pytest.raises(ValueError):
        quantile([1.0], 1.5)
    with pytest.raises(ValueError):
        quantile([1.0], -0.1)


# ----------------------------------------------------------------------
# arrival schedules
def test_arrivals_seed_reproducible_and_sorted():
    for proc in ("poisson", "bursty", "diurnal"):
        a = make_arrivals(proc, rate=200.0, n=300, seed=5)
        b = make_arrivals(proc, rate=200.0, n=300, seed=5)
        c = make_arrivals(proc, rate=200.0, n=300, seed=6)
        assert np.array_equal(a, b)
        assert not np.array_equal(a, c)
        assert np.all(np.diff(a) >= 0) and a.shape == (300,)


@pytest.mark.parametrize("proc", ARRIVAL_PROCESSES)
def test_arrivals_equal_reference(proc):
    for seed in (0, 5):
        np.testing.assert_array_equal(
            make_arrivals(proc, rate=120.0, n=400, seed=seed),
            ref_make_arrivals(proc, rate=120.0, n=400, seed=seed))


def test_poisson_mean_rate_roughly_right():
    a = poisson_arrivals(100.0, n=5_000, seed=0)
    assert a[-1] == pytest.approx(50.0, rel=0.1)


def test_arrival_validation():
    with pytest.raises(ValueError):
        make_arrivals("weibull", 10.0, 10)
    with pytest.raises(ValueError):
        poisson_arrivals(0.0, 10)
    with pytest.raises(ValueError):
        bursty_arrivals(10.0, 10, burst_factor=8.0, duty=0.25)
    with pytest.raises(ValueError):
        diurnal_arrivals(10.0, 10, depth=1.5)


def test_slo_validation():
    SLO(p99_target_s=0.1)
    with pytest.raises(ValueError):
        SLO(p99_target_s=0.0)
    with pytest.raises(ValueError):
        SLO(p99_target_s=0.1, max_queue=0)
    with pytest.raises(ValueError):
        SLO(p99_target_s=0.1, degrade_frac=0.9, encode_frac=0.5)


# ----------------------------------------------------------------------
# open-loop serving under VirtualClock, through either package
def _run_open_loop(arrivals, slo, *, seed=0, n_samples=96, ref=False):
    Server, mk_tiny, Storage, Clock, Gen, kw = \
        (RefServer, ref_tiny, RefStorage, RefClock, RefGenerator, {}) \
        if ref else (SenecaServer, tiny, RemoteStorage, VirtualClock,
                     OpenLoopGenerator, {"device": "cpu"})
    ds = mk_tiny(n=n_samples)
    server = Server.for_dataset(ds, cache_frac=0.3, seed=0, **kw)
    clock = Clock()
    storage = Storage(ds, bandwidth=4e6, clock=clock)
    gen = Gen(server, storage, clock=clock, slo=slo, n_workers=2,
              seed=seed, phase_costs={"decode": 0.004, "augment": 0.003})
    res = gen.run(arrivals)
    stats = server.stats()
    server.close()
    return res, stats


def _per_request(res):
    return [(r.req_id, r.sample_id, r.total_s, r.queue_s, r.fetch_s,
             r.decode_s, r.augment_s, r.outcome, r.level, r.form)
            for r in res.requests]


def test_virtual_clock_burst_trace_deterministic_p99():
    arrivals = bursty_arrivals(rate=350.0, n=250, seed=11)
    r1, _ = _run_open_loop(arrivals, None)
    r2, _ = _run_open_loop(arrivals, None)
    assert _per_request(r1) == _per_request(r2)
    assert r1.percentiles() == r2.percentiles()
    assert r1.percentiles()["p99"] > 0
    assert any(r.fetch_s > 0 for r in r1.requests)


@pytest.mark.parametrize("controlled", [False, True],
                         ids=["uncontrolled", "slo"])
def test_virtual_burst_trace_equals_reference(controlled):
    """The reference's burst trace (tests/test_openloop.py:141) through
    both packages: equal per-request outcomes and latencies, equal
    counts, equal p99 — without and with SLO admission control."""
    arrivals = bursty_arrivals(rate=350.0, n=250, seed=11)
    port, port_stats = _run_open_loop(
        arrivals, SLO(p99_target_s=0.03, max_queue=32) if controlled
        else None)
    ref, ref_stats = _run_open_loop(
        arrivals, RefSLO(p99_target_s=0.03, max_queue=32) if controlled
        else None, ref=True)
    assert _per_request(port) == _per_request(ref)
    assert port.counts == ref.counts
    assert port.percentiles() == ref.percentiles()
    assert port.percentiles()["p99"] == ref.percentiles()["p99"] > 0
    assert port.makespan_s == ref.makespan_s
    assert port_stats["telemetry"]["requests"] == \
        ref_stats["telemetry"]["requests"]


def test_overload_sheds_instead_of_queueing_unboundedly():
    arrivals = poisson_arrivals(500.0, n=400, seed=3)
    slo = SLO(p99_target_s=0.05, max_queue=64)
    uncontrolled, _ = _run_open_loop(arrivals, None)
    controlled, stats = _run_open_loop(arrivals, slo)
    assert uncontrolled.counts["shed"] == 0
    c = controlled.counts
    assert c["shed"] > 0
    assert c["shed"] + c["degraded"] + c["encoded"] + c["served"] == 400
    assert controlled.percentiles()["p99"] \
        < uncontrolled.percentiles()["p99"]
    assert max(r.queue_s for r in controlled.completed) \
        < max(r.queue_s for r in uncontrolled.completed)
    req = stats["telemetry"]["requests"]
    assert req["outcomes"]["shed"] == c["shed"]
    assert req["latency_s"]["p99"] > 0


def test_degrade_caps_work_not_cached_quality():
    ds = tiny(n=8)
    server = _server(ds, cache_frac=1.0)
    clock = VirtualClock()
    storage = RemoteStorage(ds, clock=clock)
    gen = OpenLoopGenerator(server, storage, clock=clock, slo=None,
                            n_workers=1, seed=0)
    warm = gen.run(np.linspace(0.001, 0.02, 16),
                   sample_ids=list(range(8)) * 2)
    assert all(r.outcome == "served" for r in warm.requests)
    gen2 = OpenLoopGenerator(server, storage, clock=VirtualClock(),
                             slo=SLO(p99_target_s=1.0), n_workers=1,
                             seed=0)
    res = gen2.run(np.linspace(0.001, 0.01, 8),
                   sample_ids=list(range(8)))
    assert all(r.outcome == "served" and r.form == "augmented"
               for r in res.requests)
    server.close()


def test_hbm_hits_reach_the_consumer_as_host_arrays():
    """With an HBM tier (on the CPU here) an augmented hit is a device
    tensor; the generator hands the consumer host arrays, equal to the
    host-tier run's values."""
    ds = tiny(n=8)
    got = {}
    for hbm in (False, True):
        kw = dict(split=(0.0, 0.0, 1.0), cache_frac=1.0)
        if hbm:
            kw.update(device_cache_bytes=8 * ds.augmented_bytes(),
                      hbm_split=(0.0, 0.0, 1.0))
        server = _server(ds, **kw)
        clock = VirtualClock()
        values = {}
        gen = OpenLoopGenerator(
            server, RemoteStorage(ds, clock=clock), clock=clock, slo=None,
            n_workers=1, seed=0,
            consumer=lambda r, v: values.setdefault(
                (r.req_id, r.form), v))
        gen.run(np.linspace(0.001, 0.02, 16), sample_ids=list(range(8)) * 2)
        if hbm:
            assert server.stats()["residency_counts"]["hbm"] > 0
        server.close()
        got[hbm] = values
    assert got[False].keys() == got[True].keys()
    for key, v in got[True].items():
        assert isinstance(v, np.ndarray)
        np.testing.assert_array_equal(v, got[False][key])


def test_run_validates_schedule():
    ds = tiny(n=8)
    server = _server(ds)
    gen = OpenLoopGenerator(server, RemoteStorage(ds),
                            clock=VirtualClock(), slo=None)
    with pytest.raises(ValueError, match="empty"):
        gen.run([])
    with pytest.raises(ValueError, match="sorted"):
        gen.run([0.2, 0.1])
    with pytest.raises(ValueError, match="sample_ids"):
        gen.run([0.1, 0.2], sample_ids=[1])
    with pytest.raises(ValueError, match="n_workers"):
        OpenLoopGenerator(server, RemoteStorage(ds), n_workers=0)
    server.close()


# ----------------------------------------------------------------------
# token bucket on the pluggable clock
def test_bandwidth_budget_charges_virtual_time():
    clock = VirtualClock()
    ticket = clock.register()
    clock.bind(ticket)
    try:
        budget = BandwidthBudget(1000.0, clock=clock)
        wall0 = time.monotonic()
        stall = budget.consume(5000)
        assert stall == pytest.approx(5.0)
        assert clock.now() == pytest.approx(5.0)
        assert time.monotonic() - wall0 < 1.0
        budget.rate = 100.0
        budget.consume(1000)
        assert clock.now() == pytest.approx(15.0)
    finally:
        clock.unbind()
        clock.unregister(ticket)


def test_bandwidth_budget_wall_clock_default_unchanged():
    budget = BandwidthBudget(1e9)
    assert budget.clock is None
    t0 = time.monotonic()
    budget.consume(1000)
    assert time.monotonic() - t0 < 0.5
    assert budget.bytes_served == 1000


def test_remote_storage_degrade_with_virtual_clock():
    ds = tiny(n=16)
    clock = VirtualClock()
    ticket = clock.register()
    clock.bind(ticket)
    try:
        storage = RemoteStorage(ds, bandwidth=1e6, clock=clock)
        storage.fetch(0)
        t_normal = clock.now()
        storage.degrade(0.1)
        storage.fetch(1)
        t_degraded = clock.now() - t_normal
        storage.restore_bandwidth()
        assert t_degraded > 5 * t_normal
        assert storage.degraded_fetches == 1
    finally:
        clock.unbind()
        clock.unregister(ticket)


# ----------------------------------------------------------------------
# repartition cooldown on the service clock
class _FakeClock:
    def __init__(self):
        self.t = 0.0

    def now(self):
        return self.t


def test_repartition_cooldown_uses_service_clock():
    ds = tiny(n=64)
    server = _server(ds, repartition="adaptive",
                     repartition_cooldown=100.0)
    ctl = server.service.controller
    fake = _FakeClock()
    server.service.set_clock(fake)
    ctl.tick()
    first_tick = ctl._last_tick
    assert first_tick == 0.0
    fake.t = 50.0
    ctl.tick()
    assert ctl._last_tick == first_tick
    fake.t = 150.0
    ctl.tick()
    assert ctl._last_tick == 150.0
    server.close()


# ----------------------------------------------------------------------
# sub-poll timeouts
def test_per_sample_get_honors_sub_poll_timeout():
    ds = tiny(n=32)
    server = _server(ds)
    pipe = DSIPipeline(server.open_session(batch_size=8),
                       RemoteStorage(ds))
    try:
        t0 = time.monotonic()
        with pytest.raises(queue.Empty):
            pipe.get(timeout=0.05)
        assert time.monotonic() - t0 < 0.15
    finally:
        pipe.stop()
        server.close()


class _SlowEncodeDataset(SyntheticDataset):
    """First fetch takes ~0.3 s of wall time."""

    def encoded(self, sample_id: int) -> bytes:
        time.sleep(0.3)
        return super().encoded(sample_id)


def test_stage_parallel_get_batch_honors_sub_poll_timeout():
    ds = _SlowEncodeDataset("slow", 32, 24_000, image_hw=(64, 64),
                            crop_hw=(56, 56), n_classes=100)
    server = _server(ds)
    pipe = DSIPipeline(server.open_session(batch_size=8),
                       RemoteStorage(ds), executor="stage-parallel")
    try:
        t0 = time.monotonic()
        with pytest.raises(queue.Empty):
            pipe.get(timeout=0.05)
        assert time.monotonic() - t0 < 0.15
    finally:
        pipe.stop()
        server.close()
