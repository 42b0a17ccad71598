"""The port's sharded data plane over the process transport.

Twins of the reference's process-transport tests (``tests/test_service.py``:
spawn handshake, payload parity across processes, shard-side produce,
idempotent close, failed-start cleanup, and the VirtualClock refusal),
with ``device="cpu"``, plus what the port adds:

* no ``Response`` that crosses the pipe carries a ``torch.Tensor`` —
  device values travel as exchange files, brought down to the host;
* a shard asked for CUDA where there is none fails its readiness
  handshake, and the error is raised in the parent (no quiet CPU);
* the device executor over process shards uploads their shipped host
  copies (tier "hbm" included), meters them on "h2d", sends decoded
  ones through the augment kernel's plain version, and serves rows
  bitwise equal to the host path.

Each test spawns its shards (the ``spawn`` start method imports torch
in every child), so they sit in a file of their own; every start is
bounded by the transport's readiness timeout (120 s), which raises
rather than hangs.  Tolerance: exact.
"""
import glob
import os
import tempfile

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.data.augment import augment_np as ref_augment_np  # noqa: E402
from repro.data.synthetic import tiny as ref_tiny  # noqa: E402
from repro.service.shard import produce_seed as ref_produce_seed  # noqa: E402

from repro_torch.api import (SenecaServer, ShardedCache,  # noqa: E402
                             VirtualClock, WorkloadRunner)
from repro_torch.data.augment import augment_np  # noqa: E402
from repro_torch.data.pipeline import DSIPipeline, _aug_seed  # noqa: E402
from repro_torch.data.storage import RemoteStorage  # noqa: E402
from repro_torch.data.synthetic import tiny  # noqa: E402
from repro_torch.service.shard import produce_seed  # noqa: E402

SPLIT = (0.2, 0.4, 0.4)


def _process_cache(capacity, **kw):
    kw.setdefault("device", "cpu")
    return ShardedCache(capacity, kw.pop("split", SPLIT), shards=2,
                        transport="process", seed=0, **kw)


def test_process_transport_roundtrip_and_close():
    ds = tiny(n=32)
    c = _process_cache(2 * 32 * ds.augmented_bytes(), dataset=ds)
    xchg = c._xchg
    try:
        arr = np.arange(24, dtype=np.float32).reshape(2, 3, 4)
        assert c.insert(40, "decoded", arr, arr.nbytes)
        form, value, tier = c.lookup_tiered(40)
        assert form == "decoded" and tier == "dram"
        assert np.array_equal(np.asarray(value), arr)
        out = np.asarray(c.produce(9, epoch_tag=3))
        img = ds.decode(ds.encoded(9), 9)
        ref = augment_np(img, ds.crop_hw,
                         np.random.default_rng(produce_seed(3, 9)))
        assert np.array_equal(out, ref)   # cross-process byte parity
        # and the reference package's host path gives the same bytes
        rds = ref_tiny(n=32)
        want = ref_augment_np(rds.decode(rds.encoded(9), 9), rds.crop_hw,
                              np.random.default_rng(ref_produce_seed(3, 9)))
        assert np.array_equal(out, want)
        assert c.ingest(range(32), epoch_tag=1) == 32
    finally:
        c.close()
        c.close()
    assert not os.path.exists(xchg)


def test_process_transport_failed_start_cleans_up():
    before = set(glob.glob(os.path.join(tempfile.gettempdir(),
                                        "seneca-xchg-*")))
    with pytest.raises(Exception):
        # lambdas cannot pickle to a spawned shard: start must fail,
        # tear the fleet down, and leave no exchange dir behind
        _process_cache(10_000, dataset=lambda: None)
    after = set(glob.glob(os.path.join(tempfile.gettempdir(),
                                       "seneca-xchg-*")))
    assert after == before


@pytest.mark.parametrize("device", [None, "cuda"])
def test_process_shard_without_cuda_fails_its_start(device):
    """A process shard whose HBM tier asks for CUDA (``None`` means
    CUDA) where there is none fails the readiness handshake with the
    device error; nothing falls back to the CPU."""
    if torch.cuda.is_available():
        pytest.skip("this machine has CUDA: the shard would start")
    with pytest.raises(RuntimeError, match="failed to start.*CUDA is not "
                                           "available"):
        _process_cache(100_000, hbm_bytes=100_000,
                       hbm_split=(0.0, 0.0, 1.0), device=device)


def test_virtual_clock_rejects_process_transport():
    ds = tiny(n=32)
    server = SenecaServer.for_dataset(ds, cache_frac=0.5, seed=0,
                                      shards=2, device="cpu")
    # the guard keys off the cache's transport tag — no need to spawn
    server.service.cache.transport_name = "process"
    with pytest.raises(ValueError, match="sim"):
        WorkloadRunner(server, RemoteStorage(ds), clock=VirtualClock())
    server.close()


def _tensors_in(value):
    if isinstance(value, torch.Tensor):
        return 1
    if isinstance(value, dict):
        return sum(_tensors_in(v) for v in value.values())
    if isinstance(value, (list, tuple)):
        return sum(_tensors_in(v) for v in value)
    return 0


class _RecordingConn:
    """Pipe end that keeps every Response the parent receives."""

    def __init__(self, conn, seen):
        self._conn = conn
        self._seen = seen

    def recv(self):
        resp = self._conn.recv()
        self._seen.append(resp)
        return resp

    def __getattr__(self, name):
        return getattr(self._conn, name)


def test_no_tensor_crosses_the_process_pipe():
    """Shards hold tensors in their HBM tier; every value they send back
    (lookups of HBM rows, produce payloads, stats) is tensor-free, and
    the HBM rows arrive as host arrays labelled "hbm"."""
    ds = tiny(n=32)
    c = _process_cache(32 * ds.augmented_bytes(), dataset=ds,
                       split=(0.1, 0.3, 0.6),
                       hbm_bytes=32 * ds.augmented_bytes(),
                       hbm_split=(0.0, 0.3, 0.7))
    seen = []
    tr = c.transport
    tr._conns = [_RecordingConn(conn, seen) for conn in tr._conns]
    try:
        rows = {k: torch.full((*ds.crop_hw, 3), float(k))
                for k in range(40, 44)}
        assert all(c.insert_batch_gated(
            "augmented", [(k, r, r.numel() * 4) for k, r in rows.items()]))
        for k, r in rows.items():
            form, value, tier = c.lookup_tiered(k)
            assert (form, tier) == ("augmented", "hbm")
            assert isinstance(value, np.ndarray)
            np.testing.assert_array_equal(value, r.numpy())
        assert c.ingest(range(32), epoch_tag=0) == 32
        for sid in (1, 2, 3):
            c.produce(sid, epoch_tag=0)
            c.lookup_tiered(sid)
        stats = c.shard_stats()
        assert all(s["hbm_device"] == "cpu" for s in stats)
        assert sum(s["hbm_bytes_used"] for s in stats) > 0
    finally:
        c.close()
    assert seen and all(_tensors_in(r.value) == 0 for r in seen)
    assert any(isinstance(r.value, tuple) and len(r.value) == 3
               and r.value[2] == "hbm" for r in seen)


def shipped_server(ds, n, bs, device):
    """A server over 2 process shards (``SenecaServer.for_dataset``)
    that the device executor has filled: a cold epoch admits its fresh
    augmented rows (shipped to the shards, HBM tier first, LRU), then
    the session admits every decoded form.  Returns the server, the
    session and the pipeline, ready for the second epoch."""
    aug, dec = ds.augmented_bytes(), ds.decoded_bytes()
    server = SenecaServer.for_dataset(
        ds, use_ods=False, admission="capacity", eviction="lru",
        cache_bytes=int(0.25 * n * aug + 1.2 * n * dec),
        split=(0.0, 0.6, 0.4),
        device_cache_bytes=int(0.25 * n * aug + 0.6 * n * dec),
        hbm_split=(0.0, 0.5, 0.5), shards=2, shard_transport="process",
        seed=0, device=device)
    sess = server.open_session(batch_size=bs)
    pipe = DSIPipeline(sess, RemoteStorage(ds), executor="device",
                       sync_refills=True)
    for _ in range(n // bs):
        pipe.next_batch()
    decoded = [(s, ds.decode(ds.encoded(s), s)) for s in range(n)]
    assert sess.admit_batch(
        "decoded", [(s, img, img.nbytes) for s, img in decoded]).all()
    return server, sess, pipe


def second_epoch(ds, n, bs, sess, pipe):
    """Run the second epoch, holding each row bitwise against the host
    path: an augmented hit carries the crop of the epoch it was cached
    in or the background refill's (seed ``sid ^ 0x5EED``), anything
    else the session's current epoch's.
    Returns the images' device types, the ids served and each lookup's
    (form, tier, value type)."""
    lookups = {}
    lookup = sess.lookup_tiered

    def recording_lookup(sid):
        out = lookup(sid)
        lookups[int(sid)] = (out[0], out[2], type(out[1]))
        return out

    sess.lookup_tiered = recording_lookup
    seen, devices = [], set()
    for _ in range(n // bs):
        b = pipe.next_batch()
        devices.add(b["images"].device.type)
        rows, epoch = b["images"].cpu().numpy(), sess.epoch
        for row, s in zip(rows, b["ids"].tolist()):
            img = ds.decode(ds.encoded(s), s)
            seeds = ([_aug_seed(e, s) for e in range(epoch + 1)]
                     + [s ^ 0x5EED] if lookups[s][0] == "augmented"
                     else [_aug_seed(epoch, s)])
            assert any(np.array_equal(row, augment_np(
                img, ds.crop_hw, np.random.default_rng(seed)))
                for seed in seeds), s
            seen.append(s)
    pipe.stop()
    return devices, seen, list(lookups.values())


def test_device_executor_uploads_shipped_host_copies():
    """The device executor over the server's own process shards: the
    cold epoch's rows reach the shards' HBM tiers; in the second epoch
    every hit arrives as a host copy (tier "hbm" included) and is
    uploaded and metered on "h2d" and "cache"; decoded hits are
    augmented by the augment kernel's plain version; rows equal the
    host path bitwise."""
    n, bs = 48, 8
    ds = tiny(n=n)
    server, sess, pipe = shipped_server(ds, n, bs, "cpu")
    try:
        stats = server.stats()["shards"]
        assert all(s["hbm_bytes_used"] > 0 for s in stats)
        assert all(s["hbm_device"] == "cpu" for s in stats)
        tel = server.service.telemetry
        before = dict(tel.snapshot().serve_counts)
        h2d0 = tel.channel_total_bytes("h2d")
        cache0 = tel.channel_total_bytes("cache")
        devices, seen, tiers = second_epoch(ds, n, bs, sess, pipe)
        assert devices == {"cpu"}
        assert sorted(seen) == list(range(n))
        served = {k: v - before.get(k, 0)
                  for k, v in tel.snapshot().serve_counts.items()}
        assert served["augmented"] > 0 and served["decoded"] > 0
        assert served["augmented"] + served["decoded"] == n
        assert ("augmented", "hbm", np.memmap) in tiers
        assert ("decoded", "hbm", np.memmap) in tiers
        shipped = (served["augmented"] * ds.augmented_bytes()
                   + served["decoded"] * ds.decoded_bytes())
        assert tel.channel_total_bytes("h2d") - h2d0 == shipped
        assert tel.channel_total_bytes("cache") - cache0 == shipped
    finally:
        server.close()
