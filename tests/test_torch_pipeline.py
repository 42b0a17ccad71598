"""The port's device executor and service against the JAX package.

Mirrors the reference's device-executor tests
(``tests/test_pipeline_executor.py``) with ``device="cpu"``: the port's
executor runs the same code as on the card, with the kernels' plain
PyTorch versions.  At a fixed seed the two packages serve the same ids
per batch, exactly; their images agree within the reference's 2e-6 (XLA
on the CPU may round a division one float32 ulp differently); the
port's images are bitwise the host recomputation.  A job's sampler
state checkpointed in the reference continues in the port.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import repro.api as ref_api  # noqa: E402
from repro.data.pipeline import DSIPipeline as RefPipeline  # noqa: E402
from repro.data.storage import RemoteStorage as RefStorage  # noqa: E402
from repro.data.synthetic import tiny as ref_tiny  # noqa: E402

from repro_torch.api import (SenecaConfig, SenecaServer,  # noqa: E402
                             state_from_reference)
from repro_torch.data.augment import augment_batch_np  # noqa: E402
from repro_torch.data.pipeline import DSIPipeline, _aug_seed  # noqa: E402
from repro_torch.data.storage import RemoteStorage  # noqa: E402
from repro_torch.data.synthetic import tiny  # noqa: E402
from repro_torch.kernels.decode import kernel as decode_k  # noqa: E402
from repro_torch.kernels.decode.ops import decode_batch  # noqa: E402


def _host_rows(ds, ids, epoch):
    imgs = np.stack([ds.decode(ds.encoded(s), s) for s in ids])
    seeds = np.asarray([_aug_seed(epoch, s) for s in ids], np.int64)
    return augment_batch_np(imgs, ds.crop_hw, seeds)


def _ref_server(ds, **kw):
    return ref_api.SenecaServer.for_dataset(ds, cache_frac=0.3, seed=0,
                                            **kw)


def _port_server(ds, **kw):
    return SenecaServer.for_dataset(ds, cache_frac=0.3, seed=0,
                                    device="cpu", **kw)


@pytest.mark.parametrize("use_ods", [False, True])
def test_device_executor_matches_reference(use_ods):
    """Two epochs, no augmented or HBM tier (every sample takes the
    fused kernel): same ids per batch as the JAX executor, images within
    2e-6 of JAX's and bitwise equal to the host path."""
    n, bs = 48, 8
    kw = dict(use_ods=use_ods, split=(1.0, 0.0, 0.0))
    ref_server = _ref_server(ref_tiny(n=n), **kw)
    server = _port_server(tiny(n=n), **kw)
    ds = tiny(n=n)
    ref_sess = ref_server.open_session(batch_size=bs)
    sess = server.open_session(batch_size=bs)
    ref_pipe = RefPipeline(ref_sess, RefStorage(ref_tiny(n=n)),
                           n_workers=2, executor="device")
    pipe = DSIPipeline(sess, RemoteStorage(ds), n_workers=2,
                       executor="device")
    n0 = decode_k.decode_augment.launches
    seen = []
    for _ in range(2 * n // bs):
        rb, b = ref_pipe.next_batch(), pipe.next_batch()
        epoch = sess.epoch                 # the tag the batch was made with
        np.testing.assert_array_equal(b["ids"], rb["ids"])
        np.testing.assert_array_equal(b["labels"], rb["labels"])
        assert isinstance(b["images"], torch.Tensor)
        assert b["images"].dtype == torch.float32
        assert b["images"].shape == (bs, *ds.crop_hw, 3)
        got = b["images"].numpy()
        np.testing.assert_allclose(got, np.asarray(rb["images"]), rtol=0,
                                   atol=2e-6)
        np.testing.assert_array_equal(
            got, _host_rows(ds, b["ids"].tolist(), epoch))
        seen.extend(b["ids"].tolist())
    assert sorted(seen) == sorted(list(range(n)) * 2)
    # plain versions on the CPU: the kernel launch counter stays put
    assert decode_k.decode_augment.launches == n0
    for p, s in ((ref_pipe, ref_server), (pipe, server)):
        p.stop()
        s.close()


def test_per_sample_executor_matches_reference():
    """The copied host path (per-sample executor) serves the same ids and
    bitwise the same images as the reference."""
    n, bs = 32, 8
    ref_server = _ref_server(ref_tiny(n=n), use_ods=False)
    server = _port_server(tiny(n=n), use_ods=False)
    ref_pipe = RefPipeline(ref_server.open_session(batch_size=bs),
                           RefStorage(ref_tiny(n=n)), n_workers=2,
                           sync_refills=True)
    pipe = DSIPipeline(server.open_session(batch_size=bs),
                       RemoteStorage(tiny(n=n)), n_workers=2,
                       sync_refills=True)
    for _ in range(n // bs):
        rb, b = ref_pipe.next_batch(), pipe.next_batch()
        np.testing.assert_array_equal(b["ids"], rb["ids"])
        np.testing.assert_array_equal(b["images"], rb["images"])
    for p, s in ((ref_pipe, ref_server), (pipe, server)):
        p.stop()
        s.close()


def test_all_hbm_epoch_moves_zero_h2d_bytes():
    ds = tiny(n=64)
    server = _port_server(ds, use_ods=False, split=(0.5, 0.0, 0.5),
                          device_cache_bytes=int(1.2 * 64
                                                 * ds.augmented_bytes()),
                          hbm_split=(0.0, 0.0, 1.0))
    sess = server.open_session(batch_size=8)
    pipe = DSIPipeline(sess, RemoteStorage(ds), n_workers=2,
                       executor="device", sync_refills=True)
    tel = server.service.telemetry
    for _ in range(8):                            # epoch 1
        pipe.next_batch()
    h2d = tel.channel_total_bytes("h2d")
    for _ in range(8):                            # epoch 2: all HBM hits
        b = pipe.next_batch()
        assert b["images"].shape == (8, *ds.crop_hw, 3)
    assert tel.channel_total_bytes("h2d") == h2d
    stats = server.stats()
    assert stats["residency_counts"]["hbm"] == 64
    assert stats["hbm"]["augmented"]["hbm_hits"] > 0
    pipe.stop()
    server.close()


def test_dram_hits_are_uploaded_and_metered():
    """Augmented rows cached in DRAM (no HBM tier) are admitted as host
    arrays and, when hit, uploaded and metered on the h2d channel."""
    ds = tiny(n=32)
    server = _port_server(ds, use_ods=False, split=(0.0, 0.0, 1.0),
                          cache_bytes=int(1.2 * 32 * ds.augmented_bytes()))
    sess = server.open_session(batch_size=8)
    pipe = DSIPipeline(sess, RemoteStorage(ds), n_workers=2,
                       executor="device", sync_refills=True)
    tel = server.service.telemetry
    for _ in range(4):                            # epoch 1
        pipe.next_batch()
    part = server.service.cache.parts["augmented"]
    assert len(part) == 32
    assert all(isinstance(part.peek(k), np.ndarray) for k in part.keys())
    h2d = tel.channel_total_bytes("h2d")
    for _ in range(4):                            # epoch 2: all DRAM hits
        pipe.next_batch()
    assert tel.channel_total_bytes("h2d") - h2d == 32 * ds.augmented_bytes()
    pipe.stop()
    server.close()


def test_decoded_hbm_hit_stays_on_device():
    """Decoded forms pre-warmed into the HBM tier through the port's
    ``decode_batch`` are augmented on the device: no cache-channel or
    h2d bytes, rows bitwise the host path."""
    ds = tiny(n=32)
    server = _port_server(ds, use_ods=False, split=(0.0, 1.0, 0.0),
                          device_cache_bytes=int(1.2 * 32
                                                 * ds.decoded_bytes()),
                          hbm_split=(0.0, 1.0, 0.0))
    sess = server.open_session(batch_size=8)
    ids = list(range(32))
    rows = decode_batch([ds.encoded(s) for s in ids], ids, seed=ds.seed,
                        image_hw=ds.image_hw, device="cpu", as_device=True)
    for sid in ids:
        assert sess.admit(sid, "decoded", rows[sid].clone(),
                          ds.decoded_bytes())
    assert server.stats()["hbm"]["decoded"]["hbm_entries"] == 32
    pipe = DSIPipeline(sess, RemoteStorage(ds), n_workers=2,
                       executor="device")
    tel = server.service.telemetry
    seen = []
    for _ in range(4):
        epoch = sess.epoch
        b = pipe.next_batch()
        np.testing.assert_array_equal(
            b["images"].numpy(), _host_rows(ds, b["ids"].tolist(), epoch))
        seen.extend(b["ids"].tolist())
    assert sorted(seen) == ids
    assert tel.channel_total_bytes("cache") == 0
    assert tel.channel_total_bytes("h2d") == 0
    pipe.stop()
    server.close()


@pytest.mark.parametrize("form", ["augmented", "decoded"])
def test_hbm_hit_as_host_array_takes_the_host_branch(form):
    """An "hbm" hit that is not a tensor on the service's device is
    uploaded and metered on "h2d" and "cache" as a DRAM hit is; a
    decoded one goes through the augment kernel (its plain version on
    the CPU).  Rows stay bitwise the host path."""
    n, bs = 16, 8
    ds = tiny(n=n)
    split = (0.0, 0.0, 1.0) if form == "augmented" else (0.0, 1.0, 0.0)
    nbytes = (ds.augmented_bytes() if form == "augmented"
              else ds.decoded_bytes())
    server = _port_server(ds, use_ods=False, split=split,
                          device_cache_bytes=int(1.2 * n * nbytes),
                          hbm_split=split)
    sess = server.open_session(batch_size=bs)
    ids = list(range(n))
    if form == "augmented":
        rows = torch.from_numpy(_host_rows(ds, ids, 0))
    else:
        rows = decode_batch([ds.encoded(s) for s in ids], ids, seed=ds.seed,
                            image_hw=ds.image_hw, device="cpu",
                            as_device=True)
    assert sess.admit_batch(form, [(s, rows[s].clone(), nbytes)
                                   for s in ids]).all()
    assert server.stats()["hbm"][form]["hbm_entries"] == n
    lookup = sess.lookup_tiered

    def shipped(sid):
        # a fake cache: its "hbm" answers are host ndarrays, as a
        # process shard ships them
        got, value, tier = lookup(sid)
        if tier == "hbm":
            value = value.numpy().copy()
        return got, value, tier

    sess.lookup_tiered = shipped
    pipe = DSIPipeline(sess, RemoteStorage(ds), executor="device",
                       sync_refills=True)
    tel = server.service.telemetry
    seen = []
    for _ in range(n // bs):
        b = pipe.next_batch()
        np.testing.assert_array_equal(
            b["images"].numpy(), _host_rows(ds, b["ids"].tolist(), 0))
        seen.extend(b["ids"].tolist())
    assert sorted(seen) == ids
    assert tel.channel_total_bytes("h2d") == n * nbytes
    assert tel.channel_total_bytes("cache") == n * nbytes
    augmented = tel.snapshot().stage_n.get("augment", 0)
    assert (augmented > 0) == (form == "decoded")
    pipe.stop()
    server.close()


@pytest.mark.parametrize("k", [3, 7])
def test_checkpoint_from_reference_continues_in_port(k):
    """A job's sampler snapshot taken from the JAX service after k
    batches, converted and restored into the port's service, continues
    with the same next-batch ids (the loader's counterpart of carrying
    weights across)."""
    n, bs = 40, 8
    ref_server = _ref_server(ref_tiny(n=n), use_ods=False)
    ref_sess = ref_server.open_session(batch_size=bs)
    for _ in range(k):
        ref_sess.next_batch_ids()
    snap = ref_sess.checkpoint_state()
    server = _port_server(tiny(n=n), use_ods=False)
    sess = server.open_session(batch_size=bs)
    sess.restore_state(state_from_reference(snap))
    for _ in range(2 * n // bs):
        want, _ = ref_sess.next_batch_ids()
        got, _ = sess.next_batch_ids()
        np.testing.assert_array_equal(got, want)
        assert sess.epoch == ref_sess.epoch
    ref_server.close()
    server.close()


def test_state_from_reference_rejects_foreign_snapshots():
    with pytest.raises(ValueError, match="format"):
        state_from_reference({"format": 2})
    with pytest.raises(ValueError, match="lacks"):
        state_from_reference({"format": 1, "n_samples": 4, "batch_size": 2,
                              "backend": {"key": [0, 1]},
                              "sampler": {"n": 4}})


def test_unported_branches_raise():
    ds = tiny(n=16)
    # the sharded data plane is ported: two sim shards and one process
    # shard each build and serve a device-executor batch on the CPU
    for kw in (dict(shards=2), dict(shard_transport="process")):
        server = SenecaServer.for_dataset(ds, device="cpu", **kw)
        pipe = DSIPipeline(server.open_session(batch_size=4),
                           RemoteStorage(ds), executor="device",
                           sync_refills=True)
        batch = pipe.next_batch()
        assert tuple(batch["images"].shape) == (4, *ds.crop_hw, 3)
        assert len(server.stats()["shards"]) == kw.get("shards", 1)
        pipe.stop()
        server.close()
    # the named request samplers and the workload runner are ported:
    # they run, and refuse what the reference refuses
    server = SenecaServer.for_dataset(ds, device="cpu")
    with server.open_session(batch_size=4, sampler="zipfian") as sess:
        assert len(sess.next_batch_ids()[0]) == 4
    with pytest.raises(ValueError, match="unknown request sampler"):
        server.open_session(batch_size=4, sampler="bogus")
    with pytest.raises(ValueError, match="empty workload"):
        server.run_workload([], RemoteStorage(ds))
    assert server.n_sessions == 0
    server.close()
    assert SenecaConfig.__dataclass_fields__["backend"].default == "numpy"
