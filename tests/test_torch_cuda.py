"""The port's CUDA kernels on the card, against their plain versions.

Marked ``cuda``: every test takes the ``cuda`` fixture, which skips when
``torch.cuda.is_available()`` is false (the CPU-only test box).  Run on
a machine with an NVIDIA GPU with::

    PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_cuda.py

The kernels are pinned *bitwise* to their plain PyTorch versions and to
the host path (``SyntheticDataset.decode`` then ``augment_np``): every
step is integer arithmetic or a correctly rounded IEEE float32 op.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.api import CudaAugmentBackend, SenecaServer  # noqa: E402
from repro_torch.data.augment import augment_batch_np  # noqa: E402
from repro_torch.data.pipeline import DSIPipeline, _aug_seed  # noqa: E402
from repro_torch.data.storage import RemoteStorage  # noqa: E402
from repro_torch.data.synthetic import SyntheticDataset, tiny  # noqa: E402
from repro_torch.kernels.augment import kernel as augment_k  # noqa: E402
from repro_torch.kernels.augment.ops import (  # noqa: E402
    augment_batch_seeded, decode_augment_batch_seeded)
from repro_torch.kernels.decode import kernel as decode_k  # noqa: E402
from repro_torch.kernels.decode.ops import decode_batch  # noqa: E402

pytestmark = pytest.mark.cuda

HW = (48, 40)
CROP = (32, 24)


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (torch.cuda.is_available() is "
                    "false)")
    return torch.device("cuda")


def _params(rng, B, hw, crop, dev):
    bases = torch.from_numpy(rng.integers(0, 2**32, B, dtype=np.int64))
    mixes = torch.from_numpy(rng.integers(0, 256, B, dtype=np.int32))
    tops = torch.from_numpy(
        rng.integers(0, hw[0] - crop[0] + 1, B, dtype=np.int32))
    lefts = torch.from_numpy(
        rng.integers(0, hw[1] - crop[1] + 1, B, dtype=np.int32))
    flips = torch.from_numpy(rng.integers(0, 2, B, dtype=np.int32))
    return [t.to(dev) for t in (bases, mixes, tops, lefts, flips)]


@pytest.mark.parametrize("B", [1, 3, 17])
def test_decode_kernel_byte_equal_plain(cuda, B):
    bases, mixes, *_ = _params(np.random.default_rng(B), B, HW, CROP, cuda)
    n0 = decode_k.decode.launches
    out = decode_k.decode(bases, mixes, h=HW[0], w=HW[1])
    torch.cuda.synchronize()
    assert decode_k.decode.launches == n0 + 1
    ref = decode_k.decode_plain(bases.cpu(), mixes.cpu(), *HW)
    assert torch.equal(out.cpu(), ref)


@pytest.mark.parametrize("out_dtype", [torch.float32, torch.bfloat16])
def test_decode_augment_kernel_bitwise_plain_and_composition(cuda,
                                                             out_dtype):
    B = 9
    args = _params(np.random.default_rng(4), B, HW, CROP, cuda)
    out = decode_k.decode_augment(*args, img_h=HW[0], img_w=HW[1],
                                  crop_h=CROP[0], crop_w=CROP[1],
                                  out_dtype=out_dtype)
    plain = decode_k.decode_augment_plain(*[a.cpu() for a in args], HW[1],
                                          *CROP, out_dtype)
    assert torch.equal(out.cpu(), plain)
    bases, mixes, tops, lefts, flips = args
    imgs = decode_k.decode(bases, mixes, h=HW[0], w=HW[1])
    composed = augment_k.augment(imgs, tops, lefts, flips, crop_h=CROP[0],
                                 crop_w=CROP[1], out_dtype=out_dtype)
    assert torch.equal(out, composed)


@pytest.mark.parametrize("out_dtype", [torch.float32, torch.bfloat16])
def test_augment_kernel_bitwise_plain(cuda, out_dtype):
    rng = np.random.default_rng(8)
    B = 11
    imgs = torch.from_numpy(
        rng.integers(0, 256, (B, *HW, 3), dtype=np.uint8)).to(cuda)
    _b, _m, tops, lefts, flips = _params(rng, B, HW, CROP, cuda)
    n0 = augment_k.augment.launches
    out = augment_k.augment(imgs, tops, lefts, flips, crop_h=CROP[0],
                            crop_w=CROP[1], out_dtype=out_dtype)
    torch.cuda.synchronize()
    assert augment_k.augment.launches == n0 + 1
    plain = augment_k.augment_plain(imgs.cpu(), tops.cpu(), lefts.cpu(),
                                    flips.cpu(), *CROP, out_dtype)
    assert torch.equal(out.cpu(), plain)
    # the plain version on the card divides for real too
    on_card = augment_k.augment_plain(imgs, tops, lefts, flips, *CROP,
                                      out_dtype)
    assert torch.equal(out, on_card)


def test_ops_match_host_path_bitwise(cuda):
    ds = SyntheticDataset("t", 64, 2048, image_hw=HW, crop_hw=CROP,
                          seed=2**31 - 3)
    sids = [0, 7, 63, 2**32 - 5]
    payloads = [ds.encoded(s % 64) for s in sids]
    host = np.stack([ds.decode(p, s) for p, s in zip(payloads, sids)])
    dec = decode_batch(payloads, sids, seed=ds.seed, image_hw=HW,
                       device=cuda)
    np.testing.assert_array_equal(dec, host)
    seeds = np.asarray([_aug_seed(2, s) for s in sids], np.int64)
    ref = augment_batch_np(host, CROP, seeds)
    aug = augment_batch_seeded(host, seeds, *CROP, device=cuda)
    np.testing.assert_array_equal(aug, ref)
    fused = decode_augment_batch_seeded(payloads, sids, seeds,
                                        ds_seed=ds.seed, image_hw=HW,
                                        crop_h=CROP[0], crop_w=CROP[1],
                                        device=cuda)
    assert fused.device.type == "cuda"
    np.testing.assert_array_equal(fused.cpu().numpy(), ref)


def test_wrappers_reject_bad_cuda_inputs(cuda):
    imgs = torch.zeros((2, *HW, 3), dtype=torch.uint8, device=cuda)
    p = torch.zeros(2, dtype=torch.int32, device=cuda)
    with pytest.raises(TypeError):
        augment_k.augment(imgs.float(), p, p, p, crop_h=CROP[0],
                          crop_w=CROP[1])
    with pytest.raises(ValueError, match="contiguous"):
        augment_k.augment(imgs.transpose(1, 2), p, p, p, crop_h=8,
                          crop_w=8)
    with pytest.raises(ValueError, match="on cpu"):
        decode_k.decode(torch.zeros(2, dtype=torch.int64, device=cuda),
                        p.cpu(), h=4, w=4)


def test_cuda_augment_backend_matches_numpy(cuda):
    rng = np.random.default_rng(3)
    imgs = rng.integers(0, 256, (5, *HW, 3), dtype=np.uint8)
    seeds = rng.integers(0, 2**31, 5)
    out = CudaAugmentBackend().augment_batch(imgs, CROP, seeds)
    np.testing.assert_array_equal(out, augment_batch_np(imgs, CROP, seeds))


def test_device_executor_on_card(cuda):
    """One cold epoch then one all-HBM epoch: rows are bitwise the host
    recomputation, the second epoch moves no h2d bytes, and every HBM
    entry owns exactly its declared bytes (admitted rows are clones)."""
    ds = tiny(n=64)
    hbm = int(1.2 * 64 * ds.augmented_bytes())
    server = SenecaServer.for_dataset(ds, use_ods=False,
                                      admission="capacity", eviction="lru",
                                      device_cache_bytes=hbm,
                                      hbm_split=(0.0, 0.0, 1.0))
    sess = server.open_session(batch_size=16)
    pipe = DSIPipeline(sess, RemoteStorage(ds), n_workers=2,
                       executor="device", sync_refills=True)
    tel = server.service.telemetry
    n0 = decode_k.decode_augment.launches
    for epoch in range(2):
        if epoch == 1:
            h2d = tel.channel_total_bytes("h2d")
        for _ in range(64 // 16):
            b = pipe.next_batch()
            e = sess.epoch                 # the tag the batch was made with
            assert b["images"].device.type == "cuda"
            assert b["images"].dtype == torch.float32
            for k, sid in enumerate(b["ids"].tolist()):
                img = ds.decode(ds.encoded(sid), sid)[None]
                cands = [_aug_seed(x, sid) for x in range(e + 1)] \
                    + [sid ^ 0x5EED]
                row = b["images"][k].cpu().numpy()
                assert any(np.array_equal(
                    row, augment_batch_np(img, ds.crop_hw, [c])[0])
                    for c in cands)
    assert tel.channel_total_bytes("h2d") == h2d
    assert decode_k.decode_augment.launches > n0
    part = server.service.cache.parts["augmented"]
    for key in part.hbm.keys():
        t = part.hbm.peek(key)
        assert t.device.type == "cuda"
        assert t.untyped_storage().nbytes() == part.hbm._sizes[key]
    pipe.stop()
    server.close()
