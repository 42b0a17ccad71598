"""The port's CUDA kernels on the card, against their plain versions.

Marked ``cuda``: every test takes the ``cuda`` fixture, which skips when
``torch.cuda.is_available()`` is false (the CPU-only test box).  Run on
a machine with an NVIDIA GPU with::

    PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_cuda.py

The loader kernels (K1-K3) are pinned *bitwise* to their plain PyTorch
versions and to the host path (``SyntheticDataset.decode`` then
``augment_np``): every step is integer arithmetic or a correctly rounded
IEEE float32 op.  Flash attention (K4) and the SSD scan (K5) sum in
another order than their plain versions and are held to the reference's
tolerances (``tests/test_kernels.py``); unsupported shapes raise.  K4's
backward is held to its plain twin like K4, and one reduced training
step checks that gradients reach the attention weights on the card;
K5's backward likewise, with one reduced mamba2-1.3b step for the ssm
weights.  The reduced moe models run forward and backward on the card
against the same parameters on the CPU, and two bf16 prefills on the
card give the same bits; so do the reduced vlm and encdec models, whose
cross-attention runs K4 and its backward at Sq != Sk (checked on their
own at ragged lengths too).  The kernels' ``torch.library`` ops give, in
their fake implementations, the layouts their launches give.
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
    # float32 plain versions run in full float32, not TF32
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
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


@pytest.mark.parametrize("hw", [(37, 29), (5, 7), (1, 1), (3, 1),
                                (256, 256)])
@pytest.mark.parametrize("B", [1, 17])
@pytest.mark.parametrize("near_top", [False, True])
def test_decode_kernel_edge_shapes_byte_equal(cuda, hw, B, near_top):
    """K3 at images whose byte count is not a multiple of 16 (at B 17 the
    image starts fall on every offset mod 16; (1, 1) and (3, 1) are all
    scalar bytes), at the main path's 256x256, and with bases near 2**32,
    byte-equal to its plain version."""
    rng = np.random.default_rng(hw[0] * B + near_top)
    lo = 2**32 - 2**12 if near_top else 0
    bases = torch.from_numpy(rng.integers(lo, 2**32, B, dtype=np.int64))
    mixes = torch.from_numpy(rng.integers(0, 256, B, dtype=np.int32))
    n0 = decode_k.decode.launches
    out = decode_k.decode(bases.to(cuda), mixes.to(cuda), h=hw[0], w=hw[1])
    torch.cuda.synchronize()
    assert decode_k.decode.launches == n0 + 1
    assert torch.equal(out.cpu(), decode_k.decode_plain(bases, mixes, *hw))


def test_decode_kernel_rejects_64_bit_images_before_allocating(cuda):
    bases = torch.zeros(1, dtype=torch.int64, device=cuda)
    mixes = torch.zeros(1, dtype=torch.int32, device=cuda)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats(cuda)
    peak = torch.cuda.max_memory_allocated(cuda)
    n0 = decode_k.decode.launches
    for h, w in ((2**15, 2**15), (1, 715_827_883)):   # 3 h w >= 2**31
        with pytest.raises(ValueError, match="32-bit"):
            decode_k.decode(bases, mixes, h=h, w=w)
    assert decode_k.decode.launches == n0
    assert torch.cuda.max_memory_allocated(cuda) == peak


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


#: (B, image hw, crop hw, edge): crop rows that are not a multiple of the
#: 16-byte vector (23 * 3 elements), a crop equal to the image, a 1x1
#: crop, and ``edge``: every left at the right edge (W - cw) with flip on
LOADER_EDGE_CASES = [
    (1, (48, 41), (31, 23), False), (17, (48, 41), (31, 23), False),
    (17, (48, 41), (31, 23), True), (1, (37, 29), (37, 29), False),
    (17, (37, 29), (37, 29), True), (1, (5, 7), (1, 1), False),
    (17, (5, 7), (1, 1), True), (17, (256, 256), (224, 224), True)]


@pytest.mark.parametrize("B,hw,crop,edge", LOADER_EDGE_CASES)
@pytest.mark.parametrize("out_dtype", [torch.float32, torch.bfloat16])
def test_loader_kernels_edge_shapes_bitwise(cuda, B, hw, crop, edge,
                                            out_dtype):
    """K1 and K2 at shapes that reach their element-by-element row ends
    and the crop window's edges: each bitwise equal to its plain version,
    and K1 to K3 then K2.  K2 also reads an image batch that starts at a
    byte offset that is not a multiple of 16 (a view past one image)."""
    bases, mixes, tops, lefts, flips = _params(
        np.random.default_rng(B * 1000 + crop[1]), B, hw, crop, cuda)
    if edge:
        lefts.fill_(hw[1] - crop[1])
        flips.fill_(1)
    args = (bases, mixes, tops, lefts, flips)
    n1, n2 = decode_k.decode_augment.launches, augment_k.augment.launches
    k1 = decode_k.decode_augment(*args, img_h=hw[0], img_w=hw[1],
                                 crop_h=crop[0], crop_w=crop[1],
                                 out_dtype=out_dtype)
    imgs = decode_k.decode(bases, mixes, h=hw[0], w=hw[1])
    shifted = torch.cat([imgs[:1], imgs])[1:]
    assert shifted.is_contiguous() and torch.equal(shifted, imgs)
    k2 = augment_k.augment(imgs, tops, lefts, flips, crop_h=crop[0],
                           crop_w=crop[1], out_dtype=out_dtype)
    k2_shifted = augment_k.augment(shifted, tops, lefts, flips,
                                   crop_h=crop[0], crop_w=crop[1],
                                   out_dtype=out_dtype)
    torch.cuda.synchronize()
    assert decode_k.decode_augment.launches == n1 + 1
    assert augment_k.augment.launches == n2 + 2
    plain1 = decode_k.decode_augment_plain(*[a.cpu() for a in args], hw[1],
                                           *crop, out_dtype)
    plain2 = augment_k.augment_plain(imgs.cpu(), tops.cpu(), lefts.cpu(),
                                     flips.cpu(), *crop, out_dtype)
    assert torch.equal(k1.cpu(), plain1)
    assert torch.equal(k2.cpu(), plain2)
    assert torch.equal(k1, k2) and torch.equal(k2_shifted, k2)


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


# ------------------------------------------------- K4 flash attention, K5 SSD
def _attn_inputs(B, S, H, K, hd, dtype, dev, seed):
    rng = np.random.default_rng(seed)
    return [torch.from_numpy(rng.standard_normal(shape).astype(np.float32))
            .to(dtype).to(dev)
            for shape in ((B, S, H, hd), (B, S, K, hd), (B, S, K, hd))]


@pytest.mark.parametrize("S,H,K,hd", [(16, 4, 2, 16), (77, 4, 4, 32),
                                      (200, 8, 2, 64), (256, 8, 2, 128),
                                      (129, 32, 8, 128), (197, 16, 16, 80)])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("causal", [True, False])
def test_flash_attention_kernel_matches_plain(cuda, S, H, K, hd, dtype,
                                              causal):
    """2e-5 in float32, the reference's (tests/test_kernels.py:52): the
    same float32 arithmetic, summed in another order.  In bfloat16 both
    round the same float32 result once, so they differ by at most one
    bf16 ulp, 2**-7 of the value (atol covers outputs near 0)."""
    from repro_torch.kernels.flash_attention import kernel as fa
    q, k, v = _attn_inputs(2, S, H, K, hd, dtype, cuda, S * hd)
    n0 = fa.flash_attention.launches
    out = fa.flash_attention(q, k, v, causal=causal)
    torch.cuda.synchronize()
    assert fa.flash_attention.launches == n0 + 1
    assert out.dtype == dtype and out.shape == q.shape
    plain = fa.flash_attention_plain(q, k, v, causal)
    atol, rtol = (2e-5, 2e-5) if dtype == torch.float32 else \
        (1e-3, 2.0 ** -7)
    torch.testing.assert_close(out.float(), plain.float(), atol=atol,
                               rtol=rtol)


@pytest.mark.parametrize("S,P,N,chunk", [(64, 16, 16, 64), (100, 16, 16, 32),
                                         (256, 64, 128, 256),
                                         (300, 64, 128, 256),
                                         (1000, 64, 128, 128),
                                         (600, 64, 128, 256),
                                         (400, 48, 80, 150),
                                         # zamba2-1.2b's P 64, N 64
                                         (300, 64, 64, 256),
                                         (1000, 64, 64, 256)])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_ssd_scan_kernel_matches_plain(cuda, S, P, N, chunk, dtype):
    """The reference's tolerances (tests/test_kernels.py:89): 5e-4 in
    float32, 5e-2 in bfloat16; the kernel's chunks (32-row sub-chunks in
    float32, multiples of 64 rows on the tensor cores in bfloat16) and
    the plain version's chunks round differently."""
    from repro_torch.kernels.ssd_scan import kernel as ssd_k
    rng = np.random.default_rng(S + P)
    B, nh = 2, 3

    def t(a, dt=dtype):
        return torch.from_numpy(a.astype(np.float32)).to(dt).to(cuda)

    x = t(rng.standard_normal((B, S, nh, P)) * 0.5)
    dt = t(np.log1p(np.exp(rng.standard_normal((B, S, nh)))), torch.float32)
    A = t(-np.exp(rng.standard_normal(nh) * 0.3), torch.float32)
    Bm = t(rng.standard_normal((B, S, N)) * 0.5)
    Cm = t(rng.standard_normal((B, S, N)) * 0.5)
    n0 = ssd_k.ssd_scan.launches
    y, h = ssd_k.ssd_scan(x, dt, A, Bm, Cm, chunk=chunk)
    torch.cuda.synchronize()
    assert ssd_k.ssd_scan.launches == n0 + 1
    y_p, h_p = ssd_k.ssd_scan_plain(x, dt, A, Bm, Cm, chunk)
    tol = 5e-4 if dtype == torch.float32 else 5e-2
    assert y.dtype == dtype and h.dtype == torch.float32
    torch.testing.assert_close(y.float(), y_p.float(), atol=tol, rtol=tol)
    torch.testing.assert_close(h, h_p, atol=tol, rtol=tol)


def _k4_within_one_bf16_ulp(out, plain):
    """The bf16 card check of K4 (as in chip_smoke.py): per element within
    1e-3 + 2**-7 |x| of the plain version, relative RMS <= 2**-8."""
    torch.testing.assert_close(out.float(), plain.float(), atol=1e-3,
                               rtol=2.0 ** -7)
    rel = (out.float() - plain.float()).norm() / plain.float().norm()
    assert float(rel) <= 2.0 ** -8


@pytest.mark.parametrize("S,hd,causal", [
    (1024, 128, True),                       # qwen3-8b's prefill
    (1000, 64, True), (1000, 64, False), (1025, 64, True),
    (1025, 64, False), (1000, 128, True), (1000, 128, False),
    (1025, 128, True), (1025, 128, False),
    (197, 80, False), (197, 80, True),       # vit-huge's S and head width
    (256, 80, False), (256, 80, True)])
def test_flash_attention_bf16_tensor_cores_at_model_widths(cuda, S, hd,
                                                           causal):
    """The bfloat16 kernel (wgmma, TMA) at qwen3-8b's prefill shape
    (4, 1024, 32 | 8, 128) and at ragged S on both sides of a 128-row
    query tile, against its plain version within one bf16 ulp.  hd 80
    (vit-huge's) runs in the 128-column instance: its second TMA box
    covers columns 64-127 of a 160-byte row, 80-127 filled with zeros."""
    from repro_torch.kernels.flash_attention import kernel as fa
    B, H, K = (4, 32, 8) if S == 1024 else (2, 8, 2)
    q, k, v = _attn_inputs(B, S, H, K, hd, torch.bfloat16, cuda, S + hd)
    n0 = fa.flash_attention.launches
    out = fa.flash_attention(q, k, v, causal=causal)
    torch.cuda.synchronize()
    assert fa.flash_attention.launches == n0 + 1
    _k4_within_one_bf16_ulp(out, fa.flash_attention_plain(q, k, v, causal))


def test_flash_attention_bf16_is_deterministic(cuda):
    """Prefill logits must equal forward's bitwise, so two calls on the
    same inputs give the same bits (no key is split across CTAs)."""
    from repro_torch.kernels.flash_attention import kernel as fa
    q, k, v = _attn_inputs(2, 1000, 8, 2, 128, torch.bfloat16, cuda, 5)
    n0 = fa.flash_attention.launches
    a = fa.flash_attention(q, k, v, causal=True)
    b = fa.flash_attention(q, k, v, causal=True)
    torch.cuda.synchronize()
    assert fa.flash_attention.launches == n0 + 2
    assert torch.equal(a, b)


@pytest.mark.parametrize("S,chunk", [(1024, 256), (1000, 256)])
def test_ssd_scan_bf16_tensor_cores_at_model_width(cuda, S, chunk):
    """The bfloat16 kernel (chunks in parallel on the tensor cores) at
    mamba2-1.3b's width (64 heads, P 64, N 128, chunk 256), at S 1024 and
    at a ragged S, against its plain version at the reference's
    tolerances: 5e-2 on y, 5e-4 on the float32 state."""
    from repro_torch.kernels.ssd_scan import kernel as ssd_k
    rng = np.random.default_rng(S)
    B, nh, P, N = 2, 64, 64, 128

    def t(a, dt=torch.bfloat16):
        return torch.from_numpy(a.astype(np.float32)).to(dt).to(cuda)

    x = t(rng.standard_normal((B, S, nh, P)))
    dt = t(np.log1p(np.exp(rng.standard_normal((B, S, nh)))), torch.float32)
    A = t(-np.exp(rng.standard_normal(nh) * 0.3), torch.float32)
    Bm = t(rng.standard_normal((B, S, N)))
    Cm = t(rng.standard_normal((B, S, N)))
    n0 = ssd_k.ssd_scan.launches
    y, h = ssd_k.ssd_scan(x, dt, A, Bm, Cm, chunk=chunk)
    torch.cuda.synchronize()
    assert ssd_k.ssd_scan.launches == n0 + 1
    y_p, h_p = ssd_k.ssd_scan_plain(x, dt, A, Bm, Cm, chunk)
    torch.testing.assert_close(y.float(), y_p.float(), atol=5e-2, rtol=5e-2)
    torch.testing.assert_close(h, h_p, atol=5e-4, rtol=5e-4)


@pytest.mark.parametrize("S,H,K,hd", [(70, 4, 4, 16), (200, 8, 2, 64),
                                      (333, 8, 2, 128), (129, 32, 8, 128),
                                      (197, 16, 16, 80)])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("causal", [True, False])
def test_flash_attention_backward_kernel_matches_plain(cuda, S, H, K, hd,
                                                       dtype, causal):
    """K4's backward against its plain twin, GQA (G = 1, 4, 4) and S not a
    multiple of the 64-row tile: 1e-4 in float32 (the same float32
    formula summed in another order; ~2e-6 seen at gradients ~10); in
    bfloat16 both round one float32 result, so within one bf16 ulp as
    K4.  Two launches give the same bits (no atomics)."""
    from repro_torch.kernels.flash_attention import kernel as fa
    q, k, v = _attn_inputs(2, S, H, K, hd, dtype, cuda, S + H)
    dout = _attn_inputs(2, S, H, K, hd, dtype, cuda, S + 1)[0]
    out = fa.flash_attention(q, k, v, causal=causal)
    n0 = fa.flash_attention_backward.launches
    got = fa.flash_attention_backward(q, k, v, out, dout, causal=causal)
    again = fa.flash_attention_backward(q, k, v, out, dout, causal=causal)
    torch.cuda.synchronize()
    assert fa.flash_attention_backward.launches == n0 + 2
    want = fa.flash_attention_backward_plain(q, k, v, out, dout, causal)
    for g, a, w in zip(got, again, want):
        assert g.dtype == dtype and g.shape == w.shape
        assert torch.equal(g, a)
        if dtype == torch.float32:
            torch.testing.assert_close(g, w, atol=1e-4, rtol=1e-4)
        else:
            _k4_within_one_bf16_ulp(g, w)


@pytest.mark.parametrize("S,hd,causal", [
    (1024, 128, True), (1024, 128, False),   # qwen3-8b's training shape
    (1000, 64, True), (1000, 64, False), (1025, 64, True),
    (1025, 64, False), (1000, 128, True), (1000, 128, False),
    (1025, 128, True), (1025, 128, False),
    (197, 80, False), (197, 80, True),       # vit-huge's S and head width
    (256, 80, False), (256, 80, True)])
def test_flash_attention_backward_bf16_tensor_cores_at_model_widths(
        cuda, S, hd, causal):
    """The bfloat16 backward (wgmma, TMA; P and dS as hi + lo) at
    qwen3-8b's training shape (4, 1024, 32 | 8, 128) and at ragged S on
    both sides of its 128-row items, within one bf16 ulp of its plain
    version; two calls give the same bits (no atomics)."""
    from repro_torch.kernels.flash_attention import kernel as fa
    B, H, K = (4, 32, 8) if S == 1024 else (2, 8, 2)
    q, k, v = _attn_inputs(B, S, H, K, hd, torch.bfloat16, cuda, S + hd)
    dout = _attn_inputs(B, S, H, K, hd, torch.bfloat16, cuda, S + 2)[0]
    out = fa.flash_attention(q, k, v, causal=causal)
    n0 = fa.flash_attention_backward.launches
    got = fa.flash_attention_backward(q, k, v, out, dout, causal=causal)
    again = fa.flash_attention_backward(q, k, v, out, dout, causal=causal)
    torch.cuda.synchronize()
    assert fa.flash_attention_backward.launches == n0 + 2
    want = fa.flash_attention_backward_plain(q, k, v, out, dout, causal)
    for g, a, w in zip(got, again, want):
        assert g.dtype == torch.bfloat16 and g.shape == w.shape
        assert torch.equal(g, a)
        _k4_within_one_bf16_ulp(g, w)


#: the sliding windows of the card tests: 1 (each query its own key),
#: sizes that are not multiples of the 64-key tiles or the 128-row items,
#: and one past every S (the causal mask alone)
_WINDOWS = [1, 37, 64, 100, 129, 2000]


@pytest.mark.parametrize("S,hd", [(200, 64), (1000, 128), (1025, 64)])
@pytest.mark.parametrize("window", _WINDOWS)
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_flash_attention_window_matches_plain(cuda, S, hd, window, dtype):
    """K4 and its backward with a sliding window (the hybrid family's)
    against their plain versions, GQA (8 | 2), S ragged against the
    tiles: float32 at K4's 2e-5 and the backward's 1e-4, bf16 within one
    bf16 ulp.  Under window 1 the softmax has one key, so dq and dk are 0
    by construction: the plain version's are float32 rounding (~1e-7),
    no scale for a relative measure, and both are held to 1e-5 (the
    gradients are of order 1).  Two
    backward calls give the same bits; a window past S gives the bits of
    no window, forward and backward."""
    from repro_torch.kernels.flash_attention import kernel as fa
    q, k, v = _attn_inputs(2, S, 8, 2, hd, dtype, cuda, S + window)
    dout = _attn_inputs(2, S, 8, 2, hd, dtype, cuda, S + 3)[0]
    f0, b0 = fa.flash_attention.launches, fa.flash_attention_backward.launches
    out = fa.flash_attention(q, k, v, causal=True, window=window)
    got = fa.flash_attention_backward(q, k, v, out, dout, causal=True,
                                      window=window)
    again = fa.flash_attention_backward(q, k, v, out, dout, causal=True,
                                        window=window)
    torch.cuda.synchronize()
    assert fa.flash_attention.launches == f0 + 1
    assert fa.flash_attention_backward.launches == b0 + 2
    plain = fa.flash_attention_plain(q, k, v, True, window)
    want = fa.flash_attention_backward_plain(q, k, v, out, dout, True,
                                             window)
    if dtype == torch.float32:
        torch.testing.assert_close(out, plain, atol=2e-5, rtol=2e-5)
    else:
        _k4_within_one_bf16_ulp(out, plain)
    for name, g, a, w in zip(("dq", "dk", "dv"), got, again, want):
        assert g.dtype == dtype and g.shape == w.shape
        assert torch.equal(g, a)
        if window == 1 and name != "dv":
            assert float(g.abs().max()) <= 1e-5
            assert float(w.abs().max()) <= 1e-5
        elif dtype == torch.float32:
            torch.testing.assert_close(g, w, atol=1e-4, rtol=1e-4)
        else:
            _k4_within_one_bf16_ulp(g, w)
    if window >= S:
        assert torch.equal(out, fa.flash_attention(q, k, v, causal=True))
        assert all(torch.equal(a, b) for a, b in zip(
            got, fa.flash_attention_backward(q, k, v, out, dout,
                                             causal=True)))


def test_flash_attention_window_is_deterministic(cuda):
    """Two windowed bf16 forwards on the same inputs give the same bits."""
    from repro_torch.kernels.flash_attention import kernel as fa
    q, k, v = _attn_inputs(1, 2000, 8, 8, 64, torch.bfloat16, cuda, 11)
    a = fa.flash_attention(q, k, v, causal=True, window=300)
    b = fa.flash_attention(q, k, v, causal=True, window=300)
    torch.cuda.synchronize()
    assert torch.equal(a, b)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_hybrid_decode_on_card_wraps_the_ring(cuda, dtype):
    """A reduced-width zamba2 (4 layers, the shared block after every 2)
    with attn_window 16, so that both K4's window (forward) and the
    decode ring (W = 16 slots) act within 40 tokens: decode from zero
    state against forward.  float32 (the ring buffers cast to float32;
    the reference's bf16 cache makes float32 decode raise): relative RMS
    1e-4; bf16: the reference's ssm criteria (tests/test_models.py:126).
    The forward launches K4 once per site, with the window."""
    import dataclasses
    from repro_torch.configs import registry
    from repro_torch.kernels.flash_attention import kernel as fa
    from repro_torch.models.model import build

    cfg = dataclasses.replace(registry.get_reduced("zamba2-1.2b"),
                              attn_window=16)
    model = build(cfg).init(dtype=dtype, seed=0, device=cuda)
    toks = torch.from_numpy(np.random.default_rng(2).integers(
        0, cfg.vocab_size, (2, 40))).to(cuda)
    f0 = fa.flash_attention.launches
    full = model({"tokens": toks})[0].float()
    torch.cuda.synchronize()
    assert fa.flash_attention.launches - f0 == 2
    cache = {k: v.to(dtype) if k in ("ak", "av") else v
             for k, v in model.init_cache(2, 40).items()}
    assert cache["ak"].shape[2] == 16
    outs = []
    for t in range(40):
        logits, cache = model.decode_step(cache, toks[:, t:t + 1], t)
        outs.append(logits[:, 0].float())
    dec = torch.stack(outs, dim=1)
    agree = float((dec.argmax(-1) == full.argmax(-1)).float().mean())
    if dtype == torch.float32:
        assert _rel_rms(dec, full) <= 1e-4 and agree >= 0.9
    else:
        torch.testing.assert_close(dec, full, atol=1.5e-1, rtol=5e-2)
        assert agree >= 0.9


#: the kernels of each route of K4's backward (csrc/flash_attention_bwd.cu)
_BWD_KERNELS = {torch.bfloat16: ("prep_tc_kernel", "dkdv_tc_kernel",
                                 "dq_tc_kernel"),
                torch.float32: ("bwd_prep_kernel", "bwd_dkdv_kernel",
                                "bwd_dq_kernel")}


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_flash_attention_backward_routes_by_type(cuda, dtype):
    """By the profiler's kernel names: a bf16 call runs the three
    tensor-core kernels and none of the CUDA-core form; a float32 call
    the CUDA-core form and none of the tensor-core kernels."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    from repro_torch.kernels.flash_attention import kernel as fa
    q, k, v = _attn_inputs(2, 200, 8, 2, 128, dtype, cuda, 7)
    dout = _attn_inputs(2, 200, 8, 2, 128, dtype, cuda, 8)[0]
    out = fa.flash_attention(q, k, v, causal=True)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        fa.flash_attention_backward(q, k, v, out, dout, causal=True)
        torch.cuda.synchronize()
    names = [e.name for e in prof.events()
             if e.device_type == DeviceType.CUDA]
    mine = _BWD_KERNELS[dtype]
    other = _BWD_KERNELS[torch.float32 if dtype == torch.bfloat16
                         else torch.bfloat16]
    for kernel in mine:
        assert sum(f"{kernel}<" in n for n in names) == 1, names
    assert not any(f"{kernel}<" in n for n in names for kernel in other)


def test_training_step_on_card_reaches_attention(cuda):
    """One reduced-depth qwen3-8b training step on the card (block
    remat, int8 moments): K4 launches twice per layer, its backward
    once, and every layer's wq/wk/wv/wo gets a finite, non-zero
    gradient — the output of K4 carries a grad_fn on the card."""
    from repro_torch.configs import registry
    from repro_torch.configs.base import ParallelismConfig
    from repro_torch.kernels.flash_attention import kernel as fa
    from repro_torch.models.model import build
    from repro_torch.train.optimizer import AdamW
    from repro_torch.train.step import build_train_step

    cfg = registry.get_reduced("qwen3-8b")
    model = build(cfg).init(seed=0, device=cuda)
    seen = {}

    class Capture(AdamW):
        def update(self, grads, state, params):
            seen.update({n: float(g.float().norm()) for n, g in
                         grads.items() if ".attn.w" in n})
            return super().update(grads, state, params)

    opt = Capture(lr=1e-3, state_dtype="int8")
    step = build_train_step(model, ParallelismConfig(remat="block"), opt)
    toks = torch.from_numpy(np.random.default_rng(0).integers(
        0, cfg.vocab_size, (2, 65))).to(cuda)
    batch = {"tokens": toks[:, :-1], "labels": toks[:, 1:]}
    f0, b0 = fa.flash_attention.launches, fa.flash_attention_backward.launches
    _, _, metrics = step(model, opt.init(model), batch)
    torch.cuda.synchronize()
    assert fa.flash_attention.launches - f0 == 2 * cfg.n_layers
    assert fa.flash_attention_backward.launches - b0 == cfg.n_layers
    assert np.isfinite(float(metrics["loss"]))
    assert len(seen) == 4 * cfg.n_layers
    assert all(np.isfinite(x) and x > 0 for x in seen.values()), seen


def test_vit_image_path_on_card_takes_the_device_executor(cuda):
    """Reduced vit-huge on the card through ``image_batch_source``: the
    pipeline runs the device executor, so the batch's patch embeddings
    come out on the card (K1 decodes the cold samples there), and one
    training step launches K4 twice per layer, non-causal, and its
    backward once, with finite, non-zero attention gradients."""
    from repro_torch.configs import registry
    from repro_torch.configs.base import ParallelismConfig
    from repro_torch.kernels.flash_attention import kernel as fa
    from repro_torch.launch.train import image_batch_source
    from repro_torch.models.model import build
    from repro_torch.train.optimizer import AdamW
    from repro_torch.train.step import build_train_step

    cfg = registry.get_reduced("vit-huge")
    model = build(cfg).init(seed=0, device=cuda)
    source, pipe, server = image_batch_source(model, 16)
    seen = {}

    class Capture(AdamW):
        def update(self, grads, state, params):
            seen.update({n: float(g.float().norm()) for n, g in
                         grads.items() if ".attn.w" in n})
            return super().update(grads, state, params)

    try:
        assert pipe.executor == "device"
        k1 = decode_k.decode_augment.launches
        batch = source()
        assert decode_k.decode_augment.launches > k1
        assert batch["patch_embeds"].device.type == "cuda"
        assert batch["patch_embeds"].dtype == torch.bfloat16
        assert tuple(batch["patch_embeds"].shape) == (
            16, cfg.frontend_tokens, cfg.d_model)
        assert batch["labels"].device.type == "cuda"
        opt = Capture(lr=1e-3, state_dtype="int8")
        step = build_train_step(model, ParallelismConfig(remat="block"), opt)
        f0 = fa.flash_attention.launches
        b0 = fa.flash_attention_backward.launches
        _, _, metrics = step(model, opt.init(model), batch)
        torch.cuda.synchronize()
    finally:
        pipe.stop()
        server.close()
    assert fa.flash_attention.launches - f0 == 2 * cfg.n_layers
    assert fa.flash_attention_backward.launches - b0 == cfg.n_layers
    assert np.isfinite(float(metrics["loss"]))
    assert len(seen) == 4 * cfg.n_layers
    assert all(np.isfinite(x) and x > 0 for x in seen.values()), seen


@pytest.mark.parametrize("arch", ["deepseek-moe-16b", "kimi-k2-1t-a32b"])
def test_moe_forward_and_backward_on_card_match_cpu(cuda, arch):
    """A reduced moe model in float32 with the same parameters on the
    card and on the CPU: the routing of the first layer equal, logits,
    aux loss, loss and every gradient within 1e-4 (the card runs K4 and
    its backward and cuBLAS, the CPU their plain versions and MKL: other
    summation orders in float32)."""
    from repro_torch.configs import registry
    from repro_torch.kernels.flash_attention import kernel as fa
    from repro_torch.models import moe
    from repro_torch.models.convert import params_from_jax, params_to_numpy
    from repro_torch.models.model import build

    cfg = registry.get_reduced(arch)
    cpu = build(cfg).init(dtype=torch.float32, seed=0, device="cpu")
    card = params_from_jax(build(cfg), params_to_numpy(cpu), device=cuda)
    toks = np.random.default_rng(0).integers(0, cfg.vocab_size, (2, 65))
    batches = [{"tokens": torch.from_numpy(toks[:, :-1]).to(d),
                "labels": torch.from_numpy(toks[:, 1:]).to(d)}
               for d in ("cpu", cuda)]
    x = np.random.default_rng(1).standard_normal((128, cfg.d_model))
    routes = [moe._route(torch.from_numpy(x).float().to(m.device),
                         m["blocks"][0]["moe"]["router"], cfg.moe.top_k)[0]
              for m in (cpu, card)]
    assert torch.equal(routes[0], routes[1].cpu())
    (want, want_aux), (got, aux) = (
        m.forward({"tokens": b["tokens"]}) for m, b in zip((cpu, card),
                                                           batches))
    torch.testing.assert_close(got.cpu(), want, rtol=1e-4, atol=1e-4)
    torch.testing.assert_close(aux.cpu(), want_aux, rtol=1e-4, atol=1e-6)
    grads = []
    f0, b0 = fa.flash_attention.launches, fa.flash_attention_backward.launches
    for m, b in zip((cpu, card), batches):
        m.requires_grad_(True)
        names, ps = zip(*m.named_parameters())
        loss = m.loss(b)
        grads.append((float(loss), dict(zip(names, torch.autograd.grad(
            loss, ps)))))
    torch.cuda.synchronize()
    assert fa.flash_attention.launches - f0 == cfg.n_layers
    assert fa.flash_attention_backward.launches - b0 == cfg.n_layers
    (want_loss, want_g), (got_loss, got_g) = grads
    np.testing.assert_allclose(got_loss, want_loss, rtol=1e-5)
    for n, w in want_g.items():
        scale = float(w.abs().max())
        torch.testing.assert_close(got_g[n].cpu(), w, rtol=1e-4,
                                   atol=1e-4 * max(scale, 1.0), msg=n)
        if ".moe." in n:
            assert scale > 0, n


def test_moe_bf16_prefill_is_bitwise_repeatable_on_card(cuda, monkeypatch):
    """Two bf16 prefills of reduced deepseek-moe-16b on the card (4 x
    256 tokens, assignments dropped at the published capacity factor)
    give the same bits, and forward's: the dispatch is a gather and the
    combine adds each token's rows in a fixed order, with no atomics."""
    from repro_torch.configs import registry
    from repro_torch.models import moe
    from repro_torch.models.model import build

    cfg = registry.get_reduced("deepseek-moe-16b")
    model = build(cfg).init(seed=0, device=cuda)
    toks = torch.from_numpy(np.random.default_rng(2).integers(
        0, cfg.vocab_size, (4, 256))).to(cuda)
    plan, dropped = moe.dispatch_plan, []

    def counting(top_e, n_experts, capacity, e_start=0):
        slot, src = plan(top_e, n_experts, capacity, e_start)
        dropped.append(int((slot == n_experts * capacity).sum()))
        return slot, src

    monkeypatch.setattr(moe, "dispatch_plan", counting)
    first, _ = model.prefill({"tokens": toks}, model.init_cache(4, 260))
    second, _ = model.prefill({"tokens": toks}, model.init_cache(4, 260))
    full, _ = model.forward({"tokens": toks})
    assert torch.equal(first, second) and torch.equal(first, full)
    assert bool(torch.isfinite(first.float()).all())
    assert len(dropped) == 3 * cfg.n_layers and sum(dropped) > 0, dropped


#: K5's backward against its plain version, as a relative RMS by the
#: type a gradient is stored in (chip_smoke.SSD_BWD_RMS)
K5_BWD_RMS = {torch.bfloat16: 5e-4, torch.float32: 2e-4}


def _rel_rms(got, want):
    return float((got.float() - want.float()).norm()
                 / want.float().norm().clamp_min(1e-30))


@pytest.mark.parametrize("S,P,N,chunk", [(64, 16, 16, 64), (100, 16, 16, 32),
                                         (256, 64, 128, 256),
                                         (300, 64, 128, 256),
                                         (1000, 64, 128, 128),
                                         (600, 64, 128, 256),
                                         (400, 48, 80, 150),
                                         # zamba2-1.2b's P 64, N 64
                                         (300, 64, 64, 256),
                                         (1000, 64, 64, 256)])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("with_dh", [False, True])
def test_ssd_scan_backward_kernel_matches_plain(cuda, S, P, N, chunk, dtype,
                                                with_dh):
    """K5's backward (csrc/ssd_scan_bwd.cu) against its plain twin, with
    and without the final state's gradient, S ragged against the
    kernels' chunks (bf16: the forward's, 64 to 256 rows, 192 for chunk
    150; float32: 64 rows), P and N below 64 and 128 and not powers of
    two, dt on mamba2's scale (log-uniform on [1e-3,
    0.1]) so that states pass between chunks: each gradient within
    ``K5_BWD_RMS`` of plain by the type it is stored in (the limits of
    chip_smoke.SSD_BWD_RMS, with their reasons); a second call gives the
    same bits (no atomics)."""
    from repro_torch.kernels.ssd_scan import kernel as ssd_k
    rng = np.random.default_rng(S + P + with_dh)
    B, nh = 2, 3

    def t(a, dt=dtype):
        return torch.from_numpy(a.astype(np.float32)).to(dt).to(cuda)

    x = t(rng.standard_normal((B, S, nh, P)) * 0.5)
    dt = t(np.exp(rng.uniform(np.log(1e-3), np.log(0.1), (B, S, nh))),
           torch.float32)
    A = t(-np.exp(rng.standard_normal(nh) * 0.3), torch.float32)
    Bm = t(rng.standard_normal((B, S, N)) * 0.5)
    Cm = t(rng.standard_normal((B, S, N)) * 0.5)
    dy = t(rng.standard_normal((B, S, nh, P)))
    dh = t(rng.standard_normal((B, nh, P, N)), torch.float32) \
        if with_dh else None
    n0 = ssd_k.ssd_scan_backward.launches
    got = ssd_k.ssd_scan_backward(x, dt, A, Bm, Cm, dy, dh, chunk=chunk)
    torch.cuda.synchronize()
    assert ssd_k.ssd_scan_backward.launches == n0 + 1
    again = ssd_k.ssd_scan_backward(x, dt, A, Bm, Cm, dy, dh, chunk=chunk)
    want = ssd_k.ssd_scan_backward_plain(x, dt, A, Bm, Cm, dy, dh, chunk)
    for name, g, a, w in zip(("dx", "ddt", "dA", "dB", "dC"), got, again,
                             want):
        assert g.dtype == w.dtype and g.shape == w.shape, name
        assert torch.equal(g, a), name
        assert _rel_rms(g, w) <= K5_BWD_RMS[g.dtype], (name, _rel_rms(g, w))


#: the kernels of each route of K5's backward (csrc/ssd_scan_bwd.cu)
_SSD_BWD_KERNELS = {
    torch.bfloat16: ("prep_tc_kernel", "pair_tc_kernel", "pass_tc_kernel",
                     "dx_tc_kernel", "finish_tc_kernel", "dbc_tc_kernel"),
    torch.float32: ("prep_kernel", "pair_kernel", "pass_kernel", "dx_kernel",
                    "dbc_kernel", "da_kernel")}


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_ssd_scan_backward_routes_by_type(cuda, dtype):
    """By the profiler's kernel names: a bf16 call runs the six
    tensor-core kernels once each and none of the CUDA-core design; a
    float32 call the CUDA-core design and none of the tensor-core
    kernels."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    from repro_torch.kernels.ssd_scan import kernel as ssd_k
    rng = np.random.default_rng(9)
    B, S, nh, P, N = 1, 300, 2, 64, 128

    def t(shape, dt=dtype, scale=0.5):
        return torch.from_numpy(rng.standard_normal(shape).astype(
            np.float32) * scale).to(cuda, dt)

    x, Bm, Cm, dy = t((B, S, nh, P)), t((B, S, N)), t((B, S, N)), \
        t((B, S, nh, P), scale=1.0)
    dt = t((B, S, nh), torch.float32).abs() * 0.1
    A = -torch.ones(nh, device=cuda)
    ssd_k.ssd_scan_backward(x, dt, A, Bm, Cm, dy, chunk=256)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        ssd_k.ssd_scan_backward(x, dt, A, Bm, Cm, dy, chunk=256)
        torch.cuda.synchronize()
    names = [e.name for e in prof.events()
             if e.device_type == DeviceType.CUDA]

    def launched(kernel):
        return sum(f"ssd_bwd::{kernel}<" in n or f"::{kernel}(" in n
                   for n in names)

    other = _SSD_BWD_KERNELS[torch.float32 if dtype == torch.bfloat16
                             else torch.bfloat16]
    for kernel in _SSD_BWD_KERNELS[dtype]:
        assert launched(kernel) == 1, (kernel, names)
    assert not any(launched(kernel) for kernel in other), names


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_ssd_scan_backward_takes_unaligned_inputs(cuda, dtype):
    """The kernels read x, dy, B, C and dh as 16-byte vectors: contiguous
    views that start off a 16-byte boundary give the same bits as their
    aligned copies."""
    from repro_torch.kernels.ssd_scan import kernel as ssd_k
    rng = np.random.default_rng(5)
    B, S, nh, P, N = 1, 70, 2, 16, 32

    def t(shape, dt=dtype, scale=0.5):
        a = torch.from_numpy(rng.standard_normal(shape).astype(np.float32)
                             * scale).to(cuda, dt)
        flat = torch.empty(a.numel() + 1, dtype=dt, device=cuda)
        flat[1:] = a.reshape(-1)
        return flat[1:].view(shape)

    x, Bm, Cm, dy = t((B, S, nh, P)), t((B, S, N)), t((B, S, N)), \
        t((B, S, nh, P), scale=1.0)
    dh = t((B, nh, P, N), torch.float32)
    dt = torch.nn.functional.softplus(torch.from_numpy(
        rng.standard_normal((B, S, nh)).astype(np.float32)).to(cuda))
    A = -torch.ones(nh, device=cuda)
    assert all(a.data_ptr() % 16 for a in (x, Bm, Cm, dy, dh))
    got = ssd_k.ssd_scan_backward(x, dt, A, Bm, Cm, dy, dh)
    want = ssd_k.ssd_scan_backward(*(a.clone() for a in (x, dt, A, Bm, Cm,
                                                         dy, dh)))
    for g, w in zip(got, want):
        assert torch.equal(g, w)


def test_ssd_scan_backward_rejects_unsupported_shapes(cuda):
    from repro_torch.kernels.ssd_scan import kernel as ssd_k
    dt = torch.zeros((1, 8, 1), device=cuda)
    A = -torch.ones(1, device=cuda)
    for P, N in ((24, 16), (80, 16), (16, 144)):
        x = torch.zeros((1, 8, 1, P), device=cuda)
        Bm = torch.zeros((1, 8, N), device=cuda)
        with pytest.raises(ValueError, match="multiples of 16"):
            ssd_k.ssd_scan_backward(x, dt, A, Bm, Bm, x)


def test_training_step_on_card_reaches_the_scan(cuda):
    """One reduced-depth mamba2-1.3b training step on the card (block
    remat, int8 moments): K5 launches twice per layer, its backward
    once, and every layer's ssm weights that reach the scan get a
    finite, non-zero gradient — the output of K5 carries a grad_fn on
    the card."""
    from repro_torch.configs import registry
    from repro_torch.configs.base import ParallelismConfig
    from repro_torch.kernels.ssd_scan import kernel as ssd_k
    from repro_torch.models.model import build
    from repro_torch.train.optimizer import AdamW
    from repro_torch.train.step import build_train_step

    cfg = registry.get_reduced("mamba2-1.3b")
    model = build(cfg).init(seed=0, device=cuda)
    seen = {}
    names = ("wx", "wB", "wC", "wdt", "A_log", "dt_bias", "conv_x",
             "conv_B", "conv_C")

    class Capture(AdamW):
        def update(self, grads, state, params):
            seen.update({n: float(g.float().norm()) for n, g in
                         grads.items() if n.split(".")[-1] in names})
            return super().update(grads, state, params)

    opt = Capture(lr=1e-3, state_dtype="int8")
    step = build_train_step(model, ParallelismConfig(remat="block"), opt)
    toks = torch.from_numpy(np.random.default_rng(0).integers(
        0, cfg.vocab_size, (2, 129))).to(cuda)
    batch = {"tokens": toks[:, :-1], "labels": toks[:, 1:]}
    f0, b0 = ssd_k.ssd_scan.launches, ssd_k.ssd_scan_backward.launches
    _, _, metrics = step(model, opt.init(model), batch)
    torch.cuda.synchronize()
    assert ssd_k.ssd_scan.launches - f0 == 2 * cfg.n_layers
    assert ssd_k.ssd_scan_backward.launches - b0 == cfg.n_layers
    assert np.isfinite(float(metrics["loss"]))
    assert len(seen) == len(names) * cfg.n_layers
    assert all(np.isfinite(x) and x > 0 for x in seen.values()), seen


def test_k4_k5_reject_unsupported_cuda_shapes(cuda):
    from repro_torch.kernels.flash_attention import kernel as fa
    from repro_torch.kernels.ssd_scan import kernel as ssd_k
    for hd in (12, 136):
        q, k, v = _attn_inputs(1, 8, 2, 2, hd, torch.float32, cuda, 0)
        with pytest.raises(ValueError, match="head_dim"):
            fa.flash_attention(q, k, v)
    q, k, v = _attn_inputs(1, 8, 3, 2, 16, torch.float32, cuda, 0)
    with pytest.raises(ValueError, match="group"):
        fa.flash_attention(q, k, v)
    with pytest.raises(ValueError, match="contiguous"):
        q, k, v = _attn_inputs(1, 8, 2, 2, 16, torch.float32, cuda, 0)
        fa.flash_attention(q.transpose(1, 2), k, v)
    x = torch.zeros((1, 8, 1, 256), device=cuda)
    dt = torch.zeros((1, 8, 1), device=cuda)
    A = torch.zeros(1, device=cuda)
    Bm = torch.zeros((1, 8, 256), device=cuda)
    with pytest.raises(ValueError, match="shared memory"):
        ssd_k.ssd_scan(x, dt, A, Bm, Bm)
    with pytest.raises(TypeError):
        ssd_k.ssd_scan(x, dt.double(), A, Bm, Bm)
    with pytest.raises(ValueError, match="multiples of 16"):
        xb = torch.zeros((1, 8, 1, 24), device=cuda, dtype=torch.bfloat16)
        Bb = torch.zeros((1, 8, 16), device=cuda, dtype=torch.bfloat16)
        ssd_k.ssd_scan(xb, dt, A, Bb, Bb)


# ----------------------------------------------------------------------
# the ODS step on the card ("torch" backend)
ODS_VARIANTS = ("plain", "tiered", "inflight", "tiered_inflight")


def _ods_tables(rng, N, variant):
    status = np.where(rng.random(N) < 0.5, rng.integers(1, 4, N), 0) \
        .astype(np.uint8)
    residency = np.where(status != 0, rng.integers(1, 4, N), 0) \
        .astype(np.uint8) if "tiered" in variant else None
    inflight = rng.random(N) < 0.3 if "inflight" in variant else None
    return status, residency, inflight


def _ods_scores(status, seen, requested, residency, inflight):
    """Candidate scores as the reference scores them (0 = none)."""
    cached = status != 0
    direct = cached[requested] & ~seen[requested]
    in_batch = np.zeros(len(status), bool)
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


@pytest.mark.parametrize("variant", ODS_VARIANTS)
def test_torch_ods_backend_invariants_on_card(cuda, variant):
    """Over two epochs on the card, every step of every variant serves
    unique unseen ids, keeps direct hits in their slots and fills from
    the best class with a free candidate; the step's tensors live on the
    card."""
    from repro_torch.api import TorchOdsBackend
    from repro_torch.core import ods_torch
    N, B = 2048, 64
    rng = np.random.default_rng(3)
    be = TorchOdsBackend(N, seed=1)
    assert be.device.type == "cuda"
    be.register_job(0)
    status, residency, inflight = _ods_tables(rng, N, variant)
    for form in (1, 2, 3):
        be.mark_cached(np.flatnonzero(status == form), form)
    be.set_residency(residency)
    be.set_inflight(inflight)
    seen_devices = set()
    core = ods_torch._substitute_core

    def spy(state, *a, **kw):
        seen_devices.add(state.status.device.type)
        return core(state, *a, **kw)

    ods_torch._substitute_core = spy
    try:
        for step in range(2 * N // B):
            pre_status, pre_seen = be.status.copy(), be.seen[0].copy()
            if N - be.served[0] < B:
                pre_seen[:] = False
            req = rng.choice(N, B, replace=False)
            batch, _ = be.sample_batch(0, req, evict_threshold=2)
            score, direct = _ods_scores(pre_status, pre_seen, req,
                                        residency, inflight)
            assert len(set(batch.tolist())) == B
            assert not pre_seen[batch].any()
            np.testing.assert_array_equal(batch[direct], req[direct])
            subs = batch[~direct]
            taken = np.zeros(N, bool)
            taken[subs] = True
            left = score[(score > 0) & ~taken]
            if len(subs) and len(left):
                assert score[subs].min() >= left.max()
    finally:
        ods_torch._substitute_core = core
    assert seen_devices == {"cuda"}
    assert be.epoch_of(0) >= 1


@pytest.mark.parametrize("variant", ODS_VARIANTS)
def test_torch_ods_forced_choice_equals_cpu_exactly(cuda, variant):
    """Where the choice is forced (the best class holds exactly as many
    free candidates as slots) the card's step equals the CPU's: the
    batch's set, status, refcount, seen and served."""
    from repro_torch.api import TorchOdsBackend
    N, B = 512, 16
    rng = np.random.default_rng(5)
    best = rng.choice(400, B, replace=False)
    others = np.setdiff1d(np.arange(400), best)[:100]
    out = []
    for dev in ("cuda", "cpu"):
        be = TorchOdsBackend(N, seed=9, device=dev)
        be.register_job(0)
        be.register_job(1)
        be.mark_cached(best, 3)
        residency = inflight = None
        if "tiered" in variant:
            be.mark_cached(others, 2)
            residency = np.zeros(N, np.uint8)
            residency[best] = 3
            residency[others] = 2
        if "inflight" in variant:
            if residency is None:
                be.mark_cached(others, 3)
            inflight = np.zeros(N, bool)
            inflight[others] = True
        be.set_residency(residency)
        be.set_inflight(inflight)
        batch, evicted = be.sample_batch(0, np.arange(450, 450 + B))
        out.append((sorted(batch.tolist()), evicted.tolist(),
                    be.status.copy(), be.refcount.copy(), be.seen[0].copy(),
                    be.served[0], be.hits, be.substitutions))
    card, host = out
    assert card[0] == host[0] == sorted(best.tolist())
    for a, b in zip(card[1:], host[1:]):
        np.testing.assert_array_equal(a, b)


def test_torch_ods_checkpoint_restore_on_card(cuda):
    from repro_torch.api import TorchOdsBackend
    be = TorchOdsBackend(256, seed=2)
    be.register_job(0)
    be.mark_cached(np.arange(0, 256, 2), 3)
    for i in range(5):
        be.sample_batch(0, np.arange(i * 32, i * 32 + 32))
    snap = be.checkpoint_job(0)
    assert snap["rng_state"] == be.generator.get_state().tolist()
    other = TorchOdsBackend(256, seed=3)
    other.register_job(4)
    other.restore_job(4, snap)
    np.testing.assert_array_equal(other.seen[4], be.seen[0])
    assert (other.served[4], other.epoch[4]) == (be.served[0], be.epoch[0])
    # the resumed job finishes the epoch without a repeat
    served = set(np.flatnonzero(other.seen[4]).tolist())
    while other.served[4] + 32 <= 256:
        batch, _ = other.sample_batch(4, np.arange(32))
        assert not served & set(batch.tolist())
        served |= set(batch.tolist())
    assert served == set(range(256))


def test_two_job_device_workload_on_card(cuda):
    """Two jobs share one cache on the card under a real clock: each
    runs the device executor (K1 for cold samples) with the ODS step on
    the card, and each serves every id exactly once."""
    from repro_torch.api import JobSpec
    ds = tiny(n=128)
    server = SenecaServer.for_dataset(
        ds, backend="torch", cache_frac=0.25, split=(0.0, 0.0, 1.0),
        device_cache_bytes=int(0.5 * 128 * ds.augmented_bytes()),
        hbm_split=(0.0, 0.0, 1.0), seed=0)
    n0 = decode_k.decode_augment.launches
    res = server.run_workload(
        [JobSpec("a", epochs=1, batch_size=16, executor="device"),
         JobSpec("b", arrival_s=0.05, epochs=1, batch_size=16,
                 executor="device")], RemoteStorage(ds), timeout=300)
    server.close()
    assert res.ok and res.stats["backend"] == "torch"
    for j in res.jobs:
        assert sorted(j.sample_ids) == list(range(128)), j.spec.name
    assert decode_k.decode_augment.launches > n0
    assert res.stats["substitutions"] > 0


# ----------------------------------------------------------------------
# The sharded data plane on the card
def test_sim_shard_hbm_hit_is_the_admitted_cuda_tensor(cuda):
    from repro_torch.api import ShardedCache
    c = ShardedCache(1 << 20, (0.0, 0.0, 1.0), hbm_bytes=1 << 20,
                     hbm_split=(0.0, 0.0, 1.0), shards=2, seed=0,
                     device=cuda)
    rows = {k: torch.full((8, 8, 3), float(k), device=cuda)
            for k in range(6)}
    assert all(c.insert_batch_gated(
        "augmented", [(k, r, r.numel() * 4) for k, r in rows.items()]))
    for k, r in rows.items():
        form, value, tier = c.lookup_tiered(k)
        assert (form, tier) == ("augmented", "hbm") and value is r
    assert all(s["hbm_device"].startswith("cuda") for s in c.shard_stats())
    c.close()


def test_process_shard_builds_its_hbm_tier_on_cuda(cuda):
    from repro_torch.api import ShardedCache
    ds = tiny(n=16)
    c = ShardedCache(16 * ds.augmented_bytes(), (0.1, 0.3, 0.6),
                     hbm_bytes=16 * ds.augmented_bytes(),
                     hbm_split=(0.0, 0.3, 0.7), shards=2,
                     transport="process", seed=0, dataset=ds,
                     device="cuda")
    try:
        assert c.ingest(range(16)) == 16
        stats = c.shard_stats()
        assert all(s["hbm_device"].startswith("cuda") for s in stats)
        assert sum(s["hbm_bytes_used"] for s in stats) > 0
        answers = [c.lookup_tiered(sid) for sid in range(16)]
        assert all(isinstance(v, np.ndarray) for _f, v, _t in answers)
        assert "hbm" in {t for _f, _v, t in answers}
    finally:
        c.close()


def test_device_executor_over_process_shards_on_card(cuda):
    """The server's own process shards (``SenecaServer.for_dataset``) on
    the card: the cold epoch's K1 rows are brought down, shipped and
    uploaded into the shards' HBM tiers in their own CUDA contexts; in
    the second epoch the executor uploads their host copies (metered on
    "h2d"), sends the decoded ones through K2, and collates rows bitwise
    equal to the host path."""
    from test_torch_service_process import second_epoch, shipped_server
    n, bs = 48, 8
    ds = tiny(n=n)
    k1 = decode_k.decode_augment.launches
    server, sess, pipe = shipped_server(ds, n, bs, None)
    try:
        assert decode_k.decode_augment.launches - k1 == n // bs
        stats = server.stats()["shards"]
        assert all(s["hbm_device"].startswith("cuda")
                   and s["hbm_bytes_used"] > 0 for s in stats)
        tel = server.service.telemetry
        before = dict(tel.snapshot().serve_counts)
        h2d0 = tel.channel_total_bytes("h2d")
        k2 = augment_k.augment.launches
        devices, seen, tiers = second_epoch(ds, n, bs, sess, pipe)
        assert devices == {"cuda"}
        assert sorted(seen) == list(range(n))
        assert all(t is not torch.Tensor for _f, _t, t in tiers)
        served = {k: v - before.get(k, 0)
                  for k, v in tel.snapshot().serve_counts.items()}
        assert served["decoded"] > 0 and augment_k.augment.launches > k2
        assert tel.channel_total_bytes("h2d") - h2d0 == \
            served["augmented"] * ds.augmented_bytes() \
            + served["decoded"] * ds.decoded_bytes() > 0
    finally:
        server.close()


# ------------------------------------------- K4 with its own key length
#: (Sq, Sk) of the cross-attention card checks: queries on both sides of
#: a 128-row item, keys short of one 64-key tile, ragged past one and two,
#: and one past 1024
_KV_LENGTHS = [(37, 16), (37, 100), (37, 130), (37, 1025), (1000, 16),
               (1000, 100), (1000, 130), (1000, 1025)]


def _cross_inputs(B, Sq, Sk, H, K, hd, dtype, dev, seed):
    rng = np.random.default_rng(seed)
    return [torch.from_numpy(rng.standard_normal(shape).astype(np.float32))
            .to(dtype).to(dev)
            for shape in ((B, Sq, H, hd), (B, Sk, K, hd), (B, Sk, K, hd),
                          (B, Sq, H, hd))]


@pytest.mark.parametrize("Sq,Sk", _KV_LENGTHS)
@pytest.mark.parametrize("hd", [64, 128])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_flash_attention_with_its_own_key_length_matches_plain(
        cuda, Sq, Sk, hd, dtype):
    """K4 and its backward non-causal at Sq != Sk (the encdec family's
    cross-attention), GQA 8 | 2, against their plain versions: float32 at
    K4's 2e-5 and the backward's 1e-4, bf16 within one bf16 ulp; dk and
    dv have the keys' length; two backward calls give the same bits."""
    from repro_torch.kernels.flash_attention import kernel as fa
    q, k, v, dout = _cross_inputs(2, Sq, Sk, 8, 2, hd, dtype, cuda,
                                  Sq + Sk + hd)
    f0, b0 = fa.flash_attention.launches, fa.flash_attention_backward.launches
    out = fa.flash_attention(q, k, v, causal=False)
    got = fa.flash_attention_backward(q, k, v, out, dout, causal=False)
    again = fa.flash_attention_backward(q, k, v, out, dout, causal=False)
    torch.cuda.synchronize()
    assert fa.flash_attention.launches == f0 + 1
    assert fa.flash_attention_backward.launches == b0 + 2
    plain = fa.flash_attention_plain(q, k, v, False)
    want = fa.flash_attention_backward_plain(q, k, v, out, dout, False)
    if dtype == torch.float32:
        torch.testing.assert_close(out, plain, atol=2e-5, rtol=2e-5)
    else:
        _k4_within_one_bf16_ulp(out, plain)
    for g, a, w, t in zip(got, again, want, (q, k, v)):
        assert g.dtype == dtype and g.shape == t.shape == w.shape
        assert torch.equal(g, a)
        if dtype == torch.float32:
            torch.testing.assert_close(g, w, atol=1e-4, rtol=1e-4)
        else:
            _k4_within_one_bf16_ulp(g, w)


@pytest.mark.parametrize("arch", ["internvl2-2b", "seamless-m4t-large-v2"])
def test_vlm_and_encdec_forward_and_backward_on_card_match_cpu(cuda, arch):
    """A reduced internvl2-2b and seamless-m4t-large-v2 in float32 with
    the same parameters on the card and on the CPU: logits, loss and
    every gradient within 1e-4 (the card runs K4 and its backward, the
    encdec family's cross-attention at Sq != Sk among them, the CPU their
    plain versions); K4 and its backward launch once per attention of a
    layer."""
    from repro_torch.configs import registry
    from repro_torch.kernels.flash_attention import kernel as fa
    from repro_torch.launch.train import lm_batch_source
    from repro_torch.models.convert import params_from_jax, params_to_numpy
    from repro_torch.models.model import build

    cfg = registry.get_reduced(arch)
    cpu = build(cfg).init(dtype=torch.float32, seed=0, device="cpu")
    card = params_from_jax(build(cfg), params_to_numpy(cpu), device=cuda)
    batch = {k: v.float() if v.is_floating_point() else v
             for k, v in lm_batch_source(cpu, 2, 160, seed=1)().items()}
    batches = [batch, {k: v.to(cuda) for k, v in batch.items()}]
    grads = []
    f0, b0 = fa.flash_attention.launches, fa.flash_attention_backward.launches
    for m, b in zip((cpu, card), batches):
        m.requires_grad_(True)
        names, ps = zip(*m.named_parameters())
        loss = m.loss(b)
        grads.append((float(loss), dict(zip(names, torch.autograd.grad(
            loss, ps)))))
    torch.cuda.synchronize()
    attn = cfg.n_layers + (cfg.n_layers + cfg.n_encoder_layers
                           if cfg.family == "encdec" else 0)
    assert fa.flash_attention.launches - f0 == attn
    assert fa.flash_attention_backward.launches - b0 == attn
    (want_loss, want_g), (got_loss, got_g) = grads
    np.testing.assert_allclose(got_loss, want_loss, rtol=1e-5)
    for n, w in want_g.items():
        scale = float(w.abs().max())
        torch.testing.assert_close(got_g[n].cpu(), w, rtol=1e-4,
                                   atol=1e-4 * max(scale, 1.0), msg=n)


@pytest.mark.parametrize("arch", ["internvl2-2b", "seamless-m4t-large-v2"])
def test_vlm_and_encdec_bf16_prefill_and_decode_on_card(cuda, arch):
    """A reduced bf16 model on the card: prefill's logits equal
    forward's bitwise, and decode at index S (reading prefill's cache,
    for encdec its ``encdec_src_len(S)`` cross rows) agrees with forward
    on the extended sequence within the reference's 1e-2."""
    from repro_torch.configs import registry
    from repro_torch.launch.train import lm_batch_source
    from repro_torch.models.model import build

    cfg = registry.get_reduced(arch)
    model = build(cfg).init(seed=0, device=cuda)
    batch = lm_batch_source(model, 2, 160, seed=2)()
    batch.pop("labels")
    S = 160
    logits, cache = model.prefill(batch, model.init_cache(2, S + 40))
    full, _ = model.forward(batch)
    assert torch.equal(logits, full)
    nxt = torch.full((2, 1), 3, dtype=torch.int64, device=cuda)
    dec, _ = model.decode_step(cache, nxt, S)
    ext = dict(batch, tokens=torch.cat([batch["tokens"], nxt], dim=1))
    want, _ = model.forward(ext)
    torch.testing.assert_close(dec[:, 0].float(), want[:, -1].float(),
                               atol=1e-2, rtol=1e-2)


# ------------------------------------------- the mesh layer over NCCL

@pytest.fixture(scope="module")
def nccl_world(tmp_path_factory):
    """A world of one rank over NCCL (``tests/torch_world.py``): the
    data-parallel step with and without the int8 all-reduce, the
    sequence-parallel SSD and the expert-parallel moe on reduced models,
    each beside its single-device path."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (torch.cuda.is_available() is "
                    "false)")
    import torch_world
    return torch_world.spawn("nccl_world_of_one",
                             tmp_path_factory.mktemp("nccl"), world=1,
                             device="cuda")[0]


def test_nccl_dp_step_equals_single_device_step(nccl_world):
    single, single_loss = nccl_world["dp"]["single"]
    dp, dp_loss = nccl_world["dp"]["dp"]
    assert dp_loss == single_loss
    assert all(torch.equal(dp[n], single[n]) for n in single)
    _, comp_loss = nccl_world["dp"]["dp_compressed"]
    assert abs(comp_loss - single_loss) < 0.1
    assert nccl_world["compressed"] == (True, True, True)


def test_nccl_sp_and_ep_forward_equal_local(nccl_world):
    from repro_torch.configs import registry
    assert nccl_world["sp"] == (
        True, registry.get_reduced("mamba2-1.3b").n_layers)
    assert nccl_world["ep"] == (
        True, True, registry.get_reduced("deepseek-moe-16b").n_layers)


def test_nccl_pipeline_and_reshard_equal_local(nccl_world):
    """Reduced qwen3-8b: ``pipeline_forward`` at one stage (2
    microbatches, K4 (M + S - 1) x L times) equals ``run_decoder`` on each
    microbatch bitwise, so does the 2-stage schedule run in one process;
    ``reshard`` onto ``make_mesh(1)`` demotes nothing, keeps every block
    as it was, and a model loaded from it gives the same logits."""
    from repro_torch.configs import registry
    n_layers = registry.get_reduced("qwen3-8b").n_layers
    assert nccl_world["pp"] == (True, 2 * n_layers, True)
    assert nccl_world["reshard"] == ([], True, True)


def _rel_rms(got, want) -> float:
    return float((got.float() - want.float()).norm() / want.float().norm())


@pytest.mark.parametrize("n", [2, 4])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_ssm_block_in_segments_matches_local_on_card(cuda, n, dtype):
    """The sequence-parallel stages on the card, with no collective:
    reduced mamba2-1.3b's block, the sequence (2 x 256) cut into ``n``
    segments, each through K5 from a zero state, its halo from the
    segment before and its incoming state from the hand-off
    (``ssm_block_in_segments``), against the local ``ssm_block`` (one K5
    pass over the whole sequence).  float32: within 1e-4 of the largest
    output, the reference's SP bound; bf16: relative RMS within 2**-6
    (each segment's y is rounded to bf16 once more before the hand-off's
    float32 part is added)."""
    from repro_torch.configs import registry
    from repro_torch.kernels.ssd_scan import kernel as ssd_k
    from repro_torch.models.model import build
    from repro_torch.models.ssm import ssm_block
    from repro_torch.models.ssm_sp import ssm_block_in_segments
    cfg = registry.get_reduced("mamba2-1.3b")
    model = build(cfg).init(seed=0, device=cuda).to(dtype)
    p = model.blocks[0]["ssm"]
    gen = torch.Generator(device=cuda).manual_seed(n)
    x = (torch.randn(2, 256, cfg.d_model, generator=gen, device=cuda)
         * 0.5).to(dtype)
    with torch.no_grad():
        n0 = ssd_k.ssd_scan.launches
        got = ssm_block_in_segments(p, x, cfg, n)
        assert ssd_k.ssd_scan.launches == n0 + n
        want = ssm_block(p, x, cfg)
    assert got.dtype == dtype and got.shape == want.shape
    if dtype == torch.float32:
        d = float((got - want).abs().max())
        assert d <= 1e-4 * float(want.abs().max()), d
    else:
        assert _rel_rms(got, want) <= 2.0 ** -6


@pytest.mark.parametrize("n_ranges", [2, 4])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_dispatch_over_expert_ranges_sums_to_local_on_card(cuda, n_ranges,
                                                          dtype):
    """The expert-parallel ranks' dispatch on the card, with no
    collective: reduced deepseek-moe-16b's first moe layer routes 2 x 64
    tokens at its capacity factor (with drops), and the outputs over
    ``n_ranges`` expert ranges (``e_start`` > 0 for all but the first)
    summed against the dispatch over all experts.  float32: within 1e-5
    of the largest output; bf16: relative RMS within 2**-6 (the ranges'
    partial sums are added in another order)."""
    from repro_torch.configs import registry
    from repro_torch.models import moe
    from repro_torch.models.model import build
    cfg = registry.get_reduced("deepseek-moe-16b")
    e = cfg.moe
    model = build(cfg).init(seed=0, device=cuda).to(dtype)
    p = next(b["moe"] for b in model.blocks if "moe" in b)
    gen = torch.Generator(device=cuda).manual_seed(n_ranges)
    x2d = torch.randn(128, cfg.d_model, generator=gen, device=cuda).to(dtype)
    with torch.no_grad():
        top_e, top_g, _ = moe._route(x2d, p["router"], e.top_k)
        cap = moe._capacity(128, e.top_k, e.n_experts, e.capacity_factor)
        want = moe._dispatch_local(x2d, top_e, top_g, cap, p["we_gate"],
                                   p["we_up"], p["we_out"])
        n_local = e.n_experts // n_ranges
        got = sum(moe._dispatch_local(
            x2d, top_e, top_g, cap,
            *(p[w][lo:lo + n_local] for w in ("we_gate", "we_up", "we_out")),
            e_start=lo) for lo in range(0, e.n_experts, n_local))
    if dtype == torch.float32:
        d = float((got - want).abs().max())
        assert d <= 1e-5 * float(want.abs().max()), d
    else:
        assert _rel_rms(got, want) <= 2.0 ** -6


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_kernel_ops_fake_outputs_match_launches(cuda, dtype):
    """Each kernel op's fake implementation (what a dry-run trace sees)
    gives the shapes, dtypes, strides and device of the launch's outputs
    on the card: K4, its backward (lse and delta at the library's row
    count), K5 and its backward."""
    from torch._subclasses.fake_tensor import FakeTensorMode
    from repro_torch.kernels.flash_attention import kernel as fa
    gen = torch.Generator(device=cuda).manual_seed(0)

    def r(*shape, dt=dtype):
        return torch.randn(shape, generator=gen, device=cuda).to(dt)
    q, k, v = r(2, 200, 4, 64), r(2, 200, 2, 64), r(2, 200, 2, 64)
    out = fa.flash_attention(q, k, v, causal=True)
    x, Bm, Cm = r(2, 100, 3, 16), r(2, 100, 16), r(2, 100, 16)
    dt = r(2, 100, 3, dt=torch.float32).abs() * 0.1
    A = -r(3, dt=torch.float32).abs()
    ops = torch.ops.repro_torch
    calls = [(ops.flash_attention, (q, k, v, True, 0)),
             (ops.flash_attention_bwd, (q, k, v, out, out, True, 0)),
             (ops.ssd_scan, (x, dt, A, Bm, Cm, 64)),
             (ops.ssd_scan_bwd, (x, dt, A, Bm, Cm, x, None, 64))]
    for op, args in calls:
        real = op(*args)
        with FakeTensorMode() as mode:
            fake = op(*(mode.from_tensor(a) if isinstance(a, torch.Tensor)
                        else a for a in args))
        real, fake = ((t,) if isinstance(t, torch.Tensor) else t
                      for t in (real, fake))
        assert [(t.shape, t.dtype, t.stride(), t.device.type)
                for t in fake] == [(t.shape, t.dtype, t.stride(),
                                    t.device.type) for t in real], op
