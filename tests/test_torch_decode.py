"""Decode and fused decode+augment of the port against the JAX package.

The same inputs, drawn with numpy from a seed, go through the reference
(``repro``: host ``SyntheticDataset.decode`` + ``augment_batch_np``, and
the Pallas kernels in interpret mode on the CPU) and through the port's
CPU path (``repro_torch``: the kernels' plain PyTorch versions).

Contracts, each with its reason:
* decode is byte-identical everywhere (integer hash, uint8 out), and so
  is a replay in numpy of the CUDA kernel's work split (its grid, the
  scalar bytes at unaligned image ends, the stepped counter and the
  byte packing of its 16-byte stores), which the CPU cannot run;
* the port's fused op is *bitwise* the host path (decode then
  ``augment_np``) — both divide with IEEE float32 — and bitwise the
  port's own decode followed by its augment;
* against the Pallas output the port is held to the reference's own
  2e-6 in float32: XLA on the CPU may round ``x / 255`` differently by
  one float32 ulp; in bfloat16 that can flip one rounding, so the bound
  there is one bfloat16 ulp.
"""
import re

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import repro.api  # noqa: E402,F401  (break the pipeline<->api import cycle)
from repro.data.augment import augment_batch_np as ref_augment_np  # noqa: E402
from repro.data.synthetic import SyntheticDataset as RefDataset  # noqa: E402
from repro.kernels.augment.ops import \
    decode_augment_batch_seeded as ref_fused  # noqa: E402
from repro.kernels.decode.ops import decode_batch as ref_decode  # noqa: E402

from repro_torch.data.pipeline import DSIPipeline  # noqa: E402
from repro_torch.data.storage import RemoteStorage  # noqa: E402
from repro_torch.data.synthetic import (DecodeHeavyDataset,  # noqa: E402
                                        FileDataset, SyntheticDataset)
from repro_torch.kernels.augment.ops import (  # noqa: E402
    augment_batch_seeded, decode_augment_batch_seeded)
from repro_torch.kernels.decode import kernel as decode_k  # noqa: E402
from repro_torch.kernels.decode.ops import (decode_batch,  # noqa: E402
                                            decode_params,
                                            fused_decode_seed)
from repro_torch.kernels.device import CSRC  # noqa: E402

HW = (48, 40)
CROP = (32, 24)
F32_ATOL = 2e-6


def _draws(seed: int):
    """(dataset seed, sample ids) with seeds near 2**31 and ids whose
    base ``seed*31 + id`` wraps past 2**32."""
    rng = np.random.default_rng(seed)
    ds_seed = int(rng.integers(2**31 - 4096, 2**31))
    # 31 * ds_seed mod 2**32 lies in [2**31 - 31*4096, 2**31): ids above
    # 2**31 wrap the uint32 base
    ids = [int(x) for x in rng.integers(0, 256, 3)] \
        + [int(x) for x in rng.integers(2**31 + 2**20, 2**32, 2)]
    return ds_seed, ids


def _payloads(ds, ids):
    return [ds.encoded(s % ds.n_samples) for s in ids]


def _pair(ds_seed):
    kw = dict(image_hw=HW, crop_hw=CROP, seed=ds_seed)
    return RefDataset("t", 256, 2048, **kw), SyntheticDataset("t", 256, 2048,
                                                              **kw)


def _bf16_within_one_ulp(a: np.ndarray, b: np.ndarray) -> bool:
    """float32 views of two bfloat16 arrays differ by at most one
    bfloat16 ulp (a bfloat16 ulp is 2**16 float32 ulps)."""
    ulp = np.spacing(np.abs(b).astype(np.float32)) * np.float32(2**16)
    return bool(np.all(np.abs(a - b) <= ulp))


@pytest.mark.parametrize("draw", range(4))
def test_decode_byte_equal_to_reference_and_dataset(draw):
    ds_seed, ids = _draws(draw)
    ref_ds, ds = _pair(ds_seed)
    payloads = _payloads(ds, ids)
    assert payloads == _payloads(ref_ds, ids)
    host = np.stack([ref_ds.decode(p, s) for p, s in zip(payloads, ids)])
    pallas = ref_decode(payloads, ids, seed=ds_seed, image_hw=HW)
    port = decode_batch(payloads, ids, seed=ds_seed, image_hw=HW,
                        device="cpu")
    assert port.dtype == np.uint8 and port.shape == (len(ids), *HW, 3)
    np.testing.assert_array_equal(port, host)
    np.testing.assert_array_equal(port, pallas)
    np.testing.assert_array_equal(
        port, np.stack([ds.decode(p, s) for p, s in zip(payloads, ids)]))


def test_pixel_hash_torch_matches_numpy_uint32():
    from repro_torch.data.synthetic import pixel_hash
    idx = torch.arange(1 << 16, dtype=torch.int64)
    for base in (0, 2**32 - 1, 123456789):
        got = decode_k.pixel_hash_torch(torch.tensor(base), idx)
        np.testing.assert_array_equal(got.numpy().astype(np.uint8),
                                      pixel_hash(base, 1 << 16))


def test_decode_params_match_dataset_derivation():
    ds_seed, ids = _draws(9)
    _ref, ds = _pair(ds_seed)
    payloads = _payloads(ds, ids)
    bases, mixes = decode_params(ds_seed, ids, payloads)
    assert list(bases) == [ds.decode_base_seed(s) for s in ids]
    assert list(mixes) == [ds.decode_head_mix(p) for p in payloads]


_STEP, _M1, _M2 = (np.uint32(0x9E3779B9), np.uint32(0x7FEB352D),
                   np.uint32(0x846CA68B))


def _decode_cu_constant(name: str) -> int:
    m = re.search(rf"constexpr int {name} = (\d+);",
                  (CSRC / "decode.cu").read_text())
    assert m, f"{name} is not a constant of decode.cu"
    return int(m.group(1))


def _hash_rounds(x: np.ndarray) -> np.ndarray:
    """``hash_rounds`` of ``common.cuh`` on a uint32 array."""
    x = x ^ (x >> np.uint32(16))
    x = x * _M1
    x = x ^ (x >> np.uint32(15))
    x = x * _M2
    return x ^ (x >> np.uint32(16))


def _byte_perm(x: np.ndarray, y: np.ndarray, sel: int) -> np.ndarray:
    """CUDA's ``__byte_perm``: byte n of the result is byte
    ``(sel >> 4n) & 7`` of the 8-byte value whose low word is ``x``."""
    pool = (y.astype(np.uint64) << np.uint64(32)) | x.astype(np.uint64)
    out = np.zeros(x.shape, np.uint64)
    for n in range(4):
        src = np.uint64(8 * ((sel >> (4 * n)) & 7))
        out |= ((pool >> src) & np.uint64(0xFF)) << np.uint64(8 * n)
    return out.astype(np.uint32)


def _replay_k3(bases, mixes, h: int, w: int):
    """K3's work split (``csrc/decode.cu::decode_kernel``) in numpy, into
    a 16-byte-aligned buffer as the wrapper allocates it.  Returns the
    (B, h, w, 3) bytes, how often each byte was written, and the start of
    each image mod 16."""
    threads = _decode_cu_constant("kDecodeThreads")
    per_thread = _decode_cu_constant("kDecodeVecs")
    n = h * w * 3
    mem = np.zeros(len(bases) * n, np.uint8)
    writes = np.zeros(mem.shape, np.int64)
    chunks = max(1, -(-(n // 16) // (per_thread * threads)))
    c, i, t = np.meshgrid(np.arange(chunks), np.arange(per_thread),
                          np.arange(threads), indexing="ij")
    grid_v = (c * per_thread * threads + i * threads + t).ravel()
    starts = []
    for b, (base, mix) in enumerate(zip(bases, mixes)):
        base, mix = np.uint32(base), np.uint32(mix)
        start = b * n
        starts.append(start % 16)
        head = min((16 - start % 16) % 16, n)
        n_vec = (n - head) // 16
        v = grid_v[grid_v < n_vec]
        # the counter word once per vector, then one add of the step per
        # byte; mix added to the whole word, the low byte taken by the pack
        x = base + (head + 16 * v).astype(np.uint32) * _STEP
        words = []
        for _q in range(4):
            hs = []
            for _j in range(4):
                hs.append(_hash_rounds(x) + mix)
                x = x + _STEP
            words.append(_byte_perm(_byte_perm(hs[0], hs[1], 0x0040),
                                    _byte_perm(hs[2], hs[3], 0x0040),
                                    0x5410))
        vec_bytes = np.stack(words, axis=1).astype("<u4").view(np.uint8)
        addr = start + head + 16 * v[:, None] + np.arange(16)
        assert np.all(addr[:, 0] % 16 == 0)
        mem[addr] = vec_bytes
        np.add.at(writes, addr, 1)
        # the scalar bytes: thread k < head + (n - tail) of the first chunk
        tail = head + 16 * n_vec
        ks = np.asarray([k if k < head else tail + (k - head)
                         for k in range(head + n - tail)], np.int64)
        xs = base + ks.astype(np.uint32) * _STEP
        mem[start + ks] = ((_hash_rounds(xs) + mix) & np.uint32(0xFF))
        np.add.at(writes, start + ks, 1)
    return mem.reshape(-1, h, w, 3), writes, set(starts)


@pytest.mark.parametrize("hw", [(37, 29), (5, 7), (1, 1), (3, 1), (8, 8)])
@pytest.mark.parametrize("near_top", [False, True])
def test_decode_kernel_work_split_replayed(hw, near_top):
    """The CUDA kernel's split of each image into scalar head, 16-byte
    vectors and scalar tail, its stepped counter and its little-endian
    packing, replayed on the CPU: every byte written once and equal to
    ``decode_plain``.  With 17 images of an odd byte count the image
    starts fall on every offset mod 16; bases near 2**32 wrap the
    counter word."""
    B = 17
    rng = np.random.default_rng(hw[0] * 100 + hw[1])
    lo = 2**32 - 2**12 if near_top else 0
    bases = rng.integers(lo, 2**32, B, dtype=np.int64)
    mixes = rng.integers(0, 256, B, dtype=np.int32)
    got, writes, starts = _replay_k3(bases, mixes, *hw)
    assert np.all(writes == 1)
    if hw[0] * hw[1] * 3 % 2:
        assert starts == set(range(16))
    want = decode_k.decode_plain(torch.from_numpy(bases),
                                 torch.from_numpy(mixes), *hw)
    np.testing.assert_array_equal(got, want.numpy())


@pytest.mark.parametrize("draw", range(3))
def test_fused_bitwise_host_path_and_port_composition(draw):
    ds_seed, ids = _draws(100 + draw)
    ref_ds, ds = _pair(ds_seed)
    payloads = _payloads(ds, ids)
    seeds = np.random.default_rng(draw).integers(0, 2**31, len(ids))
    fused = decode_augment_batch_seeded(
        payloads, ids, seeds, ds_seed=ds_seed, image_hw=HW, crop_h=CROP[0],
        crop_w=CROP[1], device="cpu")
    assert fused.dtype == torch.float32 and fused.device.type == "cpu"
    host = np.stack([ref_ds.decode(p, s) for p, s in zip(payloads, ids)])
    np.testing.assert_array_equal(fused.numpy(),
                                  ref_augment_np(host, CROP, seeds))
    port_dec = decode_batch(payloads, ids, seed=ds_seed, image_hw=HW,
                            device="cpu")
    np.testing.assert_array_equal(
        fused.numpy(), augment_batch_seeded(port_dec, seeds, *CROP,
                                            device="cpu"))


@pytest.mark.parametrize("out_dtype", ["float32", "bfloat16"])
def test_fused_against_pallas(out_dtype):
    import jax.numpy as jnp
    ds_seed, ids = _draws(7)
    _ref, ds = _pair(ds_seed)
    payloads = _payloads(ds, ids)
    seeds = np.random.default_rng(1).integers(0, 2**31, len(ids))
    kw = dict(ds_seed=ds_seed, image_hw=HW, crop_h=CROP[0], crop_w=CROP[1])
    pallas = np.asarray(ref_fused(payloads, ids, seeds,
                                  out_dtype=getattr(jnp, out_dtype), **kw)
                        .astype(jnp.float32))
    port = decode_augment_batch_seeded(
        payloads, ids, seeds, out_dtype=getattr(torch, out_dtype),
        device="cpu", **kw).float().numpy()
    if out_dtype == "float32":
        np.testing.assert_allclose(port, pallas, rtol=0, atol=F32_ATOL)
    else:
        assert _bf16_within_one_ulp(port, pallas)


def test_bucket_has_no_visible_effect():
    ds_seed, ids = _draws(3)
    _ref, ds = _pair(ds_seed)
    payloads = _payloads(ds, ids)
    seeds = np.arange(len(ids)) * 13 + 1
    kw = dict(ds_seed=ds_seed, image_hw=HW, crop_h=CROP[0], crop_w=CROP[1],
              device="cpu")
    plain = decode_augment_batch_seeded(payloads, ids, seeds, **kw)
    for bucket in (len(ids), 8, 64):
        out = decode_augment_batch_seeded(payloads, ids, seeds,
                                          bucket=bucket, **kw)
        assert out.shape[0] == len(ids)
        assert torch.equal(out, plain)


def test_fused_decode_seed_gating(tmp_path):
    base = SyntheticDataset("t", 16, 1024, image_hw=HW, crop_hw=CROP,
                            seed=42)
    assert fused_decode_seed(base) == 42
    assert fused_decode_seed(FileDataset(base, str(tmp_path))) == 42
    heavy = DecodeHeavyDataset("h", 16, 1024, seed=42)
    assert fused_decode_seed(heavy) is None


def test_device_executor_rejects_decode_heavy_dataset():
    from repro_torch.api import SenecaServer
    ds = DecodeHeavyDataset("h", 32, 1024)
    server = SenecaServer.for_dataset(ds, use_ods=False, device="cpu")
    with pytest.raises(ValueError, match="device executor"):
        DSIPipeline(server.open_session(batch_size=8), RemoteStorage(ds),
                    executor="device")
    server.close()


def test_decode_wrappers_validate_inputs():
    b = torch.zeros(3, dtype=torch.int64)
    m = torch.zeros(3, dtype=torch.int32)
    with pytest.raises(TypeError):
        decode_k.decode(b.to(torch.int32), m, h=4, w=4)
    with pytest.raises(ValueError, match="same length"):
        decode_k.decode(b, m[:2], h=4, w=4)
    with pytest.raises(ValueError, match="does not fit"):
        decode_k.decode_augment(b, m, m, m, m, img_h=4, img_w=4, crop_h=5,
                                crop_w=4)
    with pytest.raises(TypeError):
        decode_k.decode_augment(b, m, m, m, m, img_h=4, img_w=4, crop_h=2,
                                crop_w=2, out_dtype=torch.float16)
