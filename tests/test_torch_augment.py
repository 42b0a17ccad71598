"""Augment (K2) of the port against the JAX package, and its backends.

Inputs are uint8 images and per-sample seeds drawn with numpy.  The
port's ``augment_batch_seeded`` on the CPU (the plain PyTorch version of
the kernel) is *bitwise* the reference's host ``augment_batch_np``: both
divide with IEEE float32.  Against the Pallas ``augment`` (interpret
mode, XLA on the CPU) it is held to the reference's own 2e-6 in float32,
the size of the one-ulp gap XLA's division leaves, and to one bfloat16
ulp in bfloat16, where that gap can flip one rounding.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.data.augment import augment_batch_np as ref_augment_np  # noqa: E402
from repro.kernels.augment.ops import \
    augment_batch_seeded as ref_augment  # noqa: E402

from repro_torch.api import (CudaAugmentBackend,  # noqa: E402
                             NumpyAugmentBackend, SenecaServer,
                             resolve_augment_backend, resolve_backend)
from repro_torch.data.augment import augment_batch_np  # noqa: E402
from repro_torch.data.pipeline import DSIPipeline  # noqa: E402
from repro_torch.data.storage import RemoteStorage  # noqa: E402
from repro_torch.data.synthetic import tiny  # noqa: E402
from repro_torch.kernels.augment import kernel as augment_k  # noqa: E402
from repro_torch.kernels.augment.ops import augment_batch_seeded  # noqa: E402
from repro_torch.kernels.device import resolve_device  # noqa: E402

HW = (48, 40)
CROP = (32, 24)


def _batch(seed: int, B: int = 6):
    rng = np.random.default_rng(seed)
    imgs = rng.integers(0, 256, (B, *HW, 3), dtype=np.uint8)
    seeds = rng.integers(0, 2**31, B)
    return imgs, seeds


@pytest.mark.parametrize("seed", range(3))
def test_augment_bitwise_equal_host_path(seed):
    imgs, seeds = _batch(seed)
    out = augment_batch_seeded(imgs, seeds, *CROP, device="cpu")
    assert out.dtype == np.float32 and out.shape == (len(imgs), *CROP, 3)
    np.testing.assert_array_equal(out, ref_augment_np(imgs, CROP, seeds))
    np.testing.assert_array_equal(out, augment_batch_np(imgs, CROP, seeds))


@pytest.mark.parametrize("out_dtype", ["float32", "bfloat16"])
def test_augment_against_pallas(out_dtype):
    import jax.numpy as jnp
    imgs, seeds = _batch(11, B=8)
    pallas = np.asarray(ref_augment(imgs, seeds, *CROP,
                                    out_dtype=getattr(jnp, out_dtype),
                                    as_device=True).astype(jnp.float32))
    port = augment_batch_seeded(imgs, seeds, *CROP,
                                out_dtype=getattr(torch, out_dtype),
                                as_device=True, device="cpu")
    port = port.float().numpy()
    if out_dtype == "float32":
        np.testing.assert_allclose(port, pallas, rtol=0, atol=2e-6)
    else:
        ulp = np.spacing(np.abs(pallas)) * np.float32(2**16)
        assert np.all(np.abs(port - pallas) <= ulp)


def test_augment_tensor_input_stays_put_and_bucket_is_invisible():
    imgs, seeds = _batch(5, B=3)
    t = torch.from_numpy(imgs)
    out = augment_batch_seeded(t, seeds, *CROP, as_device=True)
    assert isinstance(out, torch.Tensor) and out.device == t.device
    for bucket in (None, 3, 4, 16):
        again = augment_batch_seeded(t, seeds, *CROP, as_device=True,
                                     bucket=bucket)
        assert torch.equal(again, out)


def test_augment_plain_flip_mirrors_columns():
    img = torch.arange(4 * 6 * 3, dtype=torch.uint8).reshape(1, 4, 6, 3)
    p = torch.tensor([1], dtype=torch.int32)
    z = torch.tensor([0], dtype=torch.int32)
    flipped = augment_k.augment(img, p, p, p, crop_h=2, crop_w=3,
                                out_dtype=torch.float32)
    straight = augment_k.augment(img, p, p, z, crop_h=2, crop_w=3,
                                 out_dtype=torch.float32)
    assert torch.equal(flipped, straight.flip(2))


def test_augment_wrapper_validates_inputs():
    img = torch.zeros((2, *HW, 3), dtype=torch.uint8)
    p = torch.zeros(2, dtype=torch.int32)
    with pytest.raises(ValueError, match="contiguous"):
        augment_k.augment(img.transpose(1, 2), p, p, p, crop_h=4, crop_w=4)
    with pytest.raises(ValueError, match="length"):
        augment_k.augment(img, p[:1], p, p, crop_h=4, crop_w=4)
    with pytest.raises(ValueError, match="does not fit"):
        augment_k.augment(img, p, p, p, crop_h=HW[0] + 1, crop_w=4)
    with pytest.raises(ValueError, match="does not fit"):
        augment_batch_seeded(img.numpy(), [1, 2], HW[0] + 1, 4,
                             device="cpu")


def test_cuda_request_without_cuda_raises(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        resolve_device(None)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        CudaAugmentBackend()
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        SenecaServer.for_dataset(tiny(n=16))
    assert resolve_device("cpu") == torch.device("cpu")


def test_cuda_backend_on_cpu_matches_numpy_backend():
    imgs, seeds = _batch(2)
    cuda_be = CudaAugmentBackend(device="cpu")
    assert cuda_be.name == "cuda"
    np.testing.assert_array_equal(
        cuda_be.augment_batch(imgs, CROP, seeds),
        NumpyAugmentBackend().augment_batch(imgs, CROP, seeds))


@pytest.mark.parametrize("name", ["pallas", "jax"])
def test_unported_backend_names_raise(name):
    with pytest.raises(ValueError, match="not ported"):
        resolve_augment_backend(name)
    if name == "jax":
        with pytest.raises(ValueError, match="not ported"):
            resolve_backend(name, 16)


def test_stage_parallel_with_cuda_backend_matches_per_sample():
    """The "cuda" augment backend (run on the CPU here) inside the
    stage-parallel executor gives the per-sample executor's tensors."""
    ds = tiny(n=32)
    out = {}
    for executor, backend in (("per-sample", None),
                              ("stage-parallel",
                               CudaAugmentBackend(device="cpu"))):
        server = SenecaServer.for_dataset(ds, use_ods=False,
                                          split=(1.0, 0.0, 0.0),
                                          device="cpu")
        sess = server.open_session(batch_size=8)
        pipe = DSIPipeline(sess, RemoteStorage(ds), n_workers=2,
                           executor=executor, augment_backend=backend)
        rows = {}
        for _ in range(4):
            b = pipe.next_batch()
            rows.update(zip(b["ids"].tolist(), b["images"]))
        pipe.stop()
        server.close()
        out[executor] = rows
    assert sorted(out["per-sample"]) == list(range(32))
    for sid, row in out["per-sample"].items():
        np.testing.assert_array_equal(out["stage-parallel"][sid], row)
