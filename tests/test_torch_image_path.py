"""The image path of the port's training launcher (``patch_batch``,
``image_batch_source``, ``--arch vit-huge``) against the reference's
``repro.launch.train``, on the CPU.

* ``patch_batch`` equals the reference's stub patchify bit for bit: the
  stub itself runs, inside the reference's ``image_batch_source`` with
  its pipeline swapped for one that hands over the test's images.
* The first batch of the port's CPU ``image_batch_source(model, 16)``
  equals the reference's bit for bit.  Later batches are held row by
  row: the reference's per-sample executor refills and substitutes from
  worker threads, so which ids batches 2-6 hold depends on timing, and
  two runs of the reference itself differ there.  Each row must equal
  ``patch_batch`` of the reference's own augment of its id under a seed
  the per-sample executor uses for it.
"""
import dataclasses
import types

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.data.augment import augment_np as ref_augment_np  # noqa: E402
from repro.data.pipeline import _aug_seed as ref_aug_seed  # noqa: E402
from repro.data.synthetic import tiny as ref_tiny  # noqa: E402
from repro.configs import registry as ref_registry  # noqa: E402
from repro.launch import train as ref_train  # noqa: E402
from repro.models.model import build as ref_build  # noqa: E402

from repro_torch.configs import registry  # noqa: E402
from repro_torch.launch import train as train_cli  # noqa: E402
from repro_torch.models.model import build  # noqa: E402

ARCH = "vit-huge"
N_BATCHES = 6


def _bits(x) -> np.ndarray:
    """bf16 values (a torch tensor or an ml_dtypes array) as uint16."""
    if isinstance(x, torch.Tensor):
        return x.cpu().view(torch.int16).numpy().view(np.uint16)
    return np.asarray(x).view(np.uint16)


def _ref_stub(raw, cfg):
    """The reference's stub patchify of ``raw``: its own
    ``image_batch_source`` closure, fed by a pipeline that returns
    ``raw``."""
    class Handing:
        def __init__(self, *args, **kwargs):
            pass

        def next_batch(self):
            return raw

    model = types.SimpleNamespace(cfg=cfg)
    saved = ref_train.DSIPipeline
    ref_train.DSIPipeline = Handing
    try:
        next_batch, _, _ = ref_train.image_batch_source(model,
                                                        len(raw["ids"]))
    finally:
        ref_train.DSIPipeline = saved
    return next_batch()


@pytest.mark.parametrize("tokens,d,hw,n_classes", [
    (17, 64, (56, 56), 16),       # reduced vit-huge on tiny's crops: cut
    (197, 1280, (224, 224), 1000),  # vit-huge on ImageNet crops: tiled
    (7, 24, (4, 5), 3),           # three copies, ragged cut
    (3, 8, (4, 4), 0),            # no classes: labels all 0
])
@pytest.mark.parametrize("as_tensor", [False, True])
def test_patch_batch_equals_reference_stub_bitwise(tokens, d, hw, n_classes,
                                                   as_tensor):
    rng = np.random.default_rng(tokens + d)
    B = 3
    images = rng.standard_normal((B, *hw, 3)).astype(np.float32)
    labels = rng.integers(0, 5000, B).astype(np.int32)
    raw = {"images": images, "labels": labels,
           "ids": np.arange(B, dtype=np.int64)}
    sizes = dict(frontend_tokens=tokens, d_model=d, n_classes=n_classes)
    cfg = dataclasses.replace(registry.get_reduced(ARCH), **sizes)
    want = _ref_stub(raw, dataclasses.replace(
        ref_registry.get_reduced(ARCH), **sizes))
    got = train_cli.patch_batch(
        {**raw, "images": torch.from_numpy(images)} if as_tensor else raw,
        cfg)
    assert got["patch_embeds"].shape == (B, tokens, d)
    assert got["patch_embeds"].dtype == torch.bfloat16
    assert got["patch_embeds"].device.type == "cpu"
    np.testing.assert_array_equal(_bits(got["patch_embeds"]),
                                  _bits(want["patch_embeds"]))
    np.testing.assert_array_equal(got["labels"].numpy(),
                                  np.asarray(want["labels"]))


def _port_batches(seed=0):
    """(patch batches, ids of each) from the port's CPU image path."""
    pm = build(registry.get_reduced(ARCH)).init(seed=0, device="cpu")
    source, pipe, server = train_cli.image_batch_source(pm, 16, seed=seed)
    assert pipe.executor == "per-sample"
    inner, ids = pipe.next_batch, []

    def recording():
        raw = inner()
        ids.append(np.asarray(raw["ids"]).copy())
        return raw

    pipe.next_batch = recording
    try:
        return [source() for _ in range(N_BATCHES)], ids
    finally:
        pipe.stop()
        server.close()


def test_first_image_batch_equals_reference_bitwise():
    rm = ref_build(ref_registry.get_reduced(ARCH))
    source, pipe, _ = ref_train.image_batch_source(rm, 16)
    try:
        want = source()
    finally:
        pipe.stop()
    batches, _ = _port_batches()
    got = batches[0]
    assert got["patch_embeds"].shape == (16, 17, 64)
    np.testing.assert_array_equal(_bits(got["patch_embeds"]),
                                  _bits(want["patch_embeds"]))
    np.testing.assert_array_equal(got["labels"].numpy(),
                                  np.asarray(want["labels"]))


def test_later_image_batches_equal_reference_rows():
    """Batches 2-6 row by row: each row is the reference's augment of its
    id under this epoch's seed or the background refill's, patched."""
    cfg = registry.get_reduced(ARCH)
    ds = ref_tiny(n=4096)
    batches, ids = _port_batches()
    assert len(ids) == N_BATCHES
    served = np.concatenate(ids)
    assert len(set(served.tolist())) == served.size   # one epoch, no repeat
    for batch, bids in zip(batches[1:], ids[1:]):
        for row, sid in enumerate(bids.tolist()):
            img = ds.decode(ds.encoded(sid), sid)
            candidates = []
            for seed in (ref_aug_seed(0, sid), sid ^ 0x5EED):
                aug = ref_augment_np(img, ds.crop_hw,
                                     np.random.default_rng(seed))
                candidates.append(_bits(train_cli.patch_batch(
                    {"images": aug[None], "labels": np.zeros(1, np.int32)},
                    cfg)["patch_embeds"][0]))
            got = _bits(batch["patch_embeds"][row])
            assert any(np.array_equal(got, c) for c in candidates), sid
            assert int(batch["labels"][row]) == \
                ds.label(sid) % cfg.n_classes


def test_cli_trains_vit_huge_on_cpu(tmp_path, capsys):
    train_cli.main(["--arch", ARCH, "--steps", "2", "--batch", "8",
                    "--device", "cpu", "--ckpt-dir", str(tmp_path)])
    out = capsys.readouterr().out
    assert "arch=vit-huge params=84,352" in out
    assert "seneca partition: " in out
    assert "2 steps in" in out and "loss " in out
    assert "pipeline stage seconds:" in out and "seneca stats:" in out
    assert (tmp_path / "LATEST").read_text() == "step_00000002"
