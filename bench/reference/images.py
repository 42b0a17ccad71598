"""Plain NumPy recomputation of the rows the loader serves.

A frozen copy of the synthetic dataset's sample generation and
counter-hash decode (``src/repro_torch/data/synthetic.py:24-98``, the
constants, ``pixel_hash``, ``encoded_size``, ``encoded``, ``label``,
``decode_base_seed``, ``decode_head_mix``, ``decode``; ``imagenet_like``
:300), of the crop, flip and normalize (``src/repro_torch/data/
augment.py:14-60``), of the per-sample augmentation seeds
(``src/repro_torch/data/pipeline.py:85-88`` and the background refill's
``sid ^ 0x5EED`` at :1027) and of the stub patchify
(``src/repro_torch/launch/train.py:84-103``).  It imports nothing of the
program.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import List, Tuple

import numpy as np
import torch

_HASH_STEP = 0x9E3779B9
_HASH_M1 = 0x7FEB352D
_HASH_M2 = 0x846CA68B
MEAN = np.array([0.485, 0.456, 0.406], np.float32)
STD = np.array([0.229, 0.224, 0.225], np.float32)


def pixel_hash(base: int, n: int) -> np.ndarray:
    """uint8[n]: the splitmix32-style counter hash of indices 0..n-1."""
    idx = np.arange(n, dtype=np.uint32)
    x = np.uint32(base & 0xFFFFFFFF) + idx * np.uint32(_HASH_STEP)
    x ^= x >> np.uint32(16)
    x *= np.uint32(_HASH_M1)
    x ^= x >> np.uint32(15)
    x *= np.uint32(_HASH_M2)
    x ^= x >> np.uint32(16)
    return (x & np.uint32(0xFF)).astype(np.uint8)


@dataclass(frozen=True)
class Dataset:
    """The synthetic image set: ``n`` samples of (256, 256, 3) pixels,
    cropped to (224, 224), 1000 classes, storage seed 1234."""
    n: int
    mean_encoded_bytes: int = 114_620
    image_hw: Tuple[int, int] = (256, 256)
    crop_hw: Tuple[int, int] = (224, 224)
    n_classes: int = 1000
    seed: int = 1234

    def encoded(self, sid: int) -> np.ndarray:
        rng = np.random.default_rng(self.seed + sid)
        s = float(np.clip(rng.lognormal(mean=0.0, sigma=0.35), 0.25, 4.0))
        n = max(int(self.mean_encoded_bytes * s), 1024)
        rng = np.random.default_rng(self.seed + sid)
        return rng.integers(0, 256, size=n, dtype=np.uint8)

    def label(self, sid: int) -> int:
        return (sid * 2654435761) % self.n_classes

    def decode(self, sid: int) -> np.ndarray:
        h, w = self.image_hw
        base = (self.seed * 31 + sid) & 0xFFFFFFFF
        mix = int(self.encoded(sid)[:4096].sum()) % 256
        img = pixel_hash(base, h * w * 3).reshape(h, w, 3)
        return ((img.astype(np.int32) + mix) % 256).astype(np.uint8)


DATASETS = {"imagenet_like": Dataset}


def aug_seeds(sid: int, epoch: int) -> List[int]:
    """The augmentation seeds that can have produced a served row of
    ``sid`` in ``epoch``: this epoch's, an earlier epoch's (a cached row
    keeps the crop it was cached with), the background refill's."""
    return [(e * 1_000_003 + sid) & 0x7FFFFFFF for e in range(epoch, -1, -1)] \
        + [sid ^ 0x5EED]


def augment(img: np.ndarray, crop_hw: Tuple[int, int],
            seed: int) -> np.ndarray:
    """Random crop (top, left, flip drawn in that order from
    ``default_rng(seed)``), flip, then ``(x / 255 - MEAN) / STD`` in
    float32."""
    rng = np.random.default_rng(int(seed))
    h, w, _ = img.shape
    ch, cw = crop_hw
    top = int(rng.integers(0, h - ch + 1))
    left = int(rng.integers(0, w - cw + 1))
    flip = int(rng.integers(0, 2))
    crop = img[top:top + ch, left:left + cw]
    if flip:
        crop = crop[:, ::-1]
    return (crop.astype(np.float32) / 255.0 - MEAN) / STD


def patchify(img: np.ndarray, tokens: int, d: int) -> torch.Tensor:
    """The stub patchify of one augmented image: its values in bf16,
    tiled and cut to (tokens, d)."""
    flat = torch.from_numpy(np.ascontiguousarray(img).reshape(-1)) \
        .to(torch.bfloat16)
    reps = -(-tokens * d // flat.shape[0])
    return flat.repeat(reps)[:tokens * d].reshape(tokens, d)


def row_candidates(ds: Dataset, sid: int, epoch: int, tokens: int, d: int):
    """Each legitimate patch embedding of a served row of ``sid``, in the
    order of :func:`aug_seeds` (the fresh one first)."""
    img = ds.decode(sid)
    for seed in aug_seeds(sid, epoch):
        yield patchify(augment(img, ds.crop_hw, seed), tokens, d)


def match_row(ds: Dataset, sid: int, epoch: int, got: torch.Tensor):
    """(equal, the reference's row): the first legitimate embedding that
    equals ``got`` bit for bit, or the fresh one where none does."""
    tokens, d = got.shape
    first = None
    for want in row_candidates(ds, sid, epoch, tokens, d):
        if first is None:
            first = want
        if torch.equal(got, want):
            return True, want
    return False, first
