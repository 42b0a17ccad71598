"""Random augmentations (random crop + horizontal flip + normalize).

Two equivalent implementations:
* numpy (host CPU — the paper-faithful placement), used by the pipeline;
* the CUDA kernel K2 (kernels/augment) and its plain PyTorch version,
  which match it bitwise in float32.

Both paths derive the per-sample crop/flip parameters from the same
:func:`crop_flip_params` draw sequence, so a given seed produces the same
geometric transform no matter which backend executes the pixel math —
the parity contract pinned by tests/test_pipeline_executor.py.
"""
from __future__ import annotations

from typing import Tuple

import numpy as np

MEAN = np.array([0.485, 0.456, 0.406], np.float32)
STD = np.array([0.229, 0.224, 0.225], np.float32)


def crop_flip_params(rng: np.random.Generator, h: int, w: int,
                     ch: int, cw: int) -> Tuple[int, int, int]:
    """The canonical three-draw parameter sequence (top, left, flip)."""
    top = int(rng.integers(0, h - ch + 1))
    left = int(rng.integers(0, w - cw + 1))
    flip = int(rng.integers(0, 2))
    return top, left, flip


def derive_batch_params(hw: Tuple[int, int], crop_hw: Tuple[int, int],
                        seeds: np.ndarray
                        ) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Per-sample (tops, lefts, flips) int32 arrays for ``seeds``.

    One fresh ``default_rng(seed)`` per sample, same draw order as
    :func:`augment_np` — this is what keeps the vectorized/CUDA path
    deterministic per *sample* (not per batch composition)."""
    h, w = hw
    ch, cw = crop_hw
    n = len(seeds)
    tops = np.empty(n, np.int32)
    lefts = np.empty(n, np.int32)
    flips = np.empty(n, np.int32)
    for i, s in enumerate(seeds):
        tops[i], lefts[i], flips[i] = crop_flip_params(
            np.random.default_rng(int(s)), h, w, ch, cw)
    return tops, lefts, flips


def augment_np(img: np.ndarray, crop_hw: Tuple[int, int],
               rng: np.random.Generator) -> np.ndarray:
    """uint8 HWC -> float32 CHW-free (kept HWC) augmented tensor."""
    h, w, _ = img.shape
    ch, cw = crop_hw
    top, left, flip = crop_flip_params(rng, h, w, ch, cw)
    crop = img[top:top + ch, left:left + cw]
    if flip:
        crop = crop[:, ::-1]
    out = crop.astype(np.float32) / 255.0
    return (out - MEAN) / STD


def augment_batch_np(imgs: np.ndarray, crop_hw: Tuple[int, int],
                     seeds: np.ndarray) -> np.ndarray:
    out = np.empty((len(imgs), crop_hw[0], crop_hw[1], 3), np.float32)
    for i, (im, s) in enumerate(zip(imgs, seeds)):
        out[i] = augment_np(im, crop_hw, np.random.default_rng(int(s)))
    return out
