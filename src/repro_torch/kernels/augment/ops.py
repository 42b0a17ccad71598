"""Public ops: device-side fused augmentation.

``augment_batch_seeded(images, seeds, ...)`` is the live-pipeline entry
point: the geometric parameters are derived *on host* from per-sample
integer seeds with the exact draw sequence of
:func:`repro_torch.data.augment.augment_np`, so the kernel output matches
the NumPy path per sample (same seed -> same crop/flip, the same IEEE
float32 math on both sides — bitwise) regardless of how samples are
batched together.

``decode_augment_batch_seeded(payloads, sample_ids, seeds, ...)`` goes
one step further for counter-hash datasets: encoded byte buffers in,
augmented device crops out, with decode and augment fused into one
kernel launch — the host ships only per-sample scalars (seed base,
header mix, crop params), never a decoded image.

Both keep the reference's ``bucket`` argument.  The reference padded
batches to power-of-two buckets to bound jit retraces; PyTorch runs
eagerly and has nothing to retrace, so here ``bucket`` is accepted and
has no effect.
"""
from __future__ import annotations

from typing import Optional, Sequence, Tuple

import numpy as np
import torch

from repro_torch.data.augment import derive_batch_params
from repro_torch.kernels.augment.kernel import augment
from repro_torch.kernels.decode.kernel import decode_augment
from repro_torch.kernels.decode.ops import decode_params, params_to_device
from repro_torch.kernels.device import resolve_device


def _crop_params(hw: Tuple[int, int], crop_hw: Tuple[int, int],
                 seeds: np.ndarray) -> Tuple[np.ndarray, ...]:
    """``derive_batch_params`` plus the bounds check the kernels rely on
    (a crop window outside the image would read out of bounds)."""
    if not (0 < crop_hw[0] <= hw[0] and 0 < crop_hw[1] <= hw[1]):
        raise ValueError(f"crop {crop_hw} does not fit image {hw}")
    return derive_batch_params(hw, crop_hw, np.asarray(seeds))


def augment_batch_seeded(images, seeds: np.ndarray, crop_h: int,
                         crop_w: int, *,
                         out_dtype: torch.dtype = torch.float32,
                         bucket: Optional[int] = None,
                         as_device: bool = False, device=None):
    """(B,H,W,3) uint8 + per-sample int seeds -> (B,crop_h,crop_w,3)
    ``out_dtype`` host array.

    ``images`` is a host array (uploaded to ``device``, CUDA when None)
    or a tensor, which stays where it lies — a CUDA tensor (HBM-tier
    decoded hits) is augmented there with no host round-trip.
    ``as_device`` skips the final host copy and returns the tensor, which
    the device executor admits into the HBM tier.  ``bucket`` has no
    effect (module doc).
    """
    del bucket
    if isinstance(images, torch.Tensor):
        dev = images.device
        images = images.contiguous()
    else:
        dev = resolve_device(device)
        images = torch.from_numpy(np.ascontiguousarray(images)).to(dev)
    B, H, W, _ = images.shape
    tops, lefts, flips = _crop_params((H, W), (crop_h, crop_w), seeds)
    as_t = [torch.from_numpy(a).to(dev) for a in (tops, lefts, flips)]
    out = augment(images, *as_t, crop_h=crop_h, crop_w=crop_w,
                  out_dtype=out_dtype)
    return out if as_device else out.cpu().numpy()


def decode_augment_batch_seeded(payloads: Sequence[bytes],
                                sample_ids: Sequence[int],
                                seeds: np.ndarray, *, ds_seed: int,
                                image_hw: Tuple[int, int], crop_h: int,
                                crop_w: int,
                                out_dtype: torch.dtype = torch.float32,
                                bucket: Optional[int] = None,
                                device=None) -> torch.Tensor:
    """Encoded byte buffers + per-sample augment seeds -> augmented
    (B,crop_h,crop_w,3) crops as a tensor on ``device`` (CUDA when
    None), decode and augment fused into one kernel launch.

    Crop/flip params come from the exact :func:`crop_flip_params` draw
    sequence (via ``derive_batch_params``), and the decode half is the
    counter hash of ``SyntheticDataset.decode`` — so per sample the
    result equals ``augment_batch_seeded(decode(payload), seed)``
    bitwise.  ``bucket`` has no effect (module doc).
    """
    del bucket
    dev = resolve_device(device)
    bases, mixes = decode_params(ds_seed, sample_ids, payloads)
    H, W = image_hw
    tops, lefts, flips = _crop_params((H, W), (crop_h, crop_w), seeds)
    args = params_to_device(bases, mixes, tops, lefts, flips, device=dev)
    return decode_augment(*args, img_h=H, img_w=W, crop_h=crop_h,
                          crop_w=crop_w, out_dtype=out_dtype)
