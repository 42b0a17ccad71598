"""Crop + flip + normalize: the CUDA kernel and its plain twin.

:func:`augment` (K2) launches the hand-written kernel of
``csrc/augment.cu`` for CUDA tensors and takes :func:`augment_plain` for
CPU tensors.  The plain version divides for real (``x / 255``, then
``(x - mean) / std``), so it matches ``augment_np`` bitwise in float32;
it divides by tensors, never by a Python scalar: PyTorch's CUDA division
by a CPU scalar multiplies by its reciprocal, which is not the IEEE
quotient.  The kernels K1 and K2 divide nothing: they read the
normalize of each (channel, pixel value) from :func:`normalize_table`,
which :func:`normalize_plain` builds on the CPU, so they match the plain
versions bitwise by construction.
"""
from __future__ import annotations

import ctypes
import threading
from typing import Dict, Tuple

import torch

from repro_torch.data.augment import MEAN, STD
from repro_torch.kernels.device import (check_launch, check_tensor,
                                        library, stream_ptr)

_OUT_DTYPES = (torch.float32, torch.bfloat16)

_tables: Dict[Tuple[torch.device, torch.dtype], torch.Tensor] = {}
_tables_lock = threading.Lock()


def normalize_plain(pix: torch.Tensor,
                    out_dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """(..., 3) pixel values in [0, 255] -> ``(p / 255 - MEAN) / STD`` in
    float32 (``augment_np``'s float32 constants), cast to ``out_dtype``
    round-to-nearest-even."""
    dev = pix.device
    mean = torch.from_numpy(MEAN).to(dev)
    std = torch.from_numpy(STD).to(dev)
    x = pix.to(torch.float32) / torch.tensor(255.0, device=dev)
    return ((x - mean) / std).to(out_dtype)


def normalize_table(device, out_dtype: torch.dtype) -> torch.Tensor:
    """The normalize as a (768,) ``out_dtype`` table on ``device``: entry
    ``c * 256 + p`` is :func:`normalize_plain` of pixel value ``p`` in
    channel ``c``.  Built on the CPU once per (device, dtype) and kept,
    so the kernels read it from where they run."""
    key = (torch.device(device), out_dtype)
    with _tables_lock:
        table = _tables.get(key)
        if table is None:
            pix = torch.arange(256, dtype=torch.int64)[:, None].expand(256, 3)
            table = normalize_plain(pix, out_dtype).t().contiguous() \
                .reshape(-1).to(key[0])
            _tables[key] = table
    return table


def augment_plain(images: torch.Tensor, tops: torch.Tensor,
                  lefts: torch.Tensor, flips: torch.Tensor, crop_h: int,
                  crop_w: int,
                  out_dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """Plain twin of K2: (B, H, W, 3) uint8 -> (B, crop_h, crop_w, 3)."""
    dev = images.device
    b = torch.arange(images.shape[0], device=dev)
    i = torch.arange(crop_h, device=dev)
    j = torch.arange(crop_w, device=dev)
    src_j = torch.where(flips[:, None] != 0, crop_w - 1 - j[None, :],
                        j[None, :])
    rows = tops.to(torch.int64)[:, None] + i[None, :]            # (B, ch)
    cols = lefts.to(torch.int64)[:, None] + src_j                # (B, cw)
    crop = images[b[:, None, None], rows[:, :, None], cols[:, None, :]]
    return normalize_plain(crop, out_dtype)


def augment(images: torch.Tensor, tops: torch.Tensor, lefts: torch.Tensor,
            flips: torch.Tensor, *, crop_h: int, crop_w: int,
            out_dtype: torch.dtype = torch.bfloat16) -> torch.Tensor:
    """K2: images (B, H, W, 3) uint8 + (B,) int32 tops/lefts/flips ->
    (B, crop_h, crop_w, 3) ``out_dtype``.  ``tops``/``lefts`` must keep
    the crop window inside the image (the ops layer checks them where it
    draws them); the kernel does not clamp."""
    check_tensor("images", images, torch.uint8, 4)
    if images.shape[-1] != 3:
        raise ValueError(f"images must be (B, H, W, 3), got "
                         f"{tuple(images.shape)}")
    B, H, W, _ = images.shape
    for name, t in (("tops", tops), ("lefts", lefts), ("flips", flips)):
        check_tensor(name, t, torch.int32, 1, images.device)
        if t.shape[0] != B:
            raise ValueError(f"{name} must have length {B}")
    if out_dtype not in _OUT_DTYPES:
        raise TypeError(f"out_dtype must be one of {_OUT_DTYPES}")
    if not (0 < crop_h <= H and 0 < crop_w <= W):
        raise ValueError(f"crop {crop_h}x{crop_w} does not fit {H}x{W}")
    if images.device.type == "cpu":
        return augment_plain(images, tops, lefts, flips, crop_h, crop_w,
                             out_dtype)
    if images.device.type != "cuda":
        raise ValueError(f"no augment kernel for device {images.device}")
    if H * W * 3 >= 2**31:
        raise ValueError(f"images of {H}x{W} exceed the kernel's 32-bit "
                         f"indices")
    table = normalize_table(images.device, out_dtype)
    out = torch.empty((B, crop_h, crop_w, 3), dtype=out_dtype,
                      device=images.device)
    fn = library("augment").repro_torch_augment
    fn.argtypes = [ctypes.c_void_p] * 6 + [ctypes.c_int] * 6 \
        + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    with torch.cuda.device(images.device):
        augment.launches += 1
        check_launch("augment", fn(
            images.data_ptr(), tops.data_ptr(), lefts.data_ptr(),
            flips.data_ptr(), table.data_ptr(), out.data_ptr(), B, H, W,
            crop_h, crop_w, int(out_dtype == torch.bfloat16),
            stream_ptr(images)))
    return out


augment.launches = 0
