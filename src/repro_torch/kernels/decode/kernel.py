"""Decode and fused decode+augment: CUDA kernels and their plain twins.

:func:`decode` (K3) synthesizes whole images from two scalars per
sample; :func:`decode_augment` (K1) hashes only the crop window's source
pixels (a flip mirrors the source column) and runs the augment float
pipeline on them, so no decoded image exists anywhere.  Both launch the
hand-written kernels of ``csrc/decode.cu`` for CUDA tensors and take the
plain PyTorch versions (:func:`decode_plain`,
:func:`decode_augment_plain`) for CPU tensors.

The plain hash works in ``int64`` masked to 32 bits after every add and
multiply (torch has too few ``uint32`` ops), and splits each multiply in
two 16-bit halves so no product leaves the ``int64`` range.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.data.synthetic import _HASH_M1, _HASH_M2, _HASH_STEP
from repro_torch.kernels.augment.kernel import (normalize_plain,
                                                normalize_table)
from repro_torch.kernels.device import (check_launch, check_tensor,
                                        library, stream_ptr)

_MASK = 0xFFFFFFFF
_OUT_DTYPES = (torch.float32, torch.bfloat16)


def _mul32(x: torch.Tensor, m: int) -> torch.Tensor:
    """``x * m mod 2**32`` for ``x`` in [0, 2**32) held in int64."""
    lo = x * (m & 0xFFFF)
    hi = ((x * (m >> 16)) & 0xFFFF) << 16
    return (lo + hi) & _MASK


def pixel_hash_torch(base: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """int64 twin of ``pixel_hash``: uint32 pixel-byte stream (low 8 bits)
    for counter indices ``idx`` under per-sample seeds ``base`` (both
    int64 holding uint32 values, broadcast against each other)."""
    x = (base + _mul32(idx, _HASH_STEP)) & _MASK
    x = x ^ (x >> 16)
    x = _mul32(x, _HASH_M1)
    x = x ^ (x >> 15)
    x = _mul32(x, _HASH_M2)
    x = x ^ (x >> 16)
    return x & 0xFF


def decode_plain(bases: torch.Tensor, mixes: torch.Tensor, h: int,
                 w: int) -> torch.Tensor:
    """(B,) int64 bases + (B,) int32 mixes -> (B, h, w, 3) uint8."""
    idx = torch.arange(h * w * 3, dtype=torch.int64, device=bases.device)
    u8 = pixel_hash_torch(bases[:, None], idx[None, :])
    out = (u8 + mixes.to(torch.int64)[:, None]) % 256
    return out.to(torch.uint8).reshape(-1, h, w, 3)


def decode(bases: torch.Tensor, mixes: torch.Tensor, *, h: int,
           w: int) -> torch.Tensor:
    """K3: (B,) int64 base seeds (uint32 values) + (B,) int32 header
    mixes -> (B, h, w, 3) uint8, byte-identical to
    ``SyntheticDataset.decode`` per sample."""
    check_tensor("bases", bases, torch.int64, 1)
    check_tensor("mixes", mixes, torch.int32, 1, bases.device)
    if mixes.shape != bases.shape:
        raise ValueError("bases and mixes must have the same length")
    if bases.device.type == "cpu":
        return decode_plain(bases, mixes, h, w)
    if bases.device.type != "cuda":
        raise ValueError(f"no decode kernel for device {bases.device}")
    if h * w * 3 >= 2**31:
        raise ValueError(f"images of {h}x{w} exceed the kernel's 32-bit "
                         f"indices")
    out = torch.empty((bases.shape[0], h, w, 3), dtype=torch.uint8,
                      device=bases.device)
    fn = library("decode").repro_torch_decode
    fn.argtypes = [ctypes.c_void_p] * 3 + [ctypes.c_int] * 3 \
        + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    with torch.cuda.device(bases.device):
        decode.launches += 1
        check_launch("decode", fn(bases.data_ptr(), mixes.data_ptr(),
                                  out.data_ptr(), bases.shape[0], h, w,
                                  stream_ptr(bases)))
    return out


decode.launches = 0


def decode_augment_plain(bases: torch.Tensor, mixes: torch.Tensor,
                         tops: torch.Tensor, lefts: torch.Tensor,
                         flips: torch.Tensor, img_w: int, crop_h: int,
                         crop_w: int,
                         out_dtype: torch.dtype = torch.float32
                         ) -> torch.Tensor:
    """Plain twin of K1 -> (B, crop_h, crop_w, 3) ``out_dtype``."""
    dev = bases.device
    i = torch.arange(crop_h, dtype=torch.int64, device=dev)
    j = torch.arange(crop_w, dtype=torch.int64, device=dev)
    c = torch.arange(3, dtype=torch.int64, device=dev)
    src_j = torch.where(flips[:, None] != 0, crop_w - 1 - j[None, :],
                        j[None, :])                            # (B, cw)
    row = tops.to(torch.int64)[:, None] + i[None, :]           # (B, ch)
    col = lefts.to(torch.int64)[:, None] + src_j               # (B, cw)
    idx = ((row[:, :, None] * img_w + col[:, None, :])[..., None] * 3
           + c) & _MASK                                        # (B,ch,cw,3)
    u8 = pixel_hash_torch(bases[:, None, None, None], idx)
    pix = (u8 + mixes.to(torch.int64)[:, None, None, None]) % 256
    return normalize_plain(pix, out_dtype)


def decode_augment(bases: torch.Tensor, mixes: torch.Tensor,
                   tops: torch.Tensor, lefts: torch.Tensor,
                   flips: torch.Tensor, *, img_h: int, img_w: int,
                   crop_h: int, crop_w: int,
                   out_dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """K1: fused decode + crop + flip + normalize.  Per-sample scalars in
    ((B,) int64 bases, (B,) int32 mixes/tops/lefts/flips), augmented
    (B, crop_h, crop_w, 3) ``out_dtype`` out, one launch."""
    check_tensor("bases", bases, torch.int64, 1)
    for name, t in (("mixes", mixes), ("tops", tops), ("lefts", lefts),
                    ("flips", flips)):
        check_tensor(name, t, torch.int32, 1, bases.device)
        if t.shape != bases.shape:
            raise ValueError(f"{name} must have length {bases.shape[0]}")
    if out_dtype not in _OUT_DTYPES:
        raise TypeError(f"out_dtype must be one of {_OUT_DTYPES}")
    if not (0 < crop_h <= img_h and 0 < crop_w <= img_w):
        raise ValueError(f"crop {crop_h}x{crop_w} does not fit "
                         f"{img_h}x{img_w}")
    if bases.device.type == "cpu":
        return decode_augment_plain(bases, mixes, tops, lefts, flips,
                                    img_w, crop_h, crop_w, out_dtype)
    if bases.device.type != "cuda":
        raise ValueError(f"no decode_augment kernel for device "
                         f"{bases.device}")
    if crop_h * crop_w * 3 >= 2**31:
        raise ValueError(f"crops of {crop_h}x{crop_w} exceed the kernel's "
                         f"32-bit indices")
    table = normalize_table(bases.device, out_dtype)
    out = torch.empty((bases.shape[0], crop_h, crop_w, 3), dtype=out_dtype,
                      device=bases.device)
    fn = library("decode").repro_torch_decode_augment
    fn.argtypes = [ctypes.c_void_p] * 7 + [ctypes.c_int] * 5 \
        + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    with torch.cuda.device(bases.device):
        decode_augment.launches += 1
        check_launch("decode_augment", fn(
            bases.data_ptr(), mixes.data_ptr(), tops.data_ptr(),
            lefts.data_ptr(), flips.data_ptr(), table.data_ptr(),
            out.data_ptr(), bases.shape[0], img_w, crop_h, crop_w,
            int(out_dtype == torch.bfloat16), stream_ptr(bases)))
    return out


decode_augment.launches = 0
