"""Public decode ops: host param derivation + batched device decode.

The device decode contract is two scalars per sample — the counter-hash
base seed and the payload-header mix — both derived here on host from the
dataset seed and the encoded byte buffers (:func:`decode_params`), so the
kernel never sees the payload itself.
"""
from __future__ import annotations

from typing import Optional, Sequence, Tuple

import numpy as np
import torch

from repro_torch.data.synthetic import FileDataset, SyntheticDataset
from repro_torch.kernels.decode.kernel import decode
from repro_torch.kernels.device import resolve_device


def decode_params(seed: int, sample_ids: Sequence[int],
                  payloads: Sequence[bytes]
                  ) -> Tuple[np.ndarray, np.ndarray]:
    """(bases uint32[B], mixes int32[B]) for a batch of encoded buffers
    under dataset ``seed`` — the host half of the kernel contract,
    byte-compatible with ``SyntheticDataset.decode_base_seed`` /
    ``decode_head_mix``."""
    bases = np.fromiter(((seed * 31 + int(s)) & 0xFFFFFFFF
                         for s in sample_ids), np.uint32,
                        count=len(sample_ids))
    mixes = np.fromiter((SyntheticDataset.decode_head_mix(p)
                         for p in payloads), np.int32,
                        count=len(payloads))
    return bases, mixes


def fused_decode_seed(ds) -> Optional[int]:
    """The dataset seed when ``ds.decode`` is exactly the base
    counter-hash decode (so the device kernel can substitute for it),
    else None.  Subclasses that override ``decode`` (e.g.
    ``DecodeHeavyDataset``) are rejected; ``FileDataset`` delegates to
    its base, so it qualifies when the base does."""
    base = ds.base if isinstance(ds, FileDataset) else ds
    if type(base) is SyntheticDataset:
        return int(base.seed)
    return None


def params_to_device(bases: np.ndarray, *int32s: np.ndarray,
                     device: torch.device) -> Tuple[torch.Tensor, ...]:
    """Host params -> kernel arguments: uint32 bases as int64, the rest
    as int32, all on ``device``."""
    out = [torch.from_numpy(bases.astype(np.int64)).to(device)]
    out += [torch.from_numpy(np.ascontiguousarray(a, np.int32)).to(device)
            for a in int32s]
    return tuple(out)


def decode_batch(payloads: Sequence[bytes], sample_ids: Sequence[int], *,
                 seed: int, image_hw: Tuple[int, int], device=None,
                 as_device: bool = False):
    """Batched device decode -> (B,h,w,3) uint8 host array, byte-identical
    to per-sample ``SyntheticDataset.decode``.  ``as_device`` returns the
    tensor on ``device`` instead (for admission into a device tier)."""
    dev = resolve_device(device)
    bases, mixes = decode_params(seed, sample_ids, payloads)
    h, w = image_hw
    out = decode(*params_to_device(bases, mixes, device=dev), h=h, w=w)
    return out if as_device else out.cpu().numpy()
