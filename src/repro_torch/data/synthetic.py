"""Deterministic synthetic multimedia dataset — in-memory and on-disk.

Samples are generated from a per-id PRNG so any worker on any host can
materialize sample ``i`` without shared state — the property real object
stores give you and the one checkpoint/restart relies on.

Encoded sizes follow a lognormal around the dataset's mean (Table 6 stats),
clipped to [0.25x, 4x] of the mean, mimicking JPEG size spread.

:class:`FileDataset` materializes the same samples into write-once
sharded files so the live pipeline exercises *real* file IO (open /
mmap / copy) instead of PRNG calls; byte-identical payloads, same
interface, drop-in behind :class:`~repro_torch.data.storage.RemoteStorage`.
"""
from __future__ import annotations

import os
from dataclasses import dataclass
from typing import Dict, Tuple

import numpy as np

# splitmix32-style counter hash: the canonical "JPEG decode" pixel PRNG.
# Every pixel byte is a pure function of (base seed, flat pixel index) in
# exact uint32 wraparound math, so the CUDA decode kernels
# (repro_torch.kernels.decode) reproduce it bit-for-bit on device — something a
# stateful NumPy Generator could never offer.  Changing any constant here
# breaks the kernel parity tests.
_HASH_STEP = 0x9E3779B9          # golden-ratio counter increment
_HASH_M1 = 0x7FEB352D
_HASH_M2 = 0x846CA68B


def pixel_hash(base: int, n: int) -> np.ndarray:
    """uint8[n] pixel stream for counter indices 0..n-1 (host reference).

    ``base`` is the per-sample seed, reduced mod 2**32; all arithmetic
    wraps in uint32 exactly like the device twin
    :func:`repro_torch.kernels.decode.kernel.pixel_hash_torch` and the
    hash in ``csrc/common.cuh``.
    """
    idx = np.arange(n, dtype=np.uint32)
    x = np.uint32(base & 0xFFFFFFFF) + idx * np.uint32(_HASH_STEP)
    x ^= x >> np.uint32(16)
    x *= np.uint32(_HASH_M1)
    x ^= x >> np.uint32(15)
    x *= np.uint32(_HASH_M2)
    x ^= x >> np.uint32(16)
    return (x & np.uint32(0xFF)).astype(np.uint8)


@dataclass(frozen=True)
class SyntheticDataset:
    name: str
    n_samples: int
    mean_encoded_bytes: int
    image_hw: Tuple[int, int] = (256, 256)
    crop_hw: Tuple[int, int] = (224, 224)
    n_classes: int = 1000
    seed: int = 1234

    def encoded_size(self, sample_id: int) -> int:
        rng = np.random.default_rng(self.seed + sample_id)
        s = rng.lognormal(mean=0.0, sigma=0.35)
        s = float(np.clip(s, 0.25, 4.0))
        return max(int(self.mean_encoded_bytes * s), 1024)

    def encoded(self, sample_id: int) -> bytes:
        """The 'file on storage' for this sample (header + payload)."""
        n = self.encoded_size(sample_id)
        rng = np.random.default_rng(self.seed + sample_id)
        # realistic cost: materialize the payload (I/O-sized buffer)
        payload = rng.integers(0, 256, size=n, dtype=np.uint8)
        return payload.tobytes()

    def label(self, sample_id: int) -> int:
        return (sample_id * 2654435761) % self.n_classes

    def decode_base_seed(self, sample_id: int) -> int:
        """The per-sample counter-hash base seed (mod 2**32) — the host
        half of the device decode contract (repro_torch.kernels.decode)."""
        return (self.seed * 31 + sample_id) & 0xFFFFFFFF

    @staticmethod
    def decode_head_mix(encoded: bytes) -> int:
        """Payload statistic folded into every pixel (0..255): the sum of
        the first 4 KiB, so decode actually reads the buffer."""
        head = np.frombuffer(encoded[:4096], dtype=np.uint8)
        return int(head.sum()) % 256

    def decode(self, encoded: bytes, sample_id: int) -> np.ndarray:
        """'JPEG decode': deterministic uint8 HWC image derived from the
        payload.  Does real CPU work proportional to the image area.

        Pixels come from the counter hash (:func:`pixel_hash`) over the
        per-sample base seed, plus a payload-header mix — exactly the
        semantics the CUDA decode kernels reproduce on device.
        """
        h, w = self.image_hw
        img = pixel_hash(self.decode_base_seed(sample_id),
                         h * w * 3).reshape(h, w, 3)
        img = (img.astype(np.int32) + self.decode_head_mix(encoded)) % 256
        return img.astype(np.uint8)

    def decoded_bytes(self) -> int:
        h, w = self.image_hw
        return h * w * 3

    def augmented_bytes(self, dtype_size: int = 4) -> int:
        h, w = self.crop_hw
        return h * w * 3 * dtype_size

    def inflation(self, dtype_size: int = 4) -> float:
        return self.augmented_bytes(dtype_size) / self.mean_encoded_bytes


@dataclass(frozen=True)
class DecodeHeavyDataset(SyntheticDataset):
    """A :class:`SyntheticDataset` whose decode burns extra CPU inside
    the GIL — a pure-Python byte fold over the encoded payload.

    Decode time scales with ``decode_work`` irrespective of image size,
    so the sharded-data-plane benchmark can dial CPU-bound decode cost
    without inflating cache footprints.  Still frozen and picklable, so
    it ships to spawned shard processes unchanged.
    """

    decode_work: int = 16_384    # payload bytes folded per decode

    def decode(self, encoded: bytes, sample_id: int) -> np.ndarray:
        acc = 0
        for b in encoded[:self.decode_work]:   # deliberate: holds the GIL
            acc = (acc * 31 + b) & 0xFFFFFFFF
        img = super().decode(encoded, sample_id)
        # fold the checksum in so the work cannot be dead-code-eliminated
        # and stays deterministic per (payload, id)
        return ((img.astype(np.int32) + acc % 7) % 256).astype(np.uint8)


class FileDataset:
    """Sharded on-disk materialization of a :class:`SyntheticDataset`.

    ``root`` gains write-once shard files (``shard-00000.bin`` …, each
    up to ``shard_bytes`` of concatenated encoded payloads) plus an
    ``index.npz`` mapping sample id -> (shard, offset, length).  A
    second construction over the same root reuses the files (the index
    is validated against the dataset's name/size), so benchmarks and
    the workload runner pay materialization once per machine.

    Reads go through one ``np.memmap`` per shard — ``encoded(i)``
    copies the sample's byte range out of the mapping, which is a real
    page-cache/disk read, unlike the PRNG-backed base dataset.  All
    other behavior (decode, labels, per-form sizes) delegates to the
    base dataset; payloads are byte-identical by construction, so the
    two are interchangeable mid-experiment.
    """

    def __init__(self, base: SyntheticDataset, root: str,
                 shard_bytes: int = 16 << 20):
        self.base = base
        self.root = root
        self.shard_bytes = int(shard_bytes)
        self._mmaps: Dict[int, np.memmap] = {}
        os.makedirs(root, exist_ok=True)
        self._index_path = os.path.join(root, "index.npz")
        if os.path.exists(self._index_path):
            idx = np.load(self._index_path, allow_pickle=False)
            if (str(idx["name"]) != base.name
                    or int(idx["n_samples"]) != base.n_samples
                    or int(idx["seed"]) != base.seed):
                raise ValueError(
                    f"{root} holds shards for dataset "
                    f"{idx['name']}/{idx['n_samples']}, not "
                    f"{base.name}/{base.n_samples}; use a fresh root")
            self.shard_of = idx["shard"]
            self.offset_of = idx["offset"]
            self.length_of = idx["length"]
            self.n_shards = int(self.shard_of[-1]) + 1 \
                if len(self.shard_of) else 0
        else:
            self._materialize()

    def _materialize(self) -> None:
        n = self.base.n_samples
        shard_of = np.zeros(n, np.int32)
        offset_of = np.zeros(n, np.int64)
        length_of = np.zeros(n, np.int64)
        shard, offset, f = 0, 0, None
        try:
            for i in range(n):
                payload = self.base.encoded(i)
                if f is None or (offset and
                                 offset + len(payload) > self.shard_bytes):
                    if f is not None:
                        f.close()
                    shard = shard + 1 if f is not None else 0
                    offset = 0
                    f = open(self._shard_path(shard), "wb")
                shard_of[i], offset_of[i] = shard, offset
                length_of[i] = len(payload)
                f.write(payload)
                offset += len(payload)
        finally:
            if f is not None:
                f.close()
        self.shard_of, self.offset_of = shard_of, offset_of
        self.length_of = length_of
        self.n_shards = shard + 1 if n else 0
        np.savez(self._index_path, shard=shard_of, offset=offset_of,
                 length=length_of, name=self.base.name,
                 n_samples=self.base.n_samples, seed=self.base.seed)

    def _shard_path(self, shard: int) -> str:
        return os.path.join(self.root, f"shard-{shard:05d}.bin")

    def _mmap(self, shard: int) -> np.memmap:
        mm = self._mmaps.get(shard)
        if mm is None:
            mm = np.memmap(self._shard_path(shard), dtype=np.uint8,
                           mode="r")
            self._mmaps[shard] = mm
        return mm

    # -- the SyntheticDataset interface --------------------------------
    @property
    def name(self) -> str:
        return f"{self.base.name}@file"

    @property
    def n_samples(self) -> int:
        return self.base.n_samples

    @property
    def mean_encoded_bytes(self) -> int:
        return self.base.mean_encoded_bytes

    @property
    def image_hw(self) -> Tuple[int, int]:
        return self.base.image_hw

    @property
    def crop_hw(self) -> Tuple[int, int]:
        return self.base.crop_hw

    @property
    def n_classes(self) -> int:
        return self.base.n_classes

    @property
    def seed(self) -> int:
        return self.base.seed

    def encoded_size(self, sample_id: int) -> int:
        return int(self.length_of[sample_id])

    def encoded(self, sample_id: int) -> bytes:
        mm = self._mmap(int(self.shard_of[sample_id]))
        off = int(self.offset_of[sample_id])
        return bytes(mm[off:off + int(self.length_of[sample_id])])

    def label(self, sample_id: int) -> int:
        return self.base.label(sample_id)

    def decode(self, encoded: bytes, sample_id: int) -> np.ndarray:
        return self.base.decode(encoded, sample_id)

    def decoded_bytes(self) -> int:
        return self.base.decoded_bytes()

    def augmented_bytes(self, dtype_size: int = 4) -> int:
        return self.base.augmented_bytes(dtype_size)

    def inflation(self, dtype_size: int = 4) -> float:
        return self.base.inflation(dtype_size)

    def total_bytes(self) -> int:
        return int(self.length_of.sum())

    def close(self) -> None:
        """Drop the shard mappings (the files stay — they are the
        dataset).  ``remove_files()`` deletes those too."""
        self._mmaps.clear()

    def remove_files(self) -> None:
        self.close()
        for shard in range(self.n_shards):
            try:
                os.unlink(self._shard_path(shard))
            except OSError:
                pass
        try:
            os.unlink(self._index_path)
            os.rmdir(self.root)
        except OSError:
            pass


# paper-shaped datasets scaled down for CPU-runnable examples/tests
def tiny(n: int = 2048, mean_bytes: int = 24_000) -> SyntheticDataset:
    return SyntheticDataset("tiny", n, mean_bytes, image_hw=(64, 64),
                            crop_hw=(56, 56), n_classes=100)


def imagenet_like(n: int = 1_300_000) -> SyntheticDataset:
    return SyntheticDataset("imagenet-1k-like", n, 114_620)


def openimages_like(n: int = 1_900_000) -> SyntheticDataset:
    return SyntheticDataset("openimages-like", n, 315_840)
