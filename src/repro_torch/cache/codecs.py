"""Per-form serialization codecs for the disk cache tier.

The DRAM tier stores live Python objects; the disk tier stores one file
per entry.  What a file holds depends on the data form:

* ``encoded`` entries are already storage-shaped ``bytes`` — they pass
  through unmodified (one ``write``, one ``read``);
* ``decoded`` / ``augmented`` entries are ndarrays — they are written as
  their raw contiguous buffer and read back through ``np.memmap``, so a
  disk hit maps the file instead of copying it (the pages fault in
  lazily and stay in the OS page cache across repeated hits).

Codecs keep the entry *metadata* (dtype/shape) in memory — the disk tier
is a process-local spill area, not a persistent store, so nothing needs
to survive a restart.
"""
from __future__ import annotations

import os
from dataclasses import dataclass
from typing import Any, Protocol, Tuple, runtime_checkable

import numpy as np


@runtime_checkable
class Codec(Protocol):
    """Serializes one cache entry to/from a file."""

    name: str

    def dump(self, value: Any, path: str) -> Tuple[int, Any]:
        """Write ``value`` to ``path``; returns (bytes written, meta)."""
        ...

    def load(self, path: str, meta: Any) -> Any:
        """Read the entry back (zero-copy where the form allows)."""
        ...


class BytesCodec:
    """Pass-through for encoded samples (they are bytes on storage too)."""

    name = "bytes"

    def dump(self, value, path: str) -> Tuple[int, Any]:
        buf = bytes(value)
        with open(path, "wb") as f:
            f.write(buf)
        return len(buf), None

    def load(self, path: str, meta) -> bytes:
        with open(path, "rb") as f:
            return f.read()


class NdarrayCodec:
    """Raw contiguous buffer + in-memory (dtype, shape) metadata.

    ``load`` returns a read-only ``np.memmap`` view of the file — the
    zero-copy contract: promoting a disk hit back to DRAM hands the
    mapped array up the chain, and unlinking the file afterwards is safe
    (the mapping keeps the pages live until dropped).
    """

    name = "ndarray"

    def dump(self, value, path: str) -> Tuple[int, Any]:
        arr = np.ascontiguousarray(value)
        arr.tofile(path)
        return arr.nbytes, (arr.dtype, arr.shape)

    def load(self, path: str, meta) -> np.ndarray:
        dtype, shape = meta
        if int(np.prod(shape)) == 0:        # memmap rejects empty files
            return np.empty(shape, dtype)
        return np.memmap(path, dtype=dtype, mode="r", shape=shape)


_CODECS = {
    "encoded": BytesCodec,
    "decoded": NdarrayCodec,
    "augmented": NdarrayCodec,
}


def codec_for(form: str) -> Codec:
    """The codec serializing ``form`` entries on the disk tier."""
    try:
        return _CODECS[form]()
    except KeyError:
        raise ValueError(f"no codec registered for form {form!r}; "
                         f"known: {tuple(sorted(_CODECS))}") from None


def register_codec(form: str, factory: type) -> None:
    _CODECS[form] = factory


# ---------------------------------------------------------------------------
# Cross-process payload currency (the sharded data plane's zero-copy path).
#
# A shard process never pickles an ndarray payload over its control pipe:
# it dumps the entry with the form's codec into a shared exchange
# directory and sends this small :class:`PayloadRef` instead.  The peer
# maps the file (``np.memmap`` for ndarrays) and unlinks it — on Linux
# the mapping keeps the pages live, so the bytes move through the page
# cache, not the pipe.

@dataclass(frozen=True)
class PayloadRef:
    """A cache payload parked in a file: ``(form, path, nbytes, meta)``
    where ``meta`` is the form codec's load metadata."""

    form: str
    path: str
    nbytes: int
    meta: Any = None


def ship_payload(form: str, value: Any, path: str) -> PayloadRef:
    """Serialize ``value`` with ``form``'s codec into ``path`` and
    return the ref the receiving process redeems."""
    nbytes, meta = codec_for(form).dump(value, path)
    return PayloadRef(form, path, nbytes, meta)


def receive_payload(ref: PayloadRef, unlink: bool = True) -> Any:
    """Redeem a :class:`PayloadRef`: load (memmap) the value, then
    unlink the exchange file so nothing accumulates — safe because the
    mapping pins the pages until the array is dropped."""
    value = codec_for(ref.form).load(ref.path, ref.meta)
    if unlink:
        try:
            os.unlink(ref.path)
        except OSError:
            pass
    return value
