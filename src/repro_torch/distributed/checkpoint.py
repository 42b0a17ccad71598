"""Fault-tolerant checkpointing: atomic, content-indexed, resumable.

The port's twin of ``repro.distributed.checkpoint``, with the same
on-disk layout (one directory per step)::

    <dir>/step_000123/
        manifest.json     # keys, shapes, dtypes, step, extras
        arrays.npz        # flattened leaves keyed by path
    <dir>/LATEST          # atomically-updated pointer

Writes go to ``step_xxx.tmp`` and are renamed into place only after
fsync, so a crash mid-write never corrupts the restore point.

A tree is nested mappings (a model's ``state_dict()``, a dict of
optimizer states), named tuples (``AdamWState``, ``Quantized``), lists
and tuples, with tensors or numpy arrays as leaves; a leaf's key is its
path joined with ``/`` (mapping keys, tuple field names, list indices),
as the reference's flattening of a pytree.  bfloat16 tensors are stored
as their ``uint16`` bits with the dtype in the manifest (npz cannot hold
bfloat16, and the port has no ``ml_dtypes``).
"""
from __future__ import annotations

import json
import os
import shutil
import tempfile
import zipfile
from typing import Any, Callable, Dict, List, Mapping, Optional, Tuple

import numpy as np
import torch


def _children(tree) -> Optional[List[Tuple[str, Any]]]:
    """(key, child) pairs of an inner node, or None for a leaf."""
    if isinstance(tree, Mapping):
        return [(str(k), v) for k, v in tree.items()]
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        return list(zip(tree._fields, tree))
    if isinstance(tree, (list, tuple)):
        return [(str(i), v) for i, v in enumerate(tree)]
    return None


def map_leaves(fn: Callable[[str, Any], Any], tree, prefix: str = ""):
    """``tree`` with every leaf replaced by ``fn(key, leaf)``: mappings
    come back as dicts, named tuples and lists as their own types."""
    kids = _children(tree)
    if kids is None:
        return fn(prefix, tree)
    out = [(k, map_leaves(fn, v, f"{prefix}/{k}" if prefix else k))
           for k, v in kids]
    if isinstance(tree, Mapping):
        return dict(out)
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        return type(tree)(*(v for _, v in out))
    return type(tree)(v for _, v in out)


def flatten(tree) -> Dict[str, Any]:
    """Leaves of ``tree`` by key (``a/b/0``), in the tree's order."""
    flat: Dict[str, Any] = {}
    map_leaves(lambda k, v: flat.__setitem__(k, v), tree)
    return flat


def _to_numpy(leaf) -> Tuple[np.ndarray, str]:
    """(stored array, true dtype name) of one leaf."""
    if isinstance(leaf, torch.Tensor):
        t = leaf.detach().cpu()
        if t.dtype == torch.bfloat16:
            return t.view(torch.int16).numpy().view(np.uint16), "bfloat16"
        a = t.numpy()
    else:
        a = np.asarray(leaf)
    return a, str(a.dtype)


def save(ckpt_dir: str, step: int, tree: Any,
         extras: Optional[Dict] = None) -> str:
    os.makedirs(ckpt_dir, exist_ok=True)
    final = os.path.join(ckpt_dir, f"step_{step:08d}")
    tmp = final + ".tmp"
    if os.path.exists(tmp):
        shutil.rmtree(tmp)
    os.makedirs(tmp)

    stored, dtypes = {}, {}
    for k, v in flatten(tree).items():
        stored[k], dtypes[k] = _to_numpy(v)
    np.savez(os.path.join(tmp, "arrays.npz"), **stored)
    manifest = {
        "step": step,
        "keys": sorted(stored.keys()),
        "shapes": {k: list(v.shape) for k, v in stored.items()},
        "dtypes": dtypes,
        "extras": extras or {},
    }
    with open(os.path.join(tmp, "manifest.json"), "w") as f:
        json.dump(manifest, f)
        f.flush()
        os.fsync(f.fileno())
    if os.path.exists(final):
        shutil.rmtree(final)
    os.rename(tmp, final)

    # atomic LATEST pointer
    ptr = os.path.join(ckpt_dir, "LATEST")
    fd, tmp_ptr = tempfile.mkstemp(dir=ckpt_dir)
    with os.fdopen(fd, "w") as f:
        f.write(os.path.basename(final))
        f.flush()
        os.fsync(f.fileno())
    os.replace(tmp_ptr, ptr)
    return final


def _is_complete(path: str) -> bool:
    """A checkpoint directory is complete iff its manifest parses, its
    arrays.npz opens, and every manifest key has an array.  Crash-
    truncated or partially-pruned checkpoints fail one of these."""
    try:
        with open(os.path.join(path, "manifest.json")) as f:
            manifest = json.load(f)
        with np.load(os.path.join(path, "arrays.npz")) as data:
            files = set(data.files)
        return set(manifest["keys"]) <= files
    except (OSError, ValueError, KeyError, json.JSONDecodeError,
            zipfile.BadZipFile):
        return False


def _step_dirs(ckpt_dir: str) -> List[str]:
    if not os.path.isdir(ckpt_dir):
        return []
    return sorted(d for d in os.listdir(ckpt_dir)
                  if d.startswith("step_") and not d.endswith(".tmp"))


def latest_step(ckpt_dir: str) -> Optional[int]:
    """Newest *complete* checkpoint step, or None.

    The LATEST pointer is the fast path; when it is stale, missing, or
    names an incomplete directory (crash mid-write, overlapping prune)
    fall back to scanning step dirs newest-first and return the first
    that validates.
    """
    ptr = os.path.join(ckpt_dir, "LATEST")
    if os.path.exists(ptr):
        with open(ptr) as f:
            name = f.read().strip()
        path = os.path.join(ckpt_dir, name)
        if os.path.isdir(path) and _is_complete(path):
            return int(name.split("_")[1])
    for name in reversed(_step_dirs(ckpt_dir)):
        if _is_complete(os.path.join(ckpt_dir, name)):
            return int(name.split("_")[1])
    return None


def restore(ckpt_dir: str, template: Any,
            step: Optional[int] = None) -> Tuple[Any, Dict]:
    """Restore into the structure of ``template`` (shape-checked; each
    tensor leaf comes back with the template leaf's dtype and device).

    With ``step=None`` the newest complete checkpoint is used; if that
    directory disappears or truncates between selection and read (prune
    racing restore), selection retries on the survivors — genuine
    template mismatches (shapes, missing keys) still raise.
    """
    if step is not None:
        return _restore_path(
            os.path.join(ckpt_dir, f"step_{step:08d}"), template)
    last_err: Optional[Exception] = None
    for _attempt in range(4):
        chosen = latest_step(ckpt_dir)
        if chosen is None:
            raise FileNotFoundError(f"no checkpoint in {ckpt_dir}")
        try:
            return _restore_path(
                os.path.join(ckpt_dir, f"step_{chosen:08d}"), template)
        except (OSError, zipfile.BadZipFile, json.JSONDecodeError) as e:
            last_err = e               # dir vanished/truncated under us
    raise FileNotFoundError(
        f"no stable checkpoint in {ckpt_dir}: {last_err!r}")


def _restore_path(path: str, template: Any) -> Tuple[Any, Dict]:
    with open(os.path.join(path, "manifest.json")) as f:
        manifest = json.load(f)
    with np.load(os.path.join(path, "arrays.npz")) as data:
        missing = set(flatten(template)) - set(data.files)
        if missing:
            raise ValueError(
                f"checkpoint missing keys: {sorted(missing)[:5]}")

        def load(key, leaf):
            arr = data[key]
            if tuple(arr.shape) != tuple(leaf.shape):
                raise ValueError(f"{key}: shape {arr.shape} != "
                                 f"{tuple(leaf.shape)}")
            if not isinstance(leaf, torch.Tensor):
                return arr.astype(leaf.dtype)
            if manifest["dtypes"].get(key) == "bfloat16":
                t = torch.from_numpy(arr.view(np.int16)).view(torch.bfloat16)
            else:
                t = torch.from_numpy(arr)
            return t.to(device=leaf.device, dtype=leaf.dtype)

        return map_leaves(load, template), manifest


def prune(ckpt_dir: str, keep: int = 3) -> List[str]:
    """Keep the newest ``keep`` checkpoints, drop the rest."""
    if not os.path.isdir(ckpt_dir):
        return []
    steps = sorted(d for d in os.listdir(ckpt_dir)
                   if d.startswith("step_") and not d.endswith(".tmp"))
    removed = []
    for d in steps[:-keep] if keep else steps:
        shutil.rmtree(os.path.join(ckpt_dir, d))
        removed.append(d)
    return removed
