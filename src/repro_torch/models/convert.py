"""Load the reference's parameters and caches into the port.

The reference keeps its parameters as a pytree: nested dicts whose
``blocks`` leaves are stacked on a leading layer axis.  Given that tree
as nested dicts of numpy arrays (``jax.tree.map(np.asarray, params)``),
:func:`params_from_jax` fills the port's :class:`Model` leaf by leaf,
layer ``i`` of ``blocks`` from row ``i`` of each stacked leaf, and
:func:`params_to_numpy` gives the tree back.  :func:`cache_from_jax`
converts a cache tree the same way.

``np.asarray`` of a JAX bfloat16 array is an ``ml_dtypes`` bfloat16
array, which ``torch.from_numpy`` refuses.  Such an array is moved by
its bits: viewed as ``uint16`` and then, in torch, as ``bfloat16``.  Both
directions are exact.  The port reads the dtype by name, so it needs no
``ml_dtypes`` (nor jax) itself.
"""
from __future__ import annotations

from typing import Dict, Mapping

import numpy as np
import torch
from torch import nn

from repro_torch.models.params import ParamDef, ParamTree, Stacked


def to_tensor(a, device=None) -> torch.Tensor:
    """A numpy array (bfloat16 included) -> a tensor with the same bits."""
    a = np.array(a, copy=True, order="C")        # writable, contiguous
    if a.dtype.name == "bfloat16":
        t = torch.from_numpy(a.view(np.uint16).view(np.int16)).view(
            torch.bfloat16)
    else:
        t = torch.from_numpy(a)
    return t.to(device) if device is not None else t


def to_numpy(t: torch.Tensor) -> np.ndarray:
    """A tensor -> numpy; bfloat16 comes back as float32 (exact)."""
    t = t.detach().cpu()
    if t.dtype == torch.bfloat16:
        t = t.float()
    return t.numpy()


def _load(tree: ParamTree, src: Mapping, device, path: str) -> None:
    for name in tree.keys():
        d = tree.defs[name]
        if name not in src:
            raise KeyError(f"reference tree has no {path}{name}")
        if isinstance(d, ParamDef):
            t = to_tensor(src[name], device)
            if tuple(t.shape) != tuple(d.shape):
                raise ValueError(f"{path}{name}: shape {tuple(t.shape)}, "
                                 f"expected {d.shape}")
            setattr(tree, name, nn.Parameter(t, requires_grad=False))
        elif isinstance(d, Stacked):
            layers = tree[name]
            for i, layer in enumerate(layers):
                _load(layer, _index(src[name], i, d.n), device,
                      f"{path}{name}[{i}].")
        else:
            _load(tree[name], src[name], device, f"{path}{name}.")


def _index(src, i: int, n: int):
    if isinstance(src, Mapping):
        return {k: _index(v, i, n) for k, v in src.items()}
    a = np.asarray(src)
    if a.shape[0] != n:
        raise ValueError(f"stacked leaf has {a.shape[0]} layers, expected "
                         f"{n}")
    return a[i]


def params_from_jax(model: ParamTree, tree: Mapping, device=None):
    """Load the reference's parameter tree (numpy leaves) into ``model``
    on ``device`` (default: CPU) and return ``model``."""
    _load(model, tree, device, "")
    return model


def params_to_numpy(model: ParamTree) -> Dict:
    """The reference's tree layout back from ``model``: nested dicts,
    ``blocks`` leaves stacked on a leading layer axis."""
    out: Dict = {}
    for name in model.keys():
        d = model.defs[name]
        if isinstance(d, ParamDef):
            out[name] = to_numpy(model[name])
        elif isinstance(d, Stacked):
            per_layer = [params_to_numpy(layer) for layer in model[name]]
            out[name] = _stack(per_layer)
        else:
            out[name] = params_to_numpy(model[name])
    return out


def _stack(trees):
    if isinstance(trees[0], dict):
        return {k: _stack([t[k] for t in trees]) for k in trees[0]}
    return np.stack(trees)


def cache_from_jax(tree: Mapping, device=None) -> Dict[str, torch.Tensor]:
    """The reference's cache dict (numpy leaves) -> the port's."""
    return {name: to_tensor(a, device) for name, a in tree.items()}
