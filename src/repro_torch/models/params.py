"""Parameter definitions of the port.

Models declare their parameters once as a nested dict of
:class:`ParamDef` (shape + logical axis names + initializer), as the
reference's ``repro.models.params`` does.  From that one source the port
derives

* :class:`ParamTree` — an ``nn.Module`` holding the materialized tensors
  at the same nested names (``blocks[i].attn.wq`` is the reference's
  ``params["blocks"]["attn"]["wq"][i]``), so layer code indexes it like
  the reference's dict;
* :func:`init_tree` — seeded initialization from an explicit
  ``torch.Generator`` on the generator's device, with the reference's
  initializers and scales (fan-in scaled normal, ``embed`` x0.02,
  ``zeros``, ``ones``).  The numbers differ from ``jax.random``'s; tests
  that compare with the reference load its parameters instead
  (:mod:`repro_torch.models.convert`);
* :func:`abstract_params` and :func:`abstract_tree` — the same shapes and
  types with no data (fake tensors under a ``FakeTensorMode``, else
  ``meta`` ones), for the dry-run (``launch/dryrun.py``), and
  :func:`param_bytes`.

The logical axes are read by the distributed layer
(``distributed.sharding.distribute_model``).  Parameters are created
with ``requires_grad=False``, as serving wants them;
:func:`repro_torch.train.step.build_train_step` turns their gradients
on.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Dict, Optional, Tuple

import numpy as np
import torch
from torch import nn


@dataclass(frozen=True)
class ParamDef:
    shape: Tuple[int, ...]
    axes: Tuple[Optional[str], ...]
    init: str = "normal"          # normal | zeros | ones | embed
    scale: float = 1.0            # multiplier on the default fan-in scale
    dtype: Any = None             # None -> use the model's param dtype

    def __post_init__(self):
        assert len(self.shape) == len(self.axes), (self.shape, self.axes)


def init_leaf(generator: torch.Generator, d: ParamDef,
              dtype: torch.dtype) -> torch.Tensor:
    """One leaf on ``generator.device``, drawn in float32 then cast."""
    dt = d.dtype or dtype
    dev = generator.device
    if d.init == "zeros":
        return torch.zeros(d.shape, dtype=dt, device=dev)
    if d.init == "ones":
        return torch.ones(d.shape, dtype=dt, device=dev)
    x = torch.randn(d.shape, generator=generator, dtype=torch.float32,
                    device=dev)
    if d.init == "embed":
        return (x * (0.02 * d.scale)).to(dt)
    # fan-in scaled normal (truncation unnecessary at these scales)
    fan_in = d.shape[-2] if len(d.shape) >= 2 else d.shape[-1]
    return (x * float(d.scale / np.sqrt(max(fan_in, 1)))).to(dt)


@dataclass(frozen=True)
class Stacked:
    """``n`` layers of the same defs: the reference stacks them on a
    leading ``layers`` axis for ``lax.scan``; the port keeps one
    :class:`ParamTree` per layer in an ``nn.ModuleList``."""
    n: int
    defs: Dict[str, Any]


def stack_defs(defs: Dict[str, Any], layers: int) -> Stacked:
    return Stacked(layers, defs)


class ParamTree(nn.Module):
    """Nested parameters under the reference's names.  ``tree["wq"]``
    and ``"wq" in tree`` work as on the reference's dict; a stacked
    entry (``tree["blocks"]``) is an ``nn.ModuleList`` of layers.
    Leaves are empty ``meta`` tensors until :func:`init_tree` (or a
    load from the reference) fills them."""

    def __init__(self, defs: Dict[str, Any]):
        super().__init__()
        self.defs = defs
        for name, d in sorted(defs.items()):
            if isinstance(d, ParamDef):
                self.register_parameter(name, nn.Parameter(
                    torch.empty(d.shape, device="meta"),
                    requires_grad=False))
            elif isinstance(d, Stacked):
                self.add_module(name, nn.ModuleList(
                    ParamTree(d.defs) for _ in range(d.n)))
            else:
                self.add_module(name, ParamTree(d))

    def __getitem__(self, name: str):
        if name not in self.defs:
            raise KeyError(name)
        return getattr(self, name)

    def __contains__(self, name: str) -> bool:
        return name in self.defs

    def keys(self):
        return sorted(self.defs)


def init_tree(tree: ParamTree, generator: torch.Generator,
              dtype: torch.dtype) -> None:
    """Materialize every leaf of ``tree`` in sorted-name order (the
    order the reference flattens its dict in)."""
    for name in tree.keys():
        d = tree.defs[name]
        if isinstance(d, ParamDef):
            setattr(tree, name, nn.Parameter(init_leaf(generator, d, dtype),
                                             requires_grad=False))
        elif isinstance(d, Stacked):
            for layer in tree[name]:
                init_tree(layer, generator, dtype)
        else:
            init_tree(tree[name], generator, dtype)


def _fake_mode_active() -> bool:
    return torch._C._get_dispatch_mode(
        torch._C._TorchDispatchModeKey.FAKE) is not None


def _abstract_leaf(d: ParamDef, dtype: torch.dtype, device, lead=()):
    return torch.empty(lead + tuple(d.shape), dtype=d.dtype or dtype,
                       device=device if _fake_mode_active() else "meta")


def abstract_params(defs, dtype: torch.dtype = torch.bfloat16,
                    device="cuda") -> Any:
    """The reference's ``abstract_params``: ``defs`` as a tree of tensors
    with no data, each of its def's shape and type (``dtype`` where the
    def names none), as ``init_tree`` would make them.  Nested dicts; a
    :class:`Stacked` entry gives its defs with the ``layers`` axis in
    front, one leaf each, as the reference stacks them.  Under a
    ``FakeTensorMode`` the leaves are fake tensors on ``device``; with no
    such mode, ``meta`` tensors.  Nothing is allocated either way."""
    def walk(d, lead: Tuple):
        if isinstance(d, ParamDef):
            return _abstract_leaf(d, dtype, device, lead)
        if isinstance(d, Stacked):
            return walk(d.defs, lead + (d.n,))
        return {k: walk(v, lead) for k, v in d.items()}

    return walk(defs, ())


def abstract_tree(tree: ParamTree, dtype: torch.dtype = torch.bfloat16,
                  device="cuda") -> None:
    """Give every leaf of ``tree`` a tensor with no data, as
    :func:`abstract_params` makes them, one per layer as
    :func:`init_tree` makes them: the dry-run's model."""
    for name in tree.keys():
        d = tree.defs[name]
        if isinstance(d, ParamDef):
            setattr(tree, name, nn.Parameter(_abstract_leaf(d, dtype, device),
                                             requires_grad=False))
        elif isinstance(d, Stacked):
            for layer in tree[name]:
                abstract_tree(layer, dtype, device)
        else:
            abstract_tree(tree[name], dtype, device)


def partition_specs(defs, rules) -> Any:
    """Map logical axes -> mesh axes via ``rules`` (a mapping, or
    ``ShardingRules`` for its ``mapping``; missing/None -> replicated):
    the reference's ``partition_specs`` over the port's defs.  A spec is
    a tuple, one entry per dimension; a :class:`Stacked` entry gives the
    specs of its defs with the ``layers`` axis in front, as the
    reference's stacked leaves have it."""
    mapping = getattr(rules, "mapping", rules)

    def walk(d, lead: Tuple):
        if isinstance(d, ParamDef):
            return lead + tuple(mapping.get(a) if a is not None else None
                                for a in d.axes)
        if isinstance(d, Stacked):
            return walk(d.defs, lead + (mapping.get("layers"),))
        return {k: walk(v, lead) for k, v in d.items()}

    return walk(defs, ())


def load_tree(tree: ParamTree, values) -> None:
    """Set each leaf of ``tree`` to the tensor at its name in ``values``:
    nested mappings, a :class:`Stacked` entry a sequence of per-layer
    mappings (as ``distributed.elastic.reshard`` returns a model's tree).
    The tensors are taken as they are, not copied; a DTensor gives its
    local block."""
    from torch.distributed.tensor import DTensor
    for name in tree.keys():
        d = tree.defs[name]
        if isinstance(d, ParamDef):
            t = values[name]
            if isinstance(t, DTensor):
                t = t.to_local()
            if tuple(t.shape) != tuple(d.shape):
                raise ValueError(f"{name}: shape {tuple(t.shape)}, "
                                 f"expected {d.shape}")
            setattr(tree, name, nn.Parameter(t, requires_grad=False))
        elif isinstance(d, Stacked):
            for layer, v in zip(tree[name], values[name], strict=True):
                load_tree(layer, v)
        else:
            load_tree(tree[name], values[name])


def param_count(defs) -> int:
    if isinstance(defs, ParamDef):
        return int(np.prod(defs.shape))
    if isinstance(defs, Stacked):
        return defs.n * param_count(defs.defs)
    return sum(param_count(d) for d in defs.values())


def param_bytes(defs, dtype: torch.dtype = torch.bfloat16) -> int:
    """Bytes of ``defs``' parameters, each in its def's type or
    ``dtype``."""
    if isinstance(defs, ParamDef):
        return int(np.prod(defs.shape)) * (defs.dtype or dtype).itemsize
    if isinstance(defs, Stacked):
        return defs.n * param_bytes(defs.defs, dtype)
    return sum(param_bytes(d, dtype) for d in defs.values())


def round_up(x: int, m: int) -> int:
    return -(-x // m) * m


def padded_vocab(vocab: int, multiple: int = 2048) -> int:
    """Pad vocab so embedding/logits shard 16-way with 128-lane alignment."""
    return round_up(vocab, multiple)
