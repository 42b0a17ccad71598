"""The weights of a run, made by the benchmark from ``--seed`` on the
device, and handed alike to the program and to the reference.

Each group of parameters (one per block, one for the rest) takes one
``torch.randn`` call of its normal entries in bf16, the type the
weights are served in, on a generator of its own seeded from the run's
seed and the group's index; each leaf is its slice times its scale
(fan-in scaled, or 0.02 for an embedding).  So any group can be made
again alone, in the same bits, to measure what the steps changed.
"""
from __future__ import annotations

import re
from typing import Dict, List, Tuple

import torch

Spec = Tuple[str, Tuple[int, ...], str, float]


def groups(specs: List[Spec]) -> List[List[Spec]]:
    """The specs by block (``blocks.<l>.``) in layer order, then the
    rest."""
    by: Dict[int, List[Spec]] = {}
    for s in specs:
        m = re.match(r"^blocks\.(\d+)\.", s[0])
        by.setdefault(int(m.group(1)) if m else -1, []).append(s)
    return [by[k] for k in sorted(k for k in by if k >= 0)] \
        + ([by[-1]] if -1 in by else [])


def _std(shape, init: str, scale: float) -> float:
    if init == "embed":
        return 0.02 * scale
    fan_in = shape[-2] if len(shape) >= 2 else shape[-1]
    return scale / max(fan_in, 1) ** 0.5


def _group_seed(seed: int, index: int) -> int:
    return (int(seed) * 1_000_003 + index * 7_919 + 17) % (1 << 63)


def make_group(group: List[Spec], seed: int, index: int, device,
               dtype=torch.bfloat16) -> Dict[str, torch.Tensor]:
    random = [s for s in group if s[2] in ("normal", "embed")]
    n = sum(torch.Size(s[1]).numel() for s in random)
    gen = torch.Generator(device=device)
    gen.manual_seed(_group_seed(seed, index))
    draw = torch.randn(n, generator=gen, dtype=dtype, device=device) \
        if n else None
    out, off = {}, 0
    for name, shape, init, scale in group:
        if init == "ones":
            out[name] = torch.ones(shape, dtype=dtype, device=device)
        elif init == "zeros":
            out[name] = torch.zeros(shape, dtype=dtype, device=device)
        else:
            k = torch.Size(shape).numel()
            out[name] = draw[off:off + k].view(shape) \
                * _std(shape, init, scale)
            off += k
    return out


def make(specs: List[Spec], seed: int, device,
         dtype=torch.bfloat16) -> Dict[str, torch.Tensor]:
    out = {}
    for i, g in enumerate(groups(specs)):
        out.update(make_group(g, seed, i, device, dtype))
    return out


def load(model, named: Dict[str, torch.Tensor]) -> None:
    """Put ``named`` into the program's model, each tensor as it is, as
    the parameter of that name; every parameter of the model must be
    given, with its shape."""
    want = {n: tuple(p.shape) for n, p in model.named_parameters()}
    got = {n: tuple(t.shape) for n, t in named.items()}
    if want != got:
        raise ValueError(f"the weights do not fit the model: missing "
                         f"{sorted(set(want) - set(got))[:4]}, extra "
                         f"{sorted(set(got) - set(want))[:4]}, shapes "
                         f"{[n for n in want if n in got and want[n] != got[n]][:4]}")
    for name, t in named.items():
        parent, _, leaf = name.rpartition(".")
        mod = model.get_submodule(parent) if parent else model
        setattr(mod, leaf, torch.nn.Parameter(t, requires_grad=False))
