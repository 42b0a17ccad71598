"""Elastic scaling: re-mesh and reshard when the node count changes.

The port's twin of ``repro.distributed.elastic``.  On failure (or a
capacity change) the mesh is rebuilt at the new size and every array is
laid out anew on it.  The *logical* rules (``distributed/sharding.py``)
are size-independent, so the resharding plan is just "same spec, new
mesh"; divisibility is re-validated and axes whose factor no longer
divides fall back to replication (recorded in the plan).

Specs are the port's plain tuples (``ShardingRules.spec``,
``models.params.partition_specs``); a resharded leaf is a DTensor with
``placements_of(new_mesh, valid_spec)``.

One controller against many.  The reference runs one process that
reaches every device, so its ``device_put`` can read each shard, a dead
device's included.  The port runs one process per rank: a plain leaf is
taken to be whole on every rank (as ``models/convert.py`` loads a model)
and each rank cuts its block with no communication; a DTensor leaf on
the old mesh is first made whole with ``full_tensor()``, which every rank
of the old mesh must call.  The data of a rank that really died is gone
with it, and only a checkpoint (``distributed/checkpoint.py``) brings it
back; this module reshards what the live ranks hold.

Building a mesh over a subset of the world creates process subgroups,
so every rank of the world calls :func:`make_mesh`, :func:`shrunk_mesh`
and :func:`reshard`, those left out of the new mesh included.  A rank
outside the new mesh holds an empty local block of each leaf.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Any, List, Mapping, Sequence, Tuple

import numpy as np
import torch

from repro_torch.distributed.sharding import block_of, placements_of


@dataclass
class RemeshPlan:
    old_shape: Tuple[int, ...]
    new_shape: Tuple[int, ...]
    axis_names: Tuple[str, ...]
    demotions: List[str]              # param paths that lost an axis

    def summary(self) -> str:
        return (f"{self.old_shape} -> {self.new_shape} on "
                f"{self.axis_names}; {len(self.demotions)} demotions")


def make_mesh(n_devices: int, axis_names=("data", "model"),
              model_parallel: int = 0, *, device=None):
    """A (n / mp, mp) ``DeviceMesh`` over the first ``n_devices`` ranks of
    the world (``launch.mesh``), ``mp`` the largest divisor of
    ``n_devices`` up to ``model_parallel`` (default 16).  ``device=None``
    means CUDA."""
    import torch.distributed as dist
    from repro_torch.launch.mesh import _mesh
    have = dist.get_world_size() if dist.is_initialized() else 0
    if n_devices > have:
        raise RuntimeError(f"need {n_devices} ranks for the mesh, the "
                           f"world has {have}")
    mp = model_parallel or min(n_devices, 16)
    while n_devices % mp:
        mp -= 1
    shape = (n_devices // mp, mp)
    return _mesh(device, shape, tuple(axis_names))


def shrunk_mesh(n_devices: int, failed: Any,
                axis_names=("data", "model"),
                model_parallel: int = 0, *, device=None):
    """Rebuild the mesh with the failed ranks removed.

    ``failed`` is either an iterable of dead rank indices or a liveness
    registry (anything with a ``failed()`` method, such as
    :class:`~repro_torch.faults.liveness.LivenessRegistry`).  The new mesh
    takes the first ``live`` ranks of the world, as the reference takes
    the first devices.
    """
    if hasattr(failed, "failed"):
        failed = failed.failed()
    dead = {int(h) for h in failed}
    live = [i for i in range(n_devices) if i not in dead]
    if not live:
        raise ValueError(f"no live devices left of {n_devices} "
                         f"(failed: {sorted(dead)})")
    return make_mesh(len(live), axis_names=axis_names,
                     model_parallel=model_parallel, device=device)


def _axis_size(mesh, name: str) -> int:
    return mesh.size(mesh.mesh_dim_names.index(name))


def _valid_spec(spec: Sequence, shape: Tuple[int, ...], mesh) -> Tuple:
    """Demote axes whose mesh factor no longer divides the dim."""
    parts = []
    for dim, ax in zip(shape, tuple(spec) + (None,) * len(shape)):
        if ax is None:
            parts.append(None)
            continue
        axes = ax if isinstance(ax, tuple) else (ax,)
        factor = int(np.prod([_axis_size(mesh, a) for a in axes]))
        parts.append(ax if dim % factor == 0 else None)
    return tuple(parts)


def _place(x: torch.Tensor, spec: Tuple, mesh):
    """``x`` as a DTensor laid out by ``spec`` on ``mesh``."""
    from torch.distributed.tensor import DTensor
    x = x.detach()
    if isinstance(x, DTensor):
        x = x.full_tensor()
    placements = placements_of(mesh, spec)
    if mesh.get_coordinate() is None:         # this rank is not in it
        local = x.new_empty(0)
    else:
        local = block_of(x, mesh, spec)
    return DTensor.from_local(local, mesh, placements, run_check=False,
                              shape=x.shape, stride=x.stride())


def _is_spec(spec) -> bool:
    return isinstance(spec, tuple) and all(
        e is None or isinstance(e, (str, tuple)) for e in spec)


def reshard(tree: Any, specs: Any, new_mesh) -> Tuple[Any, RemeshPlan]:
    """``tree`` laid out on ``new_mesh`` by ``specs``, and the plan.

    ``tree`` is nested mappings (or a ``ParamTree``) of tensors; a
    sequence of per-layer trees stands for the reference's stacked
    ``(L, ...)`` leaves, with the stacked specs (a leading unsharded
    ``layers`` entry, as ``partition_specs`` gives them).  Returns nested
    dicts (lists for the per-layer sequences) of DTensors, and a plan
    whose ``demotions`` are the paths of the leaves that lost an axis, in
    ``jax.tree_util.keystr``'s form (``"['blocks']['attn']['wq']"``), in
    the reference's order.
    """
    demotions: List[str] = []

    def move(path: str, x, spec, stacked: bool):
        full = tuple(spec)
        if stacked:
            if full and full[0] is not None:
                raise ValueError(f"{path}: the layer axis of a per-layer "
                                 f"sequence cannot shard ({full})")
            full = full[1:]
        sp = _valid_spec(full, tuple(x.shape), new_mesh)
        if sp != full and path not in demotions:
            demotions.append(path)
        return _place(x, sp, new_mesh)

    def walk(path: str, x, spec, stacked: bool = False):
        if isinstance(x, torch.Tensor):
            if not _is_spec(spec):
                raise ValueError(f"{path}: no spec for a tensor ({spec!r})")
            return move(path, x, spec, stacked)
        if isinstance(x, (Sequence, torch.nn.ModuleList)) and \
                not isinstance(x, Mapping):
            if isinstance(spec, (list, torch.nn.ModuleList)):
                return [walk(f"{path}[{i}]", xi, si, stacked)
                        for i, (xi, si) in enumerate(zip(x, spec))]
            return [walk(path, xi, spec, True) for xi in x]
        return {k: walk(f"{path}['{k}']", x[k], spec[k], stacked)
                for k in sorted(x.keys())}

    out = walk("", tree, specs)
    plan = RemeshPlan(old_shape=(), new_shape=tuple(new_mesh.shape),
                      axis_names=tuple(new_mesh.mesh_dim_names),
                      demotions=demotions)
    return out, plan
