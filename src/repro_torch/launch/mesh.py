"""Mesh construction: the port's twin of ``repro.launch.mesh``.

Functions, not module-level constants, so importing this module touches
no process group.  Single pod: 16x16 = 256 ranks (data, model).
Multi-pod: 2x16x16 = 512 ranks (pod, data, model) — the ``pod`` axis is
the slow (inter-host) dimension.

A mesh is a ``DeviceMesh`` over an initialised ``torch.distributed``
world (:func:`init_world`).  ``device=None`` means CUDA, one card per
rank, over NCCL, and raises where CUDA is missing; ``device="cpu"``
means gloo.  Nothing falls back from one to the other.  A world of
torch's ``fake`` backend (the dry-run's, ``launch/dryrun.py``) runs
nothing, so its meshes take the device named, CUDA by default, on a
machine without one too.
"""
from __future__ import annotations

from datetime import timedelta
from typing import Dict

import numpy as np
import torch
import torch.distributed as dist

from repro_torch.kernels.device import resolve_device

#: how long a collective may wait for its peers
TIMEOUT = timedelta(seconds=60)


def init_world(init_method: str, rank: int = 0, world_size: int = 1, *,
               device=None) -> torch.device:
    """Join the default process group at ``init_method`` (``file://`` or
    ``tcp://localhost:PORT``) as ``rank`` of ``world_size``, with the
    backend of ``device``; for CUDA the rank's card (rank modulo the
    cards) becomes the current device and the backend is NCCL, on the
    CPU gloo.  Returns the rank's device."""
    dev = resolve_device(device)
    if dev.type == "cuda":
        index = rank % torch.cuda.device_count() if dev.index is None \
            else dev.index
        dev = torch.device("cuda", index)
        torch.cuda.set_device(dev)
    backend = "nccl" if dev.type == "cuda" else "gloo"
    dist.init_process_group(backend, init_method=init_method,
                            rank=rank, world_size=world_size,
                            timeout=TIMEOUT)
    return dev


def _device_type(device) -> str:
    if dist.is_initialized() and dist.get_backend() == "fake":
        return torch.device("cuda" if device is None else device).type
    return resolve_device(device).type


def _mesh(device, shape, axes):
    from torch.distributed.device_mesh import DeviceMesh, init_device_mesh
    kind = _device_type(device)
    n = int(np.prod(shape))
    if n == dist.get_world_size():
        return init_device_mesh(kind, tuple(shape), mesh_dim_names=tuple(axes))
    # the first n ranks, as the reference takes devices[:n]
    return DeviceMesh(kind, torch.arange(n).reshape(shape),
                      mesh_dim_names=tuple(axes))


def _world() -> int:
    return dist.get_world_size() if dist.is_initialized() else 0


def production_axes(multi_pod: bool = False) -> Dict[str, int]:
    """The production mesh's axes and their sizes."""
    if multi_pod:
        return {"pod": 2, "data": 16, "model": 16}
    return {"data": 16, "model": 16}


def make_production_mesh(*, multi_pod: bool = False, device=None):
    sizes = production_axes(multi_pod)
    shape, axes = tuple(sizes.values()), tuple(sizes)
    n = int(np.prod(shape))
    have = _world()
    if have < n:
        raise RuntimeError(
            f"need {n} devices for the production mesh, have {have}; start "
            f"{n} ranks and init_world() in each before building it")
    return _mesh(device, shape, axes)


def make_debug_mesh(n_devices: int = 0, axes=("data", "model"), device=None):
    """Small mesh over whatever ranks exist (tests)."""
    have = _world()
    if not have:
        raise RuntimeError("no process group; call init_world() first")
    n = n_devices or have
    if n > have:
        raise RuntimeError(f"need {n} devices for the debug mesh, have "
                           f"{have}")
    model = 1
    for m in (4, 2, 1):
        if n % m == 0 and n >= m:
            model = m
            break
    return _mesh(device, (n // model, model), axes)
