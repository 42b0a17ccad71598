"""Device resolution and the CUDA kernel library.

Entry points of the port run on the card unless the caller asks for the
CPU: :func:`resolve_device` turns ``device=None`` into
``torch.device("cuda")`` and raises when CUDA is asked for on a machine
without it — nothing quietly drops to the CPU.

The hand-written kernels live in ``src/repro_torch/csrc/*.cu``.  They
are compiled at first use, one ``nvcc`` process per source, all started
together, each into a plain-C shared library under ``build/repro_torch/``
at the repository root, and loaded with :mod:`ctypes`.  Library names
carry a hash of the sources, so an edited source is rebuilt and a stale
library is never loaded.  There is no ``interpret``-style knob: a
wrapper takes its plain PyTorch version for a CPU tensor, and launches
its kernel (or raises) for a CUDA tensor (:func:`takes_plain`).  K4, K5
and their backwards launch through ``torch.library`` ops with fake
implementations and FLOP formulas (:func:`plain_flops`), so a trace of
fake tensors goes through them (``launch/dryrun.py``; :func:`as_card`).
"""
from __future__ import annotations

import contextlib
import contextvars
import ctypes
import functools
import hashlib
import os
import subprocess
import threading
from pathlib import Path
from typing import Dict, Optional

import torch

CSRC = Path(__file__).resolve().parents[1] / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "repro_torch"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC")

_build_lock = threading.Lock()
_libraries: Dict[str, ctypes.CDLL] = {}


def resolve_device(device=None) -> torch.device:
    """``None`` -> ``cuda``; an explicit device passes through.  Asking
    for CUDA where it is unavailable raises ``RuntimeError``."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"device {dev} requested but CUDA is not available; pass "
            f"device='cpu' to run the plain PyTorch versions")
    return dev


def concrete_device(device) -> torch.device:
    """``device`` with an index-less ``cuda`` resolved to the current
    CUDA device, so two devices compare by where their memory lies."""
    dev = torch.device(device)
    if dev.type == "cuda" and dev.index is None:
        return torch.device("cuda", torch.cuda.current_device())
    return dev


_AS_CARD: contextvars.ContextVar[bool] = contextvars.ContextVar(
    "repro_torch_as_card", default=False)


@contextlib.contextmanager
def as_card():
    """Inside a trace of fake tensors (a ``FakeTensorMode``), route CPU
    tensors to the kernels' ops, as CUDA tensors are routed: the dry-run's
    stand-in for fake CUDA tensors on a torch built without CUDA
    (``launch/dryrun.py``).  The ops have no CPU implementation, so a
    real CPU tensor that reached one would raise; outside a
    ``FakeTensorMode`` this raises at once."""
    if torch._C._get_dispatch_mode(
            torch._C._TorchDispatchModeKey.FAKE) is None:
        raise RuntimeError("as_card() routes fake tensors only: open a "
                           "FakeTensorMode first")
    token = _AS_CARD.set(True)
    try:
        yield
    finally:
        _AS_CARD.reset(token)


def takes_plain(t: torch.Tensor, kernel: str) -> bool:
    """A wrapper's route for its tensor ``t``: True for the plain version
    (a CPU tensor), False for the kernel's op (a CUDA tensor, or a CPU one
    under :func:`as_card`); any other device raises ``ValueError``."""
    if t.device.type == "cpu" and not _AS_CARD.get():
        return True
    if t.device.type in ("cuda", "cpu"):
        return False
    raise ValueError(f"no {kernel} kernel for device {t.device}")


def _nvcc() -> str:
    from torch.utils.cpp_extension import CUDA_HOME
    if CUDA_HOME is None:
        raise RuntimeError("no CUDA toolkit found (CUDA_HOME unset and no "
                           "nvcc on PATH); the kernels cannot be built")
    return os.path.join(CUDA_HOME, "bin", "nvcc")


def _sources_digest() -> str:
    h = hashlib.sha256()
    for path in sorted(CSRC.glob("*.cu*")):
        h.update(path.name.encode())
        h.update(path.read_bytes())
    return h.hexdigest()[:12]


def build_all() -> Dict[str, ctypes.CDLL]:
    """Compile every ``csrc/*.cu`` (once per process and source digest)
    and return the loaded libraries by source stem.  A failed build
    raises with the compiler's output."""
    with _build_lock:
        if _libraries:
            return _libraries
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        digest = _sources_digest()
        nvcc = None
        procs = {}
        for src in sorted(CSRC.glob("*.cu")):
            lib = BUILD_DIR / f"lib{src.stem}-{digest}.so"
            if not lib.exists():
                nvcc = nvcc or _nvcc()
                tmp = lib.with_suffix(f".{os.getpid()}.tmp")
                procs[src.stem] = (lib, tmp, subprocess.Popen(
                    [nvcc, *NVCC_FLAGS, "-o", str(tmp), str(src)],
                    stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                    text=True))
        failures = []
        for stem, (lib, tmp, proc) in procs.items():
            out, _ = proc.communicate()
            if proc.returncode != 0:
                failures.append(f"{stem}.cu:\n{out}")
            else:
                os.replace(tmp, lib)
        if failures:
            raise RuntimeError("nvcc failed:\n" + "\n".join(failures))
        for src in sorted(CSRC.glob("*.cu")):
            _libraries[src.stem] = ctypes.CDLL(
                str(BUILD_DIR / f"lib{src.stem}-{digest}.so"))
        return _libraries


def library(stem: str) -> ctypes.CDLL:
    """The loaded library built from ``csrc/<stem>.cu``."""
    return build_all()[stem]


def stream_ptr(t: torch.Tensor) -> ctypes.c_void_p:
    """PyTorch's current CUDA stream on ``t``'s device, for a launch."""
    return ctypes.c_void_p(torch.cuda.current_stream(t.device).cuda_stream)


def check_launch(name: str, err: int) -> None:
    """Raise when a launch returned a non-zero ``cudaGetLastError``."""
    if err != 0:
        raise RuntimeError(f"CUDA kernel {name} failed to launch: "
                           f"cudaError {err}")


@functools.lru_cache(maxsize=256)
def _plain_flops(fn, shapes, args) -> int:
    from torch.utils._python_dispatch import _disable_current_modes
    from torch.utils.flop_counter import FlopCounterMode
    # the caller may be inside a trace's modes (fake tensors, a flop
    # counter): the count runs outside them, on meta tensors of its own
    with _disable_current_modes():
        tensors = [None if s is None else torch.empty(s, device="meta")
                   for s in shapes]
        with FlopCounterMode(display=False) as counter:
            fn(*tensors, *args)
    return counter.get_total_flops()


def plain_flops(fn, shapes, *args) -> int:
    """The FLOPs ``FlopCounterMode`` counts for the plain version ``fn``
    called on float32 ``meta`` tensors of ``shapes`` (None passes None)
    and ``args``: a kernel op's FLOP formula, so that a trace through the
    op counts what a trace through the plain version counts."""
    return _plain_flops(fn, tuple(None if s is None else tuple(s)
                                  for s in shapes), args)


def check_tensor(name: str, t: torch.Tensor, dtype: torch.dtype,
                 ndim: int, device: Optional[torch.device] = None) -> None:
    """Validate a kernel argument: dtype, rank, contiguity and device."""
    if not isinstance(t, torch.Tensor):
        raise TypeError(f"{name} must be a torch.Tensor, got {type(t)}")
    if t.dtype != dtype:
        raise TypeError(f"{name} must be {dtype}, got {t.dtype}")
    if t.dim() != ndim:
        raise ValueError(f"{name} must have {ndim} dims, got {t.dim()}")
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")
    if device is not None and t.device != device:
        raise ValueError(f"{name} is on {t.device}, expected {device}")
