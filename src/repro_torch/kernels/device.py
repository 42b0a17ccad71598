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
its kernel (or raises) for a CUDA tensor.
"""
from __future__ import annotations

import ctypes
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
