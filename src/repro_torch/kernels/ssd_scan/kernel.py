"""Mamba2 SSD chunked scan: the CUDA kernel and its plain twin.

:func:`ssd_scan` (K5) launches the hand-written kernel of
``csrc/ssd_scan.cu`` for CUDA tensors and takes :func:`ssd_scan_plain`
for CPU tensors.  Both return what the reference's Pallas ``ssd_scan``
and the model's XLA path ``models.ssm._ssd_core`` return: y (B, S, nh, P)
in x's type and the final state h (B, nh, P, N) in float32, computed in
float32.

:func:`ssd_scan_plain` is a torch copy of ``_ssd_core``: chunked and
vectorised over batch, chunks and heads, with the same arithmetic.  For
bfloat16 inputs (the models' type) the kernel runs the chunked SSD
decomposition on the tensor cores with the chunks in parallel; its
chunk length is :func:`kernel_chunk` of ``chunk`` (a multiple of 64, at
most 256), and it takes P <= 64 and N <= 128, multiples of 16.  For
float32 inputs it walks the sequence in 32-row sub-chunks with the state
carried between them.  y and h do not depend on the chunk length beyond
rounding.  Unlike the reference (which asserts ``S % chunk == 0``) both
take any S: the plain version pads the last
chunk with ``x = B = C = 0`` and ``dt = 0``, which leaves the state
unchanged and contributes nothing.
"""
from __future__ import annotations

import ctypes
from typing import Tuple

import torch

from repro_torch.kernels.device import (check_launch, check_tensor,
                                        library, stream_ptr)

_DTYPES = (torch.float32, torch.bfloat16)
#: a block's shared memory on an H100 (bytes)
MAX_SMEM = 232_448
F32 = torch.float32
#: the bfloat16 kernel's limits: P and N multiples of 16, P <= 64, N <= 128
MAX_P_BF16, MAX_N_BF16 = 64, 128


def kernel_chunk(chunk: int, S: int) -> int:
    """Chunk length of the bfloat16 kernel: ``chunk`` rounded up to a
    multiple of 64, at most 256 and at most S rounded up to 64."""
    up = lambda n: -(-max(n, 1) // 64) * 64  # noqa: E731
    return min(up(chunk), 256, up(S))


def ssd_scan_plain(x: torch.Tensor, dt: torch.Tensor, A: torch.Tensor,
                   Bm: torch.Tensor, Cm: torch.Tensor, chunk: int = 128
                   ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain twin of K5: the chunked SSD scan of ``_ssd_core``, from a
    zero state."""
    Bsz, S, nh, Pd = x.shape
    N = Bm.shape[-1]
    chunk = max(1, min(chunk, S))
    pad = -S % chunk
    if pad:
        x = torch.nn.functional.pad(x, (0, 0, 0, 0, 0, pad))
        dt = torch.nn.functional.pad(dt, (0, 0, 0, pad))
        Bm = torch.nn.functional.pad(Bm, (0, 0, 0, pad))
        Cm = torch.nn.functional.pad(Cm, (0, 0, 0, pad))
    Sp = S + pad
    nc = Sp // chunk
    xc = x.reshape(Bsz, nc, chunk, nh, Pd).to(F32)
    dtc = dt.reshape(Bsz, nc, chunk, nh).to(F32)
    Bc = Bm.reshape(Bsz, nc, chunk, N).to(F32)
    Cc = Cm.reshape(Bsz, nc, chunk, N).to(F32)

    dA = dtc * A.to(F32)                           # (B, nc, c, nh), negative
    cum = torch.cumsum(dA, dim=2)                  # within-chunk cumulative
    seg_sum = cum[:, :, -1, :]                     # (B, nc, nh)

    # ---- intra-chunk (dense, quadratic in chunk) ----
    # decay(i, j) = exp(cum_i - cum_j), taken only for j <= i
    li = cum[:, :, :, None, :]                     # (B,nc,c,1,nh)
    lj = cum[:, :, None, :, :]                     # (B,nc,1,c,nh)
    mask = torch.tril(torch.ones(chunk, chunk, dtype=torch.bool,
                                 device=x.device))[None, None, :, :, None]
    decay = torch.exp(torch.where(mask, li - lj, torch.zeros((), device=x.device)))
    decay = torch.where(mask, decay, torch.zeros((), device=x.device))
    cb = torch.einsum("bcin,bcjn->bcij", Cc, Bc)
    w = cb[..., None] * decay                      # (B,nc,c,c,nh)
    xdt = xc * dtc[..., None]                      # (B,nc,c,nh,P)
    y_intra = torch.einsum("bcijh,bcjhp->bcihp", w, xdt)

    # ---- chunk states ----
    sdecay = torch.exp(seg_sum[:, :, None, :] - cum)   # (B,nc,c,nh)
    states = torch.einsum("bcjn,bcjh,bcjhp->bchpn", Bc, sdecay * dtc, xc)

    # ---- inter-chunk recurrence over nc (sequential) ----
    h = torch.zeros((Bsz, nh, Pd, N), dtype=F32, device=x.device)
    h_prev = []
    for c in range(nc):
        h_prev.append(h)
        h = h * torch.exp(seg_sum[:, c])[:, :, None, None] + states[:, c]
    h_prev = torch.stack(h_prev, dim=1)            # (B, nc, nh, P, N)

    # ---- contribution of carried-in state to each position ----
    y_inter = torch.einsum("bcin,bchpn,bcih->bcihp", Cc, h_prev,
                           torch.exp(cum))
    y = (y_intra + y_inter).reshape(Bsz, Sp, nh, Pd)[:, :S]
    return y.to(x.dtype), h


def ssd_scan(x: torch.Tensor, dt: torch.Tensor, A: torch.Tensor,
             Bm: torch.Tensor, Cm: torch.Tensor, *,
             chunk: int = 128) -> Tuple[torch.Tensor, torch.Tensor]:
    """K5: x (B, S, nh, P) and Bm/Cm (B, S, N) in float32 or bfloat16 (one
    type), dt (B, S, nh) and A (nh,) float32, all contiguous -> (y
    (B, S, nh, P) in x's type, h (B, nh, P, N) float32).  A CUDA tensor
    launches the kernel (or raises); a CPU tensor takes the plain
    version.  ``chunk`` sets the plain version's chunk length and, through
    :func:`kernel_chunk`, the bfloat16 kernel's; the float32 kernel walks
    its own 32-row sub-chunks.

    K5 has no backward yet: under grad mode, an input that requires grad
    raises ``NotImplementedError`` on the card and on the CPU alike,
    rather than return an output with no gradient (the kernel's output
    has no ``grad_fn``)."""
    if torch.is_grad_enabled() and any(
            t.requires_grad for t in (x, dt, A, Bm, Cm)):
        raise NotImplementedError(
            "ssd_scan (K5) has no backward yet, so the ssm family cannot "
            "train; see the K5 reverse pass in ROADMAP.md")
    check_tensor("x", x, x.dtype, 4)
    if x.dtype not in _DTYPES:
        raise TypeError(f"x must be one of {_DTYPES}, got {x.dtype}")
    Bsz, S, nh, P = x.shape
    check_tensor("dt", dt, F32, 3, x.device)
    check_tensor("A", A, F32, 1, x.device)
    check_tensor("Bm", Bm, x.dtype, 3, x.device)
    check_tensor("Cm", Cm, x.dtype, 3, x.device)
    N = Bm.shape[-1]
    if tuple(dt.shape) != (Bsz, S, nh) or tuple(A.shape) != (nh,) \
            or tuple(Bm.shape) != (Bsz, S, N) or Cm.shape != Bm.shape:
        raise ValueError(
            f"shapes do not agree: x {tuple(x.shape)}, dt {tuple(dt.shape)},"
            f" A {tuple(A.shape)}, Bm {tuple(Bm.shape)}, Cm {tuple(Cm.shape)}")
    if x.device.type == "cpu":
        return ssd_scan_plain(x, dt, A, Bm, Cm, chunk)
    if x.device.type != "cuda":
        raise ValueError(f"no ssd_scan kernel for device {x.device}")
    bf16 = x.dtype == torch.bfloat16
    lib = library("ssd_scan")
    if bf16:
        if P % 16 or N % 16 or P > MAX_P_BF16 or N > MAX_N_BF16:
            raise ValueError(
                f"state width P={P}, N={N}: the bfloat16 kernel takes P and N "
                f"multiples of 16 with P <= {MAX_P_BF16}, N <= {MAX_N_BF16}")
    else:
        lib.repro_torch_ssd_scan_smem.argtypes = [ctypes.c_int, ctypes.c_int]
        lib.repro_torch_ssd_scan_smem.restype = ctypes.c_longlong
        if lib.repro_torch_ssd_scan_smem(P, N) > MAX_SMEM:
            raise ValueError(f"state width P={P}, N={N} is beyond the "
                             f"kernel's shared memory")
    if Bsz * (-(-S // 64) if bf16 else 1) > 65_535:
        raise ValueError(f"batch {Bsz} (x {S} rows) is beyond the kernel's "
                         f"grid")
    y = torch.empty_like(x)
    h = torch.empty((Bsz, nh, P, N), dtype=F32, device=x.device)
    L, scratch = kernel_chunk(chunk, S), None
    if bf16:
        # C.B^T per (batch, chunk), the chunk states and the states
        # entering each chunk, carved by the library from one buffer
        lib.repro_torch_ssd_scan_scratch.argtypes = [ctypes.c_int] * 6
        lib.repro_torch_ssd_scan_scratch.restype = ctypes.c_longlong
        scratch = torch.empty(
            lib.repro_torch_ssd_scan_scratch(Bsz, S, nh, P, N, L),
            dtype=torch.uint8, device=x.device)
    fn = lib.repro_torch_ssd_scan
    fn.argtypes = [ctypes.c_void_p] * 8 + [ctypes.c_int] * 7 \
        + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    with torch.cuda.device(x.device):
        ssd_scan.launches += 1
        check_launch("ssd_scan", fn(
            x.data_ptr(), dt.data_ptr(), A.data_ptr(), Bm.data_ptr(),
            Cm.data_ptr(), y.data_ptr(), h.data_ptr(),
            0 if scratch is None else scratch.data_ptr(), Bsz, S, nh, P, N,
            L, int(bf16), stream_ptr(x)))
    return y, h


ssd_scan.launches = 0
