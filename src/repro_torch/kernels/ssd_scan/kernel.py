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

On the card K5 and its backward launch through ``torch.library`` ops,
``repro_torch::ssd_scan`` and ``repro_torch::ssd_scan_bwd``, as K4's do
(``kernels/flash_attention/kernel.py``): the ``ctypes`` launch, a fake
implementation for a trace, the plain version's products as the FLOP
formula.
"""
from __future__ import annotations

import ctypes
from typing import Optional, Tuple

import torch
from torch.utils.flop_counter import register_flop_formula

from repro_torch.kernels.device import (check_launch, check_tensor,
                                        library, plain_flops, stream_ptr,
                                        takes_plain)

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


def _check(x: torch.Tensor, dt: torch.Tensor, A: torch.Tensor,
           Bm: torch.Tensor, Cm: torch.Tensor) -> None:
    """Validate K5's arguments (the backward adds ``dy`` and ``dh``)."""
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


def _chunked(chunk: int, S: int, *arrays: torch.Tensor):
    """(chunk, nc, each array padded with zeros to ``nc * chunk`` rows and
    cut into (B, nc, chunk, ...) in float32): the plain versions'
    layout."""
    chunk = max(1, min(chunk, S))
    pad = -S % chunk
    nc = (S + pad) // chunk
    out = []
    for a in arrays:
        a = torch.nn.functional.pad(a, (0, 0) * (a.dim() - 2) + (0, pad))
        out.append(a.reshape(a.shape[0], nc, chunk, *a.shape[2:]).to(F32))
    return chunk, nc, out


def _scan_parts(xc, dtc, A, Bc, Cc):
    """The chunked scan's intermediates in float32, shared by the plain
    forward and backward: cum (B, nc, c, nh) the running sum of dt * A
    within each chunk, the decay exp(cum_i - cum_j) (B, nc, i, j, nh)
    masked to j <= i, C.B^T (B, nc, i, j), exp(seg - cum_j) with seg the
    chunk's last cum, the states entering each chunk (B, nc, nh, P, N)
    and the final state."""
    Bsz, nc, chunk, nh, Pd = xc.shape
    dev = xc.device
    cum = torch.cumsum(dtc * A.to(F32), dim=2)     # within-chunk cumulative
    seg_sum = cum[:, :, -1, :]                     # (B, nc, nh)

    # decay(i, j) = exp(cum_i - cum_j), taken only for j <= i (above the
    # diagonal the exponent is positive and may overflow)
    li = cum[:, :, :, None, :]                     # (B,nc,c,1,nh)
    lj = cum[:, :, None, :, :]                     # (B,nc,1,c,nh)
    mask = torch.tril(torch.ones(chunk, chunk, dtype=torch.bool,
                                 device=dev))[None, None, :, :, None]
    zero = torch.zeros((), device=dev)
    decay = torch.where(mask, torch.exp(torch.where(mask, li - lj, zero)),
                        zero)
    cb = torch.einsum("bcin,bcjn->bcij", Cc, Bc)

    # ---- chunk states, and the recurrence over nc (sequential) ----
    sdecay = torch.exp(seg_sum[:, :, None, :] - cum)   # (B,nc,c,nh)
    states = torch.einsum("bcjn,bcjh,bcjhp->bchpn", Bc, sdecay * dtc, xc)
    h = torch.zeros((Bsz, nh, Pd, Bc.shape[-1]), dtype=F32, device=dev)
    h_prev = []
    for c in range(nc):
        h_prev.append(h)
        h = h * torch.exp(seg_sum[:, c])[:, :, None, None] + states[:, c]
    return cum, decay, cb, sdecay, torch.stack(h_prev, dim=1), h


def ssd_scan_plain(x: torch.Tensor, dt: torch.Tensor, A: torch.Tensor,
                   Bm: torch.Tensor, Cm: torch.Tensor, chunk: int = 128
                   ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain twin of K5: the chunked SSD scan of ``_ssd_core``, from a
    zero state."""
    Bsz, S, nh, Pd = x.shape
    chunk, nc, (xc, dtc, Bc, Cc) = _chunked(chunk, S, x, dt, Bm, Cm)
    cum, decay, cb, _, h_prev, h = _scan_parts(xc, dtc, A, Bc, Cc)
    # intra-chunk (dense, quadratic in chunk), then the carried-in state
    w = cb[..., None] * decay                      # (B,nc,c,c,nh)
    y_intra = torch.einsum("bcijh,bcjhp->bcihp", w, xc * dtc[..., None])
    y_inter = torch.einsum("bcin,bchpn,bcih->bcihp", Cc, h_prev,
                           torch.exp(cum))
    y = (y_intra + y_inter).reshape(Bsz, nc * chunk, nh, Pd)[:, :S]
    return y.to(x.dtype), h


def ssd_scan_backward_plain(x: torch.Tensor, dt: torch.Tensor,
                            A: torch.Tensor, Bm: torch.Tensor,
                            Cm: torch.Tensor, dy: torch.Tensor,
                            dh: Optional[torch.Tensor] = None,
                            chunk: int = 128):
    """Plain twin of K5's backward: the explicit formula in float32, not
    autograd through :func:`ssd_scan_plain`.  ``dy`` is y's gradient
    (x's shape), ``dh`` the final state's (or None for 0).  Returns
    ``(dx, ddt, dA, dB, dC)`` in the types of ``(x, dt, A, Bm, Cm)``.

    Per (b, head) and chunk, with M_ij = (C_i.B_j) exp(cum_i - cum_j)
    for j <= i, g_i = dy_i, H the state entering the chunk and G the
    gradient of the state leaving it (``dh`` for the last chunk; a
    chunk passes exp(seg) G + sum_i exp(cum_i) g_i C_i^T to the one
    before it):
      v_j  = sum_{i>=j} M_ij g_i + exp(seg - cum_j) G B_j,  dx_j = dt_j v_j
      dC_i = sum_{j<=i} exp(cum_i - cum_j) dt_j (g_i.x_j) B_j
             + exp(cum_i) H^T g_i
      dB_j = sum_{i>=j} exp(cum_i - cum_j) dt_j (g_i.x_j) C_i
             + exp(seg - cum_j) dt_j G^T x_j
    with dB and dC summed over the heads (ngroups = 1).  cum's gradient
    is g_k.y_k - dt_k x_k.v_k, plus <G, state leaving the chunk> at the
    chunk's last row; its reverse running sum r is the gradient of
    dt * A, so ddt_k = x_k.v_k + A r_k and dA = sum dt_k r_k.  A ragged
    last chunk is padded as the forward pads it."""
    Bsz, S, nh, Pd = x.shape
    chunk, nc, (xc, dtc, Bc, Cc, gc) = _chunked(chunk, S, x, dt, Bm, Cm, dy)
    a = A.to(F32)
    cum, decay, cb, sdecay, h_prev, h_last = _scan_parts(xc, dtc, a, Bc, Cc)
    ecum = torch.exp(cum)

    # G per chunk, by a reverse scan over the chunks
    into = torch.einsum("bcih,bcihp,bcin->bchpn", ecum, gc, Cc)
    seg = cum[:, :, -1]
    G = torch.zeros_like(h_last) if dh is None else dh.to(F32)
    g_out = [None] * nc
    for c in reversed(range(nc)):
        g_out[c] = G
        G = G * torch.exp(seg[:, c])[:, :, None, None] + into[:, c]
    g_out = torch.stack(g_out, dim=1)              # (B, nc, nh, P, N)
    h_next = torch.cat([h_prev[:, 1:], h_last[:, None]], dim=1)

    M = cb[..., None] * decay                      # (B,nc,i,j,nh)
    v = torch.einsum("bcijh,bcihp->bcjhp", M, gc) + sdecay[..., None] \
        * torch.einsum("bchpn,bcjn->bcjhp", g_out, Bc)
    y = torch.einsum("bcijh,bcjhp->bcihp", M, xc * dtc[..., None]) \
        + ecum[..., None] * torch.einsum("bcin,bchpn->bcihp", Cc, h_prev)
    xv = (xc * v).sum(-1)                          # (B,nc,c,nh)
    dcum = (gc * y).sum(-1) - dtc * xv
    dcum[:, :, -1] += (g_out * h_next).sum((-2, -1))
    r = torch.flip(torch.cumsum(torch.flip(dcum, [2]), 2), [2])

    W = decay * dtc[:, :, None] * torch.einsum("bcihp,bcjhp->bcijh", gc, xc)
    dC = torch.einsum("bcijh,bcjn->bcin", W, Bc) + torch.einsum(
        "bcih,bchpn,bcihp->bcin", ecum, h_prev, gc)
    dB = torch.einsum("bcijh,bcin->bcjn", W, Cc) + torch.einsum(
        "bcjh,bchpn,bcjhp->bcjn", sdecay * dtc, g_out, xc)

    def rows(t):
        return t.reshape(Bsz, nc * chunk, *t.shape[3:])[:, :S]

    return (rows(dtc[..., None] * v).to(x.dtype),
            rows(xv + a * r).to(dt.dtype),
            (dtc * r).sum((0, 1, 2)).to(A.dtype),
            rows(dB).to(Bm.dtype), rows(dC).to(Cm.dtype))


def ssd_scan(x: torch.Tensor, dt: torch.Tensor, A: torch.Tensor,
             Bm: torch.Tensor, Cm: torch.Tensor, *,
             chunk: int = 128) -> Tuple[torch.Tensor, torch.Tensor]:
    """K5: x (B, S, nh, P) and Bm/Cm (B, S, N) in float32 or bfloat16 (one
    type), dt (B, S, nh) and A (nh,) float32, all contiguous -> (y
    (B, S, nh, P) in x's type, h (B, nh, P, N) float32).  A CUDA tensor
    launches the kernel (or raises); a CPU tensor takes the plain
    version.  ``chunk`` sets the plain version's chunk length and, through
    :func:`kernel_chunk`, the bfloat16 kernel's; the float32 kernel walks
    its own 32-row sub-chunks.  The kernel's outputs carry no gradient:
    :class:`SsdScan` is the differentiable entry."""
    _check(x, dt, A, Bm, Cm)
    if takes_plain(x, "ssd_scan"):
        return ssd_scan_plain(x, dt, A, Bm, Cm, chunk)
    return torch.ops.repro_torch.ssd_scan(x, dt, A, Bm, Cm, chunk)


@torch.library.custom_op("repro_torch::ssd_scan", mutates_args=(),
                         device_types="cuda")
def _ssd_scan_launch(x: torch.Tensor, dt: torch.Tensor, A: torch.Tensor,
                     Bm: torch.Tensor, Cm: torch.Tensor,
                     chunk: int) -> tuple[torch.Tensor, torch.Tensor]:
    """K5's launch, the op's implementation (arguments checked by
    :func:`ssd_scan`)."""
    Bsz, S, nh, P = x.shape
    N = Bm.shape[-1]
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


@_ssd_scan_launch.register_fake
def _(x, dt, A, Bm, Cm, chunk):
    Bsz, _, nh, P = x.shape
    return torch.empty_like(x), torch.empty((Bsz, nh, P, Bm.shape[-1]),
                                            dtype=F32, device=x.device)


@register_flop_formula(torch.ops.repro_torch.ssd_scan)
def _(x, dt, A, Bm, Cm, chunk, *, out_shape=None):
    return plain_flops(ssd_scan_plain, (x, dt, A, Bm, Cm), chunk)


ssd_scan.launches = 0


def ssd_scan_backward(x: torch.Tensor, dt: torch.Tensor, A: torch.Tensor,
                      Bm: torch.Tensor, Cm: torch.Tensor, dy: torch.Tensor,
                      dh: Optional[torch.Tensor] = None, *,
                      chunk: int = 128):
    """K5's backward: K5's arguments plus y's gradient ``dy`` (x's shape
    and type) and the final state's ``dh`` ((B, nh, P, N) float32, or
    None for 0), all contiguous -> ``(dx, ddt, dA, dB, dC)`` in the
    inputs' types.  A CUDA tensor launches the kernels of
    ``csrc/ssd_scan_bwd.cu`` (or raises); they take P and N multiples of
    16 with P <= 64 and N <= 128.  bfloat16 inputs run on the tensor
    cores over the forward's chunks (:func:`kernel_chunk` of ``chunk``),
    float32 ones on the CUDA cores over 64-row chunks; a view that starts
    off a 16-byte boundary is copied first.  A CPU tensor takes the plain
    version, with ``chunk`` as its chunk length."""
    _check(x, dt, A, Bm, Cm)
    check_tensor("dy", dy, x.dtype, 4, x.device)
    if dy.shape != x.shape:
        raise ValueError(f"dy must have x's shape {tuple(x.shape)}, got "
                         f"{tuple(dy.shape)}")
    Bsz, S, nh, P = x.shape
    N = Bm.shape[-1]
    if dh is not None:
        check_tensor("dh", dh, F32, 4, x.device)
        if tuple(dh.shape) != (Bsz, nh, P, N):
            raise ValueError(f"dh must be {(Bsz, nh, P, N)}, got "
                             f"{tuple(dh.shape)}")
    if takes_plain(x, "ssd_scan_bwd"):
        return ssd_scan_backward_plain(x, dt, A, Bm, Cm, dy, dh, chunk)
    return torch.ops.repro_torch.ssd_scan_bwd(x, dt, A, Bm, Cm, dy, dh, chunk)


@torch.library.custom_op("repro_torch::ssd_scan_bwd", mutates_args=(),
                         device_types="cuda")
def _ssd_scan_bwd_launch(
        x: torch.Tensor, dt: torch.Tensor, A: torch.Tensor, Bm: torch.Tensor,
        Cm: torch.Tensor, dy: torch.Tensor, dh: Optional[torch.Tensor],
        chunk: int) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor,
                             torch.Tensor, torch.Tensor]:
    """K5's backward launch, the op's implementation (arguments checked
    by :func:`ssd_scan_backward`)."""
    Bsz, S, nh, P = x.shape
    N = Bm.shape[-1]
    if P % 16 or N % 16 or P > MAX_P_BF16 or N > MAX_N_BF16:
        raise ValueError(
            f"state width P={P}, N={N}: the backward takes P and N "
            f"multiples of 16 with P <= {MAX_P_BF16}, N <= {MAX_N_BF16}")
    if Bsz > 65_535 or -(-S // 64) > 65_535:
        raise ValueError(f"batch {Bsz} x {S} rows is beyond the kernel's "
                         f"grid")
    # the kernels read x, dy, B, C and dh as 16-byte vectors
    x, Bm, Cm, dy = (t if t.data_ptr() % 16 == 0 else t.clone()
                     for t in (x, Bm, Cm, dy))
    if dh is not None and dh.data_ptr() % 16:
        dh = dh.clone()
    bf16 = int(x.dtype == torch.bfloat16)
    lib = library("ssd_scan_bwd")
    # a library without the chunked entry (another checkout's first
    # design) takes the entry without the chunk
    if hasattr(lib, "repro_torch_ssd_scan_bwd_chunked"):
        size = lib.repro_torch_ssd_scan_bwd_chunked_scratch
        fn = lib.repro_torch_ssd_scan_bwd_chunked
        shape = (Bsz, S, nh, P, N, kernel_chunk(chunk, S))
        size_args = shape + (bf16,)
    else:
        size = lib.repro_torch_ssd_scan_bwd_scratch
        fn = lib.repro_torch_ssd_scan_bwd
        shape = size_args = (Bsz, S, nh, P, N)
    size.argtypes = [ctypes.c_int] * len(size_args)
    size.restype = ctypes.c_longlong
    scratch = torch.empty(size(*size_args), dtype=torch.uint8,
                          device=x.device)
    dx, dB, dC = (torch.empty_like(t) for t in (x, Bm, Cm))
    ddt = torch.empty_like(dt)
    dA = torch.empty_like(A)
    fn.argtypes = [ctypes.c_void_p] * 13 \
        + [ctypes.c_int] * (len(shape) + 1) + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    with torch.cuda.device(x.device):
        ssd_scan_backward.launches += 1
        check_launch("ssd_scan_bwd", fn(
            x.data_ptr(), dt.data_ptr(), A.data_ptr(), Bm.data_ptr(),
            Cm.data_ptr(), dy.data_ptr(), 0 if dh is None else dh.data_ptr(),
            dx.data_ptr(), ddt.data_ptr(), dA.data_ptr(), dB.data_ptr(),
            dC.data_ptr(), scratch.data_ptr(), *shape, bf16, stream_ptr(x)))
    return dx, ddt, dA, dB, dC


@_ssd_scan_bwd_launch.register_fake
def _(x, dt, A, Bm, Cm, dy, dh, chunk):
    return tuple(torch.empty_like(t) for t in (x, dt, A, Bm, Cm))


@register_flop_formula(torch.ops.repro_torch.ssd_scan_bwd)
def _(x, dt, A, Bm, Cm, dy, dh, chunk, *, out_shape=None):
    return plain_flops(ssd_scan_backward_plain, (x, dt, A, Bm, Cm, dy, dh),
                       chunk)


ssd_scan_backward.launches = 0


class SsdScan(torch.autograd.Function):
    """K5 with its backward: ``SsdScan.apply(x, dt, A, Bm, Cm, chunk)``
    -> (y, h).  Forward and backward each take the kernel for CUDA
    tensors and the plain version for CPU tensors; the backward keeps the
    inputs and recomputes the chunk states from them.  An unused output
    gives no gradient (None), so ``dh`` is None when h is not used."""

    @staticmethod
    def forward(ctx, x, dt, A, Bm, Cm, chunk):
        ctx.set_materialize_grads(False)
        y, h = ssd_scan(x, dt, A, Bm, Cm, chunk=chunk)
        ctx.save_for_backward(x, dt, A, Bm, Cm)
        ctx.chunk = chunk
        return y, h

    @staticmethod
    def backward(ctx, dy, dh):
        x, dt, A, Bm, Cm = ctx.saved_tensors
        if dy is None and dh is None:
            return None, None, None, None, None, None
        dy = torch.zeros_like(x) if dy is None else dy.contiguous()
        grads = ssd_scan_backward(x, dt, A, Bm, Cm, dy,
                                  None if dh is None else dh.contiguous(),
                                  chunk=ctx.chunk)
        return (*grads, None)
