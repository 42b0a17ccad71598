"""Sequence-parallel SSD: the port's twin of ``repro.models.ssm_sp``.

A Mamba2 block with the *sequence* sharded over the ``model`` axis and
the weights replicated.  Each rank holds its contiguous segment of the
sequence (and its block of the batch over the batch axes); the only
traffic between ranks per layer is

* a conv halo — the previous rank's last ``d_conv - 1`` pre-conv rows,
  zeros on rank 0 (as ``ppermute`` gives a rank without a source),
  taken from an all-gather of every rank's tail;
* the SSD state hand-off — each rank's summary (its final state from a
  zero state, ``S_r``, and its total log-decay ``logD_r``) is
  all-gathered, and every rank computes its incoming state as the
  exclusive affine scan over the summaries:

      h0_r = sum_{j<r} S_j * exp(cum[r-1] - cum[j]),   cum = cumsum(logD)

The reference runs its XLA SSD core twice: once from a zero state for
the summary, and again from ``h0`` for the output.  The port runs K5
(``ops.ssd``, which takes no initial state) once, from a zero state, and
adds ``h0``'s part outside the kernel.  The scan is linear in its
initial state: from ``h0`` the state entering chunk c is the zero-state
one plus ``h0`` decayed by ``exp`` of the chunks before c, and a row t
of chunk c reads that state through ``C_t`` decayed by ``exp`` of its
running sum within the chunk.  Together the decay is ``exp(cum_t)``,
with ``cum_t`` the running sum of ``dt * A`` over the rank's segment up
to and including t, so

      y_t(h0) = y_t(0) + exp(cum_t) * (C_t . h0)      (per head)

which is the reference's second pass, one K5 launch per layer instead of
two.  Rank 0 enters from a zero state and adds nothing.

The stages are functions of their own, with no collective among them:
:func:`segment_scan` (one segment's conv and K5 pass) and
:func:`hand_off` (``h0`` from the earlier segments' summaries, and its
part of the output).  :func:`ssm_block_seq_parallel` joins them with
three all-gathers; :func:`ssm_block_in_segments` joins them on one device,
the sequence cut into segments, which checks the hand-off on one card.

The all-gathers are differentiable (``torch.distributed.nn.functional``):
each rank's loss term is its own segment's, and the backward sums every
rank's gradient of a gathered tail or summary back to the rank that
sent it, so the ranks' gradients of the replicated weights summed over
the axis are those of the summed loss.  Validated against the
single-device ``ssm_block`` and its gradient in
``tests/test_torch_ep_sp.py``.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ModelConfig
from repro_torch.kernels.ssd_scan.ops import ssd

F32 = torch.float32


def _all_gather(t: torch.Tensor, group) -> torch.Tensor:
    """(n, *t.shape): every rank's ``t`` on the group, in rank order."""
    from torch.distributed.nn.functional import all_gather
    return torch.stack(all_gather(t.contiguous(), group=group))


def _halos(tails: torch.Tensor) -> torch.Tensor:
    """(n, ...) every segment's halo: the tail of the one before it,
    zeros for the first (as ``ppermute`` gives a rank without a source)."""
    return torch.cat([torch.zeros_like(tails[:1]), tails[:-1]])


def in_proj(p, x: torch.Tensor):
    """x: (B, S, D) -> (z, the pre-conv rows ``[xs | B | C]``, raw dt)."""
    z = torch.matmul(x, p["wz"])
    xs = torch.matmul(x, p["wx"])
    Bm = torch.matmul(x, p["wB"])
    Cm = torch.matmul(x, p["wC"])
    dt = torch.matmul(x, p["wdt"])
    return z, torch.cat([xs, Bm, Cm], dim=-1), dt


def segment_scan(p, cat: torch.Tensor, halo: torch.Tensor, dt: torch.Tensor,
                 cfg: ModelConfig):
    """One segment's causal conv, its left edge read from ``halo`` (the
    previous segment's last ``d_conv - 1`` pre-conv rows, zeros for the
    first), and one K5 pass from a zero state.  Returns ``(xh, Cm, dA,
    y, S)``: the heads' inputs (B, S, nh, P), C (B, S, N), ``dt * A``
    (B, S, nh) float32, the output from a zero state and the final state
    (B, nh, P, N), the segment's summary."""
    s = cfg.ssm
    d_in = s.expand * cfg.d_model
    nh = d_in // s.head_dim
    K = s.d_conv
    B, S_loc, _ = cat.shape
    full = torch.cat([halo, cat], dim=1)                  # (B, S_loc+K-1, C)
    wfull = torch.cat([p["conv_x"], p["conv_B"], p["conv_C"]], dim=-1)
    conv = torch.zeros(cat.shape, dtype=F32, device=cat.device)
    for k in range(K):
        conv = conv + full[:, k:k + S_loc, :].to(F32) * wfull[k].to(F32)
    conv = F.silu(conv).to(cat.dtype)
    xs = conv[..., :d_in]
    Bm = conv[..., d_in:d_in + s.d_state]
    Cm = conv[..., d_in + s.d_state:]

    dt = F.softplus(dt.to(F32) + p["dt_bias"].to(F32))
    A = -torch.exp(p["A_log"].to(F32))
    xh = xs.reshape(B, S_loc, nh, s.head_dim)
    y, S_r = ssd(xh, dt, A, Bm, Cm, chunk=min(s.chunk, S_loc))
    return xh, Cm, dt * A, y, S_r


def hand_off(y: torch.Tensor, Cm: torch.Tensor, dA: torch.Tensor,
             Ss: torch.Tensor, Ls: torch.Tensor, r: int) -> torch.Tensor:
    """Segment ``r``'s output from its incoming state: ``h0``, the
    exclusive affine scan of the summaries ``Ss`` (n, B, nh, P, N) and
    total log-decays ``Ls`` (n, B, nh) of every segment, and ``h0``'s
    part ``exp(cum_t) * (C_t . h0)`` added to ``y``, segment ``r``'s
    output from a zero state.  The first segment's ``h0`` is 0 and its
    output ``y``; with gradients on it takes the others' steps all the
    same, so that every rank's backward runs the same collectives."""
    if r == 0 and not torch.is_grad_enabled():
        return y
    n = Ls.shape[0]
    cum = torch.cumsum(Ls, dim=0)
    cum_prev = cum[r] - Ls[r]                             # cum[r-1]
    w = torch.exp(cum_prev[None] - cum)                   # (n, B, nh)
    mask = (torch.arange(n, device=y.device) < r)[:, None, None]
    w = torch.where(mask, w, torch.zeros_like(w))
    h0 = torch.einsum("nbh,nbhpq->bhpq", w, Ss)
    into = torch.einsum("bsn,bhpn->bshp", Cm.to(F32), h0)
    return (y.to(F32) + torch.exp(torch.cumsum(dA, dim=1))[..., None]
            * into).to(y.dtype)


def out_proj(p, y: torch.Tensor, xh: torch.Tensor, z: torch.Tensor,
             cfg: ModelConfig) -> torch.Tensor:
    """The skip, the gate, the norm and the output projection."""
    B, S_loc, nh, P = xh.shape
    y = y + xh.to(F32).to(y.dtype) * p["D_skip"].to(y.dtype)[None, None, :, None]
    y = y.reshape(B, S_loc, nh * P)
    y = y * F.silu(z.to(F32)).to(y.dtype)
    yf = y.to(F32)
    y = (yf * torch.rsqrt(torch.mean(yf * yf, -1, keepdim=True) + cfg.norm_eps)
         * p["norm"].to(F32)).to(z.dtype)
    return torch.matmul(y, p["wo"])


def ssm_block_seq_parallel(p, x: torch.Tensor, cfg: ModelConfig, mesh, *,
                           axis: str = "model") -> torch.Tensor:
    """Mamba2 block with the sequence sharded over ``axis`` of ``mesh``.

    x: (B, S_local, D), this rank's segment of the sequence (and its
    block of the batch); weights replicated.  Returns this rank's block
    of the output.  The collectives run within the rank's group on
    ``axis``."""
    K = cfg.ssm.d_conv
    group = mesh.get_group(axis)
    r = mesh.get_local_rank(axis)
    z, cat, dt = in_proj(p, x)
    tails = _all_gather(cat[:, cat.shape[1] - (K - 1):, :], group)
    halo = _halos(tails)[r]
    xh, Cm, dA, y, S_r = segment_scan(p, cat, halo, dt, cfg)
    Ss = _all_gather(S_r, group)                          # (n, B, nh, P, N)
    Ls = _all_gather(torch.sum(dA, dim=1), group)         # (n, B, nh)
    return out_proj(p, hand_off(y, Cm, dA, Ss, Ls, r), xh, z, cfg)


def ssm_block_in_segments(p, x: torch.Tensor, cfg: ModelConfig,
                          n: int) -> torch.Tensor:
    """The stages of :func:`ssm_block_seq_parallel` on one device: ``x``
    (B, S, D) cut into ``n`` segments along the sequence, each taking its
    halo and its incoming state from the segments before it as rank r of
    ``n`` takes them from the all-gathers.  Equals ``ssm_block(p, x,
    cfg)`` up to rounding."""
    K = cfg.ssm.d_conv
    if x.shape[1] % n:
        raise ValueError(f"a sequence of {x.shape[1]} does not split into "
                         f"{n} segments")
    pre = [in_proj(p, seg) for seg in x.split(x.shape[1] // n, dim=1)]
    halos = _halos(torch.stack([cat[:, cat.shape[1] - (K - 1):, :]
                                for _, cat, _ in pre]))
    scans = [segment_scan(p, cat, halos[r], dt, cfg)
             for r, (_, cat, dt) in enumerate(pre)]
    Ss = torch.stack([S_r for *_, S_r in scans])
    Ls = torch.stack([torch.sum(dA, dim=1) for _, _, dA, _, _ in scans])
    return torch.cat([out_proj(p, hand_off(y, Cm, dA, Ss, Ls, r), xh, z, cfg)
                      for r, ((z, _, _), (xh, Cm, dA, y, _))
                      in enumerate(zip(pre, scans))], dim=1)
