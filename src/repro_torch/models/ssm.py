"""Mamba2 block (SSD — state-space duality, arXiv:2405.21060).

The port's twin of ``repro.models.ssm``.  Layout as there: d_inner =
expand * d_model, nh = d_inner / head_dim SSD heads, ngroups = 1 (B, C
shared across heads).  The full-sequence block's scan goes through K5
(``ops.ssd``) where the reference calls its XLA ``_ssd_chunked``: on a
CUDA tensor the hand-written kernel, on a CPU tensor its plain twin, a
torch copy of ``_ssd_core``.  The single-token recurrent step stays
plain torch, as in the reference.  The sequence-parallel block over a
mesh is ``models/ssm_sp.py``.

Under the reference's layout (``sharding.distribute_model`` placed the
parameters; ``ssm_inner`` on ``model``) both forms are tensor-parallel
over the SSD heads, as XLA lays the reference's arrays out by
``make_rules``: a rank holds ``wz``, ``wx``, ``wdt``, ``dt_bias``,
``A_log``, ``D_skip``, ``conv_x`` and ``norm`` for its ``nh / tp``
heads and ``wo``'s rows for them; ``wB``, ``wC``, ``conv_B`` and
``conv_C`` are whole on every rank (``ssm_state`` and ``conv`` map to
nothing).  The input enters through ``sharding.replicated_to_partial``
(its gradient summed over ``model``), and so do the whole B/C weights,
which each rank applies for its own heads only.  K5 runs on the rank's
heads.  The gated RMSNorm means over all of ``d_in``: each rank's mean
square of its columns, times its share of the width, is summed over
``model`` (``sharding.sum_over``; at one rank the plain mean times 1).
``wo`` is row-parallel into ``sharding.sum_to_replicated``, or, with
the rules' ``ssm_gather_out``, ``y`` is gathered whole over ``model``
(``sharding.gather_replicated``) and every rank projects it by the whole
``wo`` (``sharding.take_whole``), each keeping its block of their
gradients.  Decode holds the rank's heads of the state ``h`` and the
whole conv buffer (its spec splits no channel): a rank reads its own
``xs`` channels and every B/C channel, and the new buffer's ``xs``
channels are all-gathered over ``model``, so every rank holds the same
buffer.
"""
from __future__ import annotations

from typing import Dict

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ModelConfig
from repro_torch.distributed.sharding import (current_rules, gather_dim,
                                              gather_replicated, model_split,
                                              replicated_to_partial, sum_over,
                                              sum_to_replicated, take,
                                              take_whole)
from repro_torch.kernels.ssd_scan.ops import ssd
from repro_torch.models.params import ParamDef

F32 = torch.float32


def ssm_defs(cfg: ModelConfig) -> Dict:
    d = cfg.d_model
    s = cfg.ssm
    d_in = s.expand * d
    nh = d_in // s.head_dim
    return {
        "wz": ParamDef((d, d_in), ("embed", "ssm_inner")),
        "wx": ParamDef((d, d_in), ("embed", "ssm_inner")),
        "wB": ParamDef((d, s.d_state), ("embed", "ssm_state")),
        "wC": ParamDef((d, s.d_state), ("embed", "ssm_state")),
        "wdt": ParamDef((d, nh), ("embed", "ssm_inner")),
        "dt_bias": ParamDef((nh,), ("ssm_inner",), init="zeros"),
        "A_log": ParamDef((nh,), ("ssm_inner",), init="zeros"),
        "D_skip": ParamDef((nh,), ("ssm_inner",), init="ones"),
        "conv_x": ParamDef((s.d_conv, d_in), ("conv", "ssm_inner"), scale=0.5),
        "conv_B": ParamDef((s.d_conv, s.d_state), ("conv", "ssm_state"),
                           scale=0.5),
        "conv_C": ParamDef((s.d_conv, s.d_state), ("conv", "ssm_state"),
                           scale=0.5),
        "norm": ParamDef((d_in,), ("ssm_inner",), init="ones"),
        "wo": ParamDef((d_in, d), ("ssm_inner", "embed"),
                       scale=1.0 / max(1, (2 * cfg.n_layers)) ** 0.5),
    }


def _causal_conv(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """Depthwise causal conv. x: (B, S, C), w: (K, C)."""
    K = w.shape[0]
    S = x.shape[1]
    xp = F.pad(x, (0, 0, K - 1, 0))
    out = torch.zeros(x.shape, dtype=F32, device=x.device)
    for i in range(K):
        out = out + xp[:, i:i + S, :].to(F32) * w[i].to(F32)
    return F.silu(out).to(x.dtype)


def _heads_split(p, nh: int):
    """The ``model`` split the block's heads are over (``wx``'s columns),
    None when they are whole; raises where the heads do not divide it."""
    split = model_split(p["wx"])
    if split is not None and nh % split.size:
        raise ValueError(f"{nh} SSD heads do not split over {split.size} "
                         f"ranks of model")
    return split


def _gated_norm(y: torch.Tensor, scale, d_in: int, eps: float,
                split) -> torch.Tensor:
    """Mamba2's gated RMSNorm of ``y`` (float32), over all ``d_in``
    channels: with ``split``, ``y`` is this rank's channels and the mean
    square is summed over ``model`` from each rank's share."""
    ms = torch.mean(y * y, -1, keepdim=True)
    if split is not None:
        ms = sum_over(ms * (y.shape[-1] / d_in), split.group)
    return y * torch.rsqrt(ms + eps) * take(scale).to(F32)


def _out_proj(y: torch.Tensor, wo, split) -> torch.Tensor:
    """``y @ wo``: row-parallel and summed over ``model`` with ``split``,
    or under the rules' ``ssm_gather_out`` ``y`` gathered whole and
    projected by the whole ``wo`` on every rank."""
    if split is None:
        return torch.matmul(y, take(wo))
    if current_rules().mapping.get("ssm_gather_out"):
        return torch.matmul(gather_replicated(y, -1, split), take_whole(wo))
    return sum_to_replicated(torch.matmul(y, take(wo)), split.group)


def ssm_block(p, x: torch.Tensor, cfg: ModelConfig, *,
              return_state: bool = False):
    """Full-sequence Mamba2 block. x: (B, S, D).  Tensor-parallel over
    the heads when ``wx`` is placed over ``model`` (the module's
    docstring); ``h_final`` is then the rank's heads."""
    s = cfg.ssm
    d_in = s.expand * cfg.d_model
    nh = d_in // s.head_dim
    split = _heads_split(p, nh)

    def whole(name):
        w = take(p[name])
        return w if split is None else replicated_to_partial(w, split.group)

    if split is not None:
        x = replicated_to_partial(x, split.group)
    z = torch.matmul(x, take(p["wz"]))
    xs = torch.matmul(x, take(p["wx"]))
    Bm = torch.matmul(x, whole("wB"))
    Cm = torch.matmul(x, whole("wC"))
    dt = torch.matmul(x, take(p["wdt"]))

    xs = _causal_conv(xs, take(p["conv_x"]))
    Bm = _causal_conv(Bm, whole("conv_B"))
    Cm = _causal_conv(Cm, whole("conv_C"))

    dt = F.softplus(dt.to(F32) + take(p["dt_bias"]).to(F32))
    A = -torch.exp(take(p["A_log"]).to(F32))

    xh = xs.reshape(*xs.shape[:2], -1, s.head_dim)
    y, h_final = ssd(xh, dt, A, Bm, Cm, chunk=min(s.chunk, xs.shape[1]))
    y = y + xh.to(F32).to(y.dtype) \
        * take(p["D_skip"]).to(y.dtype)[None, None, :, None]
    y = y.reshape(*xs.shape[:2], -1)
    y = y * F.silu(z.to(F32)).to(y.dtype)
    # gated RMSNorm (Mamba2 normalizes after gating)
    y = _gated_norm(y.to(F32), p["norm"], d_in, cfg.norm_eps,
                    split).to(x.dtype)
    out = _out_proj(y, p["wo"], split)
    if return_state:
        return out, h_final
    return out


def ssm_decode_step(p, x: torch.Tensor, cfg: ModelConfig, h: torch.Tensor,
                    conv_buf: torch.Tensor):
    """Single-token recurrent step.

    x: (B, 1, D); h: (B, nh, P, N) fp32 state;
    conv_buf: (B, d_conv-1, d_in + 2N) previous conv inputs.
    Returns (y (B,1,D), h_new, conv_buf_new).  The new conv buffer takes
    the promoted type of the old one and the new inputs, as
    ``jnp.concatenate`` (and ``torch.cat``) does.  Tensor-parallel when
    ``wx`` is placed over ``model``: ``h`` is the rank's heads and
    ``conv_buf`` whole (the module's docstring).  No gradient flows
    through the buffer's gather.
    """
    s = cfg.ssm
    d_in = s.expand * cfg.d_model
    nh = d_in // s.head_dim
    Bsz = x.shape[0]
    split = _heads_split(p, nh)

    z = torch.matmul(x, take(p["wz"]))[:, 0]
    xs = torch.matmul(x, take(p["wx"]))[:, 0]
    Bm = torch.matmul(x, take(p["wB"]))[:, 0]
    Cm = torch.matmul(x, take(p["wC"]))[:, 0]
    dt = torch.matmul(x, take(p["wdt"]))[:, 0]

    # rolling causal conv over the last d_conv inputs
    cat = torch.cat([xs, Bm, Cm], dim=-1)                 # (B, d_in+2N)
    if split is None:
        hist = torch.cat([conv_buf, cat[:, None, :]], dim=1)  # promoting
        new_buf = hist[:, 1:, :]
    else:
        # the rank's xs channels and every B/C channel of the buffer; the
        # new buffer whole, its xs channels gathered over model
        c0 = split.rank * xs.shape[-1]
        mine = torch.cat([conv_buf[..., c0:c0 + xs.shape[-1]],
                          conv_buf[..., d_in:]], dim=-1)
        hist = torch.cat([mine, cat[:, None, :]], dim=1)
        full = torch.cat([gather_dim(xs, -1, split.group), Bm, Cm], dim=-1)
        new_buf = torch.cat([conv_buf[:, 1:], full[:, None, :]], dim=1)
    wfull = torch.cat([take(p["conv_x"]), take(p["conv_B"]),
                       take(p["conv_C"])], dim=-1)
    conv = torch.einsum("bkc,kc->bc", hist.to(F32), wfull.to(F32))
    conv = F.silu(conv)
    w = xs.shape[-1]
    xs = conv[:, :w].to(x.dtype)
    Bm = conv[:, w:w + s.d_state].to(x.dtype)
    Cm = conv[:, w + s.d_state:].to(x.dtype)

    dt = F.softplus(dt.to(F32) + take(p["dt_bias"]).to(F32))   # (B, nh)
    A = -torch.exp(take(p["A_log"]).to(F32))
    xh = xs.reshape(Bsz, -1, s.head_dim).to(F32)

    decay = torch.exp(dt * A)                             # (B, nh)
    upd = torch.einsum("bh,bn,bhp->bhpn", dt, Bm.to(F32), xh)
    h_new = h * decay[:, :, None, None] + upd
    y = torch.einsum("bn,bhpn->bhp", Cm.to(F32), h_new)
    y = y + xh * take(p["D_skip"]).to(F32)[None, :, None]
    y = y.reshape(Bsz, -1)
    y = y * F.silu(z.to(F32))
    y = _gated_norm(y, p["norm"], d_in, cfg.norm_eps, split)
    out = _out_proj(y.to(x.dtype), p["wo"], split)[:, None, :]
    return out, h_new, new_buf
