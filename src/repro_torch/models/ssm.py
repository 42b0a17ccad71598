"""Mamba2 block (SSD — state-space duality, arXiv:2405.21060).

The port's twin of ``repro.models.ssm``.  Layout as there: d_inner =
expand * d_model, nh = d_inner / head_dim SSD heads, ngroups = 1 (B, C
shared across heads).  The full-sequence block's scan goes through K5
(``ops.ssd``) where the reference calls its XLA ``_ssd_chunked``: on a
CUDA tensor the hand-written kernel, on a CPU tensor its plain twin, a
torch copy of ``_ssd_core``.  The single-token recurrent step stays
plain torch, as in the reference.  The sequence-parallel block over a
mesh is ``models/ssm_sp.py``.
"""
from __future__ import annotations

from typing import Dict

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ModelConfig
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


def ssm_block(p, x: torch.Tensor, cfg: ModelConfig, *,
              return_state: bool = False):
    """Full-sequence Mamba2 block. x: (B, S, D)."""
    s = cfg.ssm
    d_in = s.expand * cfg.d_model
    nh = d_in // s.head_dim

    z = torch.matmul(x, p["wz"])
    xs = torch.matmul(x, p["wx"])
    Bm = torch.matmul(x, p["wB"])
    Cm = torch.matmul(x, p["wC"])
    dt = torch.matmul(x, p["wdt"])

    xs = _causal_conv(xs, p["conv_x"])
    Bm = _causal_conv(Bm, p["conv_B"])
    Cm = _causal_conv(Cm, p["conv_C"])

    dt = F.softplus(dt.to(F32) + p["dt_bias"].to(F32))
    A = -torch.exp(p["A_log"].to(F32))

    xh = xs.reshape(*xs.shape[:2], nh, s.head_dim)
    y, h_final = ssd(xh, dt, A, Bm, Cm, chunk=min(s.chunk, xs.shape[1]))
    y = y + xh.to(F32).to(y.dtype) * p["D_skip"].to(y.dtype)[None, None, :, None]
    y = y.reshape(*xs.shape[:2], d_in)
    y = y * F.silu(z.to(F32)).to(y.dtype)
    # gated RMSNorm (Mamba2 normalizes after gating)
    yf = y.to(F32)
    y = (yf * torch.rsqrt(torch.mean(yf * yf, -1, keepdim=True) + cfg.norm_eps)
         * p["norm"].to(F32)).to(x.dtype)
    out = torch.matmul(y, p["wo"])
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
    ``jnp.concatenate`` (and ``torch.cat``) does.
    """
    s = cfg.ssm
    d_in = s.expand * cfg.d_model
    nh = d_in // s.head_dim
    Bsz = x.shape[0]

    z = torch.matmul(x, p["wz"])[:, 0]
    xs = torch.matmul(x, p["wx"])[:, 0]
    Bm = torch.matmul(x, p["wB"])[:, 0]
    Cm = torch.matmul(x, p["wC"])[:, 0]
    dt = torch.matmul(x, p["wdt"])[:, 0]

    # rolling causal conv over the last d_conv inputs
    cat = torch.cat([xs, Bm, Cm], dim=-1)                 # (B, d_in+2N)
    hist = torch.cat([conv_buf, cat[:, None, :]], dim=1)   # type-promoting
    new_buf = hist[:, 1:, :]
    wfull = torch.cat([p["conv_x"], p["conv_B"], p["conv_C"]], dim=-1)
    conv = torch.einsum("bkc,kc->bc", hist.to(F32), wfull.to(F32))
    conv = F.silu(conv)
    xs = conv[:, :d_in].to(x.dtype)
    Bm = conv[:, d_in:d_in + s.d_state].to(x.dtype)
    Cm = conv[:, d_in + s.d_state:].to(x.dtype)

    dt = F.softplus(dt.to(F32) + p["dt_bias"].to(F32))   # (B, nh)
    A = -torch.exp(p["A_log"].to(F32))
    xh = xs.reshape(Bsz, nh, s.head_dim).to(F32)

    decay = torch.exp(dt * A)                             # (B, nh)
    upd = torch.einsum("bh,bn,bhp->bhpn", dt, Bm.to(F32), xh)
    h_new = h * decay[:, :, None, None] + upd
    y = torch.einsum("bn,bhpn->bhp", Cm.to(F32), h_new)
    y = y + xh * p["D_skip"].to(F32)[None, :, None]
    y = y.reshape(Bsz, d_in)
    y = y * F.silu(z.to(F32))
    y = (y * torch.rsqrt(torch.mean(y * y, -1, keepdim=True) + cfg.norm_eps)
         * p["norm"].to(F32))
    out = torch.matmul(y.to(x.dtype), p["wo"])[:, None, :]
    return out, h_new, new_buf
