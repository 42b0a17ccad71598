"""Plain float32 mamba2-1.3b (the ssm family): Mamba2 blocks over token
embeddings, as arXiv:2405.21060 describes them, with the configuration's
sizes.

Per block, pre-norm (RMSNorm): the input projections z, x, B, C (one
group, shared by every head) and dt; a depthwise causal convolution of
width ``d_conv`` then SiLU over x, B and C; ``dt = softplus(dt + bias)``,
``A = -exp(A_log)``; the SSD recurrence per head, ``h_t = exp(dt_t A)
h_{t-1} + dt_t x_t B_t^T``, ``y_t = h_t C_t`` from a zero state; the skip
``+ D x``; the gate ``y * silu(z)``; an RMSNorm over the inner width; the
output projection and a residual add.  Then the final RMSNorm and the
vocabulary head; the loss is the mean next-token cross-entropy over the
published vocabulary (the head's padding columns are left out).

The recurrence is computed in its chunked form, exactly (every term in
float32): within a chunk the quadratic form, between chunks the carried
state.
"""
from __future__ import annotations

from typing import Dict, List, Tuple

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from bench import yardstick
from bench.reference.plain import nll_sum, rmsnorm


def padded_vocab(v: int) -> int:
    return -(-v // 2048) * 2048


def param_specs(cfg: Dict) -> List[Tuple[str, Tuple[int, ...], str, float]]:
    d, L, s = cfg["d_model"], cfg["n_layers"], cfg["ssm"]
    d_in = s["expand"] * d
    nh, N, K = d_in // s["head_dim"], s["d_state"], s["d_conv"]
    out = 1.0 / max(1, 2 * L) ** 0.5
    specs = []
    for l in range(L):
        b = f"blocks.{l}."
        specs += [(b + "ln1", (d,), "ones", 1.0),
                  (b + "ssm.wz", (d, d_in), "normal", 1.0),
                  (b + "ssm.wx", (d, d_in), "normal", 1.0),
                  (b + "ssm.wB", (d, N), "normal", 1.0),
                  (b + "ssm.wC", (d, N), "normal", 1.0),
                  (b + "ssm.wdt", (d, nh), "normal", 1.0),
                  (b + "ssm.dt_bias", (nh,), "zeros", 1.0),
                  (b + "ssm.A_log", (nh,), "zeros", 1.0),
                  (b + "ssm.D_skip", (nh,), "ones", 1.0),
                  (b + "ssm.conv_x", (K, d_in), "normal", 0.5),
                  (b + "ssm.conv_B", (K, N), "normal", 0.5),
                  (b + "ssm.conv_C", (K, N), "normal", 0.5),
                  (b + "ssm.norm", (d_in,), "ones", 1.0),
                  (b + "ssm.wo", (d_in, d), "normal", out)]
    V = padded_vocab(cfg["vocab_size"])
    specs += [("embed.tok", (V, d), "embed", 1.0),
              ("embed.head", (d, V), "normal", 1.0),
              ("final_norm", (d,), "ones", 1.0)]
    return specs


def causal_conv(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """Depthwise causal convolution: x (b, S, C), w (K, C); output t sums
    w[i] x[t - K + 1 + i]."""
    K, S = w.shape[0], x.shape[1]
    xp = F.pad(x, (0, 0, K - 1, 0))
    return sum(xp[:, i:i + S] * w[i] for i in range(K))


def ssd(x, dt, A, Bm, Cm, chunk: int) -> torch.Tensor:
    """y of the SSD recurrence: x (b, S, h, p), dt (b, S, h), A (h,),
    Bm, Cm (b, S, n)."""
    b, S, h, p = x.shape
    pad = -S % chunk
    if pad:
        x, dt, Bm, Cm = (F.pad(t, (0, 0) * (t.dim() - 2) + (0, pad))
                         for t in (x, dt, Bm, Cm))
    nc = x.shape[1] // chunk
    xc = x.reshape(b, nc, chunk, h, p)
    dtc = dt.reshape(b, nc, chunk, h)
    Bc = Bm.reshape(b, nc, chunk, -1)
    Cc = Cm.reshape(b, nc, chunk, -1)
    cum = torch.cumsum(dtc * A, dim=2)                       # (b, c, l, h)
    keep = torch.tril(torch.ones(chunk, chunk, dtype=torch.bool,
                                 device=x.device))
    seg = cum[:, :, :, None, :] - cum[:, :, None, :, :]      # (b,c,i,j,h)
    decay = torch.exp(torch.where(keep[None, None, :, :, None], seg,
                                  torch.full_like(seg, float("-inf"))))
    cb = torch.einsum("bcin,bcjn->bcij", Cc, Bc)
    xdt = xc * dtc[..., None]
    y = torch.einsum("bcij,bcijh,bcjhp->bcihp", cb, decay, xdt)
    # each chunk's state at its end, then the state carried into each
    to_end = torch.exp(cum[:, :, -1:, :] - cum)              # (b, c, l, h)
    states = torch.einsum("bcln,bclh,bclhp->bchpn", Bc, to_end, xdt)
    carried = [torch.zeros_like(states[:, 0])]
    for c in range(nc - 1):
        carried.append(carried[-1] * torch.exp(cum[:, c, -1])[..., None, None]
                       + states[:, c])
    h_in = torch.stack(carried, dim=1)                       # (b,c,h,p,n)
    y = y + torch.einsum("bcin,bchpn,bcih->bcihp", Cc, h_in, torch.exp(cum))
    return y.reshape(b, nc * chunk, h, p)[:, :S]


def _block(P, l: int, x: torch.Tensor, cfg: Dict, mm) -> torch.Tensor:
    s = cfg["ssm"]
    b, S, d = x.shape
    d_in = s["expand"] * d
    nh, hp = d_in // s["head_dim"], s["head_dim"]
    eps = cfg["norm_eps"]

    def w(name):
        return P[f"blocks/ssm/{name}"][l]

    h = rmsnorm(x, P["blocks/ln1"][l], eps)
    z = mm(h, w("wz"))
    xs = F.silu(causal_conv(mm(h, w("wx")), w("conv_x")))
    Bm = F.silu(causal_conv(mm(h, w("wB")), w("conv_B")))
    Cm = F.silu(causal_conv(mm(h, w("wC")), w("conv_C")))
    dt = F.softplus(mm(h, w("wdt")) + w("dt_bias"))
    A = -torch.exp(w("A_log"))
    xh = xs.reshape(b, S, nh, hp)
    y = ssd(xh, dt, A, Bm, Cm, s["chunk"]) + xh * w("D_skip")[:, None]
    y = y.reshape(b, S, d_in) * F.silu(z)
    y = rmsnorm(y, w("norm"), eps)
    return x + mm(y, w("wo"))


def loss_sum(P: Dict[str, torch.Tensor], cfg: Dict, batch: Dict,
             mm) -> torch.Tensor:
    """Summed next-token cross-entropy of a block of sequences: ``batch``
    holds ``tokens`` and ``labels`` (b, S)."""
    x = P["embed/tok"][batch["tokens"]]
    for l in range(cfg["n_layers"]):
        x = checkpoint(_block, P, l, x, cfg, mm, use_reentrant=False)
    x = rmsnorm(x, P["final_norm"], cfg["norm_eps"])
    logits = mm(x, P["embed/head"])
    return nll_sum(logits, batch["labels"], cfg["vocab_size"])


def count(batch: Dict) -> int:
    return batch["labels"].numel()


def step_flops(cfg: Dict, cell: Dict) -> float:
    """Model FLOPs of one training step of the cell (the yardstick's)."""
    return yardstick.ssm_step_flops(cfg, cell["batch"], cell["seq"])
