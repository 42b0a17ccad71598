"""AdamW with memory-tiered optimizer state: the port's twin of
``repro.train.optimizer``.

Moment dtype options per ParallelismConfig.opt_state_dtype:
* ``float32``  — classic AdamW;
* ``bfloat16`` — halves optimizer memory;
* ``int8``     — blockwise-quantized moments (scale per trailing block of
  256): signed absmax codes for the first moment, fourth-root ``uint8``
  codes for the second.

State is kept per *reference leaf*.  The reference stacks the layers of
``blocks`` on a leading axis (one ``(L, ...)`` leaf per name); the port
keeps one tensor per layer (``blocks[i].attn.wq``), so the optimizer
takes the per-layer tensors of a name together as that stacked leaf
(:func:`param_leaves`).  Two things depend on it, and both follow the
reference:

* decay applies to leaves with ``ndim >= 2`` of the *stacked* shape, so
  the per-layer norms (``ln1``, ``q_norm``, ...) are decayed, as in the
  reference, whose comment says otherwise; only ``final_norm`` is not;
* ``_blocks`` partitions the stacked leaf: when its trailing axis does
  not divide 256, the blocks tile the flattened leaf.  Where each layer
  holds whole blocks (deepseek-moe-16b's ``(L, 64, 2048, 1408)``
  ``we_gate``) the port walks it layer by layer in pieces as any other
  leaf; where blocks span layers (qwen3's ``(L, 128)`` ``q_norm``) it
  quantizes that leaf whole.

Rounding is ``torch.round`` (half to even, as ``jnp.round``) and the
float32 arithmetic follows the reference's expressions term by term, so
the int8 payloads come out equal byte for byte.

Unlike the reference's pure ``update``, the port updates parameters and
moments in place (memory: no second copy of an 8 B-parameter model), and
it walks a leaf in pieces where the blocking allows — one layer at a
time, and rows of at most ``CHUNK`` elements — so the float32
transients stay small.
"""
from __future__ import annotations

import math
from typing import Callable, Dict, List, NamedTuple, Optional, Tuple

import torch

from repro_torch.models.params import ParamDef, ParamTree, Stacked

QBLOCK = 256
#: elements per piece of a leaf in the update (float32 transients)
CHUNK = 1 << 24
F32 = torch.float32


class Quantized(NamedTuple):
    q: torch.Tensor       # int8 (first moment) / uint8 (second) payload
    scale: torch.Tensor   # fp32 per-block scales


class AdamWState(NamedTuple):
    step: torch.Tensor    # int32 scalar
    m: Dict               # reference leaf path -> state (dtype-tiered)
    v: Dict


class Leaf(NamedTuple):
    """One reference leaf: its path (``blocks/attn/wq``), the port's
    parameter names that hold it (one per layer when ``stacked``) and the
    reference's shape."""
    path: str
    names: Tuple[str, ...]
    shape: Tuple[int, ...]
    stacked: bool


def param_leaves(tree: ParamTree) -> List[Leaf]:
    """The reference's leaves of ``tree`` in its flatten order (sorted
    names), each with the port's parameter names."""
    def walk(defs, path, name):
        for key in sorted(defs):
            d = defs[key]
            p, n = f"{path}{key}", f"{name}{key}"
            if isinstance(d, ParamDef):
                yield Leaf(p, (n,), tuple(d.shape), False)
            elif isinstance(d, Stacked):
                for sub in walk(d.defs, f"{p}/", ""):
                    yield Leaf(sub.path, tuple(f"{n}.{i}.{sub.names[0]}"
                                               for i in range(d.n)),
                               (d.n, *sub.shape), True)
            else:
                yield from walk(d, f"{p}/", f"{n}.")
    return list(walk(tree.defs, "", ""))


def _structured(shape: Tuple[int, ...]) -> bool:
    """Blocks follow the trailing axis (the reference's structure-
    preserving case): any row range of the leaf quantizes on its own."""
    return len(shape) >= 1 and shape[-1] % QBLOCK == 0


def _blocks(x: torch.Tensor) -> torch.Tensor:
    """Blocked view, as the reference's ``_blocks``: (..., D/Q, Q) when
    the trailing axis divides Q, else the flattened leaf padded with
    zeros to (-1, Q)."""
    if _structured(tuple(x.shape)):
        return x.reshape(*x.shape[:-1], x.shape[-1] // QBLOCK, QBLOCK)
    flat = x.reshape(-1)
    return torch.nn.functional.pad(flat, (0, -flat.shape[0] % QBLOCK)) \
        .reshape(-1, QBLOCK)


def _unblocks(blocks: torch.Tensor, shape: Tuple[int, ...]) -> torch.Tensor:
    if _structured(shape) and blocks.dim() == len(shape) + 1:
        return blocks.reshape(shape)
    return blocks.reshape(-1)[:math.prod(shape)].reshape(shape)


def _quantize(x: torch.Tensor) -> Quantized:
    """Signed symmetric absmax int8 (for the first moment)."""
    blocks = _blocks(x)
    scale = torch.amax(torch.abs(blocks), dim=-1, keepdim=True) / 127.0
    q = torch.round(blocks / torch.clamp(scale, min=1e-12)).to(torch.int8)
    return Quantized(q, scale.to(F32))


def _dequantize(qv: Quantized, shape: Tuple[int, ...]) -> torch.Tensor:
    return _unblocks(qv.q.to(F32) * qv.scale, shape)


def _quantize_pos(x: torch.Tensor) -> Quantized:
    """Fourth-root uint8 coding for the (non-negative) second moment."""
    blocks = _blocks(x)
    vmax = torch.amax(blocks, dim=-1, keepdim=True)
    root = torch.sqrt(torch.sqrt(blocks / torch.clamp(vmax, min=1e-30)))
    q = torch.round(root * 255.0).to(torch.uint8)
    return Quantized(q, vmax.to(F32))


def _dequantize_pos(qv: Quantized, shape: Tuple[int, ...]) -> torch.Tensor:
    root = qv.q.to(F32) / 255.0
    r2 = root * root           # root ** 4 as jax's integer_pow: (r^2)^2
    return _unblocks((r2 * r2) * qv.scale, shape)


def _rows(t: torch.Tensor, width: int) -> torch.Tensor:
    """``t`` as rows of ``width`` (a view of a contiguous tensor)."""
    return t.reshape(-1, width)


def _pieces(n_rows: int, width: int):
    """Row slices of at most ``CHUNK`` elements (at least one row)."""
    step = max(1, CHUNK // max(1, width))
    return [slice(r, r + step) for r in range(0, n_rows, step)]


class AdamW:
    def __init__(self, lr=3e-4, b1=0.9, b2=0.95, eps=1e-8,
                 weight_decay=0.1, grad_clip=1.0,
                 state_dtype: str = "float32",
                 schedule: Optional[Callable] = None):
        if state_dtype not in ("float32", "bfloat16", "int8"):
            raise ValueError(f"state_dtype {state_dtype!r}: float32, "
                             f"bfloat16 or int8")
        self.lr, self.b1, self.b2, self.eps = lr, b1, b2, eps
        self.wd = weight_decay
        self.clip = grad_clip
        self.state_dtype = state_dtype
        self.schedule = schedule

    # -- state representation helpers --
    def _to_state(self, x: torch.Tensor, positive: bool = False):
        if self.state_dtype == "int8":
            return _quantize_pos(x) if positive else _quantize(x)
        if self.state_dtype == "bfloat16":
            return x.to(torch.bfloat16)
        return x.to(F32)

    def _from_state(self, s, shape, positive: bool = False) -> torch.Tensor:
        if self.state_dtype == "int8":
            return _dequantize_pos(s, shape) if positive \
                else _dequantize(s, shape)
        return s.to(F32)

    def init(self, params: ParamTree) -> AdamWState:
        """Zero moments for every reference leaf of ``params``, on the
        parameters' device."""
        named = dict(params.named_parameters())
        m, v = {}, {}
        for leaf in param_leaves(params):
            dev = named[leaf.names[0]].device
            m[leaf.path] = self._zero_state(leaf.shape, dev, torch.int8)
            v[leaf.path] = self._zero_state(leaf.shape, dev, torch.uint8)
        step = torch.zeros((), dtype=torch.int32)
        return AdamWState(step, m, v)

    def _zero_state(self, shape, device, code_dtype):
        """The state of a zero moment, made directly (what ``_to_state``
        of zeros gives, without the float32 leaf)."""
        if self.state_dtype != "int8":
            return torch.zeros(shape, device=device,
                               dtype=getattr(torch, self.state_dtype))
        if _structured(shape):
            blocked = (*shape[:-1], shape[-1] // QBLOCK, QBLOCK)
        else:
            blocked = (-(-math.prod(shape) // QBLOCK), QBLOCK)
        return Quantized(
            torch.zeros(blocked, dtype=code_dtype, device=device),
            torch.zeros((*blocked[:-1], 1), dtype=F32, device=device))

    # -- update --
    def update(self, grads: Dict[str, torch.Tensor], state: AdamWState,
               params: ParamTree):
        """One AdamW step.  ``grads`` maps the port's parameter names
        (``params.named_parameters()``) to gradients.  Updates the
        parameters and the moments in place and returns ``(params,
        state', gnorm)`` as the reference returns ``(params', state',
        gnorm)``."""
        named = dict(params.named_parameters())
        leaves = param_leaves(params)
        step = state.step + 1
        s = step.to(F32)
        lr = self.lr if self.schedule is None else self.schedule(step)

        dev = named[leaves[0].names[0]].device
        sq = torch.zeros((), dtype=F32, device=dev)
        for leaf in leaves:
            for n in leaf.names:
                g = grads[n]
                g2 = _rows(g, g.shape[-1] if g.dim() else 1)
                for sl in _pieces(*g2.shape):
                    sq = sq + torch.sum(torch.square(g2[sl].to(F32)))
        gnorm = torch.sqrt(sq)
        scale = torch.clamp(self.clip / torch.clamp(gnorm, min=1e-12),
                            max=1.0) if self.clip else 1.0

        b1c = 1.0 - torch.tensor(self.b1, dtype=F32) ** s
        b2c = 1.0 - torch.tensor(self.b2, dtype=F32) ** s
        b1c, b2c = b1c.to(dev), b2c.to(dev)
        if isinstance(lr, torch.Tensor):
            lr = lr.to(dev)

        with torch.no_grad():
            for leaf in leaves:
                self._update_leaf(leaf, named, grads, state, scale, lr,
                                  b1c, b2c)
        return params, AdamWState(step, state.m, state.v), gnorm

    def _step(self, p, g, mf, vf, scale, lr, b1c, b2c, decay: bool):
        """The reference's ``upd`` on float32 moments: (new p, m, v)."""
        g = g.to(F32) * scale
        mf = self.b1 * mf + (1 - self.b1) * g
        vf = self.b2 * vf + (1 - self.b2) * g * g
        mh = mf / b1c
        vh = vf / b2c
        delta = mh / (torch.sqrt(vh) + self.eps)
        if self.wd and decay:
            delta = delta + self.wd * p.to(F32)
        new_p = (p.to(F32) - lr * delta).to(p.dtype)
        return new_p, mf, vf

    def _update_leaf(self, leaf: Leaf, named, grads, state, scale, lr,
                     b1c, b2c) -> None:
        decay = len(leaf.shape) >= 2
        m, v = state.m[leaf.path], state.v[leaf.path]
        tensors = [named[n] for n in leaf.names]
        gs = [grads[n] for n in leaf.names]
        quant = self.state_dtype == "int8"
        per_layer = math.prod(leaf.shape[1:] if leaf.stacked else leaf.shape)
        if quant and not _structured(leaf.shape) and per_layer % QBLOCK == 0:
            # blocks tile the flattened leaf and each layer holds whole
            # blocks: a layer is its blocks' rows of the payload
            nb = per_layer // QBLOCK
            for i, (t, g) in enumerate(zip(tensors, gs)):
                rows = slice(i * nb, (i + 1) * nb)
                self._update_rows(
                    t.view(-1, QBLOCK), g.reshape(-1, QBLOCK),
                    Quantized(m.q[rows], m.scale[rows]),
                    Quantized(v.q[rows], v.scale[rows]), scale, lr, b1c,
                    b2c, decay)
            return
        if quant and not _structured(leaf.shape):
            # blocks span the flattened leaf's layers: whole leaf
            p = torch.stack(tensors) if leaf.stacked else tensors[0]
            g = torch.stack(gs) if leaf.stacked else gs[0]
            mf = self._from_state(m, leaf.shape)
            vf = self._from_state(v, leaf.shape, positive=True)
            new_p, mf, vf = self._step(p, g, mf, vf, scale, lr, b1c, b2c,
                                       decay)
            for dst, src in ((m, self._to_state(mf)),
                             (v, self._to_state(vf, positive=True))):
                for a, b in zip(dst, src):
                    a.copy_(b)
            for i, t in enumerate(tensors):
                t.copy_(new_p[i] if leaf.stacked else new_p)
            return
        # elementwise, or blocks along the trailing axis: piece by piece
        for i, (t, g) in enumerate(zip(tensors, gs)):
            ms = m if not leaf.stacked else (
                Quantized(m.q[i], m.scale[i]) if quant else m[i])
            vs = v if not leaf.stacked else (
                Quantized(v.q[i], v.scale[i]) if quant else v[i])
            self._update_rows(t, g, ms, vs, scale, lr, b1c, b2c, decay)

    def _update_rows(self, t, g, m, v, scale, lr, b1c, b2c, decay) -> None:
        """Update one layer's tensor (and its state views) in row pieces
        of at most ``CHUNK`` elements; rows run along the trailing axis,
        which carries the int8 blocks."""
        width = t.shape[-1] if t.dim() else 1
        t2, g2 = _rows(t, width), _rows(g, width)
        quant = self.state_dtype == "int8"
        if quant:
            nb = width // QBLOCK
            m = Quantized(m.q.reshape(-1, nb, QBLOCK),
                          m.scale.reshape(-1, nb, 1))
            v = Quantized(v.q.reshape(-1, nb, QBLOCK),
                          v.scale.reshape(-1, nb, 1))
        else:
            m, v = _rows(m, width), _rows(v, width)
        for sl in _pieces(*t2.shape):
            p = t2[sl]
            ms = Quantized(m.q[sl], m.scale[sl]) if quant else m[sl]
            vs = Quantized(v.q[sl], v.scale[sl]) if quant else v[sl]
            mf = self._from_state(ms, tuple(p.shape))
            vf = self._from_state(vs, tuple(p.shape), positive=True)
            new_p, mf, vf = self._step(p, g2[sl], mf, vf, scale, lr, b1c,
                                       b2c, decay)
            p.copy_(new_p)
            new_m = self._to_state(mf)
            new_v = self._to_state(vf, positive=True)
            if quant:
                for dst, src in ((ms, new_m), (vs, new_v)):
                    dst.q.copy_(src.q)
                    dst.scale.copy_(src.scale)
            else:
                ms.copy_(new_m)
                vs.copy_(new_v)


def warmup_cosine(base_lr: float, warmup: int, total: int,
                  floor: float = 0.1):
    """Linear warmup to ``base_lr``, then a cosine to ``floor * base_lr``;
    ``f(step)`` is a float32 scalar tensor, computed as the reference's."""
    def f(step):
        s = torch.as_tensor(step).to(F32)
        warm = s / max(warmup, 1)
        prog = torch.clamp((s - warmup) / max(total - warmup, 1), 0.0, 1.0)
        cos = floor + (1 - floor) * 0.5 * (1 + torch.cos(math.pi * prog))
        return base_lr * torch.where(s < warmup, warm, cos)
    return f
