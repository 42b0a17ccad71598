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

A parameter that ``distributed.sharding.distribute_model`` placed as a
DTensor (the FSDP, tensor- and expert-parallel blocks of the dense and
moe families, the experts of the data-parallel step's moe) is held and
updated as its local block, and its squared gradient is summed over the
groups of the mesh dimensions it is sharded on, so that ``gnorm`` (and
the clipping) is the whole model's on every rank, each element counted
once; a replicated parameter, whose gradient every rank holds whole, is
counted once (:meth:`AdamW._sq_norm`).  Its moments are laid out as the
reference's ``_opt_specs`` lays them out (``launch/dryrun.py``): a
float32 or bf16 moment takes its parameter's spec, so it has the local
block's shape; an int8 moment of a model placed by the reference's
layout takes :func:`quantized_spec` of the reference's blocks
(:class:`MomentLayout`).  Where those blocks are the local block's own
(the trailing axis whole, or split into whole blocks as the parameter
is) the rank updates its block alone; where the spec keeps the blocks
whole across a split trailing axis, the rank gathers its rows' gradient
and parameter along it and updates whole blocks; the flat blocks (split
over ``data`` or replicated) take the leaf whole.  Each rank codes whole
blocks only, so the payloads are what one device codes from the same
gradients.
"""
from __future__ import annotations

import math
from functools import partial
from typing import Callable, Dict, List, NamedTuple, Optional, Tuple

import torch
import torch.distributed

from repro_torch.distributed.sharding import (axis_rank, block_of, gather_dim,
                                              group_of, unblock)
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


def local_tensor(t: torch.Tensor) -> torch.Tensor:
    """A DTensor's local block (its storage, updated in place); any other
    tensor as it is."""
    from torch.distributed.tensor import DTensor
    return t.to_local() if isinstance(t, DTensor) else t


def _shard_groups(t: torch.Tensor) -> Tuple:
    """The process groups of the mesh dimensions a DTensor is sharded on
    (none for a plain tensor)."""
    from torch.distributed.tensor import DTensor, Shard
    if not isinstance(t, DTensor):
        return ()
    return tuple(t.device_mesh.get_group(i)
                 for i, pl in enumerate(t.placements) if isinstance(pl, Shard))


def local_leaves(tree: ParamTree) -> List[Leaf]:
    """:func:`param_leaves` with each leaf's shape that of the tensors the
    rank holds (a DTensor parameter's local block)."""
    named = dict(tree.named_parameters())
    out = []
    for leaf in param_leaves(tree):
        t = named[leaf.names[0]]
        shape = tuple(local_tensor(t).shape)
        out.append(leaf._replace(
            shape=(len(leaf.names), *shape) if leaf.stacked else shape))
    return out


def _structured(shape: Tuple[int, ...]) -> bool:
    """Blocks follow the trailing axis (the reference's structure-
    preserving case): any row range of the leaf quantizes on its own."""
    return len(shape) >= 1 and shape[-1] % QBLOCK == 0


def blocked_shape(shape: Tuple[int, ...]) -> Tuple[int, ...]:
    """The shape of a leaf's int8 payload: (..., D/Q, Q) when the
    trailing axis divides Q, else (ceil(n/Q), Q) of the flattened leaf."""
    if _structured(shape):
        return (*shape[:-1], shape[-1] // QBLOCK, QBLOCK)
    return (-(-math.prod(shape) // QBLOCK), QBLOCK)


def quantized_spec(blocked: Tuple[int, ...], spec: Tuple, fsdp: bool,
                   dp: int) -> Tuple:
    """The reference's ``_opt_specs`` for one int8 payload (and its
    scales) of shape ``blocked``, whose parameter has the spec ``spec``:
    structured blocks (..., D/Q, Q) inherit the parameter's spec, a
    sharded trailing axis moving to the blocks axis where D/Q divides by
    16 (the reference's literal); flat blocks split over ``data`` under
    FSDP where their count divides the data axis, else replicated.  A
    one-dimensional parameter's flat blocks take the first branch, as in
    the reference."""
    parts = list(spec) + [None] * (len(blocked) - 1 - len(spec))
    if len(blocked) == len(parts) + 1:
        last = parts[-1] if parts else None
        keep_last = last if (last is not None and
                             blocked[-2] % 16 == 0) else None
        return (*parts[:-1], keep_last, None)
    return ("data", None) if (fsdp and blocked[0] % dp == 0) else ()


def param_spec(t: torch.Tensor) -> Tuple:
    """A parameter's spec as placed: per dimension the mesh axis that
    shards it (a tuple of several, major first), None elsewhere."""
    from torch.distributed.tensor import DTensor, Shard
    if not isinstance(t, DTensor):
        return (None,) * t.dim()
    axes = [()] * t.dim()
    names = t.device_mesh.mesh_dim_names
    for i, pl in enumerate(t.placements):
        if isinstance(pl, Shard):
            axes[pl.dim] += (names[i],)
    return tuple(None if not a else a[0] if len(a) == 1 else a for a in axes)


class MomentLayout(NamedTuple):
    """An int8 moment's layout under the reference's: the leaf's spec
    (a stacked leaf's with its layers' ``None``) and whole shape, its
    payload's spec (:func:`quantized_spec`) and the mesh; ``mode`` is
    how the rank updates it: ``"local"`` (its blocks are the local
    block's), ``"trailing"`` (whole blocks across the split trailing
    axis) or ``"whole"``."""
    spec: Tuple
    shape: Tuple[int, ...]
    qspec: Tuple
    mesh: object

    @property
    def mode(self) -> str:
        if not any(self.qspec) and not any(self.spec):
            return "local"
        if _structured(self.shape):
            if self.qspec == (*self.spec, None):
                return "local"
            if self.qspec == (*self.spec[:-1], None, None):
                return "trailing"
        return "whole"

    def local_blocked(self) -> Tuple[int, ...]:
        """The rank's block of the payload."""
        out = list(blocked_shape(self.shape))
        for d, entry in enumerate(self.qspec):
            out[d] //= axis_rank(self.mesh, entry)[1]
        return tuple(out)


def moment_layouts(params: ParamTree) -> Dict[str, MomentLayout]:
    """The int8 moments' layouts of a model placed by the reference's
    layout, by leaf path; none for a model with no placed parameter or
    placed ``experts_only`` (its moments have its local blocks' shapes).
    FSDP is in force where some parameter is sharded over ``data``, as
    the rules shard ``embed`` there."""
    from torch.distributed.tensor import DTensor, Shard
    placed = dict(params.named_parameters())
    dts = [p for p in placed.values() if isinstance(p, DTensor)]
    if not dts or getattr(params, "experts_only", False):
        return {}
    mesh = dts[0].device_mesh
    names = mesh.mesh_dim_names
    fsdp = any(isinstance(pl, Shard) and names[i] == "data"
               for p in dts for i, pl in enumerate(p.placements))
    dp = mesh.size(names.index("data")) if "data" in names else 1
    out = {}
    for leaf in param_leaves(params):
        spec = param_spec(placed[leaf.names[0]])
        if leaf.stacked:
            spec = (None, *spec)
        out[leaf.path] = MomentLayout(
            spec, leaf.shape,
            quantized_spec(blocked_shape(leaf.shape), spec, fsdp, dp), mesh)
    return out


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
        parameters' device, each the rank's block of its layout."""
        named = dict(params.named_parameters())
        layouts = self._layouts(params)
        m, v = {}, {}
        for leaf in local_leaves(params):
            dev = named[leaf.names[0]].device
            lay = layouts.get(leaf.path)
            blocked = lay.local_blocked() if lay else None
            m[leaf.path] = self._zero_state(leaf.shape, dev, torch.int8,
                                            blocked)
            v[leaf.path] = self._zero_state(leaf.shape, dev, torch.uint8,
                                            blocked)
        step = torch.zeros((), dtype=torch.int32)
        return AdamWState(step, m, v)

    def _layouts(self, params: ParamTree) -> Dict[str, MomentLayout]:
        return moment_layouts(params) if self.state_dtype == "int8" else {}

    def _zero_state(self, shape, device, code_dtype, blocked=None):
        """The state of a zero moment, made directly (what ``_to_state``
        of zeros gives, without the float32 leaf); an int8 payload of
        ``blocked`` shape where given, else of ``shape``'s blocks."""
        if self.state_dtype != "int8":
            return torch.zeros(shape, device=device,
                               dtype=getattr(torch, self.state_dtype))
        blocked = blocked or blocked_shape(shape)
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
        placed = dict(params.named_parameters())
        named = {n: local_tensor(p) for n, p in placed.items()}
        leaves = local_leaves(params)
        step = state.step + 1
        s = step.to(F32)
        lr = self.lr if self.schedule is None else self.schedule(step)

        dev = named[leaves[0].names[0]].device
        # the squared gradients, piece by piece in leaf order
        pieces = []
        for leaf in leaves:
            for n in leaf.names:
                groups = _shard_groups(placed[n])
                g = local_tensor(grads[n])
                g2 = _rows(g, g.shape[-1] if g.dim() else 1)
                pieces += [(groups, g2, sl) for sl in _pieces(*g2.shape)]
        sq = self._sq_norm(pieces, torch.zeros((), dtype=F32, device=dev))
        gnorm = torch.sqrt(sq)
        scale = torch.clamp(self.clip / torch.clamp(gnorm, min=1e-12),
                            max=1.0) if self.clip else 1.0

        b1c = 1.0 - torch.tensor(self.b1, dtype=F32) ** s
        b2c = 1.0 - torch.tensor(self.b2, dtype=F32) ** s
        b1c, b2c = b1c.to(dev), b2c.to(dev)
        if isinstance(lr, torch.Tensor):
            lr = lr.to(dev)

        layouts = self._layouts(params)
        with torch.no_grad():
            for leaf in leaves:
                lay = layouts.get(leaf.path)
                mode = lay.mode if lay else "local"
                update = {"local": self._update_leaf,
                          "trailing": partial(self._update_trailing, lay),
                          "whole": partial(self._update_whole, lay)}[mode]
                update(leaf, named, grads, state, scale, lr, b1c, b2c)
        return params, AdamWState(step, state.m, state.v), gnorm

    def _sq_norm(self, pieces, sq):
        """``sq`` plus the squared norm of ``pieces`` (groups, rows,
        slice), a placed parameter's pieces summed over the groups of the
        mesh dimensions it is sharded on (so each element counts once
        across shards, and a replicated parameter once, not once per
        rank): each piece's sum into one vector, one all-reduce per group
        of its entries, then added to ``sq`` one after another in the
        pieces' order (so at one rank a placed model's norm has the
        bits of the unplaced one's)."""
        dev = sq.device
        sums = torch.empty(len(pieces), dtype=F32, device=dev)
        by_groups: Dict[tuple, list] = {}
        for i, (groups, g2, sl) in enumerate(pieces):
            self._sq_into(sums, i, g2, sl)
            if groups:
                by_groups.setdefault(groups, []).append(i)
        for groups, idx in by_groups.items():
            sel = torch.tensor(idx, device=dev)
            part = sums.index_select(0, sel)
            for group in groups:
                torch.distributed.all_reduce(part, group=group)
            sums.index_copy_(0, sel, part)
        for i in range(len(pieces)):
            sq = self._add_sum(sq, sums, i)
        return sq

    def _sq_into(self, sums, i: int, g2: torch.Tensor, sl: slice) -> None:
        """``sums[i]`` = the squared sum of rows ``sl`` of ``g2``."""
        sums[i] = torch.sum(torch.square(g2[sl].to(F32)))

    def _add_sum(self, acc, sums, i: int):
        return acc + sums[i]

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
        gs = [local_tensor(grads[n]) for n in leaf.names]
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

    def _update_trailing(self, lay: MomentLayout, leaf: Leaf, named, grads,
                         state, scale, lr, b1c, b2c) -> None:
        """An int8 leaf whose payload keeps its blocks whole across the
        trailing axis that the parameter splits (``lay.mode ==
        "trailing"``): each layer's parameter and gradient gathered
        along that axis (the rank's rows, every column), its rows of the
        moments updated whole, its columns of the parameter kept."""
        entry = lay.spec[-1]
        group = group_of(lay.mesh, entry)
        r = axis_rank(lay.mesh, entry)[0]
        m, v = state.m[leaf.path], state.v[leaf.path]
        decay = len(leaf.shape) >= 2
        for i, n in enumerate(leaf.names):
            t = named[n]
            wide = gather_dim(t, -1, group)
            g = gather_dim(local_tensor(grads[n]), -1, group)
            ms, vs = (Quantized(m.q[i], m.scale[i]),
                      Quantized(v.q[i], v.scale[i])) if leaf.stacked \
                else (m, v)
            self._update_rows(wide, g, ms, vs, scale, lr, b1c, b2c, decay)
            w = t.shape[-1]
            t.copy_(wide.narrow(-1, r * w, w))

    def _update_whole(self, lay: MomentLayout, leaf: Leaf, named, grads,
                      state, scale, lr, b1c, b2c) -> None:
        """An int8 leaf whose payload's blocks are not the local block's
        (flat blocks, split over ``data`` or replicated): the leaf, its
        gradient and its moments gathered whole, updated as on one
        device (:meth:`_update_leaf`), the rank's blocks kept."""
        mesh = lay.mesh
        spec = lay.spec[1:] if leaf.stacked else lay.spec
        whole = {n: unblock(named[n], mesh, spec) for n in leaf.names}
        g = {n: unblock(local_tensor(grads[n]), mesh, spec)
             for n in leaf.names}
        m, v = state.m[leaf.path], state.v[leaf.path]
        mw, vw = (Quantized(*(unblock(t, mesh, lay.qspec) for t in st))
                  for st in (m, v))
        self._update_leaf(leaf._replace(shape=lay.shape), whole, g,
                          AdamWState(None, {leaf.path: mw},
                                     {leaf.path: vw}),
                          scale, lr, b1c, b2c)
        for n in leaf.names:
            named[n].copy_(block_of(whole[n], mesh, spec))
        for dst, src in ((m, mw), (v, vw)):
            for a, b in zip(dst, src):
                a.copy_(block_of(b, mesh, lay.qspec))

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
            self._update_piece(t2, g2, m, v, sl, scale, lr, b1c, b2c, decay)

    def _update_piece(self, t2, g2, m, v, sl: slice, scale, lr, b1c, b2c,
                      decay) -> None:
        """Update rows ``sl`` of ``t2`` and of its state ``m``, ``v`` in
        place (:meth:`_update_rows`' rows)."""
        quant = self.state_dtype == "int8"
        p = t2[sl]
        ms = Quantized(m.q[sl], m.scale[sl]) if quant else m[sl]
        vs = Quantized(v.q[sl], v.scale[sl]) if quant else v[sl]
        mf = self._from_state(ms, tuple(p.shape))
        vf = self._from_state(vs, tuple(p.shape), positive=True)
        new_p, mf, vf = self._step(p, g2[sl], mf, vf, scale, lr, b1c, b2c,
                                   decay)
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
