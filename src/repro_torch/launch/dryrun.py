"""Dry-run: trace every (arch x shape x mesh) cell of the port, as one rank
of the production world runs it.

    python -m repro_torch.launch.dryrun [--arch all] [--shape all]
        [--mesh single,multi] [--out results/dryrun_torch.json] [--force]
        [--set key=value ...]

The port's twin of ``repro.launch.dryrun``.  The reference lowers and
compiles each cell with XLA over 512 fake host devices, and reads the
compiled program's FLOPs and bytes (``cost_analysis``), its memory
(``memory_analysis``) and its collectives (the HLO).  The port has no
compiler: its dry-run runs the port's own program once, as rank 0 of
the cell's world under the cell's rules, and counts what it does.  Two
programs, by cell (:func:`sharded_cell`):

* the dense and moe families' cells, train, prefill and decode, the
  ssm and hybrid cells whose rules place the SSD heads (tensor
  parallelism: both archs' multi-mesh training, decode and long_500k,
  zamba2's prefill) and the vlm and encdec cells whose rules place the
  attention heads (internvl2's and seamless's multi-mesh training,
  prefill and decode) run the reference's layout, as its ``lower_cell``
  jits them: every parameter, moment and cache block placed by its spec
  (``distribute_model``: FSDP of ``embed`` over ``data``, tensor
  parallelism of the heads, the MLP, the shared experts, the SSD heads,
  the encoder blocks, the cross-attention and the vocab over ``model``,
  the experts over ``model`` beside them; kimi-k2's int8 moments by
  ``_opt_specs``' structured and flat branches), activations laid out
  as the rules say, training through ``train.step.build_train_step``
  with the cell's microbatches and remat, decode with the cache's
  sequence (or the hybrid ring's slots, or the encdec cross cache's
  rows) split where the rules map ``kv_seq`` (the flash-decoding
  combine, ``models/layers.py``);
* every other cell runs the replicated program (the pure data-parallel
  train cells, mamba2's sequence-parallel prefill): the batch and, for
  the ssm prefill, the sequence split, no FSDP or tensor parallelism of
  the parameters; training through
  ``train.dp_shard.build_dp_train_step``, the reference's ``shard_map``
  twin, with no microbatches.

Either is traced so:

* the world: a process group of torch's ``fake`` backend (``FakeStore``,
  from ``torch.testing._internal.distributed.fake_pg``, checked on torch
  2.11 and 2.13) of 256 ranks (16x16, ``("data", "model")``) or 512
  (2x16x16, ``("pod", "data", "model")``), whose collectives move no
  data, and ``launch.mesh.make_production_mesh`` over it;
* the tensors: fake ones (``FakeTensorMode``), so a 1 T-parameter model
  costs no memory.  On ``device=None`` (CUDA, the card's program) K4, K5
  and their backwards enter as their ops (``repro_torch::flash_attention``
  and the rest), whose fake implementations give their outputs' shapes;
  nothing runs, so this needs no card, as the reference's fake host
  devices need no TPU (on a torch built without CUDA, fake CPU tensors
  stand in, :func:`_trace_device`).  ``device="cpu"`` traces the CPU
  program, whose attention and scan are the plain versions;
* the step: training as above, AdamW included (its row pieces of one
  signature traced once and counted for each, :class:`PieceOnceAdamW`;
  the sharded step's microbatches likewise, :class:`MicrobatchOnceStep`);
  prefill ``Model.prefill``; decode ``Model.decode_step`` at the last
  position (``seq_len - 1``): rank 0's trace is rank 0's work, and on a
  cell whose cache's sequence is split over ``model`` the last position
  lies in the last rank's block, so rank 0 writes no key (the other
  ranks' work is not traced in its place).  Each runs under
  ``use_rules(make_rules(...))`` after ``distribute_model``, on the
  inputs' local blocks: under the sharded layout by their whole specs;
  else along the axes the replicated program splits, the batch and the
  rules' ``act_seq`` (the decode cache's sequence and heads whole, as
  the replicated decode reads them);
* the counts: FLOPs by ``torch.utils.flop_counter.FlopCounterMode`` (the
  kernels' ops count their plain versions' products); bytes accessed by
  a dispatch mode, each op's input and output bytes, 0 for a view; the
  collectives by ``roofline.hlo_collectives.record()``; memory from the
  storages live during the step (:class:`Tally`).

The record has the reference's keys.  ``analytic_bytes_per_device`` is
the reference's spec arithmetic over the reference's specs, so it equals
the reference's exactly; on a sharded cell the rank holds exactly those
bytes (``trace["held_bytes"]``, equal float for float), and its traced
memory and collectives are those of the reference's layout run as the
port runs it; on a replicated cell they differ from the reference's
compiled ones.  ``lower_s`` is the trace's seconds; nothing compiles, so
``compile_s`` is 0.0.  The record adds ``trace``: the traced FLOPs and
bytes as counted (``build_record`` puts the analytic FLOPs in their
place where they are under half of them, as the reference does),
``kernel_calls``, the calls of each kernel op, ``layout``
(``"sharded"`` or ``"replicated"``) and ``held_bytes``.

Running a cell raises if the default process group is a real backend
(the trace needs a fake world): the CLI runs in a process of its own.
"""
from __future__ import annotations

import argparse
import contextlib
import contextvars
import json
import os
import time
import traceback
import weakref
from collections import Counter
from functools import partial
from typing import Any, Dict, Optional

import numpy as np
import torch
import torch.distributed as dist
from torch._subclasses.fake_tensor import FakeTensor, FakeTensorMode
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils.flop_counter import FlopCounterMode

from repro_torch.configs import registry
from repro_torch.configs.base import (ALL_SHAPES, SHAPES_BY_NAME,
                                      ParallelismConfig, ShapeConfig,
                                      shape_applicable)
from repro_torch.distributed.sharding import (axis_rank, distribute_model,
                                              in_collective, make_rules,
                                              runs_layout, use_rules)
from repro_torch.kernels.device import as_card
from repro_torch.launch.mesh import make_production_mesh, production_axes
from repro_torch.models.model import build
from repro_torch.models.params import abstract_tree, partition_specs
from repro_torch.roofline import analysis as roofline
from repro_torch.roofline import hlo_collectives
from repro_torch.train import compression
from repro_torch.train.dp_shard import build_dp_train_step
from repro_torch.train.optimizer import (AdamW, AdamWState, Quantized,
                                         local_tensor, param_leaves,
                                         quantized_spec)
from repro_torch.train.step import TrainStep

#: the logical axes of an input that the port's program splits
SPLIT_AXES = ("batch", "act_seq")
#: ops that return an alias of their input without saying so in their
#: schema (``func.is_view`` is false): they move no bytes
_ALIASES = (torch.ops.aten._unsafe_view.default,)


# ---------------------------------------------------------------------------
# Spec arithmetic (the reference's, term for term)
# ---------------------------------------------------------------------------

def _opt_specs(params_specs: Dict[str, tuple], m_abs: Dict, fsdp: bool,
               dp: int) -> Dict:
    """The optimizer moments' specs by reference leaf path: a
    ``Quantized`` state's payload and scales inherit the parameter's spec
    (structured blocks) or shard over ``data`` (the flat fallback, under
    FSDP when the blocks divide); any other state takes the parameter's
    spec."""
    out = {}
    for path, st in m_abs.items():
        spec = params_specs[path]
        if isinstance(st, Quantized):
            qspec = quantized_spec(tuple(st.q.shape), spec, fsdp, dp)
            out[path] = Quantized(qspec, qspec)
        else:
            out[path] = spec
    return out


def _shard_factor(spec, sizes: Dict[str, int]) -> int:
    f = 1
    for ax in spec:
        if ax is None:
            continue
        axes = ax if isinstance(ax, tuple) else (ax,)
        for a in axes:
            f *= sizes[a]
    return f


def _leaves(tree):
    """A tree's leaves in the reference's flatten order: a dict by sorted
    keys (as jax flattens one), the moments' dicts in their own order
    (``param_leaves``', the same), a ``Quantized`` as (q, scale).  A tuple
    is a leaf (a spec)."""
    if isinstance(tree, AdamWState):
        yield from _leaves(tree.step)
        for part in (tree.m, tree.v):
            for v in part.values():
                yield from _leaves(v)
    elif isinstance(tree, Quantized):
        yield from (tree.q, tree.scale)
    elif isinstance(tree, dict):
        for k in sorted(tree):
            yield from _leaves(tree[k])
    else:
        yield tree


def _bytes_per_device(abs_tree, spec_tree, sizes: Dict[str, int]) -> float:
    """Bytes per device of ``abs_tree`` laid out by ``spec_tree``; summed
    in the reference's order and arithmetic (numpy's), so equal to its
    bit for bit."""
    total = 0.0
    for a, s in zip(_leaves(abs_tree), _leaves(spec_tree),
                    strict=True):
        nb = np.prod(tuple(a.shape)) * a.dtype.itemsize
        total += nb / _shard_factor(s, sizes)
    return float(total)


def _cell(arch: str, shape: ShapeConfig, multi_pod: bool,
          parallel: Optional[ParallelismConfig], mesh=None):
    cfg = registry.get(arch)
    parallel = parallel or registry.default_parallelism(cfg, shape)
    sizes = production_axes(multi_pod) if mesh is None \
        else dict(zip(mesh.mesh_dim_names, mesh.shape))
    rules = make_rules(cfg, shape, parallel, multi_pod=multi_pod,
                       tp_size=sizes["model"], dp_size=sizes["data"],
                       mesh=mesh)
    return cfg, parallel, sizes, rules


def analytic_bytes_per_device(arch: str, shape: ShapeConfig, *,
                              multi_pod: bool,
                              parallel: Optional[ParallelismConfig] = None,
                              mesh=None) -> Dict[str, float]:
    """The reference's analytic bytes per device of a cell: parameters,
    then the optimizer state (train) or the decode cache, over their
    specs under the cell's rules on the production mesh's axis sizes (or
    ``mesh``'s).  Spec arithmetic: needs no process group."""
    cfg, parallel, sizes, rules = _cell(arch, shape, multi_pod, parallel,
                                        mesh)
    model = build(cfg)
    defs = model.defs
    p_specs = partition_specs(defs, rules.mapping)
    if shape.is_train:
        opt = AdamW(state_dtype=parallel.opt_state_dtype)
        o_abs = opt.init(model)           # meta moments, the reference's
        flat = {leaf.path: spec for leaf, spec in zip(
            param_leaves(model), _leaves(p_specs), strict=True)}
        m_specs = _opt_specs(flat, o_abs.m, parallel.fsdp, sizes["data"])
        extra = _bytes_per_device(
            o_abs, AdamWState((), m_specs, m_specs), sizes)
    else:
        B, S = shape.global_batch, shape.seq_len
        extra = _bytes_per_device(
            model.abstract_cache(B, S),
            partition_specs(model.cache_defs(B, S), rules.mapping), sizes)
    params = _bytes_per_device(
        model.abstract(getattr(torch, parallel.param_dtype)), p_specs, sizes)
    return {"params": params, "state_or_cache": extra,
            "total": params + extra}


# ---------------------------------------------------------------------------
# The trace's counts
# ---------------------------------------------------------------------------

def _dtensor():
    from torch.distributed.tensor import DTensor
    return DTensor


def _flat(tree, out: list) -> list:
    """``out`` with the tensors of ``tree`` (nested lists, tuples and
    dicts: an op's arguments or results) appended."""
    if isinstance(tree, torch.Tensor):
        out.append(tree)
    elif isinstance(tree, (list, tuple)):
        for t in tree:
            _flat(t, out)
    elif isinstance(tree, dict):
        for t in tree.values():
            _flat(t, out)
    return out


def _tensors(tree):
    """The tensors of ``tree`` (a step's arguments or results), a DTensor
    as its local block."""
    DTensor = _dtensor()
    return [t.to_local() if isinstance(t, DTensor) else t
            for t in _flat(tree, [])]


class Tally(TorchDispatchMode):
    """What a step does, op by op, while the mode is open: ``bytes`` the
    input plus output bytes of every op that returns a tensor and is not a
    view or an alias, ``calls`` the calls of the port's kernel ops by name,
    and memory: ``live`` the bytes of the storages the step's ops made
    that are still alive, ``peak`` the most of them at once.  The same
    counts on real and on fake tensors.  A DTensor op is left to DTensor,
    whose local ops then come through here."""

    def __init__(self):
        super().__init__()
        self.bytes = 0
        self.calls: Counter = Counter()
        self.live = self.peak = 0
        # id of each storage seen -> a weak reference that frees its bytes
        # (None for the arguments')
        self._seen: Dict[int, Any] = {}

    def own(self, tree) -> None:
        """Take the storages of ``tree`` (the step's arguments) as not the
        step's: ops that write into them allocate nothing."""
        for t in _tensors(tree):
            self._seen.setdefault(id(t.untyped_storage()), None)

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        if any(issubclass(t, _dtensor()) for t in types):
            return NotImplemented
        if func.namespace != "c10d" and in_collective():
            # an op a collective's backend issues while it completes
            # (gloo's copies into an all-gather's output at ``wait``): the
            # collective's, not the step's; NCCL and the fake backend
            # issue none
            return func(*args, **kwargs)
        out = func(*args, **kwargs)
        if func.namespace == "repro_torch":
            self.calls[func._opname] += 1
        outs = _flat(out, [])
        # a view moves nothing, nor does ``_unsafe_view`` (an alias its
        # schema does not mark); an op that returns no tensor is a query
        # of metadata (``prim.device``, which a fake tensor dispatches and
        # a real one does not)
        if outs and not func.is_view and func not in _ALIASES:
            for t in _flat(kwargs, _flat(args, outs[:])):
                self.bytes += t.numel() * t.element_size()
            for t in outs:
                self._track(t.untyped_storage())
        return out

    def _track(self, st) -> None:
        key = id(st)
        if key in self._seen:
            return
        nbytes = st.nbytes()

        def free(_, key=key, nbytes=nbytes):
            del self._seen[key]
            self.live -= nbytes

        self._seen[key] = weakref.ref(st, free)
        self.live += nbytes
        if self.live > self.peak:
            self.peak = self.live


#: the :class:`Trace` open in this context, if any
_OPEN: contextvars.ContextVar = contextvars.ContextVar("trace", default=None)


class Trace:
    """The counts of one step: ``with Trace(args) as tr: out = step()``,
    then ``tr.result(out)``.  Opens a ``FlopCounterMode``, the collective
    recorder and a :class:`Tally`, in that order, around the step."""

    def __init__(self, args):
        self.args = args
        self.flops = FlopCounterMode(display=False)
        self.coll = hlo_collectives.record()
        self.tally = Tally()
        self.tally.own(args)

    def __enter__(self) -> "Trace":
        self.t0 = time.monotonic()
        self._modes = contextlib.ExitStack()
        for mode in (self.flops, self.coll, self.tally):
            self._modes.enter_context(mode)
        self._token = _OPEN.set(self)
        return self

    def __exit__(self, *exc):
        _OPEN.reset(self._token)
        self._modes.close()
        self.seconds = time.monotonic() - self.t0
        return False

    def counts(self) -> tuple:
        """The counts so far: FLOPs by module and op, bytes accessed,
        kernel op calls, collectives recorded."""
        return ({m: dict(ops) for m, ops in self.flops.flop_counts.items()},
                self.tally.bytes, Counter(self.tally.calls),
                len(self.coll.records))

    def since(self, before: tuple) -> tuple:
        """What was counted after ``before`` (:meth:`counts`), as
        :meth:`add` takes it."""
        flops, nbytes, calls, n_coll = before
        now = self.flops.flop_counts
        return ({m: {op: n - flops.get(m, {}).get(op, 0)
                     for op, n in ops.items()} for m, ops in now.items()},
                self.tally.bytes - nbytes, self.tally.calls - calls,
                self.coll.records[n_coll:])

    def add(self, delta: tuple) -> None:
        """Count ``delta`` (:meth:`since`) once more."""
        flops, nbytes, calls, records = delta
        for m, ops in flops.items():
            for op, n in ops.items():
                self.flops.flop_counts[m][op] += n
        self.tally.bytes += nbytes
        self.tally.calls.update(calls)
        self.coll.records.extend(records)

    def result(self, out) -> Dict[str, Any]:
        """FLOPs, bytes accessed, collectives, kernel op calls, memory
        (the reference's ``memory_analysis`` names: the arguments' bytes,
        the new outputs' bytes, the peak of the step's own live bytes
        beyond the outputs, and the arguments plus that peak) and the
        seconds."""
        args = _unique_bytes(self.args)
        outputs = _unique_bytes(out, exclude=self.args)
        st = self.coll.analyze()
        return {
            "flops": float(self.flops.get_total_flops()),
            "bytes": float(self.tally.bytes),
            "collectives": dict(st.per_kind_bytes),
            "collective_counts": dict(st.per_kind_count),
            "wire_bytes": st.total_wire_bytes,
            "kernel_calls": dict(self.tally.calls),
            "memory": {
                "argument_size_in_bytes": float(args),
                "output_size_in_bytes": float(outputs),
                "temp_size_in_bytes": float(max(0, self.tally.peak
                                                - outputs)),
                "peak_memory_in_bytes": float(args + self.tally.peak)},
            "seconds": self.seconds,
        }


def _unique_bytes(tree, exclude=None) -> int:
    """Bytes of the distinct storages of ``tree``'s tensors, less those
    of ``exclude``'s."""
    skip = {id(t.untyped_storage()) for t in _tensors(exclude)}
    seen = {}
    for t in _tensors(tree):
        st = t.untyped_storage()
        if id(st) not in skip:
            seen[id(st)] = st.nbytes()
    return sum(seen.values())


def _signature(x, rows: int):
    """What decides the ops of an optimizer piece and their counts: each
    tensor's shape, strides and type, a slice's length in ``rows`` rows, a
    number's type and value."""
    if isinstance(x, torch.Tensor):
        return (tuple(x.shape), x.stride(), x.dtype, x.device.type)
    if isinstance(x, Quantized):
        return tuple(_signature(t, rows) for t in x)
    if isinstance(x, slice):
        return len(range(*x.indices(rows)))
    return (type(x), x)


class PieceOnceAdamW(AdamW):
    """AdamW as the trace runs it.  The update walks every leaf in row
    pieces (``train.optimizer.CHUNK``), tens of thousands of them at
    llama3-405b, and every piece of one signature (:func:`_signature` of
    its arguments) runs the same ops on fake tensors.  So inside a
    :class:`Trace`, on fake tensors, the first piece of each signature is
    traced and each later one counts the first's FLOPs, bytes, kernel
    calls and collectives again (:meth:`Trace.add`) without running.  A
    piece writes in place and leaves no storage behind (a squared sum
    goes into its slot of one vector; adding it to the norm leaves the
    new total, as the total it replaces is freed), so the live bytes and
    their peak are the first piece's.  On real tensors, or outside a
    trace, every piece runs."""

    def __init__(self, *args, **kwargs):
        super().__init__(*args, **kwargs)
        self._seen: Dict[tuple, tuple] = {}

    def _once(self, key, t, run, again):
        tr = _OPEN.get()
        if tr is None or not isinstance(t, FakeTensor):
            return run()
        if key in self._seen:
            tr.add(self._seen[key])
            return again
        before = tr.counts()
        out = run()
        self._seen[key] = tr.since(before)
        return out

    def _sq_into(self, sums, i, g2, sl):
        key = ("sq_into",) + tuple(_signature(x, g2.shape[0])
                                   for x in (sums, g2, sl))
        return self._once(key, g2, partial(super()._sq_into, sums, i, g2, sl),
                          None)

    def _add_sum(self, acc, sums, i):
        key = ("add_sum",) + tuple(_signature(x, 0) for x in (acc, sums))
        return self._once(key, sums, partial(super()._add_sum, acc, sums, i),
                          acc)

    def _update_piece(self, t2, g2, *rest):
        key = ("update",) + tuple(_signature(x, t2.shape[0])
                                  for x in (t2, g2, *rest))
        return self._once(key, t2,
                          partial(super()._update_piece, t2, g2, *rest), None)


class MicrobatchOnceStep(TrainStep):
    """``train.step.TrainStep`` as the trace runs it: every microbatch
    runs the same ops on tensors of the same shapes, so inside a
    :class:`Trace`, on fake tensors, the first is traced and each later
    one counts its FLOPs, bytes, kernel calls and collectives again
    (:meth:`Trace.add`) without running.  A microbatch leaves no storage
    behind (its gradients go into the accumulators, its loss into its
    slot), so the live bytes and their peak are the first's.  On real
    tensors, or outside a trace, every microbatch runs."""

    def microbatch(self, model, params, mb, acc, losses, i):
        tr = _OPEN.get()
        if tr is None or not isinstance(acc[0], FakeTensor):
            return super().microbatch(model, params, mb, acc, losses, i)
        if i == 0:
            before = tr.counts()
            super().microbatch(model, params, mb, acc, losses, i)
            self._first = tr.since(before)
        else:
            tr.add(self._first)


# ---------------------------------------------------------------------------
# One cell
# ---------------------------------------------------------------------------

def _fake_world(n: int) -> bool:
    """Start a fake world of ``n`` ranks when no process group is up
    (True: the caller destroys it); raise when a real one is."""
    if dist.is_initialized():
        if dist.get_backend() != "fake":
            raise RuntimeError(
                f"the dry-run traces on a fake process group, and the "
                f"default group is {dist.get_backend()!r}: run it in a "
                f"process of its own")
        return False
    from torch.testing._internal.distributed.fake_pg import FakeStore
    dist.init_process_group("fake", store=FakeStore(), rank=0, world_size=n)
    return True


class _StaticShapes(TorchDispatchMode):
    """Shapes a fake tensor cannot know, where the port's program fixes
    them: ``bincount(ids, minlength=E)`` of the moe router's expert ids
    (all below E, ``models/moe.py`` ``_route``) has E counts.  Opened in
    the trace's ``FakeTensorMode``, below the counts, which see the op
    as it is."""

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        if func is torch.ops.aten.bincount.default:
            ids, weights = args[0], (args[1] if len(args) > 1 else None)
            minlength = args[2] if len(args) > 2 else kwargs.get(
                "minlength", 0)
            if weights is None and minlength > 0:
                return torch.empty(minlength, dtype=torch.int64,
                                   device=ids.device)
        return func(*args, **kwargs)


def _trace_device(device):
    """The trace's device and the context it runs in.  A torch built
    without CUDA cannot trace fake CUDA tensors: indexing, ``copy_`` and
    autograd's device threads take a CUDA device guard, which such a build
    lacks.  There the card's program is traced on fake CPU tensors inside
    ``kernels.device.as_card()``, which routes them to the kernels' ops as
    CUDA tensors are routed; the program is otherwise the same (no other
    code of the port branches on the device)."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.backends.cuda.is_built():
        return torch.device("cpu"), as_card()
    return dev, contextlib.nullcontext()


def _port_spec(rules, axes, sharded: bool = False) -> tuple:
    """The spec of an input with logical ``axes`` on the port's program:
    the rules' whole spec under the reference's layout (``sharded``),
    else the rules' spec on the axes the replicated program splits, None
    elsewhere."""
    if sharded:
        return rules.spec(*axes)
    return rules.spec(*(a if a in SPLIT_AXES else None for a in axes))


def sharded_cell(cfg, rules) -> bool:
    """Whether a cell of ``rules`` runs the reference's sharded layout
    (every parameter, moment and cache block placed by its spec; the
    training step ``train.step.build_train_step``), by
    ``sharding.runs_layout``: every cell of the dense and moe families,
    decode included; the ssm and hybrid cells whose rules place the SSD
    heads, the vlm, encdec and encoder cells whose rules place the
    attention heads (tensor parallelism).  The others (pure
    data-parallel training: internvl2's, seamless's, mamba2's and
    zamba2's single-mesh train cells; mamba2's sequence-parallel
    prefill) hold every parameter whole, in the reference too, and run
    the replicated program (training through
    ``build_dp_train_step``)."""
    return runs_layout(cfg.family, rules.mapping)


def _local_zeros(dims, dtype, spec, mesh, device) -> torch.Tensor:
    """Zeros of this rank's block of a ``dims`` tensor laid out by
    ``spec`` on ``mesh`` (``sharding.block_of``'s block), made alone: a
    rank holds its block, not a view into the whole."""
    shape = list(dims)
    for d, entry in enumerate(spec):
        n = axis_rank(mesh, entry)[1]
        if shape[d] % n:
            raise ValueError(f"dimension {d} of {tuple(dims)} does not split "
                             f"over {n} ranks of {entry}")
        shape[d] //= n
    return torch.zeros(shape, dtype=dtype, device=device)


def _inputs(model, shape: ShapeConfig, rules, device,
            sharded: bool = False) -> Dict:
    """The batch: zeros of ``input_specs``' shapes and types, this rank's
    block of each."""
    axes = model.batch_logical_axes(shape)
    return {k: _local_zeros(dims, dtype, _port_spec(rules, axes[k], sharded),
                            rules.mesh, device)
            for k, (dims, dtype) in model.input_specs(shape).items()}


def _cache(model, shape: ShapeConfig, rules, device,
           sharded: bool = False) -> Dict:
    """The decode cache: zeros, this rank's block of each along the axes
    the port splits (under the reference's layout, by the cache's whole
    spec; else the batch)."""
    return {name: _local_zeros(d.shape, d.dtype,
                               _port_spec(rules, d.axes, sharded),
                               rules.mesh, device)
            for name, d in model.cache_defs(shape.global_batch,
                                            shape.seq_len).items()}


def held_bytes(args) -> Dict[str, float]:
    """The bytes this rank holds of a step's parameters and of its
    optimizer state (train) or cache (prefill, decode): the local blocks
    of :func:`cell_step`'s arguments, beside the reference's
    ``analytic_bytes_per_device``."""
    params, extra = args[0], args[1] if isinstance(args[1], AdamWState) \
        else args[2]
    p = float(sum(local_tensor(t).numel() * t.element_size()
                  for t in params))
    e = float(sum(t.numel() * t.element_size() for t in _leaves(extra)))
    return {"params": p, "state_or_cache": e, "total": p + e}


def cell_step(model, shape: ShapeConfig, parallel: ParallelismConfig,
              rules, device, optimizer=AdamW, train_step=TrainStep):
    """The cell's step on ``model`` (already placed by
    ``distribute_model``): ``(args, run, note)``, the step's arguments
    (made here: inputs, cache or optimizer state, on ``device``) and a
    thunk that runs it once, to be called under ``use_rules(rules)``.
    Fake or real tensors alike: the card check runs it on real ones to
    hold a trace against.  ``optimizer`` is the class of the training
    step's optimizer (:class:`PieceOnceAdamW` in :func:`lower_cell`),
    ``train_step`` that of the sharded cells' step
    (:class:`MicrobatchOnceStep` there).

    A sharded cell (:func:`sharded_cell`) runs the reference's program:
    training ``train.step.build_train_step`` (the cell's microbatches
    and remat) on this rank's block of the batch, prefill
    ``Model.prefill`` and decode ``Model.decode_step`` on the blocks of
    the batch and of the cache by their specs.  The others run the
    replicated program: training ``build_dp_train_step`` over the rules'
    batch axes on the global batch (each rank takes its block), prefill
    and decode on the batch's blocks with the cache's sequence and heads
    whole."""
    sharded = sharded_cell(model.cfg, rules)
    if shape.is_train:
        opt = optimizer(state_dtype=parallel.opt_state_dtype)
        state = opt.init(model)
        if sharded:
            step = train_step(model, parallel, opt)
            batch = _inputs(model, shape, rules, device, sharded=True)
            return ((list(model.parameters()), state, batch),
                    lambda: step(model, state, batch), "train_step")
        compress = parallel.grad_compression == "int8_ef"
        step = build_dp_train_step(model, opt, rules.mesh, rules.batch_axes,
                                   compress_grads=compress,
                                   remat=parallel.remat)
        ef = compression.init_ef(model) if compress else None
        # the global batch: the step takes its rank's block itself
        batch = {k: torch.zeros(dims, dtype=dtype, device=device)
                 for k, (dims, dtype) in model.input_specs(shape).items()}
        return ((list(model.parameters()), state, ef, batch),
                lambda: step(model, state, ef, batch), "train_step")
    batch = _inputs(model, shape, rules, device, sharded)
    cache = _cache(model, shape, rules, device, sharded)
    args = (list(model.parameters()), batch, cache)
    if shape.kind == "prefill":
        return args, lambda: model.prefill(batch, cache), "prefill_step"
    return args, lambda: model.decode_step(cache, batch["tokens"],
                                           shape.seq_len - 1), "serve_step"


def trace_step(model, shape: ShapeConfig, parallel: ParallelismConfig,
               rules, device, optimizer=AdamW,
               train_step=TrainStep) -> Dict[str, Any]:
    """Run the cell's step (:func:`cell_step`) once under ``rules`` inside
    a :class:`Trace`; returns its counts plus ``note``, the layout it ran
    (``"sharded"``: the reference's, or ``"replicated"``) and the bytes
    of parameters and state or cache this rank held
    (:func:`held_bytes`)."""
    args, run, note = cell_step(model, shape, parallel, rules, device,
                                optimizer, train_step)
    held = held_bytes(args)
    with use_rules(rules), Trace(args) as tr:
        out = run()
    layout = "sharded" if sharded_cell(model.cfg, rules) else "replicated"
    return {**tr.result(out), "note": note, "layout": layout,
            "held_bytes": held}


def lower_cell(arch: str, shape: ShapeConfig, *, multi_pod: bool,
               parallel: Optional[ParallelismConfig] = None, device=None,
               mesh=None) -> Dict:
    """Trace one cell; returns the record dict (or raises).

    ``device=None`` traces the card's program (fake CUDA tensors, K4 and
    K5 as their ops), ``device="cpu"`` the CPU program.  ``mesh=None`` is
    the production mesh over a fake world of 256 or 512 ranks, started
    here when no process group is up and destroyed after; a mesh given is
    used as it is (its world must be a fake one)."""
    dev, route = _trace_device(device)
    started = _fake_world(512 if multi_pod else 256)
    try:
        if mesh is None:
            mesh = make_production_mesh(multi_pod=multi_pod, device=dev.type)
        cfg, parallel, sizes, rules = _cell(arch, shape, multi_pod, parallel,
                                            mesh)
        chips = int(np.prod(list(sizes.values())))
        analytic = analytic_bytes_per_device(arch, shape, multi_pod=multi_pod,
                                             parallel=parallel, mesh=mesh)
        with FakeTensorMode(allow_non_fake_inputs=True), route, \
                _StaticShapes():
            model = build(cfg)
            abstract_tree(model, getattr(torch, parallel.param_dtype), dev)
            distribute_model(model, rules)
            tr = trace_step(model, shape, parallel, rules, dev,
                            PieceOnceAdamW, MicrobatchOnceStep)
    finally:
        if started:
            dist.destroy_process_group()
    rec = roofline.build_record(
        arch=arch, shape=shape, cfg=cfg, mesh_name="x".join(
            str(n) for n in sizes.values()), chips=chips,
        cost={"flops": tr["flops"], "bytes accessed": tr["bytes"]},
        wire_bytes=tr["wire_bytes"], collectives=tr["collectives"],
        note=tr["note"], profile=roofline.H100)
    return {
        **{k: v for k, v in rec.__dict__.items()},
        "memory_analysis": tr["memory"],
        "analytic_bytes_per_device": analytic,
        "collective_counts": tr["collective_counts"],
        "lower_s": tr["seconds"],
        "compile_s": 0.0,
        "parallelism": parallel.__dict__,
        "trace": {k: tr[k] for k in ("flops", "bytes", "kernel_calls",
                                     "layout", "held_bytes")},
    }


# ---------------------------------------------------------------------------
# CLI
# ---------------------------------------------------------------------------

def _overrides(pairs):
    """``--set key=value`` pairs as ParallelismConfig fields, parsed as the
    reference parses them."""
    overrides = {}
    for kv in pairs:
        k, v = kv.split("=", 1)
        cur = getattr(ParallelismConfig(), k)
        overrides[k] = type(cur)(int(v) if isinstance(cur, (bool, int))
                                 and v.isdigit() else v) \
            if not isinstance(cur, bool) else v in ("1", "true", "True")
    return overrides


def main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="all",
                    help="comma list or 'all' (assigned archs)")
    ap.add_argument("--shape", default="all")
    ap.add_argument("--mesh", default="single,multi")
    ap.add_argument("--out", default="results/dryrun_torch.json")
    ap.add_argument("--force", action="store_true")
    ap.add_argument("--set", action="append", default=[], dest="overrides",
                    help="ParallelismConfig override key=value (perf "
                         "hillclimbing), e.g. --set microbatches=8")
    args = ap.parse_args(argv)
    overrides = _overrides(args.overrides)

    archs = list(registry.ASSIGNED_ARCHS) if args.arch == "all" \
        else args.arch.split(",")
    shapes = [s.name for s in ALL_SHAPES] if args.shape == "all" \
        else args.shape.split(",")
    meshes = args.mesh.split(",")

    os.makedirs(os.path.dirname(args.out) or ".", exist_ok=True)
    results: Dict[str, Any] = {}
    if os.path.exists(args.out) and not args.force:
        with open(args.out) as f:
            results = json.load(f)

    for arch in archs:
        cfg = registry.get(arch)
        for sname in shapes:
            shape = SHAPES_BY_NAME[sname]
            ok, why = shape_applicable(cfg, shape)
            for mesh_kind in meshes:
                key = f"{arch}|{sname}|{mesh_kind}"
                if key in results and "error" not in results[key] \
                        and not args.force:
                    print(f"[skip cached] {key}")
                    continue
                if not ok:
                    results[key] = {"skipped": why}
                    print(f"[skip n/a] {key}: {why}")
                    continue
                print(f"[trace] {key} ...", flush=True)
                t0 = time.monotonic()
                try:
                    par = None
                    if overrides:
                        par = registry.default_parallelism(
                            cfg, shape).replace(**overrides)
                    rec = lower_cell(arch, shape,
                                     multi_pod=(mesh_kind == "multi"),
                                     parallel=par)
                    results[key] = rec
                    print(f"  ok in {time.monotonic()-t0:.0f}s "
                          f"bottleneck={rec['bottleneck']} "
                          f"frac={rec['roofline_fraction']:.2f}",
                          flush=True)
                except Exception as e:
                    results[key] = {"error": str(e),
                                    "traceback": traceback.format_exc()}
                    print(f"  FAILED: {e}", flush=True)
                with open(args.out, "w") as f:
                    json.dump(results, f, indent=1, default=str)
    n_ok = sum(1 for v in results.values()
               if "error" not in v and "skipped" not in v)
    n_err = sum(1 for v in results.values() if "error" in v)
    print(f"done: {n_ok} ok, {n_err} failed, "
          f"{len(results) - n_ok - n_err} skipped -> {args.out}")


if __name__ == "__main__":
    main()
