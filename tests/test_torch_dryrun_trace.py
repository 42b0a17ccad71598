"""The dry-run's trace (``repro_torch.launch.dryrun``) and the kernels' ops
it goes through (``repro_torch::flash_attention``, ``::flash_attention_bwd``,
``::ssd_scan``, ``::ssd_scan_bwd``).

* K4 and K5, forward and backward, at three shapes each (K4 one with a
  window and one with Sq != Sk): the ops' fake outputs have the shapes,
  dtypes and strides of the plain versions' outputs on real CPU tensors,
  contiguous as the kernels write them (K4's backward also its lse and
  delta, whole 128-row tiles), and each
  op's FLOP formula equals ``FlopCounterMode``'s count of its plain
  version;
* ``lower_cell`` on every assigned arch, reduced (the moe archs at 16
  experts, so they split over the 16 ranks of ``model``), every
  applicable shape at sequence 64 with its global batch, on the
  production mesh of 256 fake ranks: the card's program (the kernels as
  their ops) and the CPU program (the plain versions) count the same
  FLOPs, ``model_flops`` is the reference's, and the record has the
  reference's keys;
* ``lower_cell``'s optimizer, which traces one row piece of each
  signature and counts it for the rest (``PieceOnceAdamW``), counts the
  FLOPs, bytes, collectives and memory of a trace that runs every piece,
  on five families' train cells with pieces of 4096 elements;
* the trace against real execution: one spawn of 4 gloo ranks
  (``tests/torch_world.py``, case ``dryrun``) runs a reduced qwen3-8b
  prefill on a (2, 2) mesh (the reference's layout: tensor parallelism
  over ``model``), a reduced mamba2-1.3b data-parallel step (batch 256:
  pure data parallelism over both axes) and a reduced llama3-405b
  training step on the reference's layout (FSDP and TP, 4 microbatches,
  block remat; the trace runs the first microbatch and counts it for the
  rest) and a reduced kimi-k2 decode step on a (1, 4) mesh (the cache's
  sequence over ``model``: the flash-decoding combine, rank 0 writing no
  key) for real; rank 0's
  FLOPs, bytes accessed and collectives per kind (count and wire bytes)
  **equal** those of ``lower_cell`` on a fake world of 4 with the same
  mesh; in the same spawn one data-parallel step of the expert-parallel
  reduced deepseek-moe-16b keeps every rank's gradient norm and
  replicated parameters equal, and its gradient norm, parameters and
  experts (gathered) equal one device's step on the same weights, batch
  halves, lr and clip;
* a block recomputed under remat in another thread keeps the forward's
  sharding rules.
"""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from torch._subclasses.fake_tensor import FakeTensorMode  # noqa: E402
from torch.utils.flop_counter import FlopCounterMode  # noqa: E402

from repro.configs import registry as ref_registry  # noqa: E402
from repro.configs.base import ShapeConfig as RefShape  # noqa: E402
from repro.roofline import analysis as ref_analysis  # noqa: E402

from repro_torch.configs import registry  # noqa: E402
from repro_torch.configs.base import (ALL_SHAPES, ShapeConfig,  # noqa: E402
                                      shape_applicable)
from repro_torch.kernels.flash_attention import kernel as fa  # noqa: E402
from repro_torch.kernels.ssd_scan import kernel as sk  # noqa: E402
from repro_torch.launch import dryrun  # noqa: E402

import torch_world  # noqa: E402

#: K4: (B, Sq, Sk, H, K, hd, causal, window, dtype)
K4_CASES = {
    "causal_bf16": (2, 40, 40, 4, 2, 16, True, 0, torch.bfloat16),
    "window": (1, 64, 64, 4, 4, 32, True, 16, torch.float32),
    "cross": (2, 24, 56, 4, 2, 16, False, 0, torch.float32),
}
#: K5: (B, S, nh, P, N, chunk, dtype)
K5_CASES = {
    "ragged_bf16": (2, 100, 3, 16, 16, 32, torch.bfloat16),
    "one_chunk": (1, 64, 2, 32, 16, 64, torch.float32),
    "long_chunk": (2, 130, 4, 16, 32, 128, torch.float32),
}
#: the reduced cells: every shape at this sequence, its batch kept
SEQ = 64
#: the real-execution cells: (arch, shape, mesh)
REAL_CELLS = [("qwen3-8b", ("prefill_32k", 32, 4, "prefill"), (2, 2)),
              ("mamba2-1.3b", ("train_4k", 16, 256, "train"), (2, 2)),
              ("llama3-405b", ("train_4k", 16, 8, "train"), (2, 2)),
              # the sharded decode: the cache's sequence over model 4 (the
              # combine), the experts beside the heads
              ("kimi-k2-1t-a32b", ("decode_32k", 32, 4, "decode"), (1, 4))]


def _k4_inputs(case):
    B, Sq, Sk, H, K, hd, causal, window, dtype = K4_CASES[case]
    rng = np.random.default_rng(0)

    def t(*shape):
        return torch.from_numpy(rng.standard_normal(shape,
                                                    dtype=np.float32)).to(dtype)
    return (t(B, Sq, H, hd), t(B, Sk, K, hd), t(B, Sk, K, hd),
            t(B, Sq, H, hd)), causal, window


def _k5_inputs(case):
    B, S, nh, P, N, chunk, dtype = K5_CASES[case]
    rng = np.random.default_rng(1)
    x = torch.from_numpy(rng.standard_normal((B, S, nh, P),
                                             dtype=np.float32)).to(dtype)
    dt = torch.from_numpy(rng.uniform(1e-3, 0.1, (B, S, nh))
                          .astype(np.float32))
    A = -torch.from_numpy(rng.uniform(0.5, 2.0, nh).astype(np.float32))
    Bm = torch.from_numpy(rng.standard_normal((B, S, N),
                                              dtype=np.float32)).to(dtype)
    Cm = torch.from_numpy(rng.standard_normal((B, S, N),
                                              dtype=np.float32)).to(dtype)
    dy = torch.from_numpy(rng.standard_normal((B, S, nh, P),
                                              dtype=np.float32)).to(dtype)
    dh = torch.from_numpy(rng.standard_normal((B, nh, P, N),
                                              dtype=np.float32))
    return (x, dt, A, Bm, Cm), dy, dh, chunk


def _counted(fn):
    with FlopCounterMode(display=False) as counter:
        out = fn()
    return counter.get_total_flops(), out


def _fake(op, tensors, *args):
    """The op on fake copies of ``tensors``: (its FLOPs, its outputs)."""
    with FakeTensorMode() as mode:
        fakes = [None if t is None else mode.from_tensor(t) for t in tensors]
        return _counted(lambda: op(*fakes, *args))


def _layout(t):
    return tuple(t.shape), t.dtype, t.stride()


def _plain_layout(t):
    """A plain output's layout as the kernel writes it: contiguous (a
    plain version may return a strided view, K4's float32 output with one
    query head per kv head)."""
    return _layout(t.contiguous())


@pytest.mark.parametrize("case", K4_CASES)
@pytest.mark.parametrize("which", ["forward", "backward"])
def test_k4_op_fake_and_flops(case, which):
    (q, k, v, dout), causal, window = _k4_inputs(case)
    if which == "forward":
        want_flops, want = _counted(lambda: fa.flash_attention_plain(
            q, k, v, causal, window))
        flops, got = _fake(torch.ops.repro_torch.flash_attention,
                           (q, k, v), causal, window)
        assert _layout(got) == _plain_layout(want)
    else:
        out = fa.flash_attention_plain(q, k, v, causal, window).contiguous()
        want_flops, want = _counted(lambda: fa.flash_attention_backward_plain(
            q, k, v, out, dout, causal, window))
        flops, got = _fake(torch.ops.repro_torch.flash_attention_bwd,
                           (q, k, v, out, dout), causal, window)
        assert [_layout(t) for t in got[:3]] == \
            [_plain_layout(t) for t in want]
        B, Sq, H, _ = q.shape
        rows = -(-Sq // 128) * 128
        for t in got[3:]:
            assert _layout(t) == ((B, H, rows), torch.float32,
                                  (H * rows, rows, 1))
    assert flops == want_flops > 0


@pytest.mark.parametrize("case", K5_CASES)
@pytest.mark.parametrize("which", ["forward", "backward"])
def test_k5_op_fake_and_flops(case, which):
    args, dy, dh, chunk = _k5_inputs(case)
    if which == "forward":
        want_flops, want = _counted(lambda: sk.ssd_scan_plain(*args, chunk))
        flops, got = _fake(torch.ops.repro_torch.ssd_scan, args, chunk)
    else:
        want_flops, want = _counted(lambda: sk.ssd_scan_backward_plain(
            *args, dy, dh, chunk))
        flops, got = _fake(torch.ops.repro_torch.ssd_scan_bwd,
                           (*args, dy, dh), chunk)
    assert [_layout(t) for t in got] == [_plain_layout(t) for t in want]
    assert flops == want_flops > 0


# ------------------------------------------------------------- every arch


def _reduced(get):
    def cfg(arch):
        c = get(arch)
        if c.moe is not None:
            c = dataclasses.replace(c, moe=dataclasses.replace(
                c.moe, n_experts=16))
        return c
    return cfg


#: the reference's record keys (``repro/launch/dryrun.py:192-203``)
RECORD_KEYS = {f.name for f in dataclasses.fields(
    ref_analysis.RooflineRecord)} | {
    "memory_analysis", "analytic_bytes_per_device", "collective_counts",
    "lower_s", "compile_s", "parallelism"}


@pytest.mark.parametrize("arch", registry.ASSIGNED_ARCHS)
def test_lower_cell_every_arch(arch, monkeypatch):
    monkeypatch.setattr(registry, "get", _reduced(registry.get_reduced))
    cfg, ref_cfg = registry.get(arch), _reduced(ref_registry.get_reduced)(
        arch)
    traced = 0
    for shape in ALL_SHAPES:
        if not shape_applicable(cfg, shape)[0]:
            continue
        shape = dataclasses.replace(shape, seq_len=SEQ)
        card = dryrun.lower_cell(arch, shape, multi_pod=False)
        cpu = dryrun.lower_cell(arch, shape, multi_pod=False, device="cpu")
        assert card["trace"]["flops"] == cpu["trace"]["flops"] > 0, shape
        assert RECORD_KEYS <= set(card), RECORD_KEYS - set(card)
        assert card["compile_s"] == 0.0 and card["chips"] == 256
        ref_shape = RefShape(shape.name, shape.seq_len, shape.global_batch,
                             shape.kind)
        assert card["model_flops"] == cpu["model_flops"] == \
            ref_analysis.model_flops(ref_cfg, ref_shape)
        assert cpu["trace"]["kernel_calls"] == {}
        kernels = card["trace"]["kernel_calls"]
        if shape.kind != "decode":
            attn = cfg.n_heads > 0
            assert bool(kernels.get("flash_attention")) == attn, kernels
            assert bool(kernels.get("ssd_scan")) == \
                (cfg.family in ("ssm", "hybrid")), kernels
        if shape.is_train:
            assert set(kernels) in ({"flash_attention",
                                     "flash_attention_bwd"},
                                    {"ssd_scan", "ssd_scan_bwd"},
                                    {"flash_attention", "flash_attention_bwd",
                                     "ssd_scan", "ssd_scan_bwd"}), kernels
        traced += 1
    assert traced >= 3


#: archs whose train cell walks the optimizer's pieces: dense, moe (its
#: experts DTensor blocks), ssm, hybrid, encdec; int8 moments, and
#: float32 ones (an elementwise state)
PIECE_CELLS = [("qwen3-8b", "int8"), ("deepseek-moe-16b", "int8"),
               ("mamba2-1.3b", "int8"), ("zamba2-1.2b", "int8"),
               ("seamless-m4t-large-v2", "int8"), ("qwen3-8b", "float32")]


@pytest.mark.parametrize("arch,state", PIECE_CELLS,
                         ids=[f"{a}-{s}" for a, s in PIECE_CELLS])
def test_pieces_traced_once_count_as_every_piece(arch, state, monkeypatch):
    """``lower_cell`` traces the first optimizer piece of each signature
    and counts it again for the rest (``PieceOnceAdamW``): its FLOPs,
    bytes accessed, collectives and memory equal those of a trace that
    runs every piece (``AdamW``), with pieces of 4096 elements so that
    every leaf has many."""
    from repro_torch.train import optimizer
    monkeypatch.setattr(registry, "get", _reduced(registry.get_reduced))
    shape = ShapeConfig("train_4k", SEQ, 256, "train")
    # a sharded cell's rank holds a 16th of most leaves (tensor
    # parallelism over model): pieces of 256 elements give it as many
    monkeypatch.setattr(optimizer, "CHUNK", 256 if dryrun.sharded_cell(
        registry.get(arch), shape) else 4096)
    par = registry.default_parallelism(registry.get(arch), shape).replace(
        opt_state_dtype=state)
    added = []
    add = dryrun.Trace.add
    monkeypatch.setattr(dryrun.Trace, "add",
                        lambda self, d: (added.append(1), add(self, d)))
    once = dryrun.lower_cell(arch, shape, multi_pod=False, parallel=par)
    assert len(added) > 100, len(added)
    monkeypatch.setattr(dryrun, "PieceOnceAdamW", optimizer.AdamW)
    every = dryrun.lower_cell(arch, shape, multi_pod=False, parallel=par)
    for k in ("trace", "memory_analysis", "collectives",
              "collective_counts", "wire_bytes_per_dev"):
        assert once[k] == every[k], k


# ------------------------------------------------------- trace = execution


#: the expert-parallel step's batch and optimizer: ``eps`` at the scale of
#: the clipped gradients' elements, so that the clipping, and not only
#: the gradients' signs, reaches the updated parameters
EP_TOKENS = torch.from_numpy(np.random.default_rng(2).integers(
    0, registry.get_reduced("deepseek-moe-16b").vocab_size, (4, 16)))
EP_BATCH = {"tokens": EP_TOKENS, "labels": EP_TOKENS.roll(-1, 1)}
EP_OPT = {"lr": 1e-2, "eps": 1e-3}


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    return torch_world.spawn("dryrun", tmp_path_factory.mktemp("dryrun"),
                             {"cells": REAL_CELLS, "ep_batch": EP_BATCH,
                              "ep_opt": EP_OPT})


@pytest.mark.parametrize("cell", REAL_CELLS, ids=[c[0] for c in REAL_CELLS])
def test_trace_equals_execution(ranks, cell, monkeypatch):
    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh
    from torch.testing._internal.distributed.fake_pg import FakeStore
    arch, shape, mesh_shape = cell
    monkeypatch.setattr(registry, "get", registry.get_reduced)
    dist.init_process_group("fake", store=FakeStore(), rank=0, world_size=4)
    try:
        mesh = init_device_mesh("cpu", mesh_shape,
                                mesh_dim_names=("data", "model"))
        rec = dryrun.lower_cell(arch, ShapeConfig(*shape), multi_pod=False,
                                device="cpu", mesh=mesh)
    finally:
        dist.destroy_process_group()
    want = ranks[0][arch]
    assert rec["trace"]["flops"] == want["flops"] > 0
    assert rec["trace"]["bytes"] == want["bytes"] > 0
    assert rec["collective_counts"] == want["collective_counts"]
    assert rec["collectives"] == want["collectives"]
    if shape[3] == "train":
        assert want["collective_counts"]["all-reduce"] > 0


def test_expert_parallel_dp_step_keeps_ranks_in_step(ranks):
    """One data-parallel step of the expert-parallel moe on a (2, 2)
    mesh (each model rank 4 of the 8 experts, as DTensor blocks): AdamW
    sums the experts' squared gradients over the model axis, so the
    gradient norm, and the clipping, is the whole model's on every rank,
    and the replicated parameters stay bitwise equal on all 4 ranks."""
    steps = [r["ep_step"] for r in ranks]
    assert [s["n_local"] for s in steps] == [4] * 4
    assert len({s["grad_norm"] for s in steps}) == 1
    for s in steps[1:]:
        assert s["replicated"].keys() == steps[0]["replicated"].keys()
        for n, p in s["replicated"].items():
            assert torch.equal(p, steps[0]["replicated"][n]), n


def test_expert_parallel_dp_step_matches_one_device(ranks):
    """The same step on one device: the reduced deepseek-moe-16b from the
    same seed, the mean of the gradients of the two data ranks' halves
    of the batch (each half routed on its own, as each data rank routes
    its own tokens), one ``AdamW.update`` with the same lr and clip.  Its
    gradient norm, its clipped update of every parameter and every
    expert (rank 0's blocks and rank 1's, gathered over ``model``) must
    equal the 4 ranks'; the clip is active (the norm exceeds it)."""
    from repro_torch.models.model import build
    from repro_torch.train.optimizer import AdamW
    got = ranks[0]["ep_step"]
    model = build(registry.get_reduced("deepseek-moe-16b")).init(
        seed=0, dtype=torch.float32, device="cpu").requires_grad_(True)
    names, params = zip(*model.named_parameters())
    halves = [torch.autograd.grad(model.loss(
        {k: v[i:i + 2] for k, v in EP_BATCH.items()}), params)
        for i in (0, 2)]
    grads = {n: (a + b) / 2 for n, a, b in zip(names, *halves)}
    opt = AdamW(**EP_OPT)
    _, _, gnorm = opt.update(grads, opt.init(model), model)
    assert float(gnorm) > opt.clip
    np.testing.assert_allclose(got["grad_norm"], float(gnorm), rtol=1e-6)
    stepped = {**got["replicated"], **got["experts"]}
    assert stepped.keys() == set(names)
    assert len(got["experts"]) == 3 * registry.get_reduced(
        "deepseek-moe-16b").n_layers
    for n, p in model.named_parameters():
        torch.testing.assert_close(stepped[n], p.detach(), rtol=1e-6,
                                   atol=1e-7, msg=n)


def test_remat_recompute_keeps_the_rules():
    """Found by the dry-run on the card: a block recomputed under remat
    in a thread of its own (autograd's device thread, on the card) takes
    the forward's sharding rules, so the expert-parallel moe recomputes
    its expert-parallel branch (its DTensor experts would otherwise reach
    the local branch's products).  One reduced deepseek-moe-16b loss at
    block remat on a fake world of one, its gradient taken in another
    thread, equals the gradient taken in this one."""
    import threading
    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh
    from torch.testing._internal.distributed.fake_pg import FakeStore
    from repro_torch.configs.base import TRAIN_4K, ParallelismConfig
    from repro_torch.distributed.sharding import (distribute_model,
                                                  make_rules, use_rules)
    from repro_torch.models.model import build
    cfg = registry.get_reduced("deepseek-moe-16b")
    dist.init_process_group("fake", store=FakeStore(), rank=0, world_size=1)
    try:
        mesh = init_device_mesh("cpu", (1, 1),
                                mesh_dim_names=("data", "model"))
        rules = make_rules(cfg, TRAIN_4K, ParallelismConfig(ep=True),
                           tp_size=1, dp_size=1, mesh=mesh)
        model = distribute_model(build(cfg).init(seed=0, device="cpu"),
                                 rules).requires_grad_(True)
        tokens = torch.from_numpy(np.random.default_rng(0).integers(
            0, cfg.vocab_size, (2, 16)))
        batch = {"tokens": tokens, "labels": tokens}
        params = list(model.parameters())
        grads = {}

        def grad(key):
            with use_rules(rules):
                loss = model.loss(batch, remat="block")
            thread = threading.Thread(target=lambda: grads.__setitem__(
                key, torch.autograd.grad(loss, params)))
            thread.start()
            thread.join(timeout=120)
            assert not thread.is_alive()

        grad("thread")
        with use_rules(rules):
            grads["here"] = torch.autograd.grad(
                model.loss(batch, remat="block"), params)
    finally:
        dist.destroy_process_group()
    assert len(grads["thread"]) == len(params)
    for a, b in zip(grads["thread"], grads["here"]):
        assert torch.equal(a.to_local() if hasattr(a, "to_local") else a,
                           b.to_local() if hasattr(b, "to_local") else b)
