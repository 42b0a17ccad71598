"""The port's expert-parallel moe and sequence-parallel SSD against the
reference, in one world of 4 gloo ranks on the CPU
(``tests/torch_world.py``).

* Expert parallelism (``models/moe.py`` under ``make_rules(...,
  ParallelismConfig(ep=True))``), the twin of
  ``test_moe_ep_matches_local_dispatch``: reduced deepseek-moe-16b in
  float32 at capacity factor 100 (no drops, so per-rank capacities
  cannot differ from the local dispatch's), each rank holding only its
  experts (``distribute_model(..., experts_only=True)``: the
  data-parallel step's program, its loss the local mean), on a (2, 2)
  and a (1, 4) mesh of the
  same world.  The gathered logits are held to the reference's local
  forward within its 1e-4.  The aux loss is the mean over the data ranks
  of each rank's batch block's, as the reference's ``pmean`` gives it:
  it is held to the mean of the reference's local aux over the same
  blocks (one block on the (1, 4) mesh: the whole batch's), within
  float32 rounding.
* Sequence-parallel SSD (``models/ssm_sp.py``), the twin of
  ``test_seq_parallel_ssd_matches_local``: reduced mamba2-1.3b's block in
  float32, B 2, S 64 on a (1, 4) mesh (16 rows a rank), against the
  reference's ``ssm_block`` within its 1e-4; and a reduced mamba2-1.3b
  ``Model.forward`` under the rules of ``default_parallelism`` at the
  prefill shape (``act_seq`` -> ``model``), each rank fed its segment of
  the tokens, against the forward without rules, within 1e-4: that
  covers ``transformer._ssm_block``'s routing.

Gradients: each rank's gradient under the EP rules, averaged over the
data ranks, against ``jax.grad`` of the reference's mean loss over the
same data blocks; the SP block's, summed over the ranks, against
``jax.grad`` of the reference's ``ssm_block``.

In process, one rank's dispatch over an expert range (``e_start``,
``n_local``) against the reference's ``_dispatch_local`` on the same
routing, in float32 within 1e-6, with dropping, for each rank of 4, and
the ranges' outputs summed against the dispatch over all experts; and
the SP stages on one device, the sequence cut into 1, 2 and 4 segments
(``ssm_block_in_segments``), against the reference's ``ssm_block``.
"""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs import registry as ref_registry  # noqa: E402
from repro.configs.base import TRAIN_4K as REF_TRAIN_4K  # noqa: E402
from repro.models import moe as ref_moe  # noqa: E402
from repro.models import ssm as ref_ssm  # noqa: E402
from repro.models.model import build as ref_build  # noqa: E402
from repro.models.model import make_batch  # noqa: E402
from repro.models.params import init_params  # noqa: E402

from repro_torch.configs import registry  # noqa: E402
from repro_torch.models import moe  # noqa: E402
from repro_torch.models.convert import params_from_jax  # noqa: E402
from repro_torch.models.model import build  # noqa: E402

import torch_world  # noqa: E402


def test_dispatch_plan_takes_an_expert_range():
    """Experts 1 and 2 of 3, capacity 2: the other expert's assignments
    and the full expert's third go to the overflow row (4)."""
    top_e = torch.tensor([[1, 0], [0, 1], [1, 2], [0, 1]])
    slot, src = moe.dispatch_plan(top_e, 2, 2, e_start=1)
    assert slot.tolist() == [[0, 4], [4, 1], [4, 2], [4, 4]]
    assert src.tolist() == [0, 1, 2, 4]


@pytest.mark.parametrize("rank", range(4))
def test_dispatch_over_an_expert_range_matches_reference(rank):
    E, n_local, k, T, D, F = 8, 2, 2, 24, 16, 12
    rng = np.random.default_rng(rank)
    x = rng.standard_normal((T, D)).astype(np.float32)
    top_e = np.stack([rng.choice(E, k, replace=False) for _ in range(T)])
    top_g = rng.random((T, k)).astype(np.float32)
    we = [rng.standard_normal(s).astype(np.float32) * 0.3
          for s in ((E, D, F), (E, D, F), (E, F, D))]
    cap = 4                     # some experts overflow
    lo = rank * n_local
    want = ref_moe._dispatch_local(
        jnp.asarray(x), jnp.asarray(top_e, jnp.int32), jnp.asarray(top_g),
        lo, n_local, cap, *(jnp.asarray(w[lo:lo + n_local]) for w in we))
    got = moe._dispatch_local(
        torch.from_numpy(x), torch.from_numpy(top_e), torch.from_numpy(top_g),
        cap, *(torch.from_numpy(w[lo:lo + n_local]) for w in we),
        e_start=lo)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0,
                               atol=1e-6)


@pytest.mark.parametrize("n_ranges", [2, 4])
def test_dispatch_over_expert_ranges_sums_to_reference(n_ranges):
    """The ranks' partial outputs, each over its expert range, summed (as
    the expert-parallel all-reduce sums them) against the reference's
    dispatch over all experts, with drops: float32 within 1e-5."""
    E, k, T, D, F = 8, 2, 24, 16, 12
    rng = np.random.default_rng(10 + n_ranges)
    x = rng.standard_normal((T, D)).astype(np.float32)
    top_e = np.stack([rng.choice(E, k, replace=False) for _ in range(T)])
    top_g = rng.random((T, k)).astype(np.float32)
    we = [rng.standard_normal(s).astype(np.float32) * 0.3
          for s in ((E, D, F), (E, D, F), (E, F, D))]
    cap = 4
    want = ref_moe._dispatch_local(
        jnp.asarray(x), jnp.asarray(top_e, jnp.int32), jnp.asarray(top_g),
        0, E, cap, *(jnp.asarray(w) for w in we))
    n_local = E // n_ranges
    got = sum(moe._dispatch_local(
        torch.from_numpy(x), torch.from_numpy(top_e), torch.from_numpy(top_g),
        cap, *(torch.from_numpy(w[lo:lo + n_local]) for w in we), e_start=lo)
        for lo in range(0, E, n_local))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0,
                               atol=1e-5)


def _no_drops(cfg):
    return dataclasses.replace(cfg, moe=dataclasses.replace(
        cfg.moe, capacity_factor=100.0))


def _port_named(cfg, tree):
    """{port parameter name: numpy array} of a reference tree (parameters
    or their gradients)."""
    m = params_from_jax(build(cfg), jax.tree.map(np.asarray, tree))
    return {n: t.detach().numpy() for n, t in m.named_parameters()}


@pytest.fixture(scope="module")
def ref_ep():
    cfg = _no_drops(ref_registry.get_reduced("deepseek-moe-16b"))
    m = ref_build(cfg)
    params = m.init(jax.random.key(0), dtype=jnp.float32)
    batch = make_batch(jax.random.key(1), m, REF_TRAIN_4K,
                       reduced_shape=(4, 16))
    labels = batch.pop("labels")
    logits, aux = m.forward(params, batch)
    halves = [float(m.forward(params, {"tokens": batch["tokens"][i:i + 2]})[1])
              for i in (0, 2)]

    def mean_loss(p, blocks):
        return sum(m.loss(p, {"tokens": batch["tokens"][i:i + n],
                              "labels": labels[i:i + n]})
                   for i, n in blocks) / len(blocks)

    # the gradient of the mean of the data blocks' losses: on (1, 4) one
    # block, the whole batch; on (2, 2) two of two rows
    pcfg = _no_drops(registry.get_reduced("deepseek-moe-16b"))
    grads = {shape: _port_named(pcfg, jax.grad(mean_loss)(params, blocks))
             for shape, blocks in (((1, 4), ((0, 4),)),
                                   ((2, 2), ((0, 2), (2, 2))))}
    return params, np.array(batch["tokens"]), np.asarray(logits), \
        float(aux), halves, np.array(labels), grads


@pytest.fixture(scope="module")
def ref_sp():
    cfg = ref_registry.get_reduced("mamba2-1.3b")
    p = init_params(jax.random.key(0), ref_ssm.ssm_defs(cfg), jnp.float32)
    x = jax.random.normal(jax.random.key(1), (2, 64, cfg.d_model),
                          jnp.float32) * 0.5
    want = ref_ssm.ssm_block(p, x, cfg)
    w = np.random.default_rng(4).standard_normal(
        (2, 64, cfg.d_model)).astype(np.float32)
    gp, gx = jax.grad(lambda p, x: jnp.sum(ref_ssm.ssm_block(p, x, cfg) * w),
                      argnums=(0, 1))(p, x)
    grads = dict({k: np.asarray(v) for k, v in gp.items()}, x=np.asarray(gx))
    m = ref_build(cfg)
    params = m.init(jax.random.key(2), dtype=jnp.float32)
    return p, np.asarray(x), np.asarray(want), params, w, grads


@pytest.fixture(scope="module")
def world(tmp_path_factory, ref_ep, ref_sp):
    params, tokens, *_, labels, _ = ref_ep
    cfg = _no_drops(registry.get_reduced("deepseek-moe-16b"))
    pm = params_from_jax(build(cfg), jax.tree.map(np.asarray, params))
    ep = {"cfg": cfg, "tokens": torch.from_numpy(tokens),
          "labels": torch.from_numpy(labels),
          "state": {n: p.detach().clone()
                    for n, p in pm.named_parameters()}}
    block, x, _, mparams, w, _ = ref_sp
    scfg = registry.get_reduced("mamba2-1.3b")
    sm = params_from_jax(build(scfg), jax.tree.map(np.asarray, mparams))
    toks = np.random.default_rng(3).integers(0, scfg.vocab_size, (2, 64))
    sp = {"cfg": scfg, "x": torch.from_numpy(np.array(x)),
          "w": torch.from_numpy(w),
          "block": {k: torch.from_numpy(np.array(v))
                    for k, v in block.items()},
          "state": {n: p.detach().clone() for n, p in sm.named_parameters()},
          "tokens": torch.from_numpy(toks)}
    return torch_world.spawn("ep_sp", tmp_path_factory.mktemp("ep_sp"),
                             {"ep": ep, "sp": sp})


@pytest.mark.parametrize("shape", [(2, 2), (1, 4)])
def test_moe_ep_matches_local_dispatch(world, ref_ep, shape):
    _, _, want, aux, halves, _, _ = ref_ep
    n_experts = registry.get_reduced("deepseek-moe-16b").moe.n_experts
    for out in world:
        got = out[shape]
        assert got["n_local"] == n_experts // shape[1]
        d = float(np.abs(got["logits"].numpy() - want).max())
        assert d < 1e-4, d
        want_aux = aux if shape[0] == 1 else float(np.mean(halves))
        assert abs(got["aux"] - want_aux) <= 1e-6 * abs(want_aux), \
            (got["aux"], want_aux)


@pytest.mark.parametrize("shape", [(2, 2), (1, 4)])
def test_moe_ep_gradient_matches_reference(world, ref_ep, shape):
    """Each rank's gradient of its block's loss (the router, attention and
    every replicated weight whole, its experts' block), averaged over the
    data ranks and the experts' blocks gathered, against ``jax.grad`` of
    the mean of the reference's local losses over the same blocks: within
    1e-4 of each parameter's largest gradient entry."""
    want = ref_ep[-1][shape]
    for out in world:
        got = out[shape]["grads"]
        assert sorted(got) == sorted(want)
        for n, w in want.items():
            d = float(np.abs(got[n].numpy() - w).max())
            assert d <= 1e-4 * float(np.abs(w).max()), (n, d)


@pytest.mark.parametrize("n", [1, 2, 4])
def test_ssm_block_in_segments_matches_reference(ref_sp, n):
    """The sequence-parallel stages on one device (``ssm_block_in_segments``:
    the halo and the hand-off from the segments before, no collective)
    against the reference's ``ssm_block``, within its 1e-4."""
    from repro_torch.models.ssm_sp import ssm_block_in_segments
    block, x, want, *_ = ref_sp
    cfg = registry.get_reduced("mamba2-1.3b")
    got = ssm_block_in_segments(
        {k: torch.from_numpy(np.array(v)) for k, v in block.items()},
        torch.from_numpy(np.array(x)), cfg, n)
    d = float(np.abs(got.numpy() - want).max())
    assert d < 1e-4, d


def test_seq_parallel_ssd_matches_local(world, ref_sp):
    want = ref_sp[2]
    for out in world:
        d = float(np.abs(out["sp_block"].numpy() - want).max())
        assert d < 1e-4, d


def test_seq_parallel_ssd_gradient_matches_reference(world, ref_sp):
    """The input's gradient gathered over the segments, and the weights'
    summed over the ranks, against ``jax.grad`` of the reference's
    ``ssm_block`` under the same loss: within 1e-4 of each one's largest
    entry."""
    want = ref_sp[-1]
    for out in world:
        got = out["sp_grads"]
        assert sorted(got) == sorted(want)
        for n, w in want.items():
            d = float(np.abs(got[n].numpy() - w).max())
            assert d <= 1e-4 * float(np.abs(w).max()), (n, d)


def test_ssm_forward_under_default_rules_takes_the_sp_path(world):
    for out in world:
        assert out["act_seq"] == "model"
        got, want = out["sp_forward"], out["local_forward"]
        assert got.shape == want.shape
        d = float((got - want).abs().max())
        assert d < 1e-4, d
