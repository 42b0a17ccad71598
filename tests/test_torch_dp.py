"""The port's data-parallel trainer and int8 gradient compression against
the reference (``repro_torch.train.{dp_shard,compression}``).

* ``compress`` / ``decompress``: byte-equal int8 codes, equal scales and
  residuals on the reference's 513-element case and a 2-D gradient; the
  port passes the twins of ``tests/test_train.py``'s error-bound and
  error-feedback tests;
* ``allreduce_compressed`` over 4 gloo ranks equals the reference's
  under ``shard_map`` over 4 fake CPU devices (one subprocess with
  ``XLA_FLAGS=--xla_force_host_platform_device_count=4``, as
  ``tests/test_distributed.py`` runs the mesh), on the same four per-rank
  gradients and residuals: the shared scales, the int32 sums of the
  codes, the mean and the residuals, all byte-equal;
* the DP step on 4 ranks, the twin of
  ``test_dp_shard_matches_single_device``: reduced deepseek-7b, batch
  (8, 16), 3 steps, from the reference's parameters, held to the
  reference's single-device ``build_train_step``: in float32 the loss and
  gradient norm within 1e-4 relative and the parameters within 1e-4 (the
  gradients are averaged in another order than one device sums them);
  in bf16 within the reference's own 5e-2; and reduced mamba2-1.3b in
  float32, 2 steps, the ssm family's step (K5's backward on the card);
* compressed DP tracks float32 DP: reduced qwen3-8b, 8 steps, final
  losses within 0.1, the twin of ``test_compressed_dp_tracks_fp32``.

The ranks of one world run every case in one spawn
(``tests/torch_world.py``).
"""
import os
import subprocess
import sys
import textwrap

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs import registry as ref_registry  # noqa: E402
from repro.configs.base import TRAIN_4K as REF_TRAIN_4K  # noqa: E402
from repro.configs.base import ParallelismConfig as RefParallel  # noqa: E402
from repro.models.model import build as ref_build  # noqa: E402
from repro.models.model import make_batch  # noqa: E402
from repro.train import compression as ref_comp  # noqa: E402
from repro.train.optimizer import AdamW as RefAdamW  # noqa: E402
from repro.train.step import build_train_step as ref_step  # noqa: E402

from repro_torch.configs import registry  # noqa: E402
from repro_torch.models.convert import params_from_jax  # noqa: E402
from repro_torch.models.model import build  # noqa: E402
from repro_torch.train import compression  # noqa: E402

import torch_world  # noqa: E402

SRC = os.path.join(os.path.dirname(__file__), "..", "src")
WORLD = 4
_JDT = {"float32": jnp.float32, "bfloat16": jnp.bfloat16}


# ------------------------------------------------------------ compression

def _grad(shape, seed):
    return np.random.default_rng(seed).standard_normal(shape).astype(
        np.float32)


@pytest.mark.parametrize("shape", [(513,), (37, 300)])
def test_compress_codes_byte_equal_reference(shape):
    g = _grad(shape, 1)
    r = _grad(shape, 2) * 1e-3
    q, scale, new_r = compression.compress(torch.from_numpy(g),
                                           torch.from_numpy(r))
    rq, rscale, rnew = ref_comp.compress(jnp.asarray(g), jnp.asarray(r))
    assert q.dtype == torch.int8
    np.testing.assert_array_equal(q.numpy(), np.asarray(rq))
    assert scale.numpy().tobytes() == np.asarray(rscale).tobytes()
    assert new_r.numpy().tobytes() == np.asarray(rnew).tobytes()
    deq = compression.decompress(q, scale, shape)
    rdeq = ref_comp.decompress(rq, rscale, shape)
    assert deq.numpy().tobytes() == np.asarray(rdeq).tobytes()


def test_compression_error_bound():
    """Twin of ``tests/test_train.py::test_compression_error_bound``."""
    g = torch.from_numpy(_grad((513,), 1))
    r = torch.zeros_like(g)
    q, scale, new_r = compression.compress(g, r)
    deq = compression.decompress(q, scale, g.shape)
    assert float(torch.max(torch.abs(deq + new_r - g))) < 1e-5
    assert float(torch.max(torch.abs(new_r))) <= float(
        torch.max(torch.abs(scale))) + 1e-6


def test_error_feedback_is_unbiased_over_steps():
    """Twin of ``tests/test_train.py::test_error_feedback_is_unbiased_over_
    steps``: compressing the same gradient with error feedback transmits
    its full magnitude over time."""
    g = torch.from_numpy(_grad((300,), 2)) * 1e-3
    r = torch.zeros_like(g)
    sent = torch.zeros_like(g)
    for _ in range(50):
        q, s, r = compression.compress(g, r)
        sent = sent + compression.decompress(q, s, g.shape)
    np.testing.assert_allclose((sent / 50).numpy(), g.numpy(), atol=1e-4)


def test_init_ef_keys_and_zeros():
    model = build(registry.get_reduced("qwen3-8b")).init(seed=0,
                                                         device="cpu")
    ef = compression.init_ef(model)
    names = [n for n, _ in model.named_parameters()]
    assert list(ef.residual) == names
    assert all(r.dtype == torch.float32 and not r.any()
               for r in ef.residual.values())


# ------------------------------------------------------------ one world

_AR_SHAPES = {"a": (513,), "b": (37, 21)}


def _allreduce_inputs():
    grads = [{k: torch.from_numpy(_grad(s, 10 * r + i))
              for i, (k, s) in enumerate(_AR_SHAPES.items())}
             for r in range(WORLD)]
    res = [{k: torch.from_numpy(_grad(s, 100 + 10 * r + i) * 1e-2)
            for i, (k, s) in enumerate(_AR_SHAPES.items())}
           for r in range(WORLD)]
    return {"grads": grads, "residuals": res}


def _ref_setup(arch, dtype):
    """The reference's model, parameters and batch (8, 16), and the port's
    parameters converted from them."""
    rm = ref_build(ref_registry.get_reduced(arch))
    params = rm.init(jax.random.key(0), dtype=_JDT[dtype])
    batch = make_batch(jax.random.key(1), rm, REF_TRAIN_4K,
                       reduced_shape=(8, 16))
    pm = params_from_jax(build(registry.get_reduced(arch)),
                         jax.tree.map(np.asarray, params))
    state = {n: p.detach().clone() for n, p in pm.named_parameters()}
    tb = {k: torch.from_numpy(np.array(v)) for k, v in batch.items()}
    return rm, params, batch, state, tb


RUNS = {"f32": ("deepseek-7b", "float32", False, 3),
        "bf16": ("deepseek-7b", "bfloat16", False, 3),
        "qwen_f32dp": ("qwen3-8b", "bfloat16", False, 8),
        "qwen_comp": ("qwen3-8b", "bfloat16", True, 8),
        "ssm_f32": ("mamba2-1.3b", "float32", False, 2)}


@pytest.fixture(scope="module")
def dp_world(tmp_path_factory):
    runs = {}
    for key, (arch, dtype, comp, steps) in RUNS.items():
        *_, state, tb = _ref_setup(arch, dtype)
        runs[key] = {"arch": arch, "state": state, "batch": tb,
                     "compress": comp, "steps": steps}
    inputs = {"allreduce": _allreduce_inputs(), "runs": runs}
    return inputs, torch_world.spawn("dp", tmp_path_factory.mktemp("dp"),
                                     inputs)


_JAX_ALLREDUCE = """
import numpy as np, jax, jax.numpy as jnp
from jax.sharding import Mesh, PartitionSpec as P
from repro.distributed.compat import shard_map
from repro.train import compression as C

d = dict(np.load({path!r}))
keys = {keys!r}
g = {{k: jnp.asarray(d["g_" + k]) for k in keys}}
r = {{k: jnp.asarray(d["r_" + k]) for k in keys}}
mesh = Mesh(np.asarray(jax.devices()[:4]), ("data",))

def local(g, r):
    g = {{k: v[0] for k, v in g.items()}}
    r = {{k: v[0] for k, v in r.items()}}
    mean, ef = C.allreduce_compressed(g, C.EFState(r), "data")
    seen = {{}}
    for k in keys:
        # the shared scale and the int32 sum of the codes, as
        # allreduce_compressed computes them
        blocks, n = C._blocks(g[k].astype(jnp.float32) + r[k])
        scale = jax.lax.pmax(
            jnp.max(jnp.abs(blocks), axis=1, keepdims=True) / 127.0, "data")
        q = jnp.clip(jnp.round(blocks / jnp.maximum(scale, 1e-12)),
                     -127, 127).astype(jnp.int8)
        seen[k] = (scale, jax.lax.psum(q.astype(jnp.int32), "data"))
    add = lambda t: jax.tree.map(lambda x: x[None], t)
    return add(mean), add(ef.residual), add(seen)

f = jax.jit(shard_map(local, mesh=mesh, in_specs=(P("data"), P("data")),
                      out_specs=P("data")))
mean, res, seen = f(g, r)
out = {{}}
for k in keys:
    out["mean_" + k] = np.asarray(mean[k])
    out["res_" + k] = np.asarray(res[k])
    out["scale_" + k] = np.asarray(seen[k][0])
    out["total_" + k] = np.asarray(seen[k][1])
np.savez({out!r}, **out)
print("ok")
"""


def test_allreduce_compressed_matches_reference_shard_map(dp_world,
                                                          tmp_path):
    inputs, outs = dp_world
    ar = inputs["allreduce"]
    keys = list(_AR_SHAPES)
    arrays = {}
    for k in keys:
        arrays["g_" + k] = np.stack([ar["grads"][r][k].numpy()
                                     for r in range(WORLD)])
        arrays["r_" + k] = np.stack([ar["residuals"][r][k].numpy()
                                     for r in range(WORLD)])
    np.savez(tmp_path / "in.npz", **arrays)
    env = dict(os.environ, PYTHONPATH=SRC, JAX_PLATFORMS="cpu",
               XLA_FLAGS="--xla_force_host_platform_device_count=4")
    code = _JAX_ALLREDUCE.format(path=str(tmp_path / "in.npz"), keys=keys,
                                 out=str(tmp_path / "out.npz"))
    proc = subprocess.run([sys.executable, "-c", textwrap.dedent(code)],
                          capture_output=True, text=True, env=env,
                          timeout=300)
    assert proc.returncode == 0, proc.stderr[-4000:]
    want = np.load(tmp_path / "out.npz")
    for r, out in enumerate(outs):
        got = out["allreduce"]
        for i, k in enumerate(keys):
            scale, total = got["seen"][2 * i], got["seen"][2 * i + 1]
            assert total.dtype == torch.int32
            assert scale.numpy().tobytes() == want["scale_" + k][r].tobytes()
            np.testing.assert_array_equal(total.numpy(),
                                          want["total_" + k][r])
            assert got["mean"][k].numpy().tobytes() == \
                want["mean_" + k][r].tobytes(), (r, k)
            assert got["residual"][k].numpy().tobytes() == \
                want["res_" + k][r].tobytes(), (r, k)


def _ref_train(arch, dtype, steps):
    rm, params, batch, *_ = _ref_setup(arch, dtype)
    opt = RefAdamW(lr=1e-3)
    step = jax.jit(ref_step(rm, RefParallel(), opt))
    p, s = params, opt.init(params)
    hist = []
    for _ in range(steps):
        p, s, m = step(p, s, batch)
        hist.append({k: float(v) for k, v in m.items()})
    pm = params_from_jax(build(registry.get_reduced(arch)),
                         jax.tree.map(np.asarray, p))
    return hist, {n: q.detach().float() for n, q in pm.named_parameters()}


def test_dp_ranks_agree(dp_world):
    _, outs = dp_world
    for key in RUNS:
        digests = [out[key]["digest"] for out in outs]
        assert all(torch.equal(d, digests[0]) for d in digests), key
        hists = [out[key]["hist"] for out in outs]
        assert all(h == hists[0] for h in hists), key


@pytest.mark.parametrize("key,rtol,atol", [("f32", 1e-4, 1e-4),
                                           ("bf16", None, 5e-2),
                                           ("ssm_f32", 1e-4, 1e-4)])
def test_dp_step_matches_single_device(dp_world, key, rtol, atol):
    arch, dtype, _, steps = RUNS[key]
    want_hist, want = _ref_train(arch, dtype, steps)
    got = dp_world[1][0][key]
    for g, w in zip(got["hist"], want_hist):
        for metric in ("loss", "grad_norm"):
            if rtol is None:
                assert abs(g[metric] - w[metric]) < atol, (metric, g, w)
            else:
                assert abs(g[metric] - w[metric]) <= rtol * abs(w[metric]), \
                    (metric, g, w)
    d = max(float((got["params"][n].float() - want[n]).abs().max())
            for n in want)
    assert d < atol, d


def test_compressed_dp_tracks_fp32(dp_world):
    outs = dp_world[1][0]
    plain = outs["qwen_f32dp"]["hist"][-1]["loss"]
    comp = outs["qwen_comp"]["hist"][-1]["loss"]
    assert np.isfinite(comp) and abs(comp - plain) < 0.1, (comp, plain)
    # the int8 path really changed the updates: it is not the plain path
    assert outs["qwen_comp"]["hist"] != outs["qwen_f32dp"]["hist"]
