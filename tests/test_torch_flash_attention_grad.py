"""K4's backward: the plain twin ``flash_attention_backward_plain`` against
the reference's autodiff, and the autograd Function ``FlashAttention``.

The reference has no backward kernel: XLA differentiates its attention.
So the port's explicit formula is held against ``jax.vjp`` of the
reference's ``_sdpa`` (``repro/models/layers.py``, the model's path for
short sequences, grouped-query heads read in place) and of the Pallas
kernel's oracle ``attention_ref`` (kv heads repeated, as the reference's
``flash_mha`` does; the repeat's vjp sums a group's gradients).  Inputs
and the output gradient are drawn with numpy from a seed; S is not a
multiple of 64 (the CUDA kernel's tile).  Tolerances, with reasons:

* float32: 2e-5 absolute + 2e-5 relative — the same function summed in
  other orders (measured differences ~1e-6 at gradients of magnitude
  ~5);
* bfloat16: 4e-2 absolute + 4e-2 relative — ``_sdpa`` and
  ``attention_ref`` cast the probabilities to bf16 before ``P V`` and
  XLA's vjp carries bf16 intermediates, where the port computes in
  float32 and rounds once; this is the reference's bf16 kernel
  tolerance (2e-2) doubled for the backward's extra product;
* the autograd Function on the CPU runs exactly the plain backward, so
  it matches it bit for bit, and autograd through the plain forward to
  1e-5 (float32; other summation order).
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.kernels.flash_attention.ref import attention_ref  # noqa: E402
from repro.models.layers import _sdpa, causal_mask  # noqa: E402
from repro_torch.kernels.flash_attention.kernel import (  # noqa: E402
    FlashAttention, flash_attention_backward, flash_attention_backward_plain,
    flash_attention_plain)
from repro_torch.kernels.flash_attention.ops import flash_mha  # noqa: E402

TOL = {"float32": 2e-5, "bfloat16": 4e-2}
_JDT = {"float32": jnp.float32, "bfloat16": jnp.bfloat16}


def _inputs(G, dtype, B=2, S=70, K=2, hd=16, seed=0):
    rng = np.random.default_rng(seed)
    H = K * G
    shapes = ((B, S, H, hd), (B, S, K, hd), (B, S, K, hd), (B, S, H, hd))
    arrs = [rng.standard_normal(s).astype(np.float32) for s in shapes]
    # round through the working type once, so both sides see equal inputs
    ts = [torch.from_numpy(a).to(getattr(torch, dtype)) for a in arrs]
    js = [jnp.asarray(t.float().numpy()).astype(_JDT[dtype]) for t in ts]
    return ts, js


def _port(ts, causal):
    q, k, v, dout = ts
    out = flash_attention_plain(q, k, v, causal).contiguous()
    return [g.float().numpy()
            for g in flash_attention_backward_plain(q, k, v, out, dout,
                                                    causal)]


def _close(got, want, dtype):
    tol = TOL[dtype]
    for g, w in zip(got, want):
        np.testing.assert_allclose(g, np.asarray(w, np.float32), atol=tol,
                                   rtol=tol)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("G", [1, 2, 4])
def test_plain_backward_matches_jax_grad_of_sdpa(G, dtype):
    ts, (q, k, v, dout) = _inputs(G, dtype)
    S = q.shape[1]

    def f(q, k, v):
        return _sdpa(q, k, v, causal_mask(S, S), None)

    _, vjp = jax.vjp(f, q, k, v)
    _close(_port(ts, True), vjp(dout), dtype)


@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("G", [1, 2, 4])
def test_plain_backward_matches_jax_grad_of_attention_ref(G, dtype, causal):
    ts, (q, k, v, dout) = _inputs(G, dtype, S=100, seed=1)

    def f(q, k, v):
        k = jnp.repeat(k, G, axis=2)
        v = jnp.repeat(v, G, axis=2)
        out = attention_ref(*(jnp.swapaxes(t, 1, 2) for t in (q, k, v)),
                            causal=causal)
        return jnp.swapaxes(out, 1, 2)

    _, vjp = jax.vjp(f, q, k, v)
    _close(_port(ts, causal), vjp(dout), dtype)


@pytest.mark.parametrize("G", [1, 2, 4])
def test_plain_backward_matches_autograd_of_plain_forward(G):
    ts, _ = _inputs(G, "float32", seed=2)
    q, k, v = (t.clone().requires_grad_() for t in ts[:3])
    out = flash_attention_plain(q, k, v, True)
    auto = torch.autograd.grad(out, (q, k, v), ts[3])
    mine = flash_attention_backward_plain(*ts[:3], out.detach().contiguous(),
                                          ts[3], True)
    for a, b in zip(auto, mine):
        torch.testing.assert_close(b, a, atol=1e-5, rtol=1e-5)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_autograd_function_runs_the_backward(dtype):
    """``flash_mha`` goes through ``FlashAttention``: gradients reach q,
    k and v, equal to the plain backward, and the backward's launch
    counter stays 0 on the CPU (it counts kernel launches only)."""
    ts, _ = _inputs(2, dtype, seed=3)
    q, k, v = (t.clone().requires_grad_() for t in ts[:3])
    before = flash_attention_backward.launches
    out = flash_mha(q, k, v, causal=True)
    assert out.grad_fn is not None
    grads = torch.autograd.grad(out, (q, k, v), ts[3])
    want = flash_attention_backward_plain(
        *ts[:3], FlashAttention.apply(*ts[:3], True).contiguous(), ts[3],
        True)
    for g, w in zip(grads, want):
        assert g.dtype == w.dtype
        assert torch.equal(g, w)
    assert flash_attention_backward.launches == before


def test_backward_validates_its_arguments():
    ts, _ = _inputs(2, "float32")
    q, k, v, dout = ts
    out = flash_attention_plain(q, k, v, True).contiguous()
    with pytest.raises(ValueError, match="shape"):
        flash_attention_backward(q, k, v, out[:, :10].contiguous(), dout)
    with pytest.raises(TypeError):
        flash_attention_backward(q, k, v, out, dout.double())
