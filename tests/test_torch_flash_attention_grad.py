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


# ---- the bf16 tensor-core backward's arithmetic, emulated on the CPU
def _k4_bwd_tensor_core_emulation(q, k, v, out, dout, causal, split_p,
                                  split_ds):
    """K4's bf16 backward (csrc/flash_attention_bwd.cu, the tensor-core
    kernels) in torch: float32 products of the bf16 operands (S = Q K^T,
    dP = dO V^T), lse from the float32 online pass, P = exp(S/sqrt(hd) -
    lse) with masked keys exactly 0, dS = P (dP - D) in float32; P (into
    dV) and dS (into dK and dQ) rounded to one bf16 (``split_*=False``) or
    carried as hi + lo bf16 parts; float32 sums, dK and dQ scaled once,
    one cast at the end."""
    B, S, H, hd = q.shape
    K = k.shape[2]
    G = H // K
    scale = 1.0 / np.sqrt(hd)
    qg = q.float().reshape(B, S, K, G, hd)
    dog = dout.float().reshape(B, S, K, G, hd)
    kf, vf = k.float(), v.float()
    s = torch.einsum("bqkgh,bskh->bkgqs", qg, kf) * scale
    if causal:
        pos = torch.arange(S)
        masked = pos[None, :] > pos[:, None]
    else:
        masked = torch.zeros((S, S), dtype=torch.bool)
    s = s.masked_fill(masked, float("-inf"))
    m = s.amax(-1, keepdim=True)
    lse = m + torch.log(torch.exp(s - m).sum(-1, keepdim=True)
                        .clamp_min(1e-20))
    p = torch.where(masked, torch.zeros(()), torch.exp(s - lse))
    delta = (dog * out.float().reshape(B, S, K, G, hd)).sum(-1)
    dp = torch.einsum("bqkgh,bskh->bkgqs", dog, vf)
    ds = p * (dp - delta.permute(0, 2, 3, 1)[..., None])

    def parts(x, split):
        hi = x.bfloat16().float()
        return hi + (x - hi).bfloat16().float() if split else hi

    pq, dsq = parts(p, split_p), parts(ds, split_ds)
    dq = torch.einsum("bkgqs,bskh->bqkgh", dsq, kf) * scale
    dk = torch.einsum("bkgqs,bqkgh->bskh", dsq, qg) * scale
    dv = torch.einsum("bkgqs,bqkgh->bskh", pq, dog)
    return (dq.reshape(B, S, H, hd).to(q.dtype), dk.to(k.dtype),
            dv.to(v.dtype))


def _k4_within_one_bf16_ulp(out, ref):
    """The card check of the bf16 backward (as of K4): per element
    1e-3 + 2**-7 |x|, relative RMS <= 2**-8."""
    out, ref = out.float(), ref.float()
    rel = float((out - ref).norm() / ref.norm())
    return torch.allclose(out, ref, atol=1e-3, rtol=2.0 ** -7) \
        and rel <= 2.0 ** -8


# qwen3-8b's head width and GQA 4:1, at S 1024 and at a ragged S
_CARD_SHAPES = [(1, 1024, 8, 2, 128), (2, 333, 8, 2, 128)]


def _k4_bwd_card_inputs(B, S, H, K, hd):
    rng = np.random.default_rng(13)
    q, k, v, dout = (torch.from_numpy(rng.standard_normal(s)
                                      .astype(np.float32)).bfloat16()
                     for s in ((B, S, H, hd), (B, S, K, hd), (B, S, K, hd),
                               (B, S, H, hd)))
    out = flash_attention_plain(q, k, v, True).contiguous()
    return q, k, v, out, dout


@pytest.mark.parametrize("shape", _CARD_SHAPES)
def test_k4_bwd_hi_lo_emulation_holds_the_card_bound(shape):
    """P and dS each as hi + lo bf16 parts (two wgmmas per product) keep
    all three gradients within one bf16 ulp of the plain version, the
    bound the card check holds the kernel to."""
    args = _k4_bwd_card_inputs(*shape)
    want = flash_attention_backward_plain(*args, True)
    got = _k4_bwd_tensor_core_emulation(*args, True, split_p=True,
                                        split_ds=True)
    for g, w in zip(got, want):
        assert _k4_within_one_bf16_ulp(g, w)


@pytest.mark.parametrize("split_p,split_ds", [(False, False), (True, False),
                                              (False, True)])
@pytest.mark.parametrize("shape", _CARD_SHAPES)
def test_k4_bwd_single_bf16_emulation_misses_the_card_bound(shape, split_p,
                                                            split_ds):
    """One bf16 rounding of P misses the bound in dV, of dS in dQ or dK:
    gradients near 0 fall beyond 1e-3 + 2**-7 |x|.  Why the kernels
    carry both as hi + lo."""
    args = _k4_bwd_card_inputs(*shape)
    want = flash_attention_backward_plain(*args, True)
    dq, dk, dv = _k4_bwd_tensor_core_emulation(*args, True, split_p=split_p,
                                               split_ds=split_ds)
    if not split_p:
        assert not _k4_within_one_bf16_ulp(dv, want[2])
    if not split_ds:
        assert not (_k4_within_one_bf16_ulp(dq, want[0])
                    and _k4_within_one_bf16_ulp(dk, want[1]))
