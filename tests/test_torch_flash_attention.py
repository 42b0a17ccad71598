"""K4 flash attention of the port against the JAX package.

The same inputs, drawn with numpy from a seed, go through the
reference's Pallas ``flash_attention`` / ``flash_mha`` (interpret mode on
the CPU, as ``tests/test_kernels.py`` runs them) and through the port's
CPU path, the kernel's plain PyTorch version.  The port takes the model
layout (B, S, H, hd); the reference kernel (B, H, S, hd), so the tests
transpose.  Tolerances are the reference's own
(``tests/test_kernels.py:52,69``): 2e-5 in float32 (the same float32
arithmetic summed in another order) and 2e-2 in bfloat16 (one rounding
of the output).
"""
import math

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from repro.kernels.flash_attention.kernel import \
    flash_attention as ref_flash  # noqa: E402
from repro.kernels.flash_attention.ops import flash_mha as ref_mha  # noqa: E402
from repro.kernels.flash_attention.ref import attention_ref  # noqa: E402

from repro_torch.kernels.flash_attention import kernel as fa  # noqa: E402
from repro_torch.kernels.flash_attention.ops import flash_mha  # noqa: E402

DTYPES = {"float32": (jnp.float32, torch.float32),
          "bfloat16": (jnp.bfloat16, torch.bfloat16)}


def _draw(seed, *shapes):
    rng = np.random.default_rng(seed)
    return [rng.standard_normal(s).astype(np.float32) for s in shapes]


def _both(a, dtype):
    jdt, tdt = DTYPES[dtype]
    return jnp.asarray(a).astype(jdt), torch.from_numpy(a).to(tdt)


@pytest.mark.parametrize("S,hd,qb", [(128, 32, 64), (256, 64, 128),
                                     (192, 128, 64)])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("causal", [True, False])
def test_plain_matches_pallas_sweep(S, hd, qb, dtype, causal):
    B, H = 2, 2
    arrs = _draw(S + hd, *[(B, H, S, hd)] * 3)
    (qj, qt), (kj, kt), (vj, vt) = [_both(a, dtype) for a in arrs]
    ref = ref_flash(qj, kj, vj, causal=causal, q_block=qb, k_block=qb)
    out = fa.flash_attention(qt.transpose(1, 2).contiguous(),
                             kt.transpose(1, 2).contiguous(),
                             vt.transpose(1, 2).contiguous(), causal=causal)
    assert out.dtype == DTYPES[dtype][1]
    assert fa.flash_attention.launches == 0        # CPU: plain version
    tol = 2e-5 if dtype == "float32" else 2e-2
    np.testing.assert_allclose(out.transpose(1, 2).float().numpy(),
                               np.asarray(ref, np.float32), atol=tol,
                               rtol=tol)


def test_flash_mha_gqa_matches_reference():
    B, S, H, K, hd = 2, 128, 8, 2, 32
    q, k, v = _draw(0, (B, S, H, hd), (B, S, K, hd), (B, S, K, hd))
    ref = ref_mha(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                  causal=True)
    out = flash_mha(torch.from_numpy(q), torch.from_numpy(k),
                    torch.from_numpy(v), causal=True)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), atol=2e-5,
                               rtol=2e-5)


@pytest.mark.parametrize("S", [1, 77])
def test_any_sequence_length_matches_oracle(S):
    """The reference kernel asserts S % block == 0; the port takes any S.
    Held to the reference's float32 oracle ``attention_ref``."""
    B, H, K, hd = 1, 4, 2, 16
    q, k, v = _draw(S, (B, S, H, hd), (B, S, K, hd), (B, S, K, hd))
    kf, vf = np.repeat(k, H // K, 2), np.repeat(v, H // K, 2)
    ref = attention_ref(*[jnp.asarray(np.swapaxes(a, 1, 2))
                          for a in (q, kf, vf)], causal=True)
    out = flash_mha(*[torch.from_numpy(a) for a in (q, k, v)])
    np.testing.assert_allclose(out.numpy(), np.swapaxes(np.asarray(ref), 1, 2),
                               atol=2e-5, rtol=2e-5)


def test_wrapper_checks_shapes():
    q = torch.zeros((1, 4, 2, 12))
    with pytest.raises(ValueError, match="head_dim"):
        fa.flash_attention(q, q, q)
    q = torch.zeros((1, 4, 3, 16))
    k = torch.zeros((1, 4, 2, 16))
    with pytest.raises(ValueError, match="group"):
        fa.flash_attention(q, k, k)
    with pytest.raises(TypeError):
        fa.flash_attention(q.double(), k.double(), k.double())


# ---- the bf16 tensor-core kernel's arithmetic, emulated on the CPU
def _k4_tensor_core_emulation(q, k, v, causal, split_p, block_k=64):
    """K4's bf16 arithmetic (csrc/flash_attention.cu, flash_tc_kernel) in
    torch: float32 scores of bf16 operands, the online softmax over
    64-key tiles in the log2 domain, masked keys p = 0, P rounded to bf16
    (``split_p=False``) or carried as hi + lo bf16 parts, P V summed in
    float32, one division by max(l, 1e-20), one cast."""
    B, S, H, hd = q.shape
    K = k.shape[2]
    qf = q.float().reshape(B, S, K, H // K, hd).permute(0, 2, 3, 1, 4)
    kf, vf = (t.float().permute(0, 2, 1, 3)[:, :, None] for t in (k, v))
    c = math.log2(math.e) / math.sqrt(hd)
    m = torch.full((B, K, H // K, S, 1), -1e30)
    l = torch.zeros_like(m)
    acc = torch.zeros((B, K, H // K, S, hd))
    rows = torch.arange(S)[:, None]
    for k0 in range(0, S, block_k):
        s = qf @ kf[..., k0:k0 + block_k, :].transpose(-1, -2) * c
        cols = torch.arange(k0, min(k0 + block_k, S))[None, :]
        masked = (cols > rows) if causal else torch.zeros_like(cols > rows)
        s = s.masked_fill(masked, float("-inf"))
        m_new = torch.maximum(m, s.amax(-1, keepdim=True))
        p = torch.where(masked, torch.zeros(()), torch.exp2(s - m_new))
        alpha = torch.exp2(m - m_new)
        l = l * alpha + p.sum(-1, keepdim=True)
        hi = p.bfloat16().float()
        pq = hi + (p - hi).bfloat16().float() if split_p else hi
        acc = acc * alpha + pq @ vf[..., k0:k0 + block_k, :]
        m = m_new
    out = acc / l.clamp_min(1e-20)
    return out.permute(0, 3, 1, 2, 4).reshape(B, S, H, hd).to(q.dtype)


def _k4_card_inputs():
    """qwen3-8b's head width and GQA 4:1 at S 1024, from a numpy seed."""
    arrs = _draw(13, (1, 1024, 8, 128), (1, 1024, 2, 128), (1, 1024, 2, 128))
    return [torch.from_numpy(a).bfloat16() for a in arrs]


def _within_one_bf16_ulp(out, ref):
    """The card check of the bf16 kernel: per element 1e-3 + 2**-7 |x|,
    relative RMS <= 2**-8."""
    out, ref = out.float(), ref.float()
    rel = float((out - ref).norm() / ref.norm())
    return torch.allclose(out, ref, atol=1e-3, rtol=2.0 ** -7) \
        and rel <= 2.0 ** -8


def test_k4_hi_lo_p_emulation_holds_the_card_bound():
    """P as hi + lo bf16 parts (two wgmmas) keeps K4 within one bf16 ulp
    of its plain version, the bound the card check holds it to."""
    q, k, v = _k4_card_inputs()
    ref = fa.flash_attention_plain(q, k, v, True)
    assert _within_one_bf16_ulp(
        _k4_tensor_core_emulation(q, k, v, True, split_p=True), ref)


def test_k4_single_bf16_p_emulation_misses_the_card_bound():
    """One bf16 rounding of P puts outputs near 0 up to 2**-9 |v| off the
    float32 plain version: beyond 1e-3 + 2**-7 |x|.  Why K4 splits P."""
    q, k, v = _k4_card_inputs()
    ref = fa.flash_attention_plain(q, k, v, True)
    assert not _within_one_bf16_ulp(
        _k4_tensor_core_emulation(q, k, v, True, split_p=False), ref)


def test_wrapper_raises_on_a_device_without_a_kernel():
    """A tensor neither on the CPU nor on CUDA takes no path: no kernel,
    no plain fallback."""
    q = torch.zeros((1, 8, 2, 16), device="meta")
    with pytest.raises(ValueError, match="no flash_attention kernel"):
        fa.flash_attention(q, q, q)
