"""K5 SSD scan of the port against the JAX package.

The same inputs, drawn with numpy from a seed, go through the
reference's Pallas ``ssd_scan`` (interpret mode on the CPU, as
``tests/test_kernels.py`` runs it), its oracle ``ssd_ref`` and the
model's XLA path ``models.ssm._ssd_core``, and through the port's CPU
path, the kernel's plain PyTorch version.  Tolerances are the
reference's own (``tests/test_kernels.py:89,110``): 5e-4 in float32 and
5e-2 in bfloat16 against the kernel, 1e-4 against ``_ssd_core``.  The
port's ``dt`` is float32, as the model passes it; in the bfloat16 sweep
it carries the same bfloat16 values.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from repro.kernels.ssd_scan.kernel import ssd_scan as ref_ssd_scan  # noqa: E402
from repro.kernels.ssd_scan.ref import ssd_ref  # noqa: E402
from repro.models.ssm import _ssd_core  # noqa: E402

from repro_torch.kernels.ssd_scan import kernel as ssd_k  # noqa: E402
from repro_torch.kernels.ssd_scan.ops import ssd  # noqa: E402


def _inputs(seed, B, S, nh, P, N):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((B, S, nh, P)).astype(np.float32) * 0.5
    dt = np.log1p(np.exp(rng.standard_normal((B, S, nh)))).astype(np.float32)
    A = (-np.exp(rng.standard_normal(nh) * 0.3)).astype(np.float32)
    Bm = rng.standard_normal((B, S, N)).astype(np.float32) * 0.5
    Cm = rng.standard_normal((B, S, N)).astype(np.float32) * 0.5
    return x, dt, A, Bm, Cm


@pytest.mark.parametrize("S,chunk,P,N", [(64, 16, 8, 16), (128, 32, 16, 32),
                                         (96, 32, 32, 16)])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_plain_matches_pallas_sweep(S, chunk, P, N, dtype):
    x, dt, A, Bm, Cm = _inputs(S * N, 2, S, 3, P, N)
    jdt = jnp.float32 if dtype == "float32" else jnp.bfloat16
    tdt = getattr(torch, dtype)
    xj, dtj, Bj, Cj = (jnp.asarray(a).astype(jdt) for a in (x, dt, Bm, Cm))
    y_r, h_r = ref_ssd_scan(xj, dtj, jnp.asarray(A), Bj, Cj, chunk=chunk)
    y, h = ssd(torch.from_numpy(x).to(tdt),
               torch.from_numpy(np.asarray(dtj, np.float32)),
               torch.from_numpy(A), torch.from_numpy(Bm).to(tdt),
               torch.from_numpy(Cm).to(tdt), chunk=chunk)
    assert ssd_k.ssd_scan.launches == 0           # CPU: plain version
    assert y.dtype == tdt and h.dtype == torch.float32
    tol = 5e-4 if dtype == "float32" else 5e-2
    np.testing.assert_allclose(y.float().numpy(), np.asarray(y_r, np.float32),
                               atol=tol, rtol=tol)
    np.testing.assert_allclose(h.numpy(), np.asarray(h_r), atol=tol,
                               rtol=tol)


def test_plain_matches_model_core():
    arrs = _inputs(3, 1, 64, 2, 8, 16)
    y_m, h_m = _ssd_core(*map(jnp.asarray, arrs), chunk=16)
    y, h = ssd(*map(torch.from_numpy, arrs), chunk=16)
    np.testing.assert_allclose(y.numpy(), np.asarray(y_m), atol=1e-4,
                               rtol=1e-4)
    np.testing.assert_allclose(h.numpy(), np.asarray(h_m), atol=1e-4,
                               rtol=1e-4)


@pytest.mark.parametrize("S,chunk", [(37, 16), (100, 256)])
def test_any_sequence_length_matches_recurrence(S, chunk):
    """The reference asserts S % chunk == 0; the port pads the last chunk
    with dt = 0.  Held to the sequential oracle ``ssd_ref`` (5e-4)."""
    arrs = _inputs(S, 2, S, 3, 8, 16)
    y_r, h_r = ssd_ref(*map(jnp.asarray, arrs))
    y, h = ssd(*map(torch.from_numpy, arrs), chunk=chunk)
    np.testing.assert_allclose(y.numpy(), np.asarray(y_r), atol=5e-4,
                               rtol=5e-4)
    np.testing.assert_allclose(h.numpy(), np.asarray(h_r), atol=5e-4,
                               rtol=5e-4)


def test_wrapper_checks_types_and_shapes():
    x, dt, A, Bm, Cm = map(torch.from_numpy, _inputs(0, 1, 8, 2, 4, 4))
    with pytest.raises(TypeError):
        ssd_k.ssd_scan(x, dt.double(), A, Bm, Cm)
    with pytest.raises(TypeError):
        ssd_k.ssd_scan(x, dt, A, Bm.bfloat16(), Cm)
    with pytest.raises(ValueError, match="do not agree"):
        ssd_k.ssd_scan(x, dt[:, :4].contiguous(), A, Bm, Cm)


# ---- the bf16 tensor-core kernel's arithmetic, emulated on the CPU
def _hi_lo(t, split=True):
    """A float32 operand as the kernel passes it to the bf16 tensor cores:
    hi = bf16(t), lo = bf16(t - hi), the products summed in float32 (hi
    alone when ``split`` is false)."""
    hi = t.bfloat16().float()
    return hi + (t - hi).bfloat16().float() if split else hi


def _k5_tensor_core_emulation(x, dt, A, Bm, Cm, L, split=True):
    """K5's bf16 arithmetic (csrc/ssd_scan.cu, the tc:: kernels) in torch,
    chunk by chunk: C.B^T in float32 from bf16 operands, the decay-masked
    weights W = C.B^T exp(cum_i - cum_j) dt_j (j <= i), u = x dt
    exp(seg - cum_j) and the carried state h each as hi + lo bf16 (or
    rounded once to bf16 when ``split`` is false); x, B and C exact."""
    Bsz, S, nh, P = x.shape
    f = torch.float32
    y = torch.empty((Bsz, S, nh, P), dtype=f)
    h = torch.zeros((Bsz, nh, P, Bm.shape[-1]), dtype=f)
    for s0 in range(0, S, L):
        xc, dtc = x[:, s0:s0 + L].float(), dt[:, s0:s0 + L].float()
        Bc, Cc = Bm[:, s0:s0 + L].float(), Cm[:, s0:s0 + L].float()
        n = xc.shape[1]
        cum = torch.cumsum(dtc * A, dim=1)                 # (B, n, nh)
        seg = cum[:, -1]                                   # (B, nh)
        cb = Cc @ Bc.transpose(1, 2)                       # (B, n, n)
        tril = torch.tril(torch.ones(n, n, dtype=torch.bool))[None, :, :, None]
        diff = cum[:, :, None, :] - cum[:, None, :, :]     # (B, i, j, nh)
        decay = torch.exp(torch.where(tril, diff, torch.zeros(())))
        w = torch.where(tril, cb[..., None] * decay * dtc[:, None], 0.0)
        y_intra = torch.einsum("bijh,bjhp->bihp", _hi_lo(w, split), xc)
        u = xc * (dtc * torch.exp(seg[:, None] - cum))[..., None]
        state = torch.einsum("bjhp,bjn->bhpn", _hi_lo(u, split), Bc)
        y_carried = torch.einsum("bin,bhpn->bihp", Cc, _hi_lo(h, split)) \
            * torch.exp(cum)[..., None]
        y[:, s0:s0 + L] = y_intra + y_carried
        h = h * torch.exp(seg)[..., None, None] + state
    return y.to(x.dtype), h


def _k5_card_inputs():
    """mamba2-1.3b's state width (P 64, N 128) over two chunks of 256,
    from a numpy seed."""
    x, dt, A, Bm, Cm = _inputs(21, 1, 512, 4, 64, 128)
    x, Bm, Cm = (torch.from_numpy(a).bfloat16() for a in (x, Bm, Cm))
    return x, torch.from_numpy(dt), torch.from_numpy(A), Bm, Cm


def test_k5_hi_lo_emulation_holds_the_card_bounds():
    """The hi + lo split of K5's float32 operands keeps it within the
    card's tolerances of its plain version: 5e-4 on h, 5e-2 on y."""
    args = _k5_card_inputs()
    y, h = _k5_tensor_core_emulation(*args, 256)
    y_p, h_p = ssd_k.ssd_scan_plain(*args, 256)
    torch.testing.assert_close(h, h_p, atol=5e-4, rtol=5e-4)
    torch.testing.assert_close(y.float(), y_p.float(), atol=5e-2, rtol=5e-2)


def test_k5_single_bf16_operands_miss_the_state_bound():
    """Rounding W, u and h once to bf16 puts the state ~5e-3 off the
    plain version, beyond the 5e-4 the card holds it to.  Why K5 splits
    them."""
    args = _k5_card_inputs()
    _, h = _k5_tensor_core_emulation(*args, 256, split=False)
    _, h_p = ssd_k.ssd_scan_plain(*args, 256)
    assert not torch.allclose(h, h_p, atol=5e-4, rtol=5e-4)


def test_wrapper_raises_on_a_device_without_a_kernel():
    """A tensor neither on the CPU nor on CUDA takes no path: no kernel,
    no plain fallback."""
    x = torch.zeros((1, 8, 1, 16), device="meta")
    dt = torch.zeros((1, 8, 1), device="meta")
    A = torch.zeros(1, device="meta")
    Bm = torch.zeros((1, 8, 16), device="meta")
    with pytest.raises(ValueError, match="no ssd_scan kernel"):
        ssd_k.ssd_scan(x, dt, A, Bm, Bm)
