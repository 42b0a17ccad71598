"""K5's backward: the plain twin ``ssd_scan_backward_plain`` against the
reference's autodiff, and the autograd Function ``SsdScan``.

The reference has no backward kernel: XLA differentiates the model's
chunked scan ``repro.models.ssm._ssd_core``.  So the port's explicit
formula is held against ``jax.vjp`` of ``_ssd_core`` (several chunks
per sequence; cotangents for y alone, for the final state alone, and
for both) and, at a ragged S that ``_ssd_core`` does not take, of the
sequential oracle ``ssd_ref``.  Inputs and cotangents are drawn with
numpy from a seed.  Tolerances, with reasons:

* against the reference, float32: atol 1e-4 * max(|want|, 1) and rtol
  1e-4, as ``tests/test_torch_train.py`` holds the model's gradients —
  the same function summed in other orders (dA sums every row's share
  of the scan's gradient, ~1e-6 relative measured);
* the autograd Function on the CPU runs exactly the plain backward, so
  it matches it bit for bit, and autograd through the plain forward to
  1e-5 relative (float32; other summation order);
* the card check's limits (``K5_BWD_RMS``) against a CPU emulation of a
  tensor-core form: hi + lo parts hold them with 3x to spare, one bf16
  rounding of the float32 operands misses them by 4x or more in every
  gradient, one tf32 rounding in dx, dA, dB and dC.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.kernels.ssd_scan.ref import ssd_ref  # noqa: E402
from repro.models.ssm import _ssd_core  # noqa: E402

from repro_torch.kernels.ssd_scan import kernel as ssd_k  # noqa: E402
from repro_torch.kernels.ssd_scan.ops import ssd  # noqa: E402

B, NH, P, N = 2, 4, 16, 16


def _mamba2_dt(rng, shape):
    """dt on mamba2's scale: log-uniform on [1e-3, 0.1], the range its
    dt_bias is drawn for; a state then decays by about e^-0.35 over 16
    rows and passes from chunk to chunk."""
    return np.exp(rng.uniform(np.log(1e-3), np.log(0.1), shape)).astype(
        np.float32)


def _inputs(S, seed, mamba2_dt=False):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((B, S, NH, P)).astype(np.float32) * 0.5
    dt = _mamba2_dt(rng, (B, S, NH)) if mamba2_dt else \
        np.log1p(np.exp(rng.standard_normal((B, S, NH)))).astype(np.float32)
    A = (-np.exp(rng.standard_normal(NH) * 0.3)).astype(np.float32)
    Bm = rng.standard_normal((B, S, N)).astype(np.float32) * 0.5
    Cm = rng.standard_normal((B, S, N)).astype(np.float32) * 0.5
    dy = rng.standard_normal((B, S, NH, P)).astype(np.float32)
    dh = rng.standard_normal((B, NH, P, N)).astype(np.float32)
    return (x, dt, A, Bm, Cm), dy, dh


def _cotangents(which, dy, dh):
    """(dy, dh) for the reference (zeros where unused) and for the port
    (None for an unused final state)."""
    ref = (dy if which != "h" else np.zeros_like(dy),
           dh if which != "y" else np.zeros_like(dh))
    port = (torch.from_numpy(ref[0]),
            None if which == "y" else torch.from_numpy(dh))
    return ref, port


def _close(got, want):
    for g, w in zip(got, want):
        w = np.asarray(w, np.float32)
        scale = float(np.abs(w).max())
        np.testing.assert_allclose(g.numpy(), w, rtol=1e-4,
                                   atol=1e-4 * max(scale, 1.0))


@pytest.mark.parametrize("which", ["y", "h", "both"])
@pytest.mark.parametrize("S,chunk,mamba2_dt", [
    pytest.param(64, 16, False, id="64-16"),
    pytest.param(48, 16, False, id="48-16"),
    pytest.param(128, 16, True, id="128-16-mamba2_dt")])
def test_plain_backward_matches_jax_vjp_of_ssd_core(S, chunk, mamba2_dt,
                                                    which):
    """With dt on mamba2's scale (eight chunks of 16) the state passed
    forward and its gradient passed back reach across chunks (with the
    other inputs they decay by ~e^-12 per chunk), so the inter-chunk
    terms of every gradient are held to the reference too."""
    args, dy, dh = _inputs(S, S + len(which), mamba2_dt)
    (rdy, rdh), (pdy, pdh) = _cotangents(which, dy, dh)
    _, vjp = jax.vjp(lambda *a: _ssd_core(*a, chunk=chunk),
                     *map(jnp.asarray, args))
    want = vjp((jnp.asarray(rdy), jnp.asarray(rdh)))
    got = ssd_k.ssd_scan_backward_plain(*map(torch.from_numpy, args), pdy,
                                        pdh, chunk)
    _close(got, want)


@pytest.mark.parametrize("which", ["y", "both"])
def test_plain_backward_ragged_matches_jax_vjp_of_ssd_ref(which):
    """S 40 with chunk 16: the last chunk is padded (x = B = C = 0, dt =
    0), which ``_ssd_core`` does not take; the sequential recurrence
    ``ssd_ref`` does."""
    args, dy, dh = _inputs(40, 7)
    (rdy, rdh), (pdy, pdh) = _cotangents(which, dy, dh)
    _, vjp = jax.vjp(ssd_ref, *map(jnp.asarray, args))
    want = vjp((jnp.asarray(rdy), jnp.asarray(rdh)))
    got = ssd_k.ssd_scan_backward_plain(*map(torch.from_numpy, args), pdy,
                                        pdh, 16)
    _close(got, want)


@pytest.mark.parametrize("use_h", [False, True])
@pytest.mark.parametrize("S,chunk", [(64, 16), (37, 16)])
def test_function_on_cpu_matches_autograd_through_plain(S, chunk, use_h):
    """``SsdScan.apply`` (the model's path through ``ops.ssd``) on the
    CPU: its gradients are the plain backward's bit for bit, and within
    float32 rounding of autograd through ``ssd_scan_plain``; an unused
    final state reaches the backward as None.  Nothing launches."""
    args, dy, dh = _inputs(S, 3)
    n0, b0 = ssd_k.ssd_scan.launches, ssd_k.ssd_scan_backward.launches
    leaves = [torch.from_numpy(a).requires_grad_() for a in args]
    y, h = ssd(*leaves, chunk=chunk)
    loss = (y * torch.from_numpy(dy)).sum()
    if use_h:
        loss = loss + (h * torch.from_numpy(dh)).sum()
    got = torch.autograd.grad(loss, leaves)
    plain = ssd_k.ssd_scan_backward_plain(
        *map(torch.from_numpy, args), torch.from_numpy(dy),
        torch.from_numpy(dh) if use_h else None, chunk)
    for g, p in zip(got, plain):
        assert torch.equal(g, p)
    leaves = [torch.from_numpy(a).requires_grad_() for a in args]
    y, h = ssd_k.ssd_scan_plain(*leaves, chunk)
    loss = (y * torch.from_numpy(dy)).sum()
    if use_h:
        loss = loss + (h * torch.from_numpy(dh)).sum()
    for g, w in zip(got, torch.autograd.grad(loss, leaves)):
        torch.testing.assert_close(g, w, rtol=1e-5,
                                   atol=1e-5 * float(w.abs().max()))
    assert ssd_k.ssd_scan.launches == n0
    assert ssd_k.ssd_scan_backward.launches == b0


def test_backward_keeps_the_input_types():
    """bf16 x, B, C (the models' type): dx, dB, dC come back in bf16, ddt
    and dA in float32, and equal the float32 formula rounded once."""
    args, dy, _ = _inputs(32, 11)
    x, dt, A, Bm, Cm = map(torch.from_numpy, args)
    bf = [t.to(torch.bfloat16) for t in (x, Bm, Cm, torch.from_numpy(dy))]
    got = ssd_k.ssd_scan_backward(bf[0], dt, A, bf[1], bf[2], bf[3])
    assert [g.dtype for g in got] == [torch.bfloat16, torch.float32,
                                      torch.float32, torch.bfloat16,
                                      torch.bfloat16]
    want = ssd_k.ssd_scan_backward_plain(*(t.float() for t in (
        bf[0], dt, A, bf[1], bf[2], bf[3])))
    for g, w in zip(got, want):
        assert torch.equal(g, w.to(g.dtype))


def test_backward_rejects_mismatched_gradients():
    args, dy, dh = _inputs(16, 0)
    x, dt, A, Bm, Cm = map(torch.from_numpy, args)
    with pytest.raises(ValueError, match="dy"):
        ssd_k.ssd_scan_backward(x, dt, A, Bm, Cm,
                                torch.from_numpy(dy)[:, :8].contiguous())
    with pytest.raises(ValueError, match="dh"):
        ssd_k.ssd_scan_backward(x, dt, A, Bm, Cm, torch.from_numpy(dy),
                                torch.from_numpy(dh)[:, :2].contiguous())
    with pytest.raises(TypeError, match="dh"):
        ssd_k.ssd_scan_backward(x, dt, A, Bm, Cm, torch.from_numpy(dy),
                                torch.from_numpy(dh).double())


# ------------------------------------------------ the card check's limits
#: the card check of K5's backward against its plain version, as a
#: relative RMS by the type a gradient is stored in
#: (chip_smoke.SSD_BWD_RMS)
K5_BWD_RMS = {torch.bfloat16: 5e-4, torch.float32: 2e-4}


def _hi_lo(t):
    hi = t.bfloat16().float()
    return hi + (t - hi).bfloat16().float()


def _tf32(t):
    """Round to nearest on tf32's 10 stored mantissa bits."""
    bits = t.contiguous().view(torch.int32)
    return ((bits + 0x1000) & ~0x1FFF).view(torch.float32)


_ROUNDINGS = {"hi_lo": _hi_lo, "tf32": _tf32,
              "bf16": lambda t: t.bfloat16().float()}


def _k5_bwd_tensor_core_emulation(x, dt, A, Bm, Cm, dy, dh, chunk, rnd):
    """K5's backward as a tensor-core form would run it: the plain
    version's formula, every product's operands passed through ``rnd``
    (a bf16 operand, such as x, dy, B and C of a bf16 call, passes
    unchanged) and summed in float32; the scalings, exponentials and
    scans elementwise in float32."""
    def mm(eq, *ops):
        return torch.einsum(eq, *map(rnd, ops))

    Bsz, S, nh, Pd = x.shape
    chunk, nc, (xc, dtc, Bc, Cc, gc) = ssd_k._chunked(chunk, S, x, dt, Bm,
                                                      Cm, dy)
    a = A.float()
    cum = torch.cumsum(dtc * a, dim=2)
    seg = cum[:, :, -1]
    mask = torch.tril(torch.ones(chunk, chunk, dtype=torch.bool))[
        None, None, :, :, None]
    diff = torch.where(mask, cum[:, :, :, None] - cum[:, :, None], 0.0)
    decay = torch.where(mask, torch.exp(diff), 0.0)
    sdecay = torch.exp(seg[:, :, None] - cum)
    ecum = torch.exp(cum)
    states = mm("bcjn,bcjhp->bchpn", Bc, (sdecay * dtc)[..., None] * xc)
    into = mm("bcihp,bcin->bchpn", ecum[..., None] * gc, Cc)
    h = torch.zeros((Bsz, nh, Pd, Bc.shape[-1]))
    G = torch.zeros_like(h) if dh is None else dh.float()
    h_prev, g_out = [], [None] * nc
    for c in range(nc):
        h_prev.append(h)
        h = h * torch.exp(seg[:, c])[:, :, None, None] + states[:, c]
    for c in reversed(range(nc)):
        g_out[c] = G
        G = G * torch.exp(seg[:, c])[:, :, None, None] + into[:, c]
    h_prev, g_out = torch.stack(h_prev, 1), torch.stack(g_out, 1)
    h_next = torch.cat([h_prev[:, 1:], h[:, None]], 1)

    M = mm("bcin,bcjn->bcij", Cc, Bc)[..., None] * decay
    v = mm("bcijh,bcihp->bcjhp", M, gc) \
        + sdecay[..., None] * mm("bchpn,bcjn->bcjhp", g_out, Bc)
    hg = mm("bchpn,bcihp->bcihn", h_prev, gc)      # H^T g_i
    xv = (xc * v).sum(-1)
    gy = mm("bcijh,bcjhp->bcihp", M, xc * dtc[..., None]) * gc
    dcum = gy.sum(-1) + ecum * (hg * Cc[:, :, :, None]).sum(-1) - dtc * xv
    dcum[:, :, -1] += (g_out * h_next).sum((-2, -1))
    r = torch.flip(torch.cumsum(torch.flip(dcum, [2]), 2), [2])
    W = decay * dtc[:, :, None] * mm("bcihp,bcjhp->bcijh", gc, xc)
    dC = mm("bcijh,bcjn->bcin", W, Bc) + (ecum[..., None] * hg).sum(3)
    dB = mm("bcijh,bcin->bcjn", W, Cc) + ((sdecay * dtc)[..., None] * mm(
        "bchpn,bcjhp->bcjhn", g_out, xc)).sum(3)

    def rows(t):
        return t.reshape(Bsz, nc * chunk, *t.shape[3:])[:, :S]

    return (rows(dtc[..., None] * v).to(x.dtype), rows(xv + a * r),
            (dtc * r).sum((0, 1, 2)), rows(dB).to(Bm.dtype),
            rows(dC).to(Cm.dtype))


def _k5_bwd_card_rows(dtype):
    """The card check's two calls at 8 heads of mamba2-1.3b's widths (P
    64, N 128): bf16 over 512 rows without dh, as the model calls it;
    float32 over 300 rows with dh.  dt on mamba2's scale.  Returns a
    function of a rounding's name: the emulation's relative RMS against
    the plain version and the card check's limit, by gradient."""
    rng = np.random.default_rng(17)
    S = 512 if dtype == torch.bfloat16 else 300

    def t(shape, scale=1.0, dt=dtype):
        return (torch.from_numpy(rng.standard_normal(shape).astype(
            np.float32)) * scale).to(dt)

    x, Bm, Cm = t((1, S, 8, 64), 0.5), t((1, S, 128), 0.5), \
        t((1, S, 128), 0.5)
    dy = t((1, S, 8, 64))
    dt = torch.from_numpy(_mamba2_dt(rng, (1, S, 8)))
    A = t((8,), 0.3, torch.float32).exp().neg()
    dh = t((1, 8, 64, 128), dt=torch.float32) if dtype == torch.float32 \
        else None
    want = ssd_k.ssd_scan_backward_plain(x, dt, A, Bm, Cm, dy, dh, 64)

    def rel(rounding):
        got = _k5_bwd_tensor_core_emulation(x, dt, A, Bm, Cm, dy, dh, 64,
                                            _ROUNDINGS[rounding])
        return {name: (float((g.float() - w.float()).norm()
                             / w.float().norm()), K5_BWD_RMS[w.dtype])
                for name, g, w in zip(("dx", "ddt", "dA", "dB", "dC"), got,
                                      want)}
    return rel


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32],
                         ids=["bf16_inputs", "float32_inputs"])
def test_k5_bwd_hi_lo_emulation_holds_the_card_bound(dtype):
    """Every float32 operand as hi + lo bf16 parts (two products each on
    the tensor cores) keeps every gradient within the card check's
    limit, by 3x or more (at most 1.3e-4 measured): the form a
    tensor-core redesign can take."""
    for name, (rel, limit) in _k5_bwd_card_rows(dtype)("hi_lo").items():
        assert rel <= limit / 3, (name, rel, limit)


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32],
                         ids=["bf16_inputs", "float32_inputs"])
@pytest.mark.parametrize("rounding", ["bf16", "tf32"])
def test_k5_bwd_single_rounding_emulation_misses_the_card_bound(dtype,
                                                               rounding):
    """One rounding of each float32 operand to bf16 puts every gradient
    beyond the card check's limit, by 4x or more (2.0e-3 to 4.3e-3
    measured); one rounding to tf32 puts dx, dA, dB and dC beyond it
    (3.4e-4 to 9.9e-4).  So the check tells either shortcut from the
    float32 sums it holds the kernel to."""
    rel = _k5_bwd_card_rows(dtype)(rounding)
    if rounding == "bf16":
        missed = {n for n, (r, limit) in rel.items() if r > 4 * limit}
        assert missed == set(rel), rel
    else:
        missed = {n for n, (r, limit) in rel.items() if r > limit}
        assert {"dx", "dA", "dB", "dC"} <= missed, rel
