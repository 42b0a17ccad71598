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
