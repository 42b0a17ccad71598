"""The reference at tiny sizes against the port's CPU path: the loader's
rows bit for bit, the models' loss and gradients, the int8 AdamW's
payloads; and the chunked SSD against the plain recurrence."""
from __future__ import annotations

import sys
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")
ROOT = Path(__file__).resolve().parents[2]
sys.path[:0] = [str(ROOT), str(ROOT / "src")]

from bench import cells, weights  # noqa: E402
from bench.reference import adamw, images, ssm, train  # noqa: E402
from bench.tests.bench_tiny import TINY_CONFIGS  # noqa: E402


def tiny(name):
    cfg = cells.load_config(name)
    cfg.update(TINY_CONFIGS[name])
    return cfg


def port_model(cfg, named):
    from repro_torch.models.model import build
    model = build(cells.model_config(cfg))
    weights.load(model, named)
    return model


@pytest.mark.parametrize("sid,epoch", [(0, 0), (7, 2), (123_456, 1)])
def test_rows_equal_the_ports_decode_augment_patchify(sid, epoch):
    from repro_torch.data.augment import augment_np
    from repro_torch.data.pipeline import _aug_seed
    from repro_torch.data.synthetic import imagenet_like
    from repro_torch.launch.train import patch_batch
    ds = imagenet_like(n=200_000)
    ref = images.Dataset(n=200_000)
    img = ds.decode(ds.encoded(sid), sid)
    assert np.array_equal(img, ref.decode(sid))
    assert ref.label(sid) == ds.label(sid)
    cfg = cells.model_config(tiny("vit-huge"))
    seeds = [_aug_seed(e, sid) for e in range(epoch, -1, -1)] + [sid ^ 0x5EED]
    assert seeds == images.aug_seeds(sid, epoch)
    for seed, want in zip(seeds, images.row_candidates(
            ref, sid, epoch, cfg.frontend_tokens, cfg.d_model)):
        aug = augment_np(img, ds.crop_hw, np.random.default_rng(seed))
        got = patch_batch({"images": aug[None], "labels": [0]}, cfg)
        assert torch.equal(got["patch_embeds"][0], want)
    ok, _ = images.match_row(ref, sid, epoch, want)
    assert ok
    assert not images.match_row(ref, sid, epoch, want + 1)[0]


def test_chunked_ssd_equals_the_recurrence():
    g = torch.Generator().manual_seed(0)
    b, S, h, p, n = 2, 37, 3, 4, 5
    x = torch.randn(b, S, h, p, generator=g, dtype=torch.float64)
    dt = torch.rand(b, S, h, generator=g, dtype=torch.float64) * 0.5
    A = -torch.rand(h, generator=g, dtype=torch.float64) - 0.1
    Bm = torch.randn(b, S, n, generator=g, dtype=torch.float64)
    Cm = torch.randn(b, S, n, generator=g, dtype=torch.float64)
    state = torch.zeros(b, h, p, n, dtype=torch.float64)
    want = []
    for t in range(S):
        state = state * torch.exp(dt[:, t] * A)[..., None, None] \
            + torch.einsum("bh,bhp,bn->bhpn", dt[:, t], x[:, t], Bm[:, t])
        want.append(torch.einsum("bhpn,bn->bhp", state, Cm[:, t]))
    for chunk in (1, 8, 16, 64):
        got = ssm.ssd(x, dt, A, Bm, Cm, chunk)
        assert torch.allclose(got, torch.stack(want, 1), atol=1e-10)


@pytest.mark.parametrize("name", ["vit-huge", "mamba2-1.3b"])
def test_model_loss_and_gradients_equal_the_ports(name):
    """float32 weights: the reference's loss and each leaf's gradient
    equal the port's CPU path within float32 rounding."""
    cfg = tiny(name)
    specs = train.family(cfg).param_specs(cfg)
    named = weights.make(specs, 5, "cpu", torch.float32)
    g = torch.Generator().manual_seed(1)
    if cfg["family"] == "encoder":
        batch = {"patch_embeds": torch.randn(
            3, cfg["frontend_tokens"], cfg["d_model"], generator=g
            ).to(torch.bfloat16),
            "labels": torch.randint(0, cfg["n_classes"], (3,), generator=g)}
    else:
        toks = torch.randint(0, cfg["vocab_size"], (2, 41), generator=g)
        batch = {"tokens": toks[:, :-1], "labels": toks[:, 1:]}
    model = port_model(cfg, {k: v.clone() for k, v in named.items()})
    model.requires_grad_(True)
    names, params = zip(*model.named_parameters())
    loss = model.loss(batch)
    grads = torch.autograd.grad(loss, params)
    port = train.stack(dict(zip(names, grads)))
    P = train.stack(named)
    ref_loss, ref_grads = train.loss_and_grads(P, cfg, batch,
                                               torch.matmul, rows=1)
    assert abs(float(loss) - ref_loss) < 1e-4 * abs(ref_loss)
    for k, want in ref_grads.items():
        err = float(torch.linalg.vector_norm(port[k] - want))
        assert err <= 1e-4 * float(torch.linalg.vector_norm(want)) + 1e-8, k


def test_int8_adamw_payloads_equal_the_ports():
    """Fed the same gradients, the reference's bf16 parameters and int8
    and uint8 codes equal the port's after each of three steps."""
    from repro_torch.train.optimizer import AdamW
    cfg = tiny("mamba2-1.3b")
    specs = train.family(cfg).param_specs(cfg)
    named = weights.make(specs, 3, "cpu")
    model = port_model(cfg, {k: v.clone() for k, v in named.items()})
    opt = AdamW(lr=3e-4, state_dtype="int8")
    state = opt.init(model)
    ref = adamw.AdamW8(3e-4)
    P = train.stack(named)
    g = torch.Generator().manual_seed(2)
    for _ in range(3):
        grads = {n: torch.randn(p.shape, generator=g) * 1e-2
                 for n, p in model.named_parameters()}
        _, state, _ = opt.update(grads, state, model)
        ref.step(P, train.stack(grads))
        port = train.stack(dict(model.named_parameters()))
        for k in P:
            assert torch.equal(port[k], P[k]), k
            assert torch.equal(state.m[k].q.reshape(-1),
                               ref.m[k][0].reshape(-1)), k
            assert torch.equal(state.v[k].q.reshape(-1),
                               ref.v[k][0].reshape(-1)), k
