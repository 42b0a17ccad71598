"""Fixed-batch training on one GPU: K4's kernels against plain, and by rate.

    python3 scripts/check_training.py [--arch ARCH] [--steps N] [--seed N]
    python3 scripts/check_training.py --floor [--arch ARCH] [--seed N]

Takes the batch ``chip_smoke.py``'s training phase trains ``ARCH``
(default seamless-m4t-large-v2) on (``launch.train.lm_batch_source``'s
first, ``chip_smoke.TRAIN_B`` x ``chip_smoke.TRAIN_S`` tokens), then at
the model's published widths and full depth (random weights from
``--seed``):

1. one loss and gradient (block remat) with K4 and its backward as
   kernels, and again with their plain versions swapped in on the card
   (``plain_k4``), for bf16 and for float32 parameters: the loss's
   difference, and each parameter's gradient's relative difference
   ``|g - g_plain| / |g_plain|`` (the largest three and the median);
2. ``N`` steps of ``launch.train.train_steps`` (block remat) for each
   run of ``RUNS``: int8 moments at several constant rates, at the phase's
   rate with K4's plain versions, with float32 parameters and with
   float32 moments; each run's losses and gradient norms beside ln V,
   the loss of a uniform prediction.

With ``--floor``, instead, the rounding floor of that gradient: from the
bf16 weights, one block-remat gradient each with K4's kernels and with
its plain versions in bf16, and with the kernels, the plain versions and
``scaled_dot_product_attention`` (``sdpa_k4``, another summation order)
in float32 parameters (the same weights, cast).  Per parameter it
prints the relative difference of: kernels against plain in bf16 (the
reading above), plain bf16 against plain float32 (the plain version's own
bf16 floor), kernels in bf16 against plain float32, kernels in float32
against plain float32, and SDPA in float32 against plain float32 (a
float32 floor: two correct summation orders); each as its largest three
and median, and how many parameters' kernel gap exceeds its floor.

Needs one NVIDIA GPU.
"""
from __future__ import annotations

import argparse
import contextlib
import gc
import math
import sys
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))
sys.path.insert(0, str(ROOT / "src"))

import chip_smoke  # noqa: E402
from repro_torch.configs import registry  # noqa: E402
from repro_torch.configs.base import ParallelismConfig  # noqa: E402
from repro_torch.kernels.device import build_all  # noqa: E402
from repro_torch.kernels.flash_attention import kernel as fa  # noqa: E402
from repro_torch.launch.train import lm_batch_source, train_steps  # noqa: E402
from repro_torch.models.model import build  # noqa: E402
from repro_torch.train.optimizer import AdamW  # noqa: E402

#: (label, parameter type, rate, moments, K4 plain)
RUNS = (("bf16, lr 3e-4", torch.bfloat16, 3e-4, "int8", False),
        ("bf16, lr 1e-4", torch.bfloat16, 1e-4, "int8", False),
        ("bf16, lr 3e-5", torch.bfloat16, 3e-5, "int8", False),
        ("bf16, lr 3e-4, K4 plain", torch.bfloat16, 3e-4, "int8", True),
        ("float32 parameters, lr 3e-4", torch.float32, 3e-4, "int8", False),
        ("bf16, lr 3e-4, float32 moments", torch.bfloat16, 3e-4, "float32",
         False))


@contextlib.contextmanager
def plain_k4():
    """Within the block, K4 and its backward take their plain versions on
    the card too (the model reaches both through the kernel module's
    globals)."""
    real = fa.flash_attention, fa.flash_attention_backward
    fa.flash_attention = lambda q, k, v, *, causal=True, window=0: \
        fa.flash_attention_plain(q, k, v, causal, window)
    fa.flash_attention_backward = \
        lambda q, k, v, out, dout, *, causal=True, window=0: \
        fa.flash_attention_backward_plain(q, k, v, out, dout, causal, window)
    try:
        yield
    finally:
        fa.flash_attention, fa.flash_attention_backward = real


@contextlib.contextmanager
def sdpa_k4():
    """Within the block, K4 and its backward are
    ``scaled_dot_product_attention`` and its autograd backward (no
    window)."""
    import torch.nn.functional as F
    real = fa.flash_attention, fa.flash_attention_backward

    def sdpa(q, k, v, causal):
        out = F.scaled_dot_product_attention(
            q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2),
            is_causal=causal, enable_gqa=True)
        return out.transpose(1, 2)

    def forward(q, k, v, *, causal=True, window=0):
        assert not window
        return sdpa(q, k, v, causal).contiguous()

    def backward(q, k, v, out, dout, *, causal=True, window=0):
        assert not window
        with torch.enable_grad():
            q, k, v = (t.detach().requires_grad_() for t in (q, k, v))
            return torch.autograd.grad(sdpa(q, k, v, causal), (q, k, v),
                                       dout)

    fa.flash_attention, fa.flash_attention_backward = forward, backward
    try:
        yield
    finally:
        fa.flash_attention, fa.flash_attention_backward = real


def relative(got, want):
    """{name: |got - want| / |want|} over the parameters."""
    return {n: float((got[n].float() - want[n].float()).norm()
                     / want[n].float().norm().clamp_min(1e-30))
            for n in want}


def summary(rel) -> str:
    top = sorted(((r, n) for n, r in rel.items()), reverse=True)
    return (", ".join(f"{n} {r:.3e}" for r, n in top[:3])
            + f", median {top[len(top) // 2][0]:.3e}")


def floor(args, dev, card, batch) -> None:
    """The ``--floor`` readings (module docstring)."""
    model = make_model(args.arch, dev, args.seed, torch.bfloat16)
    with plain_k4():
        loss_pb, plain_bf16 = gradients(model, batch)
    f32 = make_model(args.arch, dev, args.seed, torch.bfloat16)
    f32.float()
    with plain_k4():
        loss_pf, plain_f32 = gradients(f32, batch)
    loss_kb, got = gradients(model, batch)
    rows = {"kernels bf16 vs plain bf16": relative(got, plain_bf16),
            "kernels bf16 vs plain float32": relative(got, plain_f32)}
    del got, model
    rows["plain bf16 vs plain float32"] = relative(plain_bf16, plain_f32)
    del plain_bf16
    loss_kf, got = gradients(f32, batch)
    rows["kernels float32 vs plain float32"] = relative(got, plain_f32)
    del got
    with sdpa_k4():
        loss_sf, got = gradients(f32, batch)
    rows["SDPA float32 vs plain float32"] = relative(got, plain_f32)
    del got, plain_f32, f32
    gc.collect()
    torch.cuda.empty_cache()
    print(f"{args.arch} one block-remat gradient from the bf16 weights: "
          f"loss kernels bf16 {loss_kb:.6f}, plain bf16 {loss_pb:.6f}, "
          f"kernels float32 {loss_kf:.6f}, plain float32 {loss_pf:.6f}, "
          f"SDPA float32 {loss_sf:.6f} ({card})", flush=True)
    for label, rel in rows.items():
        print(f"{args.arch} gradient relative difference, {label}: "
              f"largest {summary(rel)} over {len(rel)} parameters ({card})",
              flush=True)
    for gap, base in (("kernels bf16 vs plain float32",
                       "plain bf16 vs plain float32"),
                      ("kernels bf16 vs plain bf16",
                       "plain bf16 vs plain float32"),
                      ("kernels float32 vs plain float32",
                       "SDPA float32 vs plain float32")):
        over = sorted(((rows[gap][n] / max(rows[base][n], 1e-30), n)
                       for n in rows[gap]), reverse=True)
        n_over = sum(1 for r, _ in over if r > 1.0)
        print(f"{args.arch} {gap} against {base}: {n_over} of {len(over)} "
              f"parameters above their floor; largest ratios "
              + ", ".join(f"{n} {r:.2f}" for r, n in over[:3])
              + f"; median ratio {over[len(over) // 2][0]:.2f} ({card})",
              flush=True)


def make_model(arch: str, dev, seed: int, dtype):
    gen = torch.Generator(device=dev)
    gen.manual_seed(seed)
    return build(registry.get(arch)).init(gen, dtype)


def gradients(model, batch):
    """(loss, {name: gradient}) of one block-remat loss."""
    names, params = zip(*model.named_parameters())
    for p in params:
        p.requires_grad_(True)
    loss = model.loss(batch, remat="block")
    return float(loss.detach()), dict(zip(names,
                                          torch.autograd.grad(loss, params)))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--arch", default="seamless-m4t-large-v2")
    ap.add_argument("--steps", type=int, default=8)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--floor", action="store_true",
                    help="read the gradient's rounding floor only")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("check_training: needs an NVIDIA GPU", file=sys.stderr)
        return 2
    dev = torch.device("cuda")
    card = chip_smoke.card_line()
    print(f"card: {card}", flush=True)
    torch.backends.cuda.matmul.allow_tf32 = False
    build_all()
    cfg = registry.get(args.arch)
    uniform = math.log(cfg.vocab_size)
    if args.floor:
        model = make_model(args.arch, dev, args.seed, torch.bfloat16)
        batch = lm_batch_source(model, chip_smoke.TRAIN_B,
                                chip_smoke.TRAIN_S, args.seed + 2)()
        del model
        floor(args, dev, card, batch)
        return 0
    batch = None
    for dtype in (torch.bfloat16, torch.float32):
        model = make_model(args.arch, dev, args.seed, dtype)
        if batch is None:
            batch = lm_batch_source(model, chip_smoke.TRAIN_B,
                                    chip_smoke.TRAIN_S, args.seed + 2)()
        loss, got = gradients(model, batch)
        with plain_k4():
            loss_p, want = gradients(model, batch)
        rel = sorted(((float((got[n].float() - want[n].float()).norm()
                             / want[n].float().norm().clamp_min(1e-30)), n)
                      for n in want), reverse=True)
        print(f"{args.arch} {dtype} parameters, one block-remat gradient, K4 "
              f"kernels against K4 plain on the card: loss {loss:.6f} "
              f"against {loss_p:.6f}; gradient relative difference largest "
              + ", ".join(f"{n} {r:.3e}" for r, n in rel[:3])
              + f", median {rel[len(rel) // 2][0]:.3e} over {len(rel)} "
              f"parameters ({card})", flush=True)
        del model, got, want
        gc.collect()
        torch.cuda.empty_cache()
    parallel = ParallelismConfig(remat="block")
    for label, dtype, lr, moments, plain in RUNS:
        model = make_model(args.arch, dev, args.seed, dtype)
        opt = AdamW(lr=lr, state_dtype=moments)
        with plain_k4() if plain else contextlib.nullcontext():
            hist = train_steps(model, opt, parallel, lambda: batch,
                               args.steps)
        print(f"{args.arch} {label}: losses "
              f"{[round(h['loss'], 4) for h in hist]} (ln V {uniform:.4f}); "
              f"grad norms {[round(h['grad_norm'], 4) for h in hist]} "
              f"({card})", flush=True)
        del model, opt, hist
        gc.collect()
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
