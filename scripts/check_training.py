"""Fixed-batch training on one GPU: K4's kernels against plain, and by rate.

    python3 scripts/check_training.py [--arch ARCH] [--steps N] [--seed N]

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
