"""vit-huge's fixed-batch training losses at several learning rates.

    python3 scripts/vit_lr_sweep.py [--steps N] [--seed N]

Takes the batch ``chip_smoke.py``'s "training, vit-huge" phase trains on
(the first batch of the loader's device route through
``launch.train.patch_batch``: 256 ImageNet-like crops), then for each
rate trains a fresh vit-huge (published widths, full depth, random bf16
weights from ``--seed``) for ``N`` steps on it through
``launch.train.train_steps`` (block remat, int8 AdamW moments) and
prints the losses and gradient norms.  One AdamW step moves every weight
by about the rate, so over 840 M weights a large rate fits the batch at
once; the phase's ``VIT_LR`` is chosen from this sweep.  Needs one
NVIDIA GPU.
"""
from __future__ import annotations

import argparse
import gc
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
from repro_torch.launch.train import train_steps  # noqa: E402
from repro_torch.train.optimizer import AdamW, warmup_cosine  # noqa: E402

#: constant rates, then the training CLI's schedule (warmup over 20
#: steps to 3e-4)
RATES = (1e-6, 3e-6, 1e-5, 3e-5, 1e-4, 3e-4)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--steps", type=int, default=6)
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("vit_lr_sweep: needs an NVIDIA GPU", file=sys.stderr)
        return 2
    dev = torch.device("cuda")
    print(f"card: {chip_smoke.card_line()}", flush=True)
    build_all()
    cfg = registry.get("vit-huge")
    batch = chip_smoke.first_image_batch(dev, args.seed, cfg)
    print(f"batch: {tuple(batch['patch_embeds'].shape)} patch embeddings, "
          f"{int(batch['labels'].unique().numel())} distinct labels",
          flush=True)
    parallel = ParallelismConfig(remat="block", opt_state_dtype="int8")
    runs = [(f"lr {r:g}", dict(lr=r)) for r in RATES]
    runs.append(("the CLI's warmup to 3e-4 over 20 steps",
                 dict(lr=3e-4, schedule=warmup_cosine(3e-4, 20, 200))))
    for name, kw in runs:
        model = chip_smoke.build_model("vit-huge", dev, args.seed)
        hist = train_steps(model, AdamW(state_dtype="int8", **kw), parallel,
                           lambda: batch, args.steps)
        losses = [round(h["loss"], 4) for h in hist]
        norms = ", ".join(f"{h['grad_norm']:.4g}" for h in hist)
        print(f"{name}: losses {losses}, grad norms [{norms}]", flush=True)
        del model, hist
        gc.collect()
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
