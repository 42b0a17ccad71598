"""End-to-end training loop: the port's twin of ``repro.launch.train``.

Wires the model, the optimizer, the train step and fault tolerance into
one runnable loop:

    PYTHONPATH=src python -m repro_torch.launch.train --arch qwen3-8b \
        --steps 200 --batch 16 --seq 128 [--device cpu]

As in the reference, ``--reduced`` defaults to on and cannot be turned
off, so the CLI trains the smoke-scale config; a full-width model trains
through :func:`train_steps` (``chip_smoke.py`` trains qwen3-8b at its
published widths with it).  The device is CUDA unless ``--device``
names another.

LM archs take the synthetic token stream of :func:`lm_batch_source`.
The reference's image path (``--arch vit-huge``, batches from the
Seneca image pipeline) needs the encoder family, which is not ported:
the registry raises ``NotImplementedError`` naming ROADMAP.md for it.
"""
from __future__ import annotations

import argparse
import os
import tempfile
import time
from typing import Callable, Dict, List

import numpy as np
import torch

from repro_torch.configs import registry
from repro_torch.configs.base import ParallelismConfig
from repro_torch.distributed.ft import FTConfig, ResilientTrainer
from repro_torch.kernels.device import resolve_device
from repro_torch.models.model import Model, build
from repro_torch.train.optimizer import AdamW, warmup_cosine
from repro_torch.train.step import build_train_step


def lm_batch_source(model: Model, batch: int, seq: int,
                    seed: int = 0) -> Callable[[], Dict]:
    """Synthetic-corpus LM batches (deterministic token stream, drawn as
    the reference draws it), on the model's device."""
    rng = np.random.default_rng(seed)
    V = model.cfg.vocab_size
    dev = model.device

    def next_batch():
        toks = rng.integers(0, V, size=(batch, seq + 1), dtype=np.int64)
        return {"tokens": torch.from_numpy(toks[:, :-1].copy()).to(dev),
                "labels": torch.from_numpy(toks[:, 1:].copy()).to(dev)}

    return next_batch


def train_steps(model: Model, opt: AdamW, parallel: ParallelismConfig,
                batch_source: Callable[[], Dict],
                n_steps: int) -> List[Dict]:
    """``n_steps`` of the train step from a fresh optimizer state, with
    no checkpoints (a host snapshot or a checkpoint of an 8 B-parameter
    model and its moments is tens of GB).  Returns one record per step:
    ``loss``, ``grad_norm``, and ``seconds``, the step's host time
    ending after the device has finished it."""
    step = build_train_step(model, parallel, opt)
    state = opt.init(model)
    history = []
    for i in range(n_steps):
        batch = batch_source()
        t0 = time.monotonic()
        model, state, metrics = step(model, state, batch)
        rec = {k: float(v) for k, v in metrics.items()}
        if model.device.type == "cuda":
            torch.cuda.synchronize(model.device)
        rec["seconds"] = time.monotonic() - t0
        rec["step"] = i + 1
        history.append(rec)
    return history


def main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="qwen3-8b",
                    choices=registry.list_archs())
    ap.add_argument("--reduced", action="store_true", default=True)
    ap.add_argument("--steps", type=int, default=200)
    ap.add_argument("--batch", type=int, default=16)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--lr", type=float, default=1e-3)
    ap.add_argument("--ckpt-dir", default=os.path.join(
        tempfile.gettempdir(), "repro_torch_train_ckpt"))
    ap.add_argument("--ckpt-every", type=int, default=50)
    ap.add_argument("--microbatches", type=int, default=1)
    ap.add_argument("--device", default=None,
                    help="torch device (default: cuda)")
    args = ap.parse_args(argv)

    cfg = registry.get_reduced(args.arch) if args.reduced \
        else registry.get(args.arch)
    device = resolve_device(args.device)
    model = build(cfg).init(seed=0, device=device)
    print(f"arch={cfg.name} params={model.n_params():,} "
          f"(reduced={args.reduced}) device={device}")

    parallel = ParallelismConfig(microbatches=args.microbatches)
    opt = AdamW(lr=args.lr, state_dtype=parallel.opt_state_dtype,
                schedule=warmup_cosine(args.lr, 20, args.steps))
    opt_state = opt.init(model)
    step = build_train_step(model, parallel, opt)
    source = lm_batch_source(model, args.batch, args.seq)

    trainer = ResilientTrainer(
        step_fn=step, params=model, opt_state=opt_state,
        cfg=FTConfig(ckpt_dir=args.ckpt_dir, ckpt_every=args.ckpt_every),
        batch_source=source)
    t0 = time.monotonic()
    hist = trainer.run(args.steps)
    dt = time.monotonic() - t0
    print(f"{len(hist)} steps in {dt:.1f}s "
          f"({len(hist) * args.batch / max(dt, 1e-9):.1f} samples/s)")
    if hist:
        print(f"loss {hist[0]['loss']:.3f} -> {hist[-1]['loss']:.3f}")


if __name__ == "__main__":
    main()
