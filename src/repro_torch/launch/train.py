"""End-to-end training loop: the port's twin of ``repro.launch.train``.

Wires the Seneca data service (MDP + ODS), the DSI pipeline, the model,
the optimizer, the train step and fault tolerance into one runnable
loop:

    PYTHONPATH=src python -m repro_torch.launch.train --arch qwen3-8b \
        --steps 200 --batch 16 --seq 128 [--device cpu]

As in the reference, ``--reduced`` defaults to on and cannot be turned
off, so the CLI trains the smoke-scale config; a full-width model trains
through :func:`train_steps` (``chip_smoke.py`` trains qwen3-8b at its
published widths with it).  The device is CUDA unless ``--device``
names another.

LM archs take the synthetic token stream of :func:`lm_batch_source`
(with the vlm family's patch embeddings and the encdec family's frame
embeddings drawn as the reference draws them).
The image-model path (``--arch vit-huge``) takes its batches from the
Seneca image pipeline (:func:`image_batch_source`), each turned into
patch embeddings by :func:`patch_batch`.  The pipeline's executor
follows the model's device: on CUDA the device executor, so the images
never leave the card; on the CPU the reference's per-sample executor.
"""
from __future__ import annotations

import argparse
import os
import tempfile
import time
from typing import Callable, Dict, List

import numpy as np
import torch

from repro_torch.api import AZURE_NC96, GB, SenecaServer
from repro_torch.configs import registry
from repro_torch.configs.base import ModelConfig, ParallelismConfig
from repro_torch.data.pipeline import DSIPipeline
from repro_torch.data.storage import RemoteStorage
from repro_torch.data.synthetic import tiny
from repro_torch.distributed.ft import FTConfig, ResilientTrainer
from repro_torch.kernels.device import resolve_device
from repro_torch.models.model import Model, build
from repro_torch.models.transformer import ENCDEC, encdec_src_len
from repro_torch.train.optimizer import AdamW, warmup_cosine
from repro_torch.train.step import build_train_step


def lm_batch_source(model: Model, batch: int, seq: int,
                    seed: int = 0) -> Callable[[], Dict]:
    """Synthetic-corpus LM batches (deterministic token stream, drawn as
    the reference draws it), on the model's device.  The vlm family's
    batch holds ``frontend_tokens`` = P patch embeddings (bf16) in front
    of ``seq - P`` tokens, with the ``seq`` labels of every row; the
    encdec family's adds ``encdec_src_len(seq)`` frame embeddings (bf16),
    ``src_embeds``.  Each is drawn after the tokens, from the same
    generator, as the reference's."""
    rng = np.random.default_rng(seed)
    cfg = model.cfg
    dev = model.device

    def embeds(rows: int) -> torch.Tensor:
        x = rng.normal(size=(batch, rows, cfg.d_model))
        return torch.from_numpy(x).to(dev, torch.bfloat16)

    def next_batch():
        toks = rng.integers(0, cfg.vocab_size, size=(batch, seq + 1),
                            dtype=np.int64)
        b = {"tokens": torch.from_numpy(toks[:, :-1].copy()).to(dev),
             "labels": torch.from_numpy(toks[:, 1:].copy()).to(dev)}
        if cfg.family == "vlm":
            p = cfg.frontend_tokens
            b["tokens"] = b["tokens"][:, :seq - p].contiguous()
            b["patch_embeds"] = embeds(p)
        if cfg.family in ENCDEC:
            b["src_embeds"] = embeds(encdec_src_len(seq))
        return b

    return next_batch


def patch_batch(raw: Dict, cfg: ModelConfig) -> Dict[str, torch.Tensor]:
    """The reference's stub patchify of a pipeline batch, on the device
    of its images: each flattened image tiled to ``ceil(T * d / (H W C))``
    copies, cut to ``T * d`` values and shaped (B, T, d) in bf16
    (``patch_embeds``); ``labels`` modulo ``max(n_classes, 1)``.  The
    images may be a numpy array (the per-sample executor's) or a tensor
    (the device executor's).  The cast to bf16 comes before the tiling,
    which gives the same bits and moves half the bytes."""
    imgs = raw["images"]
    if not isinstance(imgs, torch.Tensor):
        imgs = torch.from_numpy(np.asarray(imgs, np.float32))
    B = imgs.shape[0]
    T, d = cfg.frontend_tokens, cfg.d_model
    flat = imgs.reshape(B, -1).to(torch.bfloat16)
    reps = -(-T * d // flat.shape[1])
    emb = flat.repeat(1, reps)[:, :T * d].reshape(B, T, d)
    labels = torch.as_tensor(np.asarray(raw["labels"], np.int64),
                             device=imgs.device)
    return {"patch_embeds": emb, "labels": labels % max(cfg.n_classes, 1)}


def image_batch_source(model: Model, batch: int, seed: int = 0,
                       backend: str = "numpy"):
    """The Seneca image pipeline: storage -> 3-form cache -> ODS ->
    augment -> :func:`patch_batch`, built as the reference builds it
    (``tiny(n=4096)``, unthrottled storage, a 0.2 GB cache on the
    AZURE_NC96 profile, 4 workers).  The server and the executor live on
    the model's device: a CUDA model takes the device executor, a CPU
    model the per-sample one.

    Returns (next_batch, pipeline, server); the server is the
    :class:`repro_torch.api.SenecaServer` facade — open more sessions on
    it for concurrent jobs."""
    ds = tiny(n=4096)
    storage = RemoteStorage(ds, bandwidth=None)
    dev = model.device
    server = SenecaServer.for_dataset(ds, cache_bytes=int(0.2 * GB),
                                      hardware=AZURE_NC96, seed=seed,
                                      backend=backend, device=dev)
    executor = "device" if dev.type == "cuda" else "per-sample"
    pipe = DSIPipeline(server.open_session(batch_size=batch), storage,
                       n_workers=4, executor=executor)

    def next_batch():
        return patch_batch(pipe.next_batch(), model.cfg)

    return next_batch, pipe, server


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

    pipe = server = None
    if cfg.family == "encoder":
        source, pipe, server = image_batch_source(model, args.batch)
        print(f"seneca partition: {server.partition.label}")
    else:
        source = lm_batch_source(model, args.batch, args.seq)

    try:
        trainer = ResilientTrainer(
            step_fn=step, params=model, opt_state=opt_state,
            cfg=FTConfig(ckpt_dir=args.ckpt_dir,
                         ckpt_every=args.ckpt_every),
            batch_source=source)
        t0 = time.monotonic()
        hist = trainer.run(args.steps)
        dt = time.monotonic() - t0
        print(f"{len(hist)} steps in {dt:.1f}s "
              f"({len(hist) * args.batch / max(dt, 1e-9):.1f} samples/s)")
        if hist:
            print(f"loss {hist[0]['loss']:.3f} -> {hist[-1]['loss']:.3f}")
        if pipe is not None:
            print("pipeline stage seconds:", pipe.times.as_dict())
            print("seneca stats:", server.stats())
    finally:
        if pipe is not None:
            pipe.stop()
            server.close()


if __name__ == "__main__":
    main()
