"""Serving CLI: batched decode with KV caches.

    PYTHONPATH=src python -m repro_torch.launch.serve --arch qwen3-8b \
        --requests 8 --max-new 16 [--device cpu]

The port's twin of ``repro.launch.serve``, with the same flags.  As in
the reference, ``--reduced`` defaults to on and cannot be turned off, so
the CLI always serves the reduced config; a full-width model is served
through :func:`serve_requests` (``chip_smoke.py`` does).  The device is
CUDA unless ``--device`` names another.  ``--open-loop`` needs the
workload layer, which is not ported yet, and raises
``NotImplementedError``.
"""
from __future__ import annotations

import argparse
import time
from typing import List, Tuple

import numpy as np
import torch

from repro_torch.configs import registry
from repro_torch.kernels.device import resolve_device
from repro_torch.models.model import build
from repro_torch.serve.step import Request, Server


def make_requests(n: int, prompt_len: int, vocab_size: int,
                  max_new: int = 16, seed: int = 0) -> List[Request]:
    """``n`` requests with prompts drawn as the reference's CLI draws
    them (``default_rng(seed).integers(0, vocab, prompt_len)``)."""
    rng = np.random.default_rng(seed)
    return [Request(i, rng.integers(0, vocab_size, size=prompt_len),
                    max_new=max_new) for i in range(n)]


def serve_requests(server: Server, pending: List[Request],
                   verbose: bool = True) -> Tuple[List[Request], float]:
    """The reference CLI's loop: admit while slots are free, run a decode
    round, harvest finished requests.  Returns (finished requests, host
    seconds, ending after the card has finished)."""
    pending = list(pending)
    done: List[Request] = []
    t0 = time.monotonic()
    while pending or any(s is not None for s in server.slots):
        while pending and server.add_request(pending[0]):
            req = pending.pop(0)
            if verbose:
                print(f"  admitted request {req.req_id}")
        if not server.decode_round():
            break
        for i, s in enumerate(server.slots):
            if s is not None and s.done:
                done.append(s)
                server.slots[i] = None
    if server.model.device.type == "cuda":
        torch.cuda.synchronize(server.model.device)
    return done, time.monotonic() - t0


def main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="qwen3-8b",
                    choices=registry.list_archs())
    ap.add_argument("--reduced", action="store_true", default=True)
    ap.add_argument("--requests", type=int, default=8)
    ap.add_argument("--slots", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=12)
    ap.add_argument("--max-new", type=int, default=16)
    ap.add_argument("--s-max", type=int, default=128)
    ap.add_argument("--open-loop", type=float, default=None, metavar="RATE",
                    help="feed requests from the open-loop preprocessing "
                         "generator (not ported yet)")
    ap.add_argument("--slo-p99", type=float, default=0.2,
                    help="open-loop p99 latency target in seconds")
    ap.add_argument("--device", default=None,
                    help="torch device (default: cuda)")
    args = ap.parse_args(argv)

    if args.open_loop is not None:
        raise NotImplementedError(
            "--open-loop needs the workload layer, which is not ported "
            "yet; see ROADMAP.md")
    cfg = registry.get_reduced(args.arch) if args.reduced \
        else registry.get(args.arch)
    if not cfg.has_decoder:
        raise SystemExit(f"{cfg.name} is encoder-only; no decode path")
    model = build(cfg).init(seed=0, device=resolve_device(args.device))
    server = Server(model, n_slots=args.slots, s_max=args.s_max)
    pending = make_requests(args.requests, args.prompt_len, cfg.vocab_size,
                            max_new=args.max_new)
    n_requests = len(pending)
    done, dt = serve_requests(server, pending)
    total_tok = sum(len(r.generated)
                    for r in done) + n_requests * args.prompt_len
    print(f"{n_requests} requests, {total_tok} tokens in {dt:.1f}s "
          f"({total_tok / dt:.1f} tok/s, {server.steps} decode steps)")


if __name__ == "__main__":
    main()
