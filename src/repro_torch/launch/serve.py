"""Serving CLI: batched decode with KV caches.

    PYTHONPATH=src python -m repro_torch.launch.serve --arch qwen3-8b \
        --requests 8 --max-new 16 [--device cpu]

The port's twin of ``repro.launch.serve``, with the same flags.  As in
the reference, ``--reduced`` defaults to on and cannot be turned off, so
the CLI always serves the reduced config; a full-width model is served
through :func:`serve_requests` (``chip_smoke.py`` does).  The device is
CUDA unless ``--device`` names another.

``--open-loop RATE`` feeds the resident model from the open-loop
preprocessing generator instead of a pre-built request list: requests
arrive on a Poisson schedule at RATE req/s, each is preprocessed through
a live Seneca cache (with SLO admission control) on the same device, and
every completed sample becomes a prompt for the decode loop.  Prints the
preprocessing latency percentiles (p50/p99/p999 + per-phase breakdown)
alongside the decode throughput::

    PYTHONPATH=src python -m repro_torch.launch.serve --open-loop 350 \
        --device cpu
"""
from __future__ import annotations

import argparse
import threading
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


def _open_loop_requests(args, vocab_size: int, device) -> List[Request]:
    """Run the open-loop preprocessing stage and map every completed
    sample to a decode Request (prompt tokens derived from the
    preprocessed pixels, so the prompt depends on the served form)."""
    from repro_torch.api import SLO, SenecaServer
    from repro_torch.data import synthetic
    from repro_torch.data.storage import RemoteStorage
    from repro_torch.workload import OpenLoopGenerator, poisson_arrivals

    ds = synthetic.tiny(n=256)
    seneca = SenecaServer.for_dataset(ds, cache_frac=0.3, device=device)
    storage = RemoteStorage(ds, bandwidth=8e6)
    lock = threading.Lock()
    pending: List[Request] = []

    def consumer(res, value) -> None:
        arr = np.asarray(value, np.float32).ravel()
        tok = (np.abs(arr[:args.prompt_len]) * 1e4).astype(np.int64) \
            % vocab_size
        with lock:
            pending.append(Request(res.req_id, tok.astype(np.int32),
                                   max_new=args.max_new,
                                   arrival_s=res.arrival_s))

    gen = OpenLoopGenerator(
        seneca, storage, consumer=consumer,
        slo=SLO(p99_target_s=args.slo_p99, max_queue=64),
        n_workers=2, seed=0)
    result = gen.run(poisson_arrivals(args.open_loop, n=args.requests,
                                      seed=0))
    seneca.close()
    print(f"open-loop preprocessing @ {args.open_loop:.0f} req/s: "
          f"{result.counts}")
    lat = result.percentiles()
    if lat:
        print(f"  latency p50={lat['p50'] * 1e3:.2f}ms "
              f"p99={lat['p99'] * 1e3:.2f}ms "
              f"p999={lat['p999'] * 1e3:.2f}ms")
        for phase, pcts in sorted(result.phase_percentiles().items()):
            print(f"  {phase:>8}: p50={pcts['p50'] * 1e3:.2f}ms "
                  f"p99={pcts['p99'] * 1e3:.2f}ms")
    return pending


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
                         "generator at RATE req/s (Poisson arrivals, SLO "
                         "admission control) instead of a pre-built list")
    ap.add_argument("--slo-p99", type=float, default=0.2,
                    help="open-loop p99 latency target in seconds")
    ap.add_argument("--device", default=None,
                    help="torch device (default: cuda)")
    args = ap.parse_args(argv)

    cfg = registry.get_reduced(args.arch) if args.reduced \
        else registry.get(args.arch)
    if not cfg.has_decoder:
        raise SystemExit(f"{cfg.name} is encoder-only; no decode path")
    device = resolve_device(args.device)
    model = build(cfg).init(seed=0, device=device)
    server = Server(model, n_slots=args.slots, s_max=args.s_max)
    if args.open_loop is not None:
        pending = _open_loop_requests(args, cfg.vocab_size, device)
        if not pending:
            raise SystemExit("open-loop stage shed every request; lower "
                             "the rate or raise --slo-p99")
    else:
        pending = make_requests(args.requests, args.prompt_len,
                                cfg.vocab_size, max_new=args.max_new)
    n_requests = len(pending)
    done, dt = serve_requests(server, pending)
    total_tok = sum(len(r.generated)
                    for r in done) + n_requests * args.prompt_len
    print(f"{n_requests} requests, {total_tok} tokens in {dt:.1f}s "
          f"({total_tok / dt:.1f} tok/s, {server.steps} decode steps)")


if __name__ == "__main__":
    main()
