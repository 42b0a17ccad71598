"""Time the int8 error-feedback all-reduce on one NVIDIA GPU.

    python3 scripts/time_compression.py [--arch mamba2-1.3b] [--calls 4]

Joins an NCCL world of one rank (``launch.mesh.init_world`` on a file
store under ``build/``), makes one random bf16 gradient and a random
float32 residual per parameter of ``--arch`` at its published widths
(1.45 B elements for mamba2-1.3b), and times
``train.compression.allreduce_compressed`` over the whole gradient,
``--calls`` calls in turns with a variant whose residual is rounded once
in float64 (``corrected.double() - q.double() * scale.double()``, the
same values), synchronized host clock.  For each it also prints, from
one call under ``torch.profiler``, the device time summed over kernels
and copies, the number of kernels, and the device's busy share of the
call.  Every line ends with the card's name and power limit.
"""
from __future__ import annotations

import argparse
import os
import statistics
import sys
import time
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "src"))
sys.path.insert(0, str(ROOT))


def _residual_float64(blocks, q, scale, n, shape):
    from repro_torch.train import compression as c
    diff = blocks.double() - q.double() * scale.double()
    return c._unblock(diff.float(), n, shape)


def call_seconds(fn) -> float:
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    fn()
    torch.cuda.synchronize()
    return time.perf_counter() - t0


def profiled(fn):
    """(device ms summed over kernels and copies, kernels, wall ms) of
    one call of ``fn`` under ``torch.profiler``."""
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    device_us, kernels = 0.0, 0
    for ev in prof.events():
        if ev.device_type == torch.autograd.DeviceType.CUDA:
            device_us += ev.device_time
            kernels += 1
    return device_us / 1e3, kernels, wall * 1e3


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--arch", default="mamba2-1.3b")
    ap.add_argument("--calls", type=int, default=4)
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("time_compression: needs an NVIDIA GPU", file=sys.stderr)
        return 2
    import chip_smoke
    from repro_torch.configs import registry
    from repro_torch.launch.mesh import init_world
    from repro_torch.models.model import build
    from repro_torch.train import compression
    import torch.distributed as dist

    card = chip_smoke.card_line()
    store = ROOT / "build" / f"nccl_store_{os.getpid()}"
    store.parent.mkdir(parents=True, exist_ok=True)
    store.unlink(missing_ok=True)
    init_world(f"file://{store}", 0, 1)
    try:
        dev = torch.device("cuda")
        model = build(registry.get(args.arch))
        gen = torch.Generator(device=dev).manual_seed(args.seed)
        grads, res = {}, {}
        for name, d in model.named_parameters():
            shape = tuple(d.shape)
            grads[name] = (torch.randn(shape, generator=gen, device=dev)
                           * 1e-3).to(torch.bfloat16)
            res[name] = torch.randn(shape, generator=gen, device=dev) * 1e-5
        del model
        n = sum(g.numel() for g in grads.values())
        ef = compression.EFState(res)
        committed = compression._residual
        variants = {"float32 split (committed)": committed,
                    "float64": _residual_float64}

        def run(which):
            compression._residual = variants[which]
            try:
                return compression.allreduce_compressed(grads, ef)
            finally:
                compression._residual = committed

        names = list(variants)
        secs = {k: [] for k in names}
        run(names[0])                       # warm-up: the NCCL set-up
        order = [names[0], names[1], names[1], names[0]] * max(
            1, args.calls // 2)
        for which in order:
            secs[which].append(call_seconds(lambda: run(which)))
        out = {}
        for which in names:
            out[which] = run(which)
        same = all(torch.equal(out[names[0]][1].residual[k],
                               out[names[1]][1].residual[k]) for k in grads)
        print(f"allreduce_compressed over {len(grads)} {args.arch} "
              f"parameters, {n:,} gradient elements, NCCL world of one; "
              f"residuals of the two variants equal: {same} ({card})",
              flush=True)
        for which in names:
            dev_ms, kernels, wall_ms = profiled(lambda: run(which))
            print(f"  {which}: seconds a call {[round(s, 4) for s in secs[which]]} "
                  f"(median {statistics.median(secs[which]):.4f}); under "
                  f"the profiler {wall_ms:.1f} ms wall, {dev_ms:.1f} ms of "
                  f"device time in {kernels} kernels and copies (busy "
                  f"{100 * dev_ms / wall_ms:.1f}%) ({card})", flush=True)
    finally:
        dist.destroy_process_group()
        store.unlink(missing_ok=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
