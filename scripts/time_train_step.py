"""Time a training phase of ``chip_smoke.py`` beside another checkout's.

    python3 scripts/time_train_step.py --against DIR [--arch ARCH]
        [--turns N] [--seed N]

Runs ``chip_smoke.train_phase`` (full depth, published widths, block
remat, int8 moments, 4 steps on one batch) for ``ARCH`` (default
mamba2-1.3b) in a fresh process per run, from this checkout and from
``DIR`` (e.g. the parent commit unpacked with ``git archive``) in turns:
there, here, here, there, repeated ``N`` / 4 times.  Each process builds
its checkout's kernels into that checkout's ``build/``.  Prints each
run's training line, its step split and its forward + backward device
split, so two designs are compared on one card in one call.  Needs one
NVIDIA GPU.
"""
from __future__ import annotations

import argparse
import subprocess
import sys
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parents[1]

RUN = """
import torch, chip_smoke
from repro_torch.kernels.device import build_all
build_all()
chip_smoke.train_phase(torch.device("cuda"), {seed}, chip_smoke.card_line(),
                       "{arch}")
"""
#: the lines of a training phase that carry its numbers
KEEP = ("training (full depth", "training step split", "device split")


def run_phase(tree: Path, arch: str, seed: int) -> list:
    out = subprocess.run([sys.executable, "-c", RUN.format(seed=seed,
                                                           arch=arch)],
                         cwd=tree, capture_output=True, text=True,
                         timeout=900)
    if out.returncode != 0:
        raise RuntimeError(f"training phase in {tree} failed:\n"
                           f"{out.stdout[-2000:]}\n{out.stderr[-4000:]}")
    return [line for line in out.stdout.splitlines()
            if any(k in line for k in KEEP)]


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--against", required=True, metavar="DIR")
    ap.add_argument("--arch", default="mamba2-1.3b")
    ap.add_argument("--turns", type=int, default=4)
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("time_train_step: needs an NVIDIA GPU", file=sys.stderr)
        return 2
    there = Path(args.against).resolve()
    order = [there, ROOT, ROOT, there] * max(1, args.turns // 4)
    for tree in order:
        label = "here" if tree == ROOT else f"there ({args.against})"
        for line in run_phase(tree, args.arch, args.seed):
            print(f"{label}: {line}", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
