"""Time qwen3-8b's prefill and mamba2-1.3b's training step beside another
checkout's.

    python3 scripts/time_custom_ops.py --against DIR [--turns N]
        [--runs N] [--seed N]

In a fresh process per run, from this checkout and from ``DIR`` (e.g.
the parent commit unpacked with ``git archive``) in turns: there, here,
here, there, repeated ``N`` / 4 times.  Each run builds its checkout's
kernels into that checkout's ``build/``, then times (host clock,
synchronized) ``chip_smoke.py``'s qwen3-8b prefill, ``ATTN_B`` x
``ATTN_S`` tokens at full width with random weights, ``--runs`` times
after one warm-up, and runs ``chip_smoke.train_phase`` for mamba2-1.3b
(its step seconds).  Where the two checkouts differ in how K4 and K5 are
entered (``torch.library`` ops, with their dispatch on the host, against
plain calls), the numbers show what that costs.  Needs one NVIDIA GPU.
"""
from __future__ import annotations

import argparse
import json
import re
import subprocess
import sys
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parents[1]

RUN = """
import json, numpy as np, torch, chip_smoke
from repro_torch.kernels.device import build_all
build_all()
dev = torch.device("cuda")
card = chip_smoke.card_line()
model = chip_smoke.build_model("qwen3-8b", dev, {seed})
rng = np.random.default_rng({seed})
B, S = chip_smoke.ATTN_B, chip_smoke.ATTN_S
tokens = torch.from_numpy(rng.integers(0, model.cfg.vocab_size,
                                       (B, S))).to(dev)
secs = []
for _ in range({runs} + 1):
    cache = model.init_cache(B, chip_smoke.ATTN_S_MAX)
    _, s = chip_smoke.synced_seconds(
        lambda: model.prefill({{"tokens": tokens}}, cache))
    secs.append(s)
    del cache
print("prefill seconds " + json.dumps(secs), flush=True)
del model
torch.cuda.empty_cache()
chip_smoke.train_phase(dev, {seed}, card, "mamba2-1.3b")
print("card " + card, flush=True)
"""
STEP = re.compile(r"median of steps 2-\d+ ([0-9.]+) s")


def run_tree(tree: Path, runs: int, seed: int) -> dict:
    out = subprocess.run([sys.executable, "-c",
                          RUN.format(seed=seed, runs=runs)],
                         cwd=tree, capture_output=True, text=True,
                         timeout=900)
    if out.returncode != 0:
        raise RuntimeError(f"the run in {tree} failed:\n"
                           f"{out.stdout[-2000:]}\n{out.stderr[-4000:]}")
    lines = out.stdout.splitlines()
    prefill = json.loads(next(line for line in lines
                              if line.startswith("prefill seconds "))
                         [len("prefill seconds "):])
    train = next(line for line in lines
                 if line.startswith("mamba2-1.3b training ("))
    return {"prefill": prefill[1:], "step": float(STEP.search(train)[1]),
            "card": next(line for line in lines
                         if line.startswith("card "))[5:]}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--against", required=True, metavar="DIR")
    ap.add_argument("--turns", type=int, default=4)
    ap.add_argument("--runs", type=int, default=5)
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("time_custom_ops: needs an NVIDIA GPU", file=sys.stderr)
        return 2
    there = Path(args.against).resolve()
    order = [there, ROOT, ROOT, there] * max(1, args.turns // 4)
    for tree in order:
        label = "here" if tree == ROOT else f"there ({args.against})"
        r = run_tree(tree, args.runs, args.seed)
        print(f"{label}: qwen3-8b prefill seconds "
              f"{[round(x, 4) for x in r['prefill']]}, median "
              f"{float(np.median(r['prefill'])):.4f} s; mamba2-1.3b median "
              f"step {r['step']:.3f} s ({r['card']})", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
