"""The readings that set each cell's upper limits: the reference put in
the program's place in float8 (the control), and the reference with half
of each batch left out (a fault), each against the float32 reference
over the same weights and batches, on several seeds.

    python3 bench/control.py --workload <cell> --seeds <n> [<n> ...]

Prints one JSON line per seed and kind: ``{"seed", "kind", "numbers"}``
with the numbers ``bench/check.py`` compares.  A step that leaves its
state unchanged needs no run: its changes and first moments are 0, so
``grad_gap`` and ``change_gap`` read 1.  The benchmark's own runs never
run this.  Each kind of feed makes its batches
(``control_batches`` of ``bench/sources/<source>.py``).
"""
from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path
from typing import Dict

ROOT = Path(__file__).resolve().parents[1]
sys.path[:0] = [str(ROOT)]

from bench import cells, check, weights  # noqa: E402
from bench.reference import train  # noqa: E402
from bench.reference.plain import strict_float32  # noqa: E402


def half(batch: Dict) -> Dict:
    n = next(iter(batch.values())).shape[0]
    return {k: v[:max(1, n // 2)] for k, v in batch.items()}


def readings(cell: Dict, cfg: Dict, seed: int, device) -> Dict[str, Dict]:
    strict_float32()
    specs = train.family(cfg).param_specs(cfg)
    named0 = weights.make(specs, seed, device)
    batches = cells.source(cell["source"]).control_batches(cell, cfg, seed,
                                                           device)
    rows = cell.get("reference_rows", 1)
    ref = train.follow(cfg, cell["lr"], named0, batches, "float32", rows)
    out = {}
    for kind, bs, precision in (("fp8", batches, "fp8"),
                                ("half_batch", [half(b) for b in batches],
                                 "float32")):
        got = train.follow(cfg, cell["lr"], named0, bs, precision, rows)
        out[kind] = check.training(got, ref, device)
    return out


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    cell = cells.load_cell(args.workload)
    cfg = cells.load_config(cell["config"])
    for seed in args.seeds:
        for kind, numbers in readings(cell, cfg, seed, args.device).items():
            print(json.dumps({"cell": args.workload, "seed": seed,
                              "kind": kind, "numbers": numbers}), flush=True)


if __name__ == "__main__":
    main()
