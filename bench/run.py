"""Run one cell of the benchmark once, on the machine it is started on.

    python3 bench/run.py --workload <cell> --seed <n> --seconds <s> \\
        --trace <0|1>

Prints, as the last line of its standard output, one JSON object:
``correct``, ``attempted``, ``failed``, ``metrics`` (the cell's
end-to-end metrics, or with ``--trace 1`` its per-layer ones),
``device``, with ``--trace 1`` ``breakdown``, and last ``checks``, each
number that decided ``correct`` beside its limit; the same numbers are
the last lines of its standard error.  Exits non-zero with no result
where the port (``src/repro_torch``) is missing, where CUDA is not
available, and where JAX or the JAX package was loaded.
"""
from __future__ import annotations

import argparse
import json
import os
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]


def prepare() -> None:
    """Every cache the run writes at a fixed path inside the checkout;
    the benchmark and the program importable."""
    for var, sub in (("TORCH_EXTENSIONS_DIR", "torch_extensions"),
                     ("TRITON_CACHE_DIR", "triton")):
        os.environ[var] = str(ROOT / "build" / "bench_cache" / sub)
    os.environ["USE_FLAX"] = "0"
    sys.path[:0] = [str(ROOT), str(ROOT / "src")]


def fail(code: int, msg: str):
    print(f"bench: {msg}", file=sys.stderr, flush=True)
    sys.exit(code)


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    prepare()
    from bench import harness
    t_process = harness.process_start()
    if not (ROOT / "src" / "repro_torch").is_dir():
        fail(2, "the program (src/repro_torch) is not beside the benchmark")
    if not (ROOT / "bench" / "workloads" / f"{args.workload}.json").exists():
        fail(2, f"no cell {args.workload!r} (bench/workloads/)")
    import torch
    if not torch.cuda.is_available():
        fail(3, "CUDA is not available")
    chips = next(w["chips"] for w in harness.cells.manifest()["workloads"]
                 if w["name"] == args.workload)
    if torch.cuda.device_count() < chips:
        fail(3, f"the cell needs {chips} devices, "
                f"{torch.cuda.device_count()} seen")

    out = harness.run(args.workload, args.seed, args.seconds,
                      bool(args.trace), t_process=t_process)
    run = out.pop("_run")
    found = harness.forbidden_modules()
    if found:
        fail(4, f"modules loaded that the port must not load: {found}")
    rec = run.rec
    print(f"cell {args.workload} seed {args.seed}: {out['attempted']} steps "
          f"in the window; card {out['device']['kind']}, power limit "
          f"{rec.get('power_limit_w')} W", flush=True)
    steps = rec.get("window", rec.get("plain", {})).get("step_s", [])
    print("window step seconds: " + json.dumps(steps), flush=True)
    for who, r in (("program", run.readings), ("reference", run.ref_readings)):
        print(f"readings: {who} " + json.dumps(
            {k: v for k, v in r.items() if k != "codes"}), flush=True)
    print("numbers: " + json.dumps(run.numbers), flush=True)
    for k, v in out["checks"].items():
        print(f"check {k} {v['value']!r} limit {v['limit']!r}",
              file=sys.stderr, flush=True)
    print(json.dumps(out), flush=True)


if __name__ == "__main__":
    main()
