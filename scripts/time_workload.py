"""Time concurrent jobs on one shared cache on one NVIDIA GPU, in variants.

    python3 scripts/time_workload.py [--seed N] [--n SAMPLES] [--repeat R]

Runs the trace of ``chip_smoke.py``'s multi-job phase (three jobs, one
epoch each of ``imagenet_like(n)`` at batch 256 through the device
executor, arriving at 0, 1 and 2 s, on a real clock) ``--repeat`` times
in each of these variants, in turns:

- ``shared``: one server as ``chip_smoke.workload_phase`` builds it (the
  "torch" ODS engine, an HBM tier of half the augmented set, a DRAM
  share for the augmented form);
- ``shared-numpy``: the same with the "numpy" ODS engine on the host;
- ``shared-no-refill``: the same as ``shared`` with the pipelines'
  background refill switched off for the run (evicted or free augmented
  slots are not repopulated on the host);
- ``private``: a naive server per job, as ``chip_smoke.py``'s baseline.

Prints, per run, the makespan, each job's seconds, the storage fetches,
the ODS hit rate and substitutions, and K1's launches.  Needs one card
and the kernels' sources beside it (``src/repro_torch/csrc``).
"""
from __future__ import annotations

import argparse
import sys
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))
sys.path.insert(0, str(ROOT / "src"))

import chip_smoke as cs  # noqa: E402

VARIANTS = ("shared", "shared-numpy", "shared-no-refill", "private")


def run(variant: str, dev, n: int, seed: int, card: str) -> None:
    from repro_torch.api import RealClock
    from repro_torch.data.pipeline import DSIPipeline
    from repro_torch.data.storage import RemoteStorage
    from repro_torch.workload.runner import WorkloadRunner

    ds, trace, shared, private = cs.workload_setup(dev, seed, n)
    storage = RemoteStorage(ds)
    refill = DSIPipeline._process_refills
    if variant == "private":
        runner = WorkloadRunner(server_factory=private, storage=storage,
                                clock=RealClock(), seed=seed,
                                record_ids=False)
        server = None
    else:
        server = shared("numpy" if variant == "shared-numpy" else "torch")
        runner = WorkloadRunner(server, storage, clock=RealClock(),
                                seed=seed, record_ids=False)
        if variant == "shared-no-refill":
            DSIPipeline._process_refills = lambda self, max_n=32: None
    try:
        cs.reset_counts()
        res = runner.run(trace, timeout=900)
        k1 = cs.read_counts()["decode_augment"]
    finally:
        DSIPipeline._process_refills = refill
    stats = res.stats or {}
    if server is not None:
        server.close()
    cs.check(all(j.samples == n for j in res.jobs),
             f"{variant}: a job did not finish its epoch")
    print(f"{variant}: makespan {res.makespan:.3f} s; "
          + ", ".join(f"{j.spec.name} {j.duration_s:.3f} s"
                      for j in res.jobs)
          + f"; storage fetches {storage.fetches}; ods_hit_rate "
          f"{stats.get('ods_hit_rate', float('nan')):.4f}, substitutions "
          f"{stats.get('substitutions', 0)}; K1 launches {k1} ({card})",
          flush=True)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--n", type=int, default=cs.N_WORKLOAD)
    ap.add_argument("--repeat", type=int, default=1)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("time_workload: needs an NVIDIA GPU", file=sys.stderr)
        return 2
    from repro_torch.kernels.device import build_all, resolve_device
    build_all()
    dev = resolve_device(None)
    card = cs.card_line()
    print(f"card: {card}", flush=True)
    for r in range(args.repeat):
        order = VARIANTS if r % 2 == 0 else VARIANTS[::-1]
        for variant in order:
            run(variant, dev, args.n, args.seed, card)
    return 0


if __name__ == "__main__":
    sys.exit(main())
