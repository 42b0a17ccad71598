"""Tables of the dry-run's records.

    python3 scripts/dryrun_table.py RECORDS.json [RECORDS.json ...]

Reads the JSON that ``python -m repro_torch.launch.dryrun`` writes (one
or several files, merged) and prints, as markdown: every traced cell
(arch|shape|mesh) with its bottleneck, its trace seconds, its traced
FLOPs and bytes accessed per rank, and its traced peak memory beside
``analytic_bytes_per_device`` (the reference's spec arithmetic) and their
ratio, marking a peak beyond one H100's 80 GB; then the same peaks and
ratios one row per arch, a column per shape and mesh; then the ok,
failed and skipped counts.  Needs neither a card nor torch.
"""
from __future__ import annotations

import argparse
import json
import sys

#: one H100's memory, the line a cell's traced peak is held to (bytes)
HBM_BYTES = 80e9
SHAPE_ORDER = ["train_4k", "prefill_32k", "decode_32k", "long_500k"]
MESH_ORDER = ["single", "multi"]


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("records", nargs="+")
    args = ap.parse_args(argv)
    records = {}
    for path in args.records:
        with open(path) as f:
            records.update(json.load(f))
    ok = {k: r for k, r in records.items()
          if "error" not in r and "skipped" not in r}
    print("| cell | bottleneck | trace s | TFLOP / rank | GB accessed / rank "
          "| traced peak GB | analytic GB | peak / analytic | fits 80 GB |")
    print("|---|---|---|---|---|---|---|---|---|")
    for key in sorted(ok):
        r = ok[key]
        peak = r["memory_analysis"]["peak_memory_in_bytes"]
        analytic = r["analytic_bytes_per_device"]["total"]
        print(f"| {key} | {r['bottleneck']} | {r['lower_s']:.1f} | "
              f"{r['trace']['flops'] / 1e12:.3f} | "
              f"{r['trace']['bytes'] / 1e9:.1f} | {peak / 1e9:.1f} | "
              f"{analytic / 1e9:.2f} | {peak / analytic:.2f} | "
              f"{'yes' if peak <= HBM_BYTES else 'no'} |")
    shapes = sorted({k.split("|")[1] for k in ok}, key=SHAPE_ORDER.index)
    meshes = sorted({k.split("|")[2] for k in ok}, key=MESH_ORDER.index)
    cols = [(s, m) for s in shapes for m in meshes]
    print("\n| arch | " + " | ".join(f"{s} {m}" for s, m in cols) + " |")
    print("|---|" + "---|" * len(cols))
    for arch in sorted({k.split("|")[0] for k in ok}):
        cells = []
        for s, m in cols:
            r = ok.get(f"{arch}|{s}|{m}")
            if r is None:
                cells.append("n/a")
                continue
            peak = r["memory_analysis"]["peak_memory_in_bytes"]
            ratio = peak / r["analytic_bytes_per_device"]["total"]
            cells.append(f"{peak / 1e9:,.1f} ({ratio:.1f}x)"
                         + ("" if peak <= HBM_BYTES else " *"))
        print(f"| {arch} | " + " | ".join(cells) + " |")
    failed = [k for k, r in records.items() if "error" in r]
    fits = sum(r["memory_analysis"]["peak_memory_in_bytes"] <= HBM_BYTES
               for r in ok.values())
    seconds = ", ".join(
        f"{m} {sum(r['lower_s'] for k, r in ok.items() if k.endswith(m)):.1f}"
        for m in meshes)
    print(f"\n{len(ok)} ok, {len(failed)} failed, "
          f"{len(records) - len(ok) - len(failed)} skipped; {fits} of "
          f"{len(ok)} traced peaks within 80 GB; trace seconds {seconds}"
          + (f"; failed: {failed}" if failed else ""))
    return 0


if __name__ == "__main__":
    sys.exit(main())
