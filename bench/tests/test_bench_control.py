"""The control at a tiny size on the CPU: the reference computed in
float8 in the program's place, and the reference with half of each batch
left out, each fail the tiny cells' limits of the numbers that each cell
compares (``change_gap`` and ``grad_dir_gap`` in the token cell) against
the float32 reference, which the program's CPU path meets
(``test_bench_runs``).  ``bench/control.py`` reads the same at each
cell's own size on the card, where the committed limits hold."""
from __future__ import annotations

import sys
from pathlib import Path

import pytest

torch = pytest.importorskip("torch")
ROOT = Path(__file__).resolve().parents[2]
sys.path[:0] = [str(ROOT), str(ROOT / "src")]

from bench import cells, check, control  # noqa: E402
from bench.tests.bench_tiny import tiny_bench  # noqa: E402

MAN = cells.manifest()


@pytest.mark.parametrize("name", [w["name"] for w in MAN["workloads"]])
def test_control_and_fault_fail_the_limits(tmp_path, name):
    b = tiny_bench(tmp_path)
    cell = cells.load_cell(name, b)
    cfg = cells.load_config(cell["config"], b)
    limits = {k: v for k, v in cell["limits"].items()
              if k not in ("rows_bad", "ids_bad")}
    for seed in (1, 2):
        got = control.readings(cell, cfg, seed, "cpu")
        for kind in ("fp8", "half_batch"):
            assert not check.verdict(got[kind], limits), (kind, got)
