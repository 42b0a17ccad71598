"""Whole runs of every cell at tiny sizes on the CPU, through the
harness's normal path (the look for a card aside): each comes out
correct and reports its metrics; a cell added as a file runs with no
change of code."""
from __future__ import annotations

import json
import sys
from pathlib import Path

import pytest

torch = pytest.importorskip("torch")
ROOT = Path(__file__).resolve().parents[2]
sys.path[:0] = [str(ROOT), str(ROOT / "src")]

from bench import cells, harness  # noqa: E402
from bench.tests.bench_tiny import tiny_bench  # noqa: E402

MAN = cells.manifest()
SEED = 2**31 + 11          # past 32 signed bits


@pytest.fixture(scope="module")
def bench_dir(tmp_path_factory):
    return tiny_bench(tmp_path_factory.mktemp("bench"))


@pytest.mark.parametrize("name", [w["name"] for w in MAN["workloads"]])
def test_cell_runs_correct(bench_dir, name):
    out = harness.run(name, SEED, 1.0, False, device="cpu",
                      bench=bench_dir, man=MAN)
    out.pop("_run")
    assert out["correct"], out["checks"]
    assert out["attempted"] >= 1 and out["failed"] == 0
    assert {"samples_per_s", "step_p95_ms", "setup_s"} <= set(out["metrics"])
    assert list(out)[-1] == "checks"
    json.dumps(out)


def test_added_cell_file_runs_traced(bench_dir):
    """A new cell is a file of ``bench/workloads`` and an entry of the
    manifest: a shorter sequence of the token cell, run traced."""
    cell = json.loads((bench_dir / "workloads" /
                       "mamba2-1.3b.train-4k.json").read_text())
    cell["seq"] = 32
    (bench_dir / "workloads" / "mamba2-1.3b.train-1k.json").write_text(
        json.dumps(cell))
    man = json.loads(json.dumps(MAN))
    man["workloads"].append({"name": "mamba2-1.3b.train-1k",
                             "config": "mamba2-1.3b", "traffic": "train-1k",
                             "chips": 1, "why": "a test's cell"})
    for m in man["per_layer"]:
        if "mamba2-1.3b.train-4k" in m.get("workloads", []):
            m["workloads"].append("mamba2-1.3b.train-1k")
    out = harness.run("mamba2-1.3b.train-1k", SEED, 1.0, True, device="cpu",
                      bench=bench_dir, man=man)
    out.pop("_run")
    assert out["correct"], out["checks"]
    assert {"update_ms", "fwd_bwd_ms", "step_mfu"} <= set(out["metrics"])
    assert "busy_s" in out["device"] and "breakdown" in out
