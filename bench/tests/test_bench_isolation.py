"""What the benchmark loads and where it runs: nothing whose top-level
module is ``jax``, ``jaxlib``, ``flax`` or the JAX package ``repro``
(compared whole: the port is ``repro_torch``), nothing of
``benchmarks/``; no result without a card or without the program."""
from __future__ import annotations

import ast
import os
import shutil
import subprocess
import sys
import textwrap
from pathlib import Path

import pytest

pytest.importorskip("torch")
ROOT = Path(__file__).resolve().parents[2]
BENCH = ROOT / "bench"
FORBIDDEN = {"jax", "jaxlib", "flax", "repro", "benchmarks"}


def test_no_source_imports_a_forbidden_module():
    for path in BENCH.rglob("*.py"):
        tree = ast.parse(path.read_text())
        for node in ast.walk(tree):
            names = []
            if isinstance(node, ast.Import):
                names = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom) and node.module:
                names = [node.module]
            for name in names:
                assert name.split(".")[0] not in FORBIDDEN, (path, name)
        assert "benchmarks/" not in path.read_text() or path == Path(
            __file__), path


GUARDED_RUN = textwrap.dedent("""
    import sys
    FORBIDDEN = {"jax", "jaxlib", "flax", "repro"}

    class Guard:
        def find_spec(self, name, path=None, target=None):
            if name.split(".")[0] in FORBIDDEN:
                raise ImportError(f"forbidden import {name}")
            return None

    sys.meta_path.insert(0, Guard())
    sys.path[:0] = [ROOT, ROOT + "/src"]
    from pathlib import Path
    import bench.run  # the command's module, with its imports
    from bench import cells, harness
    from bench.tests.bench_tiny import tiny_bench
    b = tiny_bench(Path(DEST))
    for cell in ("vit-huge.cold-imagenet", "mamba2-1.3b.train-4k"):
        out = harness.run(cell, 7, 0.5, cell.startswith("mamba"),
                          device="cpu", bench=b, man=cells.manifest())
        assert out["correct"], out["checks"]
    loaded = {m.split(".")[0] for m in sys.modules} & FORBIDDEN
    assert not loaded, loaded
    print("clean")
""")


def test_a_run_loads_no_forbidden_module(tmp_path):
    script = f"ROOT = {str(ROOT)!r}\nDEST = {str(tmp_path)!r}\n" \
        + GUARDED_RUN
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    out = subprocess.run([sys.executable, "-c", script], capture_output=True,
                         text=True, timeout=600, env=env, cwd=tmp_path)
    assert out.returncode == 0 and "clean" in out.stdout, out.stderr[-3000:]


def _run_cli(cwd: Path, tmp_path: Path):
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["HOME"] = str(tmp_path)
    return subprocess.run(
        [sys.executable, "bench/run.py", "--workload",
         "mamba2-1.3b.train-4k", "--seed", "1", "--seconds", "1",
         "--trace", "0"], capture_output=True, text=True, timeout=300,
        env=env, cwd=cwd)


def test_no_result_without_a_card():
    import torch
    if torch.cuda.is_available():
        pytest.skip("a card is present: the run would measure")
    out = subprocess.run(
        [sys.executable, "bench/run.py", "--workload", "mamba2-1.3b.train-4k",
         "--seed", "1", "--seconds", "1", "--trace", "0"],
        capture_output=True, text=True, timeout=300, cwd=ROOT)
    assert out.returncode != 0 and not out.stdout.strip()
    assert "CUDA" in out.stderr


def test_no_result_with_the_benchmark_alone(tmp_path):
    """A directory with ``BENCHMARK.json`` and ``bench/`` only."""
    alone = tmp_path / "alone"
    alone.mkdir()
    shutil.copy(ROOT / "BENCHMARK.json", alone)
    shutil.copytree(BENCH, alone / "bench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    out = _run_cli(alone, tmp_path)
    assert out.returncode != 0 and not out.stdout.strip()
