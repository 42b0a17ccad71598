"""Tiny cells for the CPU tests: the benchmark's own cells and
configurations with small sizes, written into a copy of ``bench/``'s
data so that the harness runs them through its normal path."""
from __future__ import annotations

import copy
import json
import shutil
from pathlib import Path

from bench import cells

TINY_CONFIGS = {
    "vit-huge": dict(n_layers=2, d_model=64, n_heads=4, n_kv_heads=4,
                     d_ff=128, n_classes=16, frontend_tokens=17),
    "mamba2-1.3b": dict(n_layers=2, d_model=64, vocab_size=512,
                        ssm={"d_state": 16, "head_dim": 16, "expand": 2,
                             "d_conv": 4, "chunk": 32}),
}
TINY_CELLS = {
    "vit-huge.cold-imagenet": dict(batch=8, dataset={"kind": "imagenet_like",
                                                     "n": 4096},
                                   reference_rows=4),
    "vit-huge.hbm-hot": dict(batch=8, dataset={"kind": "imagenet_like",
                                               "n": 48}, reference_rows=4),
    "mamba2-1.3b.train-4k": dict(batch=2, seq=64, reference_rows=1),
}
#: the limits at these sizes of each number that a cell compares
TINY_LIMITS = {"loss_gap": 1e-2, "grad_gap": 2e-2, "change_gap": 5e-2,
               "grad_dir_gap": 1e-2}


def tiny_bench(dest: Path) -> Path:
    """A copy of ``bench/``'s cells, configurations and metric readers
    at tiny sizes under ``dest``; returns it."""
    for sub in ("configs", "workloads"):
        (dest / sub).mkdir(parents=True, exist_ok=True)
    shutil.copytree(cells.BENCH / "metrics", dest / "metrics",
                    dirs_exist_ok=True)
    for name, over in TINY_CONFIGS.items():
        cfg = cells.load_config(name)
        cfg.update(over)
        (dest / "configs" / f"{name}.json").write_text(json.dumps(cfg))
    for name, over in TINY_CELLS.items():
        cell = copy.deepcopy(cells.load_cell(name))
        cell.pop("name")
        cell.update(over)
        if "server" in cell:
            cell["server"]["device_cache_bytes"] = 32 * 602112 * 1.2
        cell["limits"] = {k: TINY_LIMITS.get(k, v)
                          for k, v in cell["limits"].items()}
        (dest / "workloads" / f"{name}.json").write_text(json.dumps(cell))
    return dest
