"""Finding a run's parts by name: the cell ``bench/workloads/<cell>.json``,
its configuration ``bench/configs/<config>.json``, its kind of feed
``bench/sources/<source>.py`` and each metric's reader
``bench/metrics/<metric>.py``; which metrics a cell reports comes from
``BENCHMARK.json``.  Adding a cell, a configuration, a kind of feed or a
metric is adding its file and its entry.
"""
from __future__ import annotations

import importlib.util
import json
from pathlib import Path
from typing import Callable, Dict, List

BENCH = Path(__file__).resolve().parent
ROOT = BENCH.parent


def manifest(root: Path = ROOT) -> Dict:
    with open(root / "BENCHMARK.json") as f:
        return json.load(f)


def load_cell(name: str, bench: Path = BENCH) -> Dict:
    with open(bench / "workloads" / f"{name}.json") as f:
        cell = json.load(f)
    cell["name"] = name
    return cell


def load_config(name: str, bench: Path = BENCH) -> Dict:
    with open(bench / "configs" / f"{name}.json") as f:
        return json.load(f)


def source(name: str):
    """The module ``bench/sources/<name>.py``: its ``Feed`` gives the
    step its batches, its ``judge`` gives the reference the checked
    steps' batches and judges the served data, its ``control_batches``
    gives the control its batches."""
    return importlib.import_module(f"bench.sources.{name}")


def metric_reader(name: str, bench: Path = BENCH) -> Callable:
    """``read(record)`` of ``bench/metrics/<name>.py``: the metric's
    value, or None where the run holds nothing for it to read."""
    path = bench / "metrics" / f"{name}.py"
    spec = importlib.util.spec_from_file_location(f"bench_metric_{name}",
                                                  path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


def metrics_of(man: Dict, cell: str, kind: str) -> List[Dict]:
    """The ``end_to_end`` or ``per_layer`` entries that ``cell``
    reports: those that list it, and those that list no cells."""
    return [m for m in man[kind] if cell in m.get("workloads", [cell])]


def model_config(cfg: Dict):
    """The program's ``ModelConfig`` of a configuration file."""
    from repro_torch.configs.base import ModelConfig, SSMConfig
    fields = {k: v for k, v in cfg.items()
              if k in ModelConfig.__dataclass_fields__ and k != "ssm"}
    if cfg.get("ssm"):
        fields["ssm"] = SSMConfig(**cfg["ssm"])
    return ModelConfig(**fields)
