"""The manifest and the files it names: every cell, configuration and
metric loads by name, the configuration files are the program's own
configurations, and the yardstick reproduces the kernel table's bounds."""
from __future__ import annotations

import re
import sys
from pathlib import Path

import pytest

torch = pytest.importorskip("torch")
ROOT = Path(__file__).resolve().parents[2]
sys.path[:0] = [str(ROOT), str(ROOT / "src")]

from bench import cells, yardstick  # noqa: E402

MAN = cells.manifest()
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
ENTRY_KEYS = {
    "configs": {"name", "source", "file", "reduced", "why"},
    "workloads": {"name", "config", "traffic", "chips", "why"},
    "end_to_end": {"name", "unit", "better", "bound", "source"},
    "per_layer": {"name", "unit", "better", "source", "layer", "moves"},
}


def test_manifest_keys_and_names():
    assert set(MAN) == {"command", "paths", "run_seconds", "configs",
                        "workloads", "end_to_end", "per_layer"}
    assert MAN["paths"] == ["bench"]
    assert 1 <= MAN["run_seconds"] <= 51
    for kind, keys in ENTRY_KEYS.items():
        names = [e["name"] for e in MAN[kind]]
        assert len(names) == len(set(names)), kind
        for e in MAN[kind]:
            assert set(e) - {"workloads"} == keys, (kind, e["name"])
            assert NAME.match(e["name"]), e["name"]
            if "unit" in e:
                assert UNIT.match(e["unit"]) and e["better"] in (
                    "lower", "higher")
    e2e = {m["name"] for m in MAN["end_to_end"]}
    assert "setup_s" in e2e
    for m in MAN["end_to_end"]:
        assert 0.01 <= m["bound"] <= 0.25
    for m in MAN["per_layer"]:
        assert m["moves"] in e2e
        assert not m["name"].endswith("_roofline") or m["unit"] == "%"


@pytest.mark.parametrize("name", [w["name"] for w in MAN["workloads"]])
def test_cell_loads_by_name(name):
    cell = cells.load_cell(name)
    entry = next(w for w in MAN["workloads"] if w["name"] == name)
    assert cell["config"] == entry["config"] and entry["chips"] == 1
    assert (cells.BENCH / "sources" / f"{cell['source']}.py").is_file()
    # every compared number has a limit set from the chip's readings
    assert cell["limits"] and all(v is not None
                                  for v in cell["limits"].values())
    training = {"loss_gap", "grad_gap", "change_gap", "grad_dir_gap"}
    assert set(cell["limits"]) <= training | {"rows_bad", "ids_bad"}
    assert set(cell["limits"]) & training
    reported = cells.metrics_of(MAN, name, "per_layer")
    assert reported and cells.metrics_of(MAN, name, "end_to_end")


@pytest.mark.parametrize("name", [c["name"] for c in MAN["configs"]])
def test_config_is_the_programs(name):
    """The file holds the configuration as run: the program's registry
    entry of that name, field for field (its provenance tag aside)."""
    import dataclasses
    from repro_torch.configs import registry
    entry = next(c for c in MAN["configs"] if c["name"] == name)
    assert entry["file"] == f"bench/configs/{name}.json"
    got = dataclasses.replace(cells.model_config(cells.load_config(name)),
                              source="")
    assert got == dataclasses.replace(registry.get(name), source="")


@pytest.mark.parametrize("name", [m["name"] for m in MAN["end_to_end"]
                                  + MAN["per_layer"]])
def test_metric_reader_loads_by_name(name):
    read = cells.metric_reader(name)
    # a run that holds nothing for the metric gives no value
    assert read({"cell": {"source": "tokens", "seq": 1},
                 "config": {"family": "ssm"}, "batch": 1}) is None


def test_yardstick_reproduces_the_kernel_table():
    """K1 154.1 MB, K4 at vit 516.4 MB (its backward 1.03 GB), K5 at
    (4, 1024, 64, 64, 128) 78.6 MB: the bounds' bytes of the port's
    kernel table; about 1.01e12 model FLOPs per vit-huge image."""
    assert round(yardstick.k1_work(256, 224, 224)[0] / 1e6, 1) == 154.1
    k4 = yardstick.k4_work(256, 197, 16, 16, 80, False)
    assert round(k4[0] / 1e6, 1) == 516.4
    assert round(yardstick.least_ms(*k4), 4) == 0.1542
    k4b = yardstick.k4_bwd_work(256, 197, 16, 16, 80, False)
    assert round(k4b[0] / 1e9, 2) == 1.03
    assert round(yardstick.least_ms(*k4b), 4) == 0.3083
    k5 = yardstick.k5_work(4, 1024, 64, 64, 128)
    assert round(k5[0] / 1e6, 1) == 78.6
    assert round(yardstick.least_ms(*k5), 4) == 0.0235
    k5b = yardstick.k5_bwd_work(4, 1024, 64, 64, 128)
    assert round(yardstick.least_ms(*k5b), 4) == 0.0455
    vit = cells.load_config("vit-huge")
    per_image = yardstick.encoder_step_flops(vit, 1)
    assert 1.0e12 < per_image < 1.02e12
