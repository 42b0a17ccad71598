"""The comparison fails a broken program: whole runs at tiny sizes on
the CPU with the timed path broken underneath come out not correct, once
for each fault a cell can have: a step that returns its state unchanged,
half of the batch left out (the mean over the rest), a served row
altered where the loader produces it.  (The cells run on one card: no
exchange between cards to leave out.)"""
from __future__ import annotations

import sys
from pathlib import Path

import pytest

torch = pytest.importorskip("torch")
ROOT = Path(__file__).resolve().parents[2]
sys.path[:0] = [str(ROOT), str(ROOT / "src")]

from bench import cells, harness  # noqa: E402
from bench.tests.bench_tiny import tiny_bench  # noqa: E402

MAN = cells.manifest()
SEED = 2**31 + 29


@pytest.fixture(scope="module")
def bench_dir(tmp_path_factory):
    return tiny_bench(tmp_path_factory.mktemp("bench"))


def unchanged(build):
    def make(model, parallel, opt):
        def step(model, state, batch):
            with torch.no_grad():
                return model, state, {"loss": model.loss(batch)}
        return step
    return make


def half_batch(build):
    def make(model, parallel, opt):
        real = build(model, parallel, opt)

        def step(model, state, batch):
            n = next(iter(batch.values())).shape[0]
            return real(model, state, {k: v[:max(1, n // 2)]
                                       for k, v in batch.items()})
        return step
    return make


FAULTS = {"unchanged": unchanged, "half_batch": half_batch}


@pytest.mark.parametrize("fault", sorted(FAULTS))
@pytest.mark.parametrize("name", [w["name"] for w in MAN["workloads"]])
def test_broken_step_is_not_correct(bench_dir, monkeypatch, name, fault):
    import repro_torch.train.step as step_mod
    monkeypatch.setattr(step_mod, "build_train_step",
                        FAULTS[fault](step_mod.build_train_step))
    out = harness.run(name, SEED, 0.5, False, device="cpu",
                      bench=bench_dir, man=MAN)
    out.pop("_run")
    assert not out["correct"], out["checks"]


@pytest.mark.parametrize("name", [w["name"] for w in MAN["workloads"]
                                  if cells.load_cell(w["name"])["source"]
                                  == "loader"])
def test_altered_row_is_not_correct(bench_dir, monkeypatch, name):
    from repro_torch.data.pipeline import DSIPipeline
    real = DSIPipeline.next_batch

    def altered(self):
        batch = real(self)
        batch["images"][-1, 0, 3, 1] += 0.5
        return batch

    monkeypatch.setattr(DSIPipeline, "next_batch", altered)
    out = harness.run(name, SEED, 0.5, False, device="cpu",
                      bench=bench_dir, man=MAN)
    out.pop("_run")
    assert not out["correct"]
    assert out["checks"]["rows_bad"]["value"] > 0
