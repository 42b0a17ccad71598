"""The port's checkpoints and resilient trainer
(``repro_torch.distributed.{checkpoint,ft}``): the checks of
``tests/test_checkpoint.py`` on the port, with reduced qwen3-8b (the
port's dense arch) in place of the reference's deepseek-7b.

Trees are the port's: nested dicts and named tuples of tensors (a
model's ``state_dict()``, an ``AdamWState``).  Restores are exact
(bf16 through its ``uint16`` bits), and the trainer's runs on the CPU
are deterministic, so every comparison is for equality.
"""
import json

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.configs import registry  # noqa: E402
from repro_torch.configs.base import ParallelismConfig  # noqa: E402
from repro_torch.distributed import checkpoint as ckpt  # noqa: E402
from repro_torch.distributed.ft import (FTConfig,  # noqa: E402
                                        HeartbeatRegistry, ResilientTrainer)
from repro_torch.models.model import build  # noqa: E402
from repro_torch.train.optimizer import AdamW  # noqa: E402
from repro_torch.train.step import build_train_step  # noqa: E402


def _tree():
    return {"a": torch.arange(6, dtype=torch.float32).reshape(2, 3),
            "b": {"c": torch.ones((4,), dtype=torch.bfloat16),
                  "d": torch.zeros((3,), dtype=torch.int8)}}


def _leaves(tree):
    return list(ckpt.flatten(tree).values())


def test_roundtrip_exact(tmp_path):
    t = _tree()
    t["b"]["c"][1] = 1.0078125           # a bf16 value that is not 1
    ckpt.save(str(tmp_path), 7, t)
    back, manifest = ckpt.restore(str(tmp_path), t)
    assert manifest["step"] == 7
    assert manifest["dtypes"]["b/c"] == "bfloat16"
    for a, b in zip(_leaves(t), _leaves(back)):
        assert a.dtype == b.dtype
        assert torch.equal(a, b)


def test_roundtrip_of_model_and_optimizer_state(tmp_path):
    """A model's state_dict and an int8 AdamWState (named tuples of
    Quantized payloads) come back equal, in their own types."""
    model = build(registry.get_reduced("qwen3-8b")).init(seed=0,
                                                         device="cpu")
    opt = AdamW(state_dtype="int8")
    state = opt.init(model)
    tree = {"params": model.state_dict(), "opt": state}
    ckpt.save(str(tmp_path), 1, tree)
    back, _ = ckpt.restore(str(tmp_path), tree)
    assert type(back["opt"]) is type(state)
    assert type(back["opt"].m["embed/tok"]) is type(state.m["embed/tok"])
    for a, b in zip(_leaves(tree), _leaves(back)):
        assert a.dtype == b.dtype and torch.equal(a, b)


def test_latest_pointer_and_prune(tmp_path):
    t = _tree()
    for s in (1, 2, 3, 4):
        ckpt.save(str(tmp_path), s, t)
    assert ckpt.latest_step(str(tmp_path)) == 4
    removed = ckpt.prune(str(tmp_path), keep=2)
    assert len(removed) == 2
    assert ckpt.latest_step(str(tmp_path)) == 4


def test_shape_mismatch_rejected(tmp_path):
    ckpt.save(str(tmp_path), 1, {"a": torch.ones((2, 2))})
    with pytest.raises(ValueError):
        ckpt.restore(str(tmp_path), {"a": torch.ones((3, 3))})


def test_latest_step_skips_truncated_manifest(tmp_path):
    t = _tree()
    for s in (1, 2, 3):
        ckpt.save(str(tmp_path), s, t)
    # crash-truncate the newest manifest: LATEST points at garbage
    mpath = tmp_path / "step_00000003" / "manifest.json"
    mpath.write_text(mpath.read_text()[:20])
    assert ckpt.latest_step(str(tmp_path)) == 2
    back, manifest = ckpt.restore(str(tmp_path), t)
    assert manifest["step"] == 2
    for a, b in zip(_leaves(t), _leaves(back)):
        assert torch.equal(a, b)


def test_latest_step_mixed_validity(tmp_path):
    """Restore picks the newest *complete* checkpoint across a mix of
    valid, truncated-npz, missing-manifest, and missing-key dirs."""
    t = _tree()
    for s in (1, 2, 3, 4, 5):
        ckpt.save(str(tmp_path), s, t)
    npz = tmp_path / "step_00000005" / "arrays.npz"
    npz.write_bytes(npz.read_bytes()[:10])
    (tmp_path / "step_00000004" / "manifest.json").unlink()
    m = tmp_path / "step_00000003" / "manifest.json"
    doc = json.loads(m.read_text())
    doc["keys"].append("ghost/leaf")
    m.write_text(json.dumps(doc))
    assert ckpt.latest_step(str(tmp_path)) == 2
    _back, manifest = ckpt.restore(str(tmp_path), t)
    assert manifest["step"] == 2


def test_latest_step_stale_pointer(tmp_path):
    t = _tree()
    ckpt.save(str(tmp_path), 1, t)
    ckpt.save(str(tmp_path), 2, t)
    (tmp_path / "LATEST").write_text("step_00000009")
    assert ckpt.latest_step(str(tmp_path)) == 2
    empty = tmp_path / "empty"
    empty.mkdir()
    assert ckpt.latest_step(str(empty)) is None
    with pytest.raises(FileNotFoundError):
        ckpt.restore(str(empty), t)


def test_restore_survives_prune_race(tmp_path, monkeypatch):
    """A checkpoint vanishing between selection and read (prune racing
    restore) must fall through to an older survivor, not crash."""
    t = _tree()
    ckpt.save(str(tmp_path), 1, t)
    ckpt.save(str(tmp_path), 2, t)
    real = ckpt._restore_path
    calls = {"n": 0}

    def racy(path, template):
        calls["n"] += 1
        if calls["n"] == 1 and path.endswith("step_00000002"):
            import shutil as _sh
            _sh.rmtree(path)
            raise FileNotFoundError(path)
        return real(path, template)

    monkeypatch.setattr(ckpt, "_restore_path", racy)
    _back, manifest = ckpt.restore(str(tmp_path), t)
    assert manifest["step"] == 1
    assert calls["n"] == 2


# ------------------------------------------------------------------ trainer

def _setup(seed=0):
    model = build(registry.get_reduced("qwen3-8b")).init(seed=seed,
                                                         device="cpu")
    opt = AdamW(lr=1e-3)
    toks = np.random.default_rng(1).integers(0, 512, (2, 17))
    batch = {"tokens": torch.from_numpy(toks[:, :-1].copy()),
             "labels": torch.from_numpy(toks[:, 1:].copy())}
    step = build_train_step(model, ParallelismConfig(), opt)
    return model, opt, batch, step


def _trainer(tmp_path, dirname="", injector=None, seed=0, **ft):
    model, opt, batch, step = _setup(seed)
    return ResilientTrainer(
        step_fn=step, params=model, opt_state=opt.init(model),
        cfg=FTConfig(ckpt_dir=str(tmp_path / dirname), **ft),
        batch_source=lambda: batch, failure_injector=injector)


def _assert_same_params(a, b):
    for (n, x), (_, y) in zip(a.params.named_parameters(),
                              b.params.named_parameters()):
        assert torch.equal(x, y), n


def test_resilient_trainer_survives_failures(tmp_path):
    """Inject failures mid-run; the final state must equal a failure-free
    run (determinism of restore + fixed batch stream)."""
    clean = _trainer(tmp_path, "clean", ckpt_every=5, max_restarts=5)
    clean.run(20)
    fails = {12: True, 17: True}
    faulty = _trainer(tmp_path, "faulty", ckpt_every=5, max_restarts=5,
                      injector=lambda s: fails.pop(s, False))
    faulty.run(20)
    assert faulty.restarts == 2
    _assert_same_params(clean, faulty)


def test_trainer_restart_without_checkpoint_resets_to_step0(tmp_path):
    """A failure before the first checkpoint restores the initial state
    (step 0) instead of crashing on the empty checkpoint dir — and the
    final params still match a failure-free run."""
    clean = _trainer(tmp_path, "clean", ckpt_every=50, max_restarts=3)
    clean.run(6)
    fails = {3: True}
    faulty = _trainer(tmp_path, "faulty", ckpt_every=50, max_restarts=3,
                      injector=lambda s: fails.pop(s, False))
    faulty.run(6)
    assert faulty.restarts == 1
    _assert_same_params(clean, faulty)


def test_trainer_restart_on_corrupt_checkpoint(tmp_path):
    """All checkpoints corrupt -> graceful reset to step 0, no raise."""
    t = _trainer(tmp_path, ckpt_every=2, max_restarts=3)
    initial = {n: p.detach().clone() for n, p in
               t.params.named_parameters()}
    t.run(4)                         # writes step_2, step_4
    for d in tmp_path.glob("step_*"):
        (d / "manifest.json").write_text("{")
    t._restart()
    assert t.step == 0 and t.restarts == 1
    assert int(t.opt_state.step) == 0
    for n, p in t.params.named_parameters():
        assert torch.equal(p, initial[n]), n
    t.run(6)                         # trains forward again from scratch
    assert t.step == 6


def test_trainer_consults_failed_hosts(tmp_path):
    """A host marked dead in the heartbeat registry triggers a restore
    before the next step and is re-admitted afterwards."""
    t = _trainer(tmp_path, ckpt_every=2, max_restarts=3)
    assert isinstance(t.heartbeats, HeartbeatRegistry)
    t.run(4)
    t.heartbeats.mark_dead(7)
    t.run(8)
    assert t.restarts == 1
    assert t.step == 8
    assert not t.heartbeats.is_dead(7)


def test_trainer_restart_budget_exhausted(tmp_path):
    t = _trainer(tmp_path, max_restarts=1, injector=lambda s: True)
    with pytest.raises(RuntimeError, match="restart budget"):
        t.run(4)


def test_resume_after_interrupt(tmp_path):
    t1 = _trainer(tmp_path, ckpt_every=5)
    t1.run(10)                       # writes step_10
    t2 = _trainer(tmp_path, ckpt_every=5, seed=9)
    t2.run(12)                       # must resume from 10, not retrain
    assert t2.step == 12
    assert len(t2.history) == 2
    # the resumed run continues the first: two more steps of t1 agree
    t1.run(12)
    _assert_same_params(t1, t2)


def test_straggler_substitute_replaces_a_late_batch(tmp_path):
    """A batch that misses its deadline (on the injected clock) is
    replaced by the substitute and counted."""
    class Clock:
        t = 0.0

        def now(self):
            return self.t

    model, opt, batch, step = _setup()
    clock = Clock()

    def slow():
        clock.t += 1.0
        return batch

    t = ResilientTrainer(
        step, model, opt.init(model),
        FTConfig(ckpt_dir=str(tmp_path), batch_deadline_s=0.5),
        batch_source=slow, straggler_substitute=lambda: batch, clock=clock)
    t.run(2)
    assert t.straggler_substitutions == 2
