"""Fault tolerance: heartbeats, failure detection, restart, stragglers.

The port's twin of ``repro.distributed.ft``.  ``ResilientTrainer`` wraps
a train step with the production loop:

* periodic atomic checkpoints (distributed/checkpoint.py);
* a heartbeat registry — hosts that miss ``dead_after`` heartbeats are
  declared failed; the trainer restores the latest checkpoint and
  resumes;
* straggler mitigation for the *data* path: if a batch misses its
  deadline, a substitute batch (cached unseen samples from the ODS
  service) takes its place instead of stalling the step;
* failure injection hooks for tests/examples.

The reference's trainer holds immutable pytrees; the port's holds the
model (an ``nn.Module``, updated in place by the step) and the optimizer
state.  A checkpoint stores ``{"params": model.state_dict(), "opt":
opt_state}``; a restore copies it back into the model and replaces the
optimizer state.  The initial state is kept as a host copy, so a missing
or corrupt checkpoint restarts from step 0 instead of crashing the job.

All timing runs on an injected ``Clock`` (default
:class:`~repro_torch.workload.clock.RealClock`), so heartbeat expiry and
batch deadlines are testable under ``VirtualClock``.
"""
from __future__ import annotations

import os
import tempfile
from dataclasses import dataclass, field
from typing import Any, Callable, Dict, List, Optional

import torch

from repro_torch.distributed import checkpoint as ckpt
from repro_torch.faults.liveness import LivenessRegistry


class HeartbeatRegistry(LivenessRegistry):
    """Host-liveness view kept for API compatibility: ``beat(host)`` /
    ``failed_hosts()`` over the generalized registry."""

    def failed_hosts(self, now: Optional[float] = None) -> List[int]:
        return self.failed(now)


@dataclass
class FTConfig:
    # the reference's default is /tmp/repro_ckpt; the port's follows TMPDIR
    ckpt_dir: str = field(default_factory=lambda: os.path.join(
        tempfile.gettempdir(), "repro_torch_ckpt"))
    ckpt_every: int = 50
    keep: int = 3
    dead_after_s: float = 10.0
    batch_deadline_s: Optional[float] = None   # straggler cutoff
    max_restarts: int = 10


def _host_copy(tree):
    return ckpt.map_leaves(
        lambda _, x: x.detach().to("cpu", copy=True)
        if isinstance(x, torch.Tensor) else x, tree)


def _onto(template, values):
    """``values`` (same structure) with each tensor on its template
    leaf's device and dtype."""
    flat = ckpt.flatten(values)
    return ckpt.map_leaves(
        lambda k, t: flat[k].to(device=t.device, dtype=t.dtype, copy=True)
        if isinstance(t, torch.Tensor) else flat[k], template)


class ResilientTrainer:
    """step_fn(model, opt_state, batch) -> (model, opt_state, metrics)."""

    def __init__(self, step_fn: Callable, params: torch.nn.Module,
                 opt_state, cfg: FTConfig,
                 batch_source: Callable[[], Any],
                 straggler_substitute: Optional[Callable[[], Any]] = None,
                 failure_injector: Optional[Callable[[int], bool]] = None,
                 clock: Optional[Any] = None):
        if clock is None:
            from repro_torch.workload.clock import RealClock
            clock = RealClock()
        self.clock = clock
        self.step_fn = step_fn
        self.params = params
        self.opt_state = opt_state
        # keep the initial state (on the host) so a missing/corrupt
        # checkpoint restarts from step 0 instead of crashing the job
        self._init_params = _host_copy(params.state_dict())
        self._init_opt = _host_copy(opt_state)
        self.cfg = cfg
        self.batch_source = batch_source
        self.straggler_substitute = straggler_substitute
        self.failure_injector = failure_injector
        self.heartbeats = HeartbeatRegistry(cfg.dead_after_s, clock=clock)
        self.step = 0
        self.restarts = 0
        self.straggler_substitutions = 0
        self.history: List[Dict] = []

    # ------------------------------------------------------------------
    def _state(self) -> Dict:
        return {"params": self.params.state_dict(), "opt": self.opt_state}

    def _checkpoint(self) -> None:
        ckpt.save(self.cfg.ckpt_dir, self.step, self._state(),
                  extras={"restarts": self.restarts})
        ckpt.prune(self.cfg.ckpt_dir, self.cfg.keep)

    def _restore(self) -> None:
        """Restore the newest complete checkpoint; with none usable,
        restart from the initial state at step 0 rather than crash."""
        try:
            tree, manifest = ckpt.restore(self.cfg.ckpt_dir, self._state())
            step = manifest["step"]
        except (FileNotFoundError, ValueError, KeyError, OSError):
            tree = _onto(self._state(), {"params": self._init_params,
                                         "opt": self._init_opt})
            step = 0
        with torch.no_grad():
            self.params.load_state_dict(tree["params"])
        self.opt_state = tree["opt"]
        self.step = step

    # ------------------------------------------------------------------
    def _get_batch(self):
        if self.cfg.batch_deadline_s is None or \
                self.straggler_substitute is None:
            return self.batch_source()
        t0 = self.clock.now()
        batch = self.batch_source()
        if self.clock.now() - t0 > self.cfg.batch_deadline_s:
            self.straggler_substitutions += 1
            return self.straggler_substitute()
        return batch

    def _restart(self) -> None:
        if self.restarts >= self.cfg.max_restarts:
            raise RuntimeError("restart budget exhausted")
        self.restarts += 1
        self._restore()

    def run(self, n_steps: int) -> List[Dict]:
        if ckpt.latest_step(self.cfg.ckpt_dir) is not None:
            self._restore()            # resume an interrupted run
        while self.step < n_steps:
            if self.failure_injector and self.failure_injector(self.step):
                # simulated node failure: lose in-memory state, restart
                self._restart()
                continue
            failed = self.heartbeats.failed_hosts()
            if failed:
                # a host missed its heartbeat window (or was marked dead
                # by a fault injector): restore and bring it back in
                self._restart()
                for h in failed:
                    self.heartbeats.mark_alive(h)
                continue
            batch = self._get_batch()
            self.params, self.opt_state, metrics = self.step_fn(
                self.params, self.opt_state, batch)
            self.step += 1
            self.heartbeats.beat(0)
            rec = {k: float(v) for k, v in metrics.items()}
            rec["step"] = self.step
            self.history.append(rec)
            if self.step % self.cfg.ckpt_every == 0:
                self._checkpoint()
        self._checkpoint()
        return self.history
