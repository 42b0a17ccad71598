"""Serving steps: batched prefill + decode with KV caches.

The port's twin of ``repro.serve.step``.  ``Server`` implements simple
continuous batching over a fixed slot count: requests occupy slots, a
prompt is prefilled token by token through ``decode_step``, and decode
steps advance all active slots in lockstep.  The reference jits one
decode program; PyTorch runs eagerly, so the port calls
``model.decode_step`` directly.

The scheduling is the reference's, behaviour included: every step runs
``decode_step`` over all ``n_slots`` rows (token 0 in rows not being
stepped) at one shared position, and keeps the whole new cache, so a
request's output depends on what the other slots hold.  Fixing that
changes both packages together (ROADMAP.md, Queue 3).

Requests carry arrival/admit/finish timestamps stamped through a
pluggable ``now`` time source — per-request end-to-end latency is
``done_s - arrival_s``, queue wait is ``admitted_s - arrival_s``.
"""
from __future__ import annotations

import dataclasses
import time
from typing import Callable, List, Optional

import numpy as np
import torch

from repro_torch.models.model import Model


@dataclasses.dataclass
class Request:
    req_id: int
    prompt: np.ndarray           # (prompt_len,) int32
    max_new: int = 16
    arrival_s: float = 0.0       # caller-stamped (open-loop generators)
    # runtime
    generated: List[int] = dataclasses.field(default_factory=list)
    done: bool = False
    admitted_s: float = 0.0      # server-stamped at slot admission
    done_s: float = 0.0          # server-stamped when max_new reached

    @property
    def latency_s(self) -> float:
        """End-to-end arrival→finish latency (0 until done)."""
        return self.done_s - self.arrival_s if self.done else 0.0


class Server:
    """Batched decode over ``n_slots`` sequences with a shared step, on
    the model's device."""

    def __init__(self, model: Model, n_slots: int, s_max: int,
                 now: Optional[Callable[[], float]] = None):
        self.model = model
        self.n_slots = n_slots
        self.s_max = s_max
        self.cache = model.init_cache(batch=n_slots, s_max=s_max)
        self.pos = np.zeros(n_slots, np.int64)
        self.slots: List[Optional[Request]] = [None] * n_slots
        self._now = now or time.monotonic
        self.steps = 0

    def _decode(self, tokens: np.ndarray, index: int) -> torch.Tensor:
        logits, self.cache = self.model.decode_step(
            self.cache, torch.from_numpy(tokens).to(self.model.device),
            index)
        return logits

    def _argmax(self, logits: torch.Tensor, slot: int) -> int:
        return int(torch.argmax(logits[slot, 0, :self.model.cfg.vocab_size]))

    def add_request(self, req: Request) -> bool:
        for i, s in enumerate(self.slots):
            if s is None:
                self.slots[i] = req
                self.pos[i] = 0
                req.admitted_s = self._now()
                # sequential prefill through the decode path, as in the
                # reference; bulk prefill is model.prefill
                for t in req.prompt:
                    self._step_slot(i, int(t))
                return True
        return False

    def _step_slot(self, slot: int, token: int) -> int:
        tokens = np.zeros((self.n_slots, 1), np.int32)
        tokens[slot, 0] = token
        logits = self._decode(tokens, int(self.pos[slot]))
        self.pos[slot] += 1
        self.steps += 1
        return self._argmax(logits, slot)

    def decode_round(self) -> int:
        """One lockstep decode for all active slots; returns #active."""
        active = [i for i, s in enumerate(self.slots)
                  if s is not None and not s.done]
        if not active:
            return 0
        tokens = np.zeros((self.n_slots, 1), np.int32)
        for i in active:
            req = self.slots[i]
            tokens[i, 0] = req.generated[-1] if req.generated else \
                int(req.prompt[-1])
        # all slots share one position index in this simple scheduler:
        # step the furthest active slot's position (as the reference)
        idx = int(self.pos[active].max())
        logits = self._decode(tokens, idx)
        for i in active:
            req = self.slots[i]
            req.generated.append(self._argmax(logits, i))
            self.pos[i] = idx + 1
            if len(req.generated) >= req.max_new:
                req.done = True    # caller harvests and frees the slot
                req.done_s = self._now()
        self.steps += 1
        return len(active)
