"""``"source": "tokens"``: seeded token batches, no loader.

The cell's ``batch`` rows of ``seq`` tokens a step, drawn from the seed.
The reference and the control read the same batches from the same seed.
"""
from __future__ import annotations

from typing import Dict, Iterator, List, Tuple

import numpy as np
import torch


def token_batches(seed: int, batch: int, seq: int,
                  vocab: int) -> Iterator[Dict[str, np.ndarray]]:
    """Seeded token batches: a frozen copy of the token stream of
    ``src/repro_torch/launch/train.py:50-81`` (``lm_batch_source``, its
    plain-token families): each batch ``batch`` rows of ``seq + 1``
    tokens drawn uniformly from the vocabulary, the first ``seq`` the
    input and the last ``seq`` the labels."""
    rng = np.random.default_rng(seed)
    while True:
        toks = rng.integers(0, vocab, size=(batch, seq + 1), dtype=np.int64)
        yield {"tokens": toks[:, :-1].copy(), "labels": toks[:, 1:].copy()}


class Feed:
    """The step's batches, on the device."""

    def __init__(self, cell: Dict, cfg: Dict, model_cfg, seed: int,
                 device):
        self.device = device
        self.it = token_batches(seed, cell["batch"], cell["seq"],
                                cfg["vocab_size"])

    def next(self):
        host = next(self.it)
        return {k: torch.from_numpy(v).to(self.device)
                for k, v in host.items()}, None

    def fill(self) -> None:
        pass

    def served(self) -> Dict[str, int]:
        return {}

    def close(self) -> None:
        pass


def control_batches(cell: Dict, cfg: Dict, seed: int,
                    device) -> List[Dict]:
    """The checked steps' batches, made again from the seed."""
    it = token_batches(seed, cell["batch"], cell["seq"], cfg["vocab_size"])
    return [{k: torch.from_numpy(v).to(device) for k, v in next(it).items()}
            for _ in range(cell["checked_steps"])]


def judge(cell: Dict, cfg: Dict, seed: int, device, checked: List,
          picked: List, served: List) -> Tuple[List[Dict], Dict]:
    """The reference's batches of the checked steps; no served data to
    judge."""
    return control_batches(cell, cfg, seed, device), {}
