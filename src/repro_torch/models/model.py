"""Public model API: ``build(cfg)`` -> :class:`Model`, an ``nn.Module``
holding the parameters under the reference's names, with forward,
prefill, decode and caches.

The reference's ``Model`` is a stateless frozen dataclass whose methods
take a ``params`` pytree; the port's ``Model`` owns its parameters, so
the methods drop that argument: ``model.forward(batch)`` is the
reference's ``model.forward(params, batch)`` and ``model.loss(batch)``
its ``model.loss(params, batch)``.  The dry-run's abstract
shapes and ``input_specs`` belong to the XLA tooling, not ported yet.
"""
from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.kernels.device import resolve_device
from repro_torch.models import transformer as tfm
from repro_torch.models.params import ParamTree, init_tree, param_count


class Model(ParamTree):
    def __init__(self, cfg: ModelConfig):
        super().__init__(tfm.param_defs(cfg))
        self.cfg = cfg

    # ---- params ----
    def init(self, generator: Optional[torch.Generator] = None,
             dtype: torch.dtype = torch.bfloat16, *, seed: int = 0,
             device=None) -> "Model":
        """Materialize the parameters from ``generator`` on its device
        (default: a generator seeded with ``seed`` on ``device``, which
        is CUDA when None).  Returns ``self``."""
        if generator is None:
            generator = torch.Generator(device=resolve_device(device))
            generator.manual_seed(seed)
        init_tree(self, generator, dtype)
        return self

    @property
    def device(self) -> torch.device:
        return self.final_norm.device

    def n_params(self) -> int:
        return param_count(self.defs)

    # ---- compute ----
    def loss(self, batch: Dict, *, remat: str = "none") -> torch.Tensor:
        """Training loss (scalar float32) with autograd on: the training
        step turns the parameters' gradients on; serving leaves them off
        and keeps to the ``no_grad`` methods below."""
        return tfm.loss_fn(self, self.cfg, batch, remat=remat)

    @torch.no_grad()
    def forward(self, batch: Dict) -> Tuple[torch.Tensor, torch.Tensor]:
        return tfm.forward(self, self.cfg, batch)

    @torch.no_grad()
    def prefill(self, batch: Dict, cache: Dict):
        return tfm.prefill(self, self.cfg, batch, cache)

    @torch.no_grad()
    def decode_step(self, cache: Dict, tokens: torch.Tensor, index: int):
        return tfm.decode_step(self, self.cfg, cache, tokens, index)

    # ---- caches ----
    def cache_defs(self, batch: int, s_max: int) -> Dict:
        return tfm.cache_defs(self.cfg, batch, s_max)

    def init_cache(self, batch: int, s_max: int) -> Dict:
        """Zero caches on the parameters' device."""
        return {name: torch.zeros(d.shape, dtype=d.dtype, device=self.device)
                for name, d in self.cache_defs(batch, s_max).items()}


def build(cfg: ModelConfig) -> Model:
    return Model(cfg)
