"""Public model API: ``build(cfg)`` -> :class:`Model`, an ``nn.Module``
holding the parameters under the reference's names, with forward,
prefill, decode and caches.

The reference's ``Model`` is a stateless frozen dataclass whose methods
take a ``params`` pytree; the port's ``Model`` owns its parameters, so
the methods drop that argument: ``model.forward(batch)`` is the
reference's ``model.forward(params, batch)`` and ``model.loss(batch)``
its ``model.loss(params, batch)``.

For the dry-run (``launch/dryrun.py``), as in the reference:
``input_specs(shape)`` gives each input of a cell as a ``(shape, dtype)``
pair, ``batch_logical_axes(shape)`` their logical sharding axes, and
``abstract(dtype)`` / ``abstract_cache(batch, s_max)`` the parameters and
the decode cache as tensors with no data (``params.abstract_params``).
"""
from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch

from repro_torch.configs.base import ModelConfig, ShapeConfig
from repro_torch.kernels.device import resolve_device
from repro_torch.models import transformer as tfm
from repro_torch.models.params import (ParamTree, abstract_params, init_tree,
                                       param_count)

#: an input of a cell: (shape, dtype)
Spec = Tuple[Tuple[int, ...], torch.dtype]


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

    # ---- dry-run ----
    def abstract(self, dtype: torch.dtype = torch.bfloat16) -> Dict:
        """The parameters as ``params.abstract_params`` gives them (the
        reference's stacked leaves)."""
        return abstract_params(self.defs, dtype)

    def abstract_cache(self, batch: int, s_max: int) -> Dict:
        return abstract_params(self.cache_defs(batch, s_max))

    def input_specs(self, shape: ShapeConfig) -> Dict[str, Spec]:
        """Every model input of a cell as a ``(shape, dtype)`` pair, in
        the reference's order.  train/prefill: the full-sequence batch;
        decode: one new token (the cache is an argument of its own,
        ``abstract_cache``).  Modality frontends are stubs, as in the
        reference: the vlm's ``p`` patch embeddings beside ``S - p``
        tokens, the encdec's ``encdec_src_len(S)`` source frames."""
        cfg = self.cfg
        B, S = shape.global_batch, shape.seq_len
        i32, bf16 = torch.int32, torch.bfloat16
        if shape.kind == "decode":
            return {"tokens": ((B, 1), i32)}
        if cfg.family == "encoder":
            spec = {"patch_embeds": ((B, cfg.frontend_tokens, cfg.d_model),
                                     bf16)}
            if shape.is_train:
                spec["labels"] = ((B,), i32)
            return spec
        if cfg.family == "vlm":
            p = cfg.frontend_tokens
            spec = {"tokens": ((B, S - p), i32),
                    "patch_embeds": ((B, p, cfg.d_model), bf16)}
        elif cfg.family in ("encdec", "audio"):
            spec = {"tokens": ((B, S), i32),
                    "src_embeds": ((B, tfm.encdec_src_len(S), cfg.d_model),
                                   bf16)}
        else:
            spec = {"tokens": ((B, S), i32)}
        if shape.is_train:
            spec["labels"] = ((B, S), i32)
        return spec

    def batch_logical_axes(self, shape: ShapeConfig) -> Dict[str, Tuple]:
        """The logical sharding axes of each input of ``input_specs``."""
        out: Dict[str, Tuple] = {}
        for name in self.input_specs(shape):
            if name in ("tokens", "labels"):
                if self.cfg.family == "encoder" and name == "labels":
                    out[name] = ("batch",)
                else:
                    out[name] = ("batch", "act_seq")
            elif name in ("patch_embeds", "src_embeds"):
                out[name] = ("batch", None, "act_embed")
        return out


def build(cfg: ModelConfig) -> Model:
    return Model(cfg)
