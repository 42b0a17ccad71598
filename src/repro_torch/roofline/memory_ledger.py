"""Analytic HBM ledger per (arch x shape x layout): what lives on a chip.

The port's twin of ``repro.roofline.memory_ledger``: a hardware-
independent budget of one chip — parameters, gradients, optimizer
moments, KV/state caches and one microbatch of activations under the
cell's sharding — and the deployment question it answers for a cell over
budget: how many pods does this config need?  The budget is a
:class:`~repro_torch.roofline.analysis.Profile`'s HBM per chip (the
H100's by default).
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, Optional

from repro_torch.configs.base import ModelConfig, ParallelismConfig, ShapeConfig
from repro_torch.roofline.analysis import H100, Profile


@dataclass
class Ledger:
    params: float
    grads: float
    opt_state: float
    cache_or_state: float
    activations: float

    @property
    def total(self) -> float:
        return (self.params + self.grads + self.opt_state
                + self.cache_or_state + self.activations)

    def fits(self, budget: Optional[float] = None,
             profile: Profile = H100) -> bool:
        """Whether the total fits ``budget`` bytes (default: the
        profile's HBM per chip)."""
        if budget is None:
            budget = profile.hbm_bytes_per_chip
        return self.total <= budget

    def pods_needed(self, profile: Profile = H100) -> int:
        """DP scale-out pods so the per-chip total fits HBM (activations
        shrink with pods; params/opt shrink only if FSDP spans pods)."""
        pods = 1
        while pods < 64:
            act = self.activations / pods
            fixed = self.params + self.grads + self.opt_state \
                + self.cache_or_state
            if fixed + act <= profile.hbm_bytes_per_chip:
                return pods
            pods *= 2
        return pods

    def as_dict(self) -> Dict[str, float]:
        return {"params_gb": self.params / 1e9,
                "grads_gb": self.grads / 1e9,
                "opt_gb": self.opt_state / 1e9,
                "cache_gb": self.cache_or_state / 1e9,
                "acts_gb": self.activations / 1e9,
                "total_gb": self.total / 1e9}


def build_ledger(cfg: ModelConfig, shape: ShapeConfig,
                 parallel: ParallelismConfig, chips: int = 16 * 16,
                 tp: int = 16, dp: int = 16) -> Ledger:
    """The ledger of one chip of ``chips`` (default: the production
    mesh's 16 x 16, ``launch/mesh.py``), ``tp`` model-parallel and ``dp``
    data-parallel ranks."""
    n = cfg.n_params()
    pbytes = 2.0                                   # bf16 params
    shard = chips if parallel.fsdp else tp         # FSDP: all chips
    params = n * pbytes / shard

    if shape.is_train:
        grads = n * pbytes / shard
        opt_mult = {"float32": 8.0, "bfloat16": 4.0, "int8": 2.02}[
            parallel.opt_state_dtype]
        opt = n * opt_mult / shard
        cache = 0.0
        # one microbatch of residual-stream activations per layer
        # (remat=block keeps ~2 tensors/layer live; none keeps ~8)
        b_loc = max(shape.global_batch // dp, 1) // max(
            parallel.microbatches, 1)
        live = 2 if parallel.remat != "none" else 8
        layers = cfg.n_layers + cfg.n_encoder_layers
        acts = b_loc * shape.seq_len * cfg.d_model * 2.0 * live * \
            max(layers, 1) / max(layers, 1)        # scan reuses per layer
        acts *= live
    else:
        grads = opt = 0.0
        acts = 0.0
        hd = cfg.resolved_head_dim
        if cfg.family in ("dense", "moe", "vlm", "encdec", "audio"):
            kv = (cfg.n_layers * 2 * cfg.n_kv_heads * hd
                  * shape.seq_len * 2.0 * shape.global_batch)
            # decode cells shard batch over data and KV-seq/heads over model
            cache = kv / chips
        else:
            s = cfg.ssm
            d_in = s.expand * cfg.d_model
            nh = d_in // s.head_dim
            cache = (cfg.n_layers * shape.global_batch * nh * s.head_dim
                     * s.d_state * 4.0) / max(dp, 1)
    return Ledger(params=params, grads=grads, opt_state=opt,
                  cache_or_state=cache, activations=acts)
