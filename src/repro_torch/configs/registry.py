"""Architecture registry: ``--arch <id>`` resolution.

``get(arch_id)`` returns the full ModelConfig and ``get_reduced(arch_id)``
the smoke-test config, as in the reference.  Every arch the reference
knows resolves, of every family: dense, moe, vlm, encdec, ssm, hybrid
and encoder; an unknown arch raises ``KeyError``.
``ASSIGNED_ARCHS`` are the archs the dry-run sweeps (``launch/dryrun.py``).
``default_parallelism(model, shape)`` is the reference's layout policy
for one (arch x shape) cell, which ``distributed.sharding.make_rules``
turns into sharding rules.
"""
from __future__ import annotations

import importlib
from typing import Dict, List, Tuple

from repro_torch.configs.base import ModelConfig, ParallelismConfig, ShapeConfig

#: arch id -> module of the port
_MODULES: Dict[str, str] = {
    "seamless-m4t-large-v2": "repro_torch.configs.seamless_m4t_large_v2",
    "qwen1.5-32b": "repro_torch.configs.qwen1_5_32b",
    "llama3-405b": "repro_torch.configs.llama3_405b",
    "qwen3-8b": "repro_torch.configs.qwen3_8b",
    "deepseek-7b": "repro_torch.configs.deepseek_7b",
    "deepseek-moe-16b": "repro_torch.configs.deepseek_moe_16b",
    "kimi-k2-1t-a32b": "repro_torch.configs.kimi_k2_1t_a32b",
    "internvl2-2b": "repro_torch.configs.internvl2_2b",
    "zamba2-1.2b": "repro_torch.configs.zamba2_1_2b",
    "mamba2-1.3b": "repro_torch.configs.mamba2_1_3b",
    "vit-huge": "repro_torch.configs.vit_huge",
}

#: the archs of the dry-run's sweep (``--arch all``): all but vit-huge, in
#: the reference's order
ASSIGNED_ARCHS: Tuple[str, ...] = tuple(k for k in _MODULES if k != "vit-huge")


def list_archs() -> List[str]:
    return list(_MODULES)


def _module(arch_id: str):
    if arch_id not in _MODULES:
        raise KeyError(f"unknown arch {arch_id!r}; known: {sorted(_MODULES)}")
    return importlib.import_module(_MODULES[arch_id])


def get(arch_id: str) -> ModelConfig:
    return _module(arch_id).CONFIG


def get_reduced(arch_id: str) -> ModelConfig:
    return _module(arch_id).reduced()


# ---------------------------------------------------------------------------
# Default layout policy
# ---------------------------------------------------------------------------

# Archs whose param+optimizer footprint forces FSDP (ZeRO-style sharding of
# params/grads/opt-state over the 'data' axis) on a 16 GB/chip pod.
_FSDP_ARCHS = {"llama3-405b", "kimi-k2-1t-a32b", "qwen1.5-32b"}
# 8-bit optimizer state for the 1T arch.
_OPT8_ARCHS = {"kimi-k2-1t-a32b"}

# Small archs whose 16-way TP is collective-bound at train_4k: pure-DP
# (batch over both axes, params replicated) removes the per-layer
# activation reductions.  Applied to the <=2.5B archs whose replicated
# params fit.
_PURE_DP_TRAIN = {"internvl2-2b", "mamba2-1.3b", "zamba2-1.2b",
                  "seamless-m4t-large-v2"}


def default_parallelism(model: ModelConfig,
                        shape: ShapeConfig) -> ParallelismConfig:
    p = ParallelismConfig()
    if model.moe is not None:
        p = p.replace(ep=True)
    if shape.is_train:
        if model.name in _FSDP_ARCHS:
            p = p.replace(fsdp=True, remat="block", microbatches=4)
        if model.name in _OPT8_ARCHS:
            # microbatches=1 avoids re-gathering FSDP shards per
            # microbatch; int8 moments use the structured block layout
            # (train/optimizer.py) so they inherit param specs
            p = p.replace(opt_state_dtype="int8", microbatches=1)
        elif model.name in _FSDP_ARCHS:
            p = p.replace(opt_state_dtype="bfloat16")
        if model.name in _PURE_DP_TRAIN and \
                shape.global_batch % 256 == 0:
            p = p.replace(tp=False, dp_over_model=True)
    else:
        # inference: no optimizer, no remat; batch=1 long decode replicates
        # data axis and uses sequence-parallel state sharding where possible.
        p = p.replace(remat="none", microbatches=1)
        if shape.name == "long_500k":
            p = p.replace(sp=True)
        if shape.name == "prefill_32k":
            p = p.replace(sp=True)   # sequence-shard activations for prefill
        if shape.kind == "prefill" and model.family == "ssm":
            # sequence-parallel SSD replaces per-layer TP reductions with
            # small state hand-offs (models/ssm_sp.py)
            p = p.replace(tp=False, sp_ssd=True)
    return p
