"""Architecture registry: ``--arch <id>`` resolution.

``get(arch_id)`` returns the full ModelConfig and ``get_reduced(arch_id)``
the smoke-test config, as in the reference.  Every arch the reference
knows resolves, of every family: dense, moe, vlm, encdec, ssm, hybrid
and encoder; an unknown arch raises ``KeyError``.  The reference's
layout policy (``default_parallelism``) belongs to the distributed
layer, which is not ported yet.
"""
from __future__ import annotations

import importlib
from typing import Dict, List

from repro_torch.configs.base import ModelConfig

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
