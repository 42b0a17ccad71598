"""kimi-k2-1t-a32b [moe] — trillion-param MoE (paper-table)
[arXiv:2501.kimi2; unverified].

61L d_model=7168 64H (GQA kv=8) d_ff=2048 (per expert) vocab=163840,
MoE 384 routed experts top-8 (+1 shared).
"""
from repro_torch.configs.base import ModelConfig, MoEConfig

CONFIG = ModelConfig(
    name="kimi-k2-1t-a32b",
    family="moe",
    n_layers=61,
    d_model=7168,
    n_heads=64,
    n_kv_heads=8,
    d_ff=2048,
    vocab_size=163_840,
    head_dim=128,
    moe=MoEConfig(n_experts=384, top_k=8, n_shared=1, d_ff_expert=2048),
    rope_theta=50_000.0,
    source="arXiv:2501.kimi2; unverified",
)


def reduced() -> ModelConfig:
    import dataclasses
    return dataclasses.replace(
        CONFIG, n_layers=2, d_model=64, n_heads=4, n_kv_heads=2, d_ff=64,
        vocab_size=512, head_dim=16,
        moe=MoEConfig(n_experts=8, top_k=2, n_shared=1, d_ff_expert=64))
