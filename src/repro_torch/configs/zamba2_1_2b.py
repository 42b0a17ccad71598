"""zamba2-1.2b [hybrid] — Mamba2 + shared attn blocks [arXiv:2411.15242; hf].

38L d_model=2048 32H (GQA kv=32) d_ff=8192 vocab=32000, ssm_state=64.
A single weight-tied attention+MLP block is applied every 6 mamba layers
(Zamba2's shared-block design).  At long context the shared attention uses a
sliding window (4096) which keeps the arch sub-quadratic for long_500k.
"""
from repro_torch.configs.base import ModelConfig, SSMConfig

CONFIG = ModelConfig(
    name="zamba2-1.2b",
    family="hybrid",
    n_layers=38,
    d_model=2048,
    n_heads=32,
    n_kv_heads=32,
    d_ff=8192,
    vocab_size=32_000,
    ssm=SSMConfig(d_state=64, head_dim=64, expand=2),
    hybrid_attn_every=6,
    attn_window=4096,
    rope_theta=10_000.0,
    source="arXiv:2411.15242; hf",
)


def reduced() -> ModelConfig:
    import dataclasses
    return dataclasses.replace(
        CONFIG, n_layers=4, d_model=64, n_heads=4, n_kv_heads=4, d_ff=128,
        vocab_size=512, ssm=SSMConfig(d_state=16, head_dim=16, expand=2),
        hybrid_attn_every=2, attn_window=64)
