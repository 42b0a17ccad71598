"""mamba2-1.3b [ssm] — SSD (state-space duality) [arXiv:2405.21060; unverified].

48L d_model=2048 (attn-free) vocab=50280, ssm_state=128.
d_inner = 2*d_model = 4096, head_dim=64 -> 64 SSD heads per layer.
"""
from repro_torch.configs.base import ModelConfig, SSMConfig

CONFIG = ModelConfig(
    name="mamba2-1.3b",
    family="ssm",
    n_layers=48,
    d_model=2048,
    n_heads=0,
    n_kv_heads=0,
    d_ff=0,
    vocab_size=50_280,
    ssm=SSMConfig(d_state=128, head_dim=64, expand=2),
    source="arXiv:2405.21060; unverified",
)


def reduced() -> ModelConfig:
    import dataclasses
    return dataclasses.replace(
        CONFIG, n_layers=2, d_model=64, vocab_size=512,
        ssm=SSMConfig(d_state=16, head_dim=16, expand=2))
