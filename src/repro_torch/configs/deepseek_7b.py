"""deepseek-7b [dense] — llama-arch [arXiv:2401.02954; hf].

30L d_model=4096 32H (GQA kv=32) d_ff=11008 vocab=102400.
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="deepseek-7b",
    family="dense",
    n_layers=30,
    d_model=4096,
    n_heads=32,
    n_kv_heads=32,
    d_ff=11_008,
    vocab_size=102_400,
    rope_theta=10_000.0,
    source="arXiv:2401.02954; hf",
)


def reduced() -> ModelConfig:
    import dataclasses
    return dataclasses.replace(
        CONFIG, n_layers=2, d_model=64, n_heads=4, n_kv_heads=4, d_ff=128,
        vocab_size=512)
