"""qwen1.5-32b [dense] — QKV bias [hf:Qwen/Qwen1.5-0.5B; hf].

64L d_model=5120 40H (GQA kv=40) d_ff=27392 vocab=152064.
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="qwen1.5-32b",
    family="dense",
    n_layers=64,
    d_model=5120,
    n_heads=40,
    n_kv_heads=40,
    d_ff=27_392,
    vocab_size=152_064,
    qkv_bias=True,
    rope_theta=1_000_000.0,
    source="hf:Qwen/Qwen1.5-0.5B; hf",
)


def reduced() -> ModelConfig:
    import dataclasses
    return dataclasses.replace(
        CONFIG, n_layers=2, d_model=64, n_heads=4, n_kv_heads=4, d_ff=160,
        vocab_size=512)
