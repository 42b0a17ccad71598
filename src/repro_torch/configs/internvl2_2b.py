"""internvl2-2b [vlm] — InternViT + InternLM2 [arXiv:2404.16821; hf].

24L d_model=2048 16H (GQA kv=8) d_ff=8192 vocab=92553.  The InternViT
frontend is a STUB, as in the reference: the batch supplies precomputed
patch embeddings (256 visual tokens per image, ``patch_embeds``) that are
prepended to the text sequence.  1,895,925,760 parameters in the defs
(vocab padded to 94,208).
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="internvl2-2b",
    family="vlm",
    n_layers=24,
    d_model=2048,
    n_heads=16,
    n_kv_heads=8,
    d_ff=8192,
    vocab_size=92_553,
    head_dim=128,
    frontend="vision_stub",
    frontend_tokens=256,
    rope_theta=1_000_000.0,
    source="arXiv:2404.16821; hf",
)


def reduced() -> ModelConfig:
    import dataclasses
    return dataclasses.replace(
        CONFIG, n_layers=2, d_model=64, n_heads=4, n_kv_heads=2, d_ff=128,
        vocab_size=512, head_dim=16, frontend_tokens=8)
