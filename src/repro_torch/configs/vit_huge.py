"""vit-huge — the paper's own largest model (ViT-h, Fig. 15) [arXiv:2010.11929].

Encoder-only classifier: 32L d_model=1280 16H d_ff=5120, patch16 @ 224px
-> 196 patch tokens + [CLS], 1000 ImageNet classes.  Its blocks carry the
zoo's gated (SwiGLU) MLP, three d_model x d_ff matrices, so the model
counts 840,476,160 parameters (head_dim 80, no qk-norm, no qkv bias).
This is the config Seneca's image pipeline actually feeds in the paper's
evaluation; it exercises the encoder-only path (no decode shapes).
"""
from repro_torch.configs.base import ModelConfig, ShapeConfig

CONFIG = ModelConfig(
    name="vit-huge",
    family="encoder",
    n_layers=32,
    d_model=1280,
    n_heads=16,
    n_kv_heads=16,
    d_ff=5120,
    vocab_size=0,
    n_classes=1000,
    frontend="vision_stub",
    frontend_tokens=197,     # 196 patches + CLS
    source="arXiv:2010.11929; hf",
)

# ViT trains on images, not 4k token streams: its own shape set.
TRAIN_224 = ShapeConfig("train_224", 197, 1024, "train")
SHAPES = (TRAIN_224,)


def reduced() -> ModelConfig:
    import dataclasses
    return dataclasses.replace(
        CONFIG, n_layers=2, d_model=64, n_heads=4, n_kv_heads=4, d_ff=128,
        n_classes=16, frontend_tokens=17)
