"""seamless-m4t-large-v2 [audio] — enc-dec multimodal [arXiv:2308.11596; hf].

24L d_model=1024 16H (GQA kv=16) d_ff=8192 vocab=256206.  Encoder and decoder
each get 24 layers (speech encoder + text decoder, per the M4T v2 layout).
The audio frontend (w2v-BERT conformer feature extractor) is a STUB, as in
the reference: the batch supplies precomputed frame embeddings
(``src_embeds``, ``encdec_src_len(S)`` frames).  2,038,556,672 parameters
in the defs (vocab padded to 258,048).
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="seamless-m4t-large-v2",
    family="encdec",
    n_layers=24,
    n_encoder_layers=24,
    d_model=1024,
    n_heads=16,
    n_kv_heads=16,
    d_ff=8192,
    vocab_size=256_206,
    frontend="audio_stub",
    frontend_tokens=0,      # encoder consumes frame embeddings directly
    rope_theta=10_000.0,
    source="arXiv:2308.11596; hf",
)


def reduced() -> ModelConfig:
    """Tiny same-family config for CPU smoke tests."""
    import dataclasses
    return dataclasses.replace(
        CONFIG, n_layers=2, n_encoder_layers=2, d_model=64, n_heads=4,
        n_kv_heads=4, d_ff=128, vocab_size=512)
