"""Config dataclasses of the port: a copy of the reference's
``repro.configs.base`` model and shape configs.

``ModelConfig``, ``SSMConfig``, ``MoEConfig``, ``ShapeConfig`` and
``ParallelismConfig`` are the reference's plain frozen dataclasses,
copied unchanged.  Of ``ParallelismConfig`` the training step reads
``remat``, ``microbatches`` and ``opt_state_dtype``; the mesh fields
(``tp``, ``ep``, ``sp``, ``sp_ssd``, ...) are read by
``distributed.sharding.make_rules``.  The reference's ``RunConfig``
is not copied: nothing of the port reads it.
"""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass
from typing import Optional, Tuple


# ---------------------------------------------------------------------------
# Model families
# ---------------------------------------------------------------------------

FAMILIES = (
    "dense",      # decoder-only transformer
    "moe",        # decoder-only with routed experts
    "encdec",     # encoder-decoder (seamless)
    "ssm",        # attention-free state space (mamba2)
    "hybrid",     # mamba2 blocks + shared attention (zamba2)
    "vlm",        # vision frontend stub + LM backbone
    "audio",      # audio frontend stub + enc-dec backbone
    "encoder",    # encoder-only (vit_huge, paper's own)
)


@dataclass(frozen=True)
class MoEConfig:
    n_experts: int            # routed experts
    top_k: int
    n_shared: int = 0         # always-on shared experts
    d_ff_expert: int = 0      # per-expert hidden size
    capacity_factor: float = 1.25
    router_jitter: float = 0.0
    aux_loss_weight: float = 0.01


@dataclass(frozen=True)
class SSMConfig:
    d_state: int = 128        # N in SSD
    head_dim: int = 64        # P
    expand: int = 2           # d_inner = expand * d_model
    d_conv: int = 4
    chunk: int = 256          # SSD chunk length


@dataclass(frozen=True)
class ModelConfig:
    name: str
    family: str
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab_size: int
    head_dim: int = 0                      # 0 -> d_model // n_heads
    qkv_bias: bool = False
    qk_norm: bool = False
    rope_theta: float = 500_000.0
    norm_eps: float = 1e-5
    tie_embeddings: bool = False
    moe: Optional[MoEConfig] = None
    ssm: Optional[SSMConfig] = None
    # hybrid: a shared (weight-tied) attention block applied every k layers
    hybrid_attn_every: int = 0
    # sliding-window size used by hybrid attention at long context (0 = full)
    attn_window: int = 0
    # enc-dec
    n_encoder_layers: int = 0
    # frontends for [audio]/[vlm]: stub supplies precomputed embeddings
    frontend: str = "none"                 # none | audio_stub | vision_stub
    frontend_tokens: int = 0               # prefix embedding count per sample
    # encoder-only classification head (vit)
    n_classes: int = 0
    source: str = ""                       # provenance tag from the brief

    @property
    def resolved_head_dim(self) -> int:
        if self.head_dim:
            return self.head_dim
        return self.d_model // self.n_heads if self.n_heads else 0

    @property
    def attention_free(self) -> bool:
        return self.family == "ssm"

    @property
    def sub_quadratic(self) -> bool:
        """True when long_500k decode is admissible (SSM state or windowed)."""
        return self.family in ("ssm", "hybrid")

    @property
    def has_decoder(self) -> bool:
        return self.family != "encoder"

    def n_params(self) -> int:
        """Analytic parameter count (used for 6ND roofline MODEL_FLOPS)."""
        d, hd = self.d_model, self.resolved_head_dim
        emb = self.vocab_size * d * (1 if self.tie_embeddings else 2)
        per_layer = 0
        if self.family == "ssm":
            s = self.ssm
            d_in = s.expand * d
            n_h = d_in // s.head_dim
            # in_proj (z,x,B,C,dt) + out_proj + conv + norm + A,D
            per_layer = d * (2 * d_in + 2 * s.d_state + n_h) + d_in * d + \
                (d_in + 2 * s.d_state) * s.d_conv + d_in + 2 * n_h + d
            return emb + self.n_layers * per_layer
        attn = d * (self.n_heads * hd) + 2 * d * (self.n_kv_heads * hd) \
            + (self.n_heads * hd) * d
        dense_ff = 3 * d * self.d_ff  # gated (silu) mlp
        norms = 2 * d
        if self.moe is not None:
            e = self.moe
            ff = 3 * d * e.d_ff_expert * (e.n_experts + e.n_shared) + d * e.n_experts
        else:
            ff = dense_ff
        per_layer = attn + ff + norms
        n = emb + self.n_layers * per_layer + d
        if self.family == "hybrid":
            # replace ff/attn estimate with mamba blocks + one shared attn block
            s = self.ssm
            d_in = s.expand * d
            n_h = d_in // s.head_dim
            mamba = d * (2 * d_in + 2 * s.d_state + n_h) + d_in * d + \
                (d_in + 2 * s.d_state) * s.d_conv + d_in + 2 * n_h + d
            shared = attn + dense_ff + norms
            n = emb + self.n_layers * mamba + shared + d
        if self.family == "encdec":
            # encoder layers (self-attn + ff) and decoder cross-attn
            enc = self.n_encoder_layers * (attn + dense_ff + norms)
            cross = self.n_layers * (attn + d)
            n += enc + cross
        if self.family == "encoder":
            n += d * self.n_classes
        return n

    def n_active_params(self) -> int:
        """Active-per-token params (MoE: shared + top_k experts only)."""
        if self.moe is None:
            return self.n_params()
        d = self.d_model
        e = self.moe
        full = self.n_params()
        all_ff = 3 * d * e.d_ff_expert * (e.n_experts + e.n_shared)
        act_ff = 3 * d * e.d_ff_expert * (e.top_k + e.n_shared)
        return full - self.n_layers * (all_ff - act_ff)


# ---------------------------------------------------------------------------
# Shapes
# ---------------------------------------------------------------------------

@dataclass(frozen=True)
class ShapeConfig:
    name: str
    seq_len: int
    global_batch: int
    kind: str                  # train | prefill | decode

    @property
    def is_train(self) -> bool:
        return self.kind == "train"


TRAIN_4K = ShapeConfig("train_4k", 4_096, 256, "train")
PREFILL_32K = ShapeConfig("prefill_32k", 32_768, 32, "prefill")
DECODE_32K = ShapeConfig("decode_32k", 32_768, 128, "decode")
LONG_500K = ShapeConfig("long_500k", 524_288, 1, "decode")

ALL_SHAPES = (TRAIN_4K, PREFILL_32K, DECODE_32K, LONG_500K)
SHAPES_BY_NAME = {s.name: s for s in ALL_SHAPES}


def shape_applicable(model: ModelConfig, shape: ShapeConfig) -> Tuple[bool, str]:
    """(applicable, reason-if-not) for an (arch, shape) cell."""
    if shape.kind == "decode" and not model.has_decoder:
        return False, "encoder-only arch has no decode step"
    if shape.name == "long_500k" and not model.sub_quadratic:
        return False, "long_500k needs sub-quadratic attention (full-attention arch)"
    return True, ""


# ---------------------------------------------------------------------------
# Parallelism
# ---------------------------------------------------------------------------

@dataclass(frozen=True)
class ParallelismConfig:
    """How a (arch x shape) cell is laid out on the mesh.

    Axes: optional leading 'pod' (DCN), 'data' (DP/FSDP/SP), 'model' (TP/EP).
    """
    dp: bool = True            # batch over ('pod','data')
    fsdp: bool = False         # params+opt state sharded over 'data' too
    tp: bool = True            # heads/ffn over 'model'
    ep: bool = False           # experts over 'model'
    sp: bool = False           # sequence over 'data' (long-context decode)
    remat: str = "none"        # none | block | full
    microbatches: int = 1      # gradient accumulation factor
    grad_compression: str = "none"   # none | int8_ef
    opt_state_dtype: str = "float32"  # float32 | bfloat16 | int8
    param_dtype: str = "bfloat16"
    # attention implementation: splash (pallas flash) | xla
    attn_impl: str = "xla"
    # pure-DP layout: replicate params and shard the batch over BOTH mesh
    # axes (tp must be off)
    dp_over_model: bool = False
    # sequence-parallel SSD prefill (SSM family)
    sp_ssd: bool = False
    # SSM out-projection comm strategy: all-gather the inner-sharded
    # activations instead of psum-ing the projected output
    ssm_gather_out: bool = False

    def replace(self, **kw) -> "ParallelismConfig":
        return dataclasses.replace(self, **kw)
