"""Roofline terms of an (arch x shape) cell on a device profile.

The port's twin of ``repro.roofline.analysis``::

    compute    = flops per chip / the profile's peak bf16 FLOP/s
    memory     = bytes per chip / its HBM bytes/s
    collective = wire bytes per chip / its link bytes/s

The device's figures are a :class:`Profile`, not module constants.
:data:`H100` is the default: NVIDIA's H100 SXM data sheet at its full
700 W power limit (the card the port runs on, "H100 80GB HBM3, 700 W").

The record's field names are the reference's.  ``cost`` (``"flops"``,
``"bytes accessed"``) and the wire bytes are per-chip numbers the caller
counted or measured; the port compiles no HLO.  Where the flops given are
less than half the analytic model FLOPs (the reference's guard against
XLA-CPU cost analysis that does not multiply loop bodies), the analytic
count takes their place, as in the reference.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Dict

from repro_torch.configs.base import ModelConfig, ShapeConfig


@dataclass(frozen=True)
class Profile:
    """One device's peak figures (per chip unless said otherwise)."""
    name: str
    peak_bf16_flops: float          # FLOP/s, dense bf16 on the tensor cores
    hbm_bytes_per_s: float          # B/s
    link_bytes_per_s: float         # B/s per direction to a neighbour
    slow_bytes_per_s: float         # B/s per chip over the slow (pod) axis
    hbm_bytes_per_chip: float       # B
    chips_per_pod: int              # chips one fast fabric joins
    fp32_flops_per_s: float = 0.0   # FLOP/s outside the tensor cores (0: not given)


#: NVIDIA H100 SXM (H100 80GB HBM3, 700 W), from NVIDIA's H100 data
#: sheet: 989 TFLOP/s dense bf16, 67 TFLOP/s float32, 3.35 TB/s of HBM3,
#: 80 GB of it, NVLink 4 at 900 GB/s per GPU (450 GB/s each way); a pod is
#: one HGX H100 board of 8 GPUs on NVSwitch, and between boards each GPU
#: has one 400 Gb/s ConnectX-7 port (50 GB/s), from NVIDIA's DGX H100
#: data sheet.
H100 = Profile(name="H100 80GB HBM3, 700 W",
               peak_bf16_flops=989e12,
               hbm_bytes_per_s=3.35e12,
               link_bytes_per_s=450e9,
               slow_bytes_per_s=400e9 / 8,
               hbm_bytes_per_chip=80e9,
               chips_per_pod=8,
               fp32_flops_per_s=67e12)


@dataclass
class RooflineRecord:
    arch: str
    shape: str
    mesh: str
    chips: int
    # counted or measured numbers (per device)
    hlo_flops_per_dev: float
    hlo_bytes_per_dev: float
    wire_bytes_per_dev: float
    collectives: Dict[str, float]
    # analytic
    model_flops: float               # global, 6ND(+attn) per step
    flops_source: str
    # derived terms (seconds)
    t_compute: float = 0.0
    t_memory: float = 0.0
    t_collective: float = 0.0
    bottleneck: str = ""
    useful_ratio: float = 0.0        # MODEL_FLOPS / (flops global)
    roofline_fraction: float = 0.0   # t_compute / max(all terms)
    note: str = ""

    def finalize(self, profile: Profile = H100) -> "RooflineRecord":
        hlo_global = self.hlo_flops_per_dev * self.chips
        self.t_compute = self.hlo_flops_per_dev / profile.peak_bf16_flops
        self.t_memory = self.hlo_bytes_per_dev / profile.hbm_bytes_per_s
        self.t_collective = self.wire_bytes_per_dev / profile.link_bytes_per_s
        terms = {"compute": self.t_compute, "memory": self.t_memory,
                 "collective": self.t_collective}
        self.bottleneck = max(terms, key=terms.get)
        self.useful_ratio = (self.model_flops / hlo_global
                             if hlo_global else 0.0)
        tmax = max(terms.values())
        self.roofline_fraction = self.t_compute / tmax if tmax else 0.0
        return self


def attention_flops(cfg: ModelConfig, shape: ShapeConfig) -> float:
    """Dot-product attention FLOPs per training/prefill step (fwd only)."""
    if cfg.n_heads == 0:
        return 0.0
    B, S = shape.global_batch, shape.seq_len
    hd = cfg.resolved_head_dim
    layers = cfg.n_layers + cfg.n_encoder_layers
    # causal: S^2/2 per pair of (qk, av) matmuls
    return 2.0 * layers * B * (S * S / 2) * cfg.n_heads * hd * 2


def model_flops(cfg: ModelConfig, shape: ShapeConfig) -> float:
    """6·N·D (dense) or 6·N_active·D (MoE) + attention term.

    Training: 6ND (fwd+bwd).  Prefill: 2ND (fwd only).  Decode: 2N per
    token x batch.
    """
    n_active = cfg.n_active_params()
    B, S = shape.global_batch, shape.seq_len
    if shape.kind == "train":
        flops = 6.0 * n_active * B * S + 3.0 * attention_flops(cfg, shape)
    elif shape.kind == "prefill":
        flops = 2.0 * n_active * B * S + attention_flops(cfg, shape)
    else:  # decode: one token per sequence; attention reads the S-cache
        hd = cfg.resolved_head_dim
        attn = (2.0 * cfg.n_layers * B * S * cfg.n_heads * hd * 2
                if cfg.n_heads else 0.0)
        flops = 2.0 * n_active * B + attn
    return flops


def build_record(*, arch: str, shape: ShapeConfig, cfg: ModelConfig,
                 mesh_name: str, chips: int, cost: Dict,
                 wire_bytes: float, collectives: Dict[str, float],
                 note: str = "", profile: Profile = H100) -> RooflineRecord:
    hlo_flops = float(cost.get("flops", 0.0))
    hlo_bytes = float(cost.get("bytes accessed", 0.0))
    mf = model_flops(cfg, shape)
    # a gross under-count (loop bodies not multiplied): substitute the
    # analytic floor
    src = "cost_analysis"
    if hlo_flops * chips < 0.5 * mf:
        hlo_flops = mf / chips
        src = "analytic_6ND(cost_analysis_undercounts_loops)"
    rec = RooflineRecord(
        arch=arch, shape=shape.name, mesh=mesh_name, chips=chips,
        hlo_flops_per_dev=hlo_flops, hlo_bytes_per_dev=hlo_bytes,
        wire_bytes_per_dev=wire_bytes, collectives=dict(collectives),
        model_flops=mf, flops_source=src, note=note)
    return rec.finalize(profile)
