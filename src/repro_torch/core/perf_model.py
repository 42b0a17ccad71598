"""The DSI pipeline performance model (Seneca §5.1, Eqs. 1–9).

The model predicts DSI throughput (samples/s) for a data-parallel training
cluster given hardware parameters (Table 3), a dataset, and the cache split
``(x_E, x_D, x_A)`` across the three data forms.

Faithfulness notes:
* Equations follow the paper exactly; all evaluations are vectorized over
  the partition simplex so MDP's 1%-granularity brute force (~5k points)
  is a single numpy pass.
* The paper expresses gradient-communication overheads C_nw / C_PCIe in
  bytes "for a batch" but adds them to per-sample sizes inside Eqs. 1/3/5.
  We therefore normalize: ``c = (2(n-1)/n) * model_bytes / batch_size``
  (per-sample share of each ring all-reduce).  The paper's text assigns
  "GPUs per node" to C_nw and "nodes" to C_PCIe, which is swapped relative
  to its own definitions; we implement the physically meaningful pairing
  (nodes -> network, GPUs/node -> PCIe) and note the discrepancy here.
* NVLink special cases (§5.1): intra-node NVLink -> C_PCIe = 0; inter-node
  NVLink -> both 0.  On TPU these correspond to "ICI is not the gradient
  bottleneck" (DESIGN.md §2).
"""
from __future__ import annotations

from dataclasses import dataclass, field, replace
from typing import Dict, Optional, Tuple

import numpy as np

GB = 1e9
MB = 1e6
KB = 1e3
Gbit = 1e9 / 8

#: local-SSD read-bandwidth prior for spill tiers whose profile carries
#: no measured ``b_disk`` (telemetry calibration replaces it live)
DEFAULT_DISK_BW = 1.5 * GB

#: device-memory serve-bandwidth prior for HBM tiers with no measured
#: ``b_hbm`` — conservatively the host→device link rate until the "h2d"
#: telemetry channel calibrates it (an HBM hit costs no transfer at all,
#: but the *fill* path that earned residency ran at this rate)
DEFAULT_HBM_BW = 100 * GB


@dataclass(frozen=True)
class HardwareProfile:
    """Per-node performance (Table 3 / Table 5)."""
    name: str
    t_gpu: float              # GPU ingestion (samples/s/node)
    t_da: float               # CPU decode+augment (samples/s/node)
    t_a: float                # CPU augment-only (samples/s/node)
    b_nic: float              # network bandwidth (B/s/node)
    b_pcie: float             # PCIe bandwidth (B/s/node)
    b_cache: float            # remote cache service bandwidth (B/s)
    b_storage: float          # remote storage bandwidth (B/s)
    s_cache: float            # cache capacity (bytes)
    n_nodes: int = 1
    gpus_per_node: int = 4
    nvlink_intra: bool = False
    nvlink_inter: bool = False
    # SSD spill tier (form×tier MDP): 0 disables the disk level
    b_disk: float = 0.0       # local disk read bandwidth (B/s)
    s_disk: float = 0.0       # disk spill capacity (bytes)
    # device-resident (HBM) tier: 0 disables the device level
    b_hbm: float = 0.0        # device-tier serve bandwidth (B/s)
    s_hbm: float = 0.0        # device cache capacity (bytes)


@dataclass(frozen=True)
class DatasetProfile:
    """Dataset parameters (Table 6) with per-form byte sizes.

    The paper's single inflation factor M=5.12 (Table 5) is precisely the
    fp32 *augmented* tensor over the encoded size for ImageNet-1K
    (224x224x3x4B = 602KB / 114.62KB = 5.25 ~ 5.12).  The *decoded* form in
    a torchvision pipeline is the uint8 image before ToTensor/Normalize
    (256x256x3 = 196KB).  Modelling each form with its true byte size
    (rather than one M for both) recovers Table 6's marquee splits — e.g.
    OpenImages/Azure "5-95-0" is exactly the minimal decoded-covering split
    (1.9M x 196KB / 400GB = 0.93).  See EXPERIMENTS.md §MDP.
    """
    name: str
    n_total: int                       # samples
    s_data: float                      # encoded sample size (bytes)
    decoded_bytes: float = 256 * 256 * 3            # uint8 decode
    augmented_bytes: float = 224 * 224 * 3 * 4      # fp32 augmented
    gpu_bytes: float = 224 * 224 * 3 * 4            # fp32 over PCIe
    inflation: float = 0.0             # legacy M; 0 -> derived per form

    @property
    def m_gpu(self) -> float:
        return (self.inflation or self.gpu_bytes / self.s_data)


@dataclass(frozen=True)
class JobProfile:
    """Training-job parameters entering the C_nw / C_PCIe terms."""
    model_bytes: float = 100 * MB
    batch_size: int = 256


@dataclass(frozen=True)
class DSIThroughput:
    dsi_a: float
    dsi_d: float
    dsi_e: float
    dsi_s: float
    n_a: float
    n_d: float
    n_e: float
    n_storage: float
    overall: float
    bottleneck: str


def _comm_overheads(hw: HardwareProfile, job: JobProfile) -> Tuple[float, float]:
    """Per-sample gradient communication overhead bytes (c_nw, c_pcie)."""
    def ring(n: int) -> float:
        return 2.0 * (n - 1) / n * job.model_bytes if n > 1 else 0.0
    c_nw = ring(hw.n_nodes) / job.batch_size
    c_pcie = ring(hw.gpus_per_node) / job.batch_size
    if hw.nvlink_intra or hw.nvlink_inter:
        c_pcie = 0.0
    if hw.nvlink_inter:
        c_nw = 0.0
    return c_nw, c_pcie


def dsi_throughput(hw: HardwareProfile, ds: DatasetProfile, job: JobProfile,
                   x_e, x_d, x_a) -> DSIThroughput:
    """Evaluate Eqs. 1–9. x_* may be scalars or broadcastable arrays."""
    x_e = np.asarray(x_e, np.float64)
    x_d = np.asarray(x_d, np.float64)
    x_a = np.asarray(x_a, np.float64)
    n = hw.n_nodes
    S = ds.s_data
    a_b, d_b, g_b = ds.augmented_bytes, ds.decoded_bytes, ds.gpu_bytes
    if ds.inflation:                   # legacy single-M mode
        a_b = d_b = g_b = ds.inflation * S
    c_nw, c_pcie = _comm_overheads(hw, job)

    # Eq. 1 — augmented data in cache
    terms_a = np.stack(np.broadcast_arrays(
        hw.b_cache / a_b + 0 * x_a,
        n * hw.b_nic / (a_b + c_nw) + 0 * x_a,
        n * hw.b_pcie / (g_b + c_pcie) + 0 * x_a,
        np.asarray(n * hw.t_gpu, np.float64) + 0 * x_a))
    dsi_a = terms_a.min(axis=0)

    # Eq. 2
    n_a = np.minimum(ds.n_total, x_a * hw.s_cache / a_b)

    # Eq. 3 — decoded data in cache (CPU applies augmentations)
    terms_d = np.stack(np.broadcast_arrays(
        hw.b_cache / d_b + 0 * x_d,
        n * hw.b_nic / (d_b + c_nw) + 0 * x_d,
        np.asarray(n * hw.t_a, np.float64) + 0 * x_d,
        n * hw.b_pcie / (g_b + c_pcie) + 0 * x_d,
        np.asarray(n * hw.t_gpu, np.float64) + 0 * x_d))
    dsi_d = terms_d.min(axis=0)

    # Eq. 4
    n_d = np.minimum(ds.n_total - n_a, x_d * hw.s_cache / d_b)

    # Eq. 5 — encoded data in cache (CPU decodes + augments)
    terms_e = np.stack(np.broadcast_arrays(
        hw.b_cache / S + 0 * x_e,
        n * hw.b_nic / (S + c_nw) + 0 * x_e,
        np.asarray(n * hw.t_da, np.float64) + 0 * x_e,
        n * hw.b_pcie / (g_b + c_pcie) + 0 * x_e,
        np.asarray(n * hw.t_gpu, np.float64) + 0 * x_e))
    dsi_e = terms_e.min(axis=0)

    # Eq. 6
    n_e = np.minimum(ds.n_total - (n_a + n_d), x_e * hw.s_cache / S)

    # Eq. 7 — storage
    dsi_s = np.minimum(dsi_e, hw.b_storage / S)

    # Eq. 8
    n_storage = np.maximum(ds.n_total - n_a - n_d - n_e, 0.0)

    # Eq. 9
    overall = (n_a * dsi_a + n_d * dsi_d + n_e * dsi_e
               + n_storage * dsi_s) / ds.n_total

    names_a = ("cache_bw", "nic", "pcie", "gpu")
    names_d = ("cache_bw", "nic", "cpu_augment", "pcie", "gpu")
    names_e = ("cache_bw", "nic", "cpu_decode_augment", "pcie", "gpu")
    if overall.ndim == 0:
        # dominant (highest-weight) access class decides the bottleneck label
        weights = np.array([n_a * dsi_a, n_d * dsi_d, n_e * dsi_e,
                            n_storage * dsi_s])
        cls = int(np.argmax(weights))
        bn = [names_a[int(terms_a.argmin(0))],
              names_d[int(terms_d.argmin(0))],
              names_e[int(terms_e.argmin(0))],
              "storage_bw" if dsi_s < dsi_e else
              names_e[int(terms_e.argmin(0))]][cls]
    else:
        bn = "vectorized"
    return DSIThroughput(
        dsi_a=dsi_a, dsi_d=dsi_d, dsi_e=dsi_e, dsi_s=dsi_s,
        n_a=n_a, n_d=n_d, n_e=n_e, n_storage=n_storage,
        overall=overall, bottleneck=bn)


# ---------------------------------------------------------------------------
# Form × tier model (DRAM level + SSD spill level)
# ---------------------------------------------------------------------------

def _form_rates(hw: HardwareProfile, ds: DatasetProfile, job: JobProfile,
                b_serve: float) -> Tuple[float, float, float, float]:
    """Per-form serve rates (Eqs. 1/3/5/7) with the cache-bandwidth term
    replaced by ``b_serve`` — the per-tier generalization: a DRAM hit is
    served at ``b_cache``, a disk hit at ``b_disk``, everything else in
    the equations (NIC, CPU, PCIe, GPU) is tier-independent."""
    n = hw.n_nodes
    S = ds.s_data
    a_b, d_b, g_b = ds.augmented_bytes, ds.decoded_bytes, ds.gpu_bytes
    if ds.inflation:
        a_b = d_b = g_b = ds.inflation * S
    c_nw, c_pcie = _comm_overheads(hw, job)
    dsi_a = min(b_serve / a_b, n * hw.b_nic / (a_b + c_nw),
                n * hw.b_pcie / (g_b + c_pcie), n * hw.t_gpu)
    dsi_d = min(b_serve / d_b, n * hw.b_nic / (d_b + c_nw), n * hw.t_a,
                n * hw.b_pcie / (g_b + c_pcie), n * hw.t_gpu)
    dsi_e = min(b_serve / S, n * hw.b_nic / (S + c_nw), n * hw.t_da,
                n * hw.b_pcie / (g_b + c_pcie), n * hw.t_gpu)
    dsi_s = min(dsi_e, hw.b_storage / S)
    return dsi_a, dsi_d, dsi_e, dsi_s


def dsi_throughput_tiered(hw: HardwareProfile, ds: DatasetProfile,
                          job: JobProfile, dram_split, disk_split,
                          hbm_split=None):
    """Overall DSI throughput with a two- or three-level cache.

    ``dram_split`` partitions ``hw.s_cache``, ``disk_split`` partitions
    ``hw.s_disk`` and ``hbm_split`` (default: ``dram_split``'s
    geometry) partitions ``hw.s_hbm`` across the three forms; each may
    be a scalar triple or broadcastable arrays (the MDP solver fixes
    two levels and sweeps the third).  Coverage is greedy
    most-processed first within each level (Eqs. 2/4/6), faster levels
    covering first — HBM, then DRAM, then the disk level over what DRAM
    left over; per-form DRAM/disk serve rates come from
    :func:`_form_rates` at ``b_cache`` vs ``b_disk``.  A device-tier
    hit is already accelerator-resident and device kernels handle any
    remaining processing (fused decode+augment), so its rate skips the
    NIC/CPU/PCIe terms entirely: ``min(b_hbm / bytes_f, n * t_gpu)``.
    With ``b_hbm * s_hbm == 0`` the computation is *bit-identical* to
    the two-level model (regression-pinned), and with
    ``b_disk * s_disk == 0`` too it reduces exactly to Eq. 9.
    """
    x_e, x_d, x_a = (np.asarray(v, np.float64) for v in dram_split)
    y_e, y_d, y_a = (np.asarray(v, np.float64) for v in disk_split)
    S = ds.s_data
    a_b, d_b = ds.augmented_bytes, ds.decoded_bytes
    if ds.inflation:
        a_b = d_b = ds.inflation * S
    da1, dd1, de1, dsi_s = _form_rates(hw, ds, job, hw.b_cache)
    s_disk = hw.s_disk if hw.b_disk > 0 else 0.0
    if s_disk > 0:
        da2, dd2, de2, _ = _form_rates(hw, ds, job, hw.b_disk)
    else:
        da2 = dd2 = de2 = 0.0
    N = float(ds.n_total)
    remaining = N + 0.0 * (x_a + y_a)          # broadcast shape
    hbm = 0.0
    s_hbm = hw.s_hbm if hw.b_hbm > 0 else 0.0
    if s_hbm > 0:
        zs = hbm_split if hbm_split is not None else (x_e, x_d, x_a)
        z_e, z_d, z_a = (np.asarray(v, np.float64) for v in zs)
        n = hw.n_nodes
        da0 = min(hw.b_hbm / a_b, n * hw.t_gpu)
        dd0 = min(hw.b_hbm / d_b, n * hw.t_gpu)
        de0 = min(hw.b_hbm / S, n * hw.t_gpu)
        remaining = remaining + 0.0 * z_a
        n_a0 = np.minimum(remaining, z_a * s_hbm / a_b)
        remaining = remaining - n_a0
        n_d0 = np.minimum(remaining, z_d * s_hbm / d_b)
        remaining = remaining - n_d0
        n_e0 = np.minimum(remaining, z_e * s_hbm / S)
        remaining = remaining - n_e0
        hbm = n_a0 * da0 + n_d0 * dd0 + n_e0 * de0
    n_a1 = np.minimum(remaining, x_a * hw.s_cache / a_b)
    remaining = remaining - n_a1
    n_d1 = np.minimum(remaining, x_d * hw.s_cache / d_b)
    remaining = remaining - n_d1
    n_e1 = np.minimum(remaining, x_e * hw.s_cache / S)
    remaining = remaining - n_e1
    n_a2 = np.minimum(remaining, y_a * s_disk / a_b)
    remaining = remaining - n_a2
    n_d2 = np.minimum(remaining, y_d * s_disk / d_b)
    remaining = remaining - n_d2
    n_e2 = np.minimum(remaining, y_e * s_disk / S)
    remaining = remaining - n_e2
    overall = (hbm
               + n_a1 * da1 + n_d1 * dd1 + n_e1 * de1
               + n_a2 * da2 + n_d2 * dd2 + n_e2 * de2
               + np.maximum(remaining, 0.0) * dsi_s) / N
    return overall


# ---------------------------------------------------------------------------
# Telemetry calibration
# ---------------------------------------------------------------------------

#: HardwareProfile fields a telemetry snapshot can override.
CALIBRATABLE = ("t_da", "t_a", "b_storage", "b_cache", "b_disk", "b_hbm")


def calibrate(hw: HardwareProfile, telemetry,
              min_samples: int = 32) -> HardwareProfile:
    """Override ``hw``'s measured rates from observed telemetry.

    ``telemetry`` is anything exposing the :data:`CALIBRATABLE` attributes
    (samples/s for CPU rates, bytes/s for bandwidths; ``None`` = no
    signal) plus a ``counts`` mapping of observation counts per field —
    i.e. a :class:`repro_torch.api.telemetry.TelemetrySnapshot`.  A field is
    only overridden once it has ``min_samples`` observations, so a cold
    server keeps the static Table-3 profile and calibration phases in
    gradually.  Returns ``hw`` itself when nothing qualifies, making
    "did calibration change anything" an identity check.
    """
    counts = getattr(telemetry, "counts", {}) or {}
    overrides = {}
    for name in CALIBRATABLE:
        value = getattr(telemetry, name, None)
        if value is None or not np.isfinite(value) or value <= 0:
            continue
        if counts.get(name, 0) < min_samples:
            continue
        overrides[name] = float(value)
    if not overrides:
        return hw
    base = hw.name.removesuffix("+calibrated")
    return replace(hw, name=f"{base}+calibrated", **overrides)


# ---------------------------------------------------------------------------
# Paper profiles (Tables 4, 5, 6)
# ---------------------------------------------------------------------------

IN_HOUSE = HardwareProfile(
    name="in-house", t_gpu=4550, t_da=2132, t_a=4050,
    b_nic=10 * Gbit, b_pcie=32 * GB, b_cache=10 * Gbit,
    b_storage=500 * MB, s_cache=64 * GB, n_nodes=1, gpus_per_node=2)

IN_HOUSE_2X = replace(IN_HOUSE, name="2x-in-house", n_nodes=2)

AWS_P3 = HardwareProfile(
    name="aws-p3.8xlarge", t_gpu=9989, t_da=3432, t_a=6520,
    b_nic=10 * Gbit, b_pcie=32 * GB, b_cache=10 * Gbit,
    b_storage=256 * MB, s_cache=64 * GB, n_nodes=1, gpus_per_node=4,
    nvlink_intra=True)

AZURE_NC96 = HardwareProfile(
    name="azure-nc96ads", t_gpu=14301, t_da=9783, t_a=12930,
    b_nic=80 * Gbit, b_pcie=64 * GB, b_cache=30 * Gbit,
    b_storage=250 * MB, s_cache=64 * GB, n_nodes=1, gpus_per_node=4,
    nvlink_intra=True)

AZURE_2X = replace(AZURE_NC96, name="2x-azure", n_nodes=2)

VALIDATION_PROFILES = (IN_HOUSE, IN_HOUSE_2X, AWS_P3, AZURE_NC96)

# Evaluation caches (§7): in-house 115GB, AWS/Azure 400GB remote cache.
EVAL_PROFILES = (
    replace(IN_HOUSE, s_cache=115 * GB),
    replace(IN_HOUSE_2X, s_cache=115 * GB),
    replace(AWS_P3, s_cache=400 * GB),
    replace(AZURE_NC96, s_cache=400 * GB),
    replace(AZURE_2X, s_cache=400 * GB),
)

IMAGENET_1K = DatasetProfile("imagenet-1k", 1_300_000, 114.62 * KB)
OPENIMAGES = DatasetProfile("openimages-v7", 1_900_000, 315.84 * KB)
IMAGENET_22K = DatasetProfile("imagenet-22k", 14_000_000, 91.39 * KB)
# Table-5-faithful single-M variant (fp32 tensors everywhere) used by the
# Fig. 8 model-validation benchmark:
IMAGENET_1K_M512 = DatasetProfile("imagenet-1k-m5.12", 1_300_000,
                                  114.62 * KB, inflation=5.12)

DATASETS = (IMAGENET_1K, OPENIMAGES, IMAGENET_22K)


def tpu_profile(*, t_tpu_samples: float, n_hosts: int,
                host_cpu_da: float = 8000.0, host_cpu_a: float = 15000.0,
                dcn_bw: float = 25 * GB, pcie_bw: float = 32 * GB,
                cache_bw: float = 50 * GB, storage_bw: float = 2 * GB,
                cache_bytes: float = 256 * GB) -> HardwareProfile:
    """TPU-pod hardware profile: T_GPU becomes the per-host TPU ingestion
    rate derived from the compiled-step roofline (DESIGN.md §2)."""
    return HardwareProfile(
        name=f"tpu-pod-{n_hosts}h", t_gpu=t_tpu_samples, t_da=host_cpu_da,
        t_a=host_cpu_a, b_nic=dcn_bw, b_pcie=pcie_bw, b_cache=cache_bw,
        b_storage=storage_bw, s_cache=cache_bytes, n_nodes=n_hosts,
        gpus_per_node=4, nvlink_intra=True)
