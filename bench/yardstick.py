"""The benchmark's yardstick: the card's peaks, the kernels' least work
and the model FLOPs that the rooflines and ``step_mfu`` divide by.

Frozen copies, so that no later change to the program moves the ruler:

* the peaks of one NVIDIA H100 SXM (NVIDIA's data sheet, dense rates,
  700 W), as ``src/repro_torch/roofline/analysis.py:47-54`` states them;
* ``bound``, ``int_ops_ms``, ``window_pairs``, ``ssd_flops``,
  ``ssd_bwd_flops``, ``K1_HASH_OPS`` and the byte counts of K1, K4, its
  backward, K5 and its backward, from ``chip_smoke.py`` (``bound``
  :482, ``int_ops_ms`` :502, ``K1_HASH_OPS`` :392, K1's bytes in
  ``kernel_phase`` :587, K4's in ``k4_rows`` :2264 and :2311, K5's in
  ``k5_row`` :2065, K5's backward's in ``ssd_scan_bwd_row`` :2139,
  ``window_pairs`` :2192, ``ssd_flops`` :2413, ``ssd_bwd_flops``
  :2433), as they stood when the benchmark was written.

The kernels' times are found by their namespaces in the trace
(``bench/roofline.py``), not by pass names, so that a pass renamed or
added by a later redesign stays in the sum.

Every function here counts from shapes alone.
"""
from __future__ import annotations

from typing import Dict, Tuple

#: bytes per second of HBM3, FLOP/s of dense bf16 on the tensor cores
#: and of float32 outside them
HBM_BYTES_PER_S = 3.35e12
BF16_FLOPS_PER_S = 989e12
FP32_FLOPS_PER_S = 67e12
#: integer lanes of one SM: the ALU pipe's 64 and the 128
#: thread-instructions its four schedulers issue per clock
ALU_LANES_PER_SM = 64
DISPATCH_LANES_PER_SM = 128
#: integer operations per hashed byte of K1 (on the ALU pipe, in all)
K1_HASH_OPS = (7, 11)


def bound(nbytes: float, flops: float,
          peak: float = FP32_FLOPS_PER_S) -> Tuple[float, str]:
    """(bound_ms, bound_by): the larger of bytes over the memory rate
    and operations over ``peak``."""
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = flops / peak * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def int_ops_ms(hashed: int, ops, sm_clocks: float) -> float:
    """Least milliseconds for the hash of ``hashed`` bytes at ``ops`` =
    (ALU-pipe operations, all integer operations) per byte, at
    ``sm_clocks`` = SMs x the SM clock in Hz."""
    alu, total = ops
    return max(hashed * alu / (sm_clocks * ALU_LANES_PER_SM),
               hashed * total / (sm_clocks * DISPATCH_LANES_PER_SM)) * 1e3


def window_pairs(S: int, causal: bool, window: int = 0, Sk=None) -> int:
    """The (query, key) pairs K4's mask keeps per (batch, head)."""
    if not causal:
        return S * (Sk or S)
    if not window or window >= S:
        return S * (S + 1) // 2
    return window * (window + 1) // 2 + (S - window) * window


def ssd_flops(B: int, S: int, nh: int, P: int, N: int,
              f32_cost: int = 1) -> int:
    """Operations of the SSD scan at the chunk length that needs fewest,
    a product with a float32 operand counted ``f32_cost`` times."""
    def at(c: int) -> int:
        nc = -(-S // c)
        pairs = nc * c * (c + 1) // 2
        return B * (2 * pairs * N + f32_cost * nh * (
            2 * pairs * P + 4 * S * P * N + 2 * nc * P * N))
    return min(at(c) for c in range(1, S + 1))


def ssd_bwd_flops(B: int, S: int, nh: int, P: int, N: int,
                  f32_cost: int = 1) -> int:
    """Operations of K5's backward at the chunk length that needs
    fewest, counted as :func:`ssd_flops` counts the forward's."""
    def at(c: int) -> int:
        nc = -(-S // c)
        pairs = nc * c * (c + 1) // 2
        bf16 = 2 * pairs * N + nh * 2 * pairs * P
        f32 = 4 * pairs * N + nh * (2 * pairs * P + 10 * S * P * N
                                    + 2 * S * N + 4 * nc * P * N)
        return B * (bf16 + f32_cost * f32)
    return min(at(c) for c in range(1, S + 1))


# -- each kernel's least work at a launch's shape: (bytes, ops, peak) ---------

def k1_work(rows: int, crop_h: int, crop_w: int, out_size: int = 4):
    """K1 (decode + crop + flip + normalize) of ``rows`` samples: the
    output written once and five 4-byte scalars per sample read; the
    hash of every output byte on the integer pipes (``int_ops_ms``)."""
    n_out = rows * crop_h * crop_w * 3
    return n_out * out_size + 20 * rows, n_out


def k4_work(B: int, S: int, H: int, K: int, hd: int, causal: bool,
            size: int = 2):
    """K4's forward: q, k, v read and the output written once; two
    products over the kept pairs, at the bf16 rate."""
    q = B * S * H * hd
    kv = B * S * K * hd
    return size * (2 * q + 2 * kv), 4 * B * H * hd * window_pairs(S, causal)


def k4_bwd_work(B: int, S: int, H: int, K: int, hd: int, causal: bool,
                size: int = 2):
    """K4's backward: q, k, v, out and dout read, dq, dk, dv written
    once; five products over the kept pairs."""
    q = B * S * H * hd
    kv = B * S * K * hd
    return size * (4 * q + 4 * kv), \
        5 * 2 * B * H * hd * window_pairs(S, causal)


def k5_work(B: int, S: int, nh: int, P: int, N: int):
    """K5 in bf16: x and y, B and C (bf16), dt, A and the final state
    (float32) once; the scan's operations with float32 operands as hi +
    lo bf16 parts."""
    x, bc, dt = B * S * nh * P, B * S * N, B * S * nh
    nbytes = 2 * (2 * x + 2 * bc) + 4 * (dt + nh + B * nh * P * N)
    return nbytes, ssd_flops(B, S, nh, P, N, 2)


def k5_bwd_work(B: int, S: int, nh: int, P: int, N: int):
    """K5's backward in bf16: x, dy, B, C (bf16), dt and A read, dx, dB,
    dC (bf16), ddt and dA written once."""
    x, bc, dt = B * S * nh * P, B * S * N, B * S * nh
    nbytes = 2 * (3 * x + 4 * bc) + 4 * (2 * dt + 2 * nh)
    return nbytes, ssd_bwd_flops(B, S, nh, P, N, 2)


def least_ms(nbytes: float, ops: float, peak: float = BF16_FLOPS_PER_S
             ) -> float:
    return bound(nbytes, ops, peak)[0]


# -- model FLOPs of one training step (no recompute counted) ------------------

def encoder_step_flops(cfg: Dict, batch: int) -> float:
    """One training step of the encoder family: 6 FLOPs per matrix
    parameter and token (forward 2, backward 4) over every block's
    attention and MLP matrices, the class head on the first token of each
    image, and attention's scores and products, 12 L S^2 d per image
    (4 S^2 d a layer forward, twice that backward)."""
    d, L, S = cfg["d_model"], cfg["n_layers"], cfg["frontend_tokens"]
    hd = cfg["head_dim"] or d // cfg["n_heads"]
    attn = d * cfg["n_heads"] * hd * 2 + 2 * d * cfg["n_kv_heads"] * hd
    block = attn + 3 * d * cfg["d_ff"]
    per_image = 6 * L * block * S + 6 * d * cfg["n_classes"] \
        + 12 * L * S * S * cfg["n_heads"] * hd
    return float(batch * per_image)


def ssm_step_flops(cfg: Dict, batch: int, seq: int) -> float:
    """One training step of the ssm family: 6 FLOPs per matrix parameter
    and token over every block's projections (z, x, B, C, dt in; out)
    and the vocabulary head (the published vocabulary, not its padding),
    plus the SSD scan, forward once and backward twice its forward
    (``ssd_flops`` at the chunk that needs fewest)."""
    d, L, s = cfg["d_model"], cfg["n_layers"], cfg["ssm"]
    d_in = s["expand"] * d
    nh = d_in // s["head_dim"]
    block = d * (2 * d_in + 2 * s["d_state"] + nh) + d_in * d
    tokens = batch * seq
    mats = 6 * tokens * (L * block + d * cfg["vocab_size"])
    scan = 3 * L * ssd_flops(batch, seq, nh, s["head_dim"], s["d_state"])
    return float(mats + scan)

