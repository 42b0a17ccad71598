"""The whole step's share of the card's peak: the model FLOPs of the
traced run's plain steps (``bench/yardstick.py``: no recompute counted),
over their wall seconds, over the H100's dense bf16 peak."""
from bench import yardstick
from bench.reference import train


def read(rec):
    plain = rec.get("plain")
    if not plain or not plain["step_s"]:
        return None
    cfg = rec["config"]
    flops = train.family(cfg).step_flops(cfg, rec["cell"])
    rate = flops * len(plain["step_s"]) / sum(plain["step_s"])
    return 100.0 * rate / yardstick.BF16_FLOPS_PER_S
