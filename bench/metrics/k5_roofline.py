"""K5's forward (``csrc/ssd_scan.cu``: its launches summed) at the ssm
family's scan shape (batch, sequence, SSD heads, head size, state)."""
from bench import roofline, yardstick


def read(rec):
    if not rec.get("profile") or rec["config"]["family"] != "ssm":
        return None
    least = yardstick.least_ms(*yardstick.k5_work(*roofline.ssd_shape(rec)))
    return roofline.share(rec, roofline.named("repro_torch::ssd::"), "k5",
                          least)
