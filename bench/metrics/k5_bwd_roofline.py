"""K5's backward (``csrc/ssd_scan_bwd.cu``: its passes summed) at the
ssm family's scan shape."""
from bench import roofline, yardstick


def read(rec):
    if not rec.get("profile") or rec["config"]["family"] != "ssm":
        return None
    least = yardstick.least_ms(*yardstick.k5_bwd_work(
        *roofline.ssd_shape(rec)))
    return roofline.share(rec, roofline.named("repro_torch::ssd_bwd::"),
                          "k5_bwd", least)
