"""K4's backward (``csrc/flash_attention_bwd.cu``: its three passes
summed) at the encoder's attention shape."""
from bench import roofline, yardstick


def read(rec):
    if not rec.get("profile") or rec["config"]["family"] != "encoder":
        return None
    least = yardstick.least_ms(*yardstick.k4_bwd_work(
        *roofline.attention_shape(rec), False))
    return roofline.share(rec, roofline.named("repro_torch::flash_bwd::"),
                          "k4_bwd", least)
