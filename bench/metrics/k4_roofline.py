"""K4's forward (``csrc/flash_attention.cu``) at the encoder's attention
shape (batch, tokens, heads | kv heads, head size; no mask)."""
from bench import roofline, yardstick


def read(rec):
    if not rec.get("profile") or rec["config"]["family"] != "encoder":
        return None
    least = yardstick.least_ms(*yardstick.k4_work(
        *roofline.attention_shape(rec), False))
    return roofline.share(rec, roofline.named("repro_torch::flash::"),
                          "k4", least)
