"""K1 (``csrc/decode.cu`` ``decode_augment_kernel``): the least time for
the rows it decoded in the profiled steps (the larger of its bytes at
the HBM rate and its hash's integer operations at the card's SM clock),
over the device time of its launches."""
from bench import roofline, yardstick
from bench.reference.images import DATASETS


def read(rec):
    prof = rec.get("profile")
    if not prof:
        return None
    times = roofline.kernel_times(rec, roofline.named(
        "decode_augment_kernel"))
    launches = prof["launches"].get("k1", 0)
    rows = prof["rows_decoded"]
    if not times or not launches or not rows:
        return None
    us, seen = (sum(v[i] for v in times.values()) for i in (0, 1))
    spent_ms = us * launches / seen / 1e3
    crop = DATASETS[rec["cell"]["dataset"]["kind"]](n=1).crop_hw
    nbytes, hashed = yardstick.k1_work(rows, *crop)
    least = nbytes / yardstick.HBM_BYTES_PER_S * 1e3
    if rec.get("sm_clocks"):
        least = max(least, yardstick.int_ops_ms(
            hashed, yardstick.K1_HASH_OPS, rec["sm_clocks"]))
    return 100.0 * least / spent_ms
